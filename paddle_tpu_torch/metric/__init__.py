"""Metrics (the port's counterpart of ``paddle_tpu/metric/__init__.py``).

``Metric.compute`` runs on the device after each train and eval
forward; ``Model`` buffers its outputs and folds them into the host
accumulators (``update_stacked``) only at a drain, so a step costs no
host sync. ``update``/``accumulate`` are the JAX package's NumPy code.

``Accuracy.compute`` returns the same ``correct`` array as the JAX
package's ``argsort(-pred)[..., :k] == label``, a stable sort in which
ties go to the lower index and NaN scores sort last: it ranks the
label's score among its row (entries greater, or equal at a lower
index, come first) in one pass over the scores, where a full sort of a
50304-column vocabulary row would cost far more.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..io import _host_array as _host


def _label_rank(pred: torch.Tensor, label: torch.Tensor):
    """(rank, valid): the position of column ``label`` in a stable
    descending sort of ``pred``'s last axis (ties to the lower index,
    NaN last, as ``argsort(-pred)``), and whether the label names a
    column at all. ``label`` has ``pred``'s shape without the last
    axis, or that shape plus a trailing axis of several labels."""
    c = pred.shape[-1]
    lab = label.long()
    extra = lab.dim() > pred.dim() - 1
    p = pred.unsqueeze(-2).expand(*lab.shape, c) if extra else pred
    valid = (lab >= 0) & (lab < c)
    v = p.gather(-1, lab.clamp(0, c - 1).unsqueeze(-1))   # [..., 1]
    before = torch.arange(c, device=pred.device) < lab.unsqueeze(-1)
    nan = torch.isnan(p)
    ahead = (p > v) | (before & (p == v)) | \
        (torch.isnan(v) & (before | ~nan))
    return ahead.sum(-1), valid


class Metric:
    """Base class: ``reset``, ``update``, ``accumulate``, ``name``, and
    ``compute`` (run on the device after the forward)."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label):
        """Optional pre-processing run on the device after the
        forward."""
        return pred, label

    def update_stacked(self, outs, nsteps: int = 1):
        """Fold buffered ``compute`` outputs into the accumulator.

        ``outs`` is a tuple of device tensors; with ``nsteps > 1`` each
        carries a leading per-step dimension. Coercion to the host
        happens here, once for the whole stack; per-step ``update``
        calls keep accumulation identical to updating after every
        step."""
        outs = tuple(_host(o) for o in outs)
        if nsteps == 1:
            self.update(*outs)
            return
        for i in range(nsteps):
            self.update(*(o[i] for o in outs))


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,),
                 name: Optional[str] = None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        super().__init__(name or "acc")
        self.reset()

    def compute(self, pred, label):
        k = max(self.topk)
        if label.dim() == pred.dim():
            # [N, C] one-hot vs [N, 1] index column: only argmax a
            # genuine one-hot
            if label.shape[-1] == pred.shape[-1] and pred.shape[-1] > 1:
                label = torch.argmax(label, dim=-1)
            else:
                label = label[..., 0]
        rank, valid = _label_rank(pred, label)
        # correct[..., j]: the j-th sorted column is the label
        return (torch.arange(k, device=pred.device) == rank.unsqueeze(-1)) \
            & valid.unsqueeze(-1)

    def update(self, correct):
        correct = _host(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            accs.append(float(num))
        self.total = [t + a for t, a in zip(self.total, accs)]
        self.count += int(np.prod(correct.shape[:-1]))
        return [t / max(self.count, 1) for t in self.total]

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name or "precision")
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels)
        pred_pos = np.rint(preds).astype(np.int64).reshape(-1) == 1
        lab = labels.astype(np.int64).reshape(-1) == 1
        self.tp += int((pred_pos & lab).sum())
        self.fp += int((pred_pos & ~lab).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    """Binary recall."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name or "recall")
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels)
        pred_pos = np.rint(preds).astype(np.int64).reshape(-1) == 1
        lab = labels.astype(np.int64).reshape(-1) == 1
        self.tp += int((pred_pos & lab).sum())
        self.fn += int((~pred_pos & lab).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC via threshold buckets."""

    def __init__(self, num_thresholds: int = 4095,
                 name: Optional[str] = None):
        self.num_thresholds = num_thresholds
        super().__init__(name or "auc")
        self.reset()

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.minimum(
            (pos_prob * self.num_thresholds).astype(np.int64),
            self.num_thresholds - 1)
        for b, lab in zip(bins, labels):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        area = 0.0
        for i in range(self.num_thresholds - 1, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            area += n * (tot_pos + p + tot_pos) / 2.0
            tot_pos += p
            tot_neg += n
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return area / (tot_pos * tot_neg)


def accuracy(input, label, k: int = 1):
    """Functional top-k accuracy: the fraction of rows with a label
    among the top-k scores (ties to the lower index), as a float32
    0-dim tensor."""
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device).reshape(
        input.shape[0], -1)
    rank, valid = _label_rank(input, label)
    hit = ((rank < k) & valid).any(dim=-1)
    return hit.to(torch.float32).mean()
