"""Fused linear + cross-entropy: the LM vocab path without the
``[tokens, vocab]`` logits (the port's counterpart of
``paddle_tpu/ops/fused_xent.py``).

The head product and the loss are one streaming computation over vocab
chunks, an online logsumexp: per chunk, ``logits_c = h @ W_c^T`` (f32,
``[T, chunk]``), the running max and sum of exponentials, and the label
logits that fall in the chunk. The backward replays the chunks, forms
each chunk's softmax gradient and contracts it at once into dh and
dW_c. Peak memory is ``[T, chunk]`` instead of ``[T, V]``.

Dtypes follow the JAX package: the chunk products take the operands in
the activation's dtype (the weight is cast to it) and give float32
results; the softmax statistics are float32; the backward casts each
chunk's float32 gradient to the weight's compute dtype and contracts it
with float32 results. A float32 result from half operands is taken
without rounding: ``torch.mm(..., out_dtype=torch.float32)`` on the
card, exactly upcast operands on the CPU. This is not a Pallas kernel in
the JAX package (a ``lax.scan``), so its products are library matmuls.

Vocab-parallel form (``tp``: a tensor-parallel head, the weight this
rank's vocab slice ``[V / tp, H]``): each rank streams its slice in
chunks as above; the row max and the sum of exponentials are then
reduced over the tp ranks (the sum rescaled to the global max), and the
label's logit comes from the rank whose slice holds it. The backward
forms each chunk's gradient against the global logsumexp; dW is the
slice's own and dh is summed over the tp ranks. No rank holds more
than ``[T, chunk]`` logits.
"""

from __future__ import annotations

from typing import Optional

import torch

_HALF = (torch.bfloat16, torch.float16)


def _pick_chunk(v: int, target: int = 8192) -> int:
    return min(target, v)


def _mm_f32(a, b):
    """a @ b with a float32 result, never rounded to the operands'
    dtype."""
    if a.dtype in _HALF:
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b)


def _chunk_rows(x, chunk: int):
    """[V, ...] zero-padded to a multiple of ``chunk`` rows and split
    into chunks of that many rows; pad rows are masked out of the
    statistics by the caller."""
    pad = (-x.shape[0]) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x.split(chunk)


def _chunk_logits(hidden, w_c, b_c, off: int, v: int):
    logits = _mm_f32(hidden, w_c.t())                  # [T, C] f32
    if b_c is not None:
        logits = logits + b_c[None, :]
    cols = off + torch.arange(w_c.shape[0], device=hidden.device)
    return logits.masked_fill((cols >= v)[None, :], float("-inf"))


def _local_labels(labels, off: int, c: int):
    local = labels - off
    inside = (local >= 0) & (local < c)
    return torch.clamp(local, 0, c - 1), inside


class _FusedLinearCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, hidden, weight, labels, bias, ignore_index, chunk,
                tp=None):
        t = hidden.shape[0]
        v = weight.shape[0]
        w = weight if weight.dtype == hidden.dtype else \
            weight.to(hidden.dtype)
        c = chunk or _pick_chunk(v)
        bias_c = None if bias is None else \
            _chunk_rows(bias.float(), c)
        labels = labels.long()
        valid = labels != ignore_index
        if tp is not None:
            # this rank's vocab slice starts at index*v; a label of
            # another rank's slice matches no column here (not even the
            # last chunk's pad columns)
            labels = labels - tp.index * v
            labels = torch.where((labels >= 0) & (labels < v), labels, -1)
        m = torch.full((t,), float("-inf"), device=hidden.device)
        l = torch.zeros((t,), device=hidden.device)
        picked = torch.zeros((t,), device=hidden.device)
        for i, w_c in enumerate(_chunk_rows(w, c)):
            off = i * c
            logits = _chunk_logits(hidden, w_c, None if bias_c is None
                                   else bias_c[i], off, v)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            l = l * torch.exp(m - m_new) + \
                torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            col, inside = _local_labels(labels, off, c)
            picked = picked + torch.where(
                inside, logits.gather(1, col[:, None])[:, 0],
                torch.zeros_like(picked))
        if tp is not None:
            import torch.distributed as dist
            from ..parallel.collective import all_reduce_
            m_all = all_reduce_(m.clone(), tp.group, dist.ReduceOp.MAX)
            l = all_reduce_(l * torch.exp(m - m_all), tp.group)
            picked = all_reduce_(picked, tp.group)
            m = m_all
        lse = m + torch.log(l)
        per_tok = torch.where(valid, lse - picked, torch.zeros_like(lse))
        n = torch.clamp(valid.sum(), min=1)
        ctx.save_for_backward(hidden, weight, labels, bias, lse, valid, n)
        ctx.chunk = c
        ctx.tp = tp
        return per_tok.sum() / n

    @staticmethod
    def backward(ctx, g):
        hidden, weight, labels, bias, lse, valid, n = ctx.saved_tensors
        t, h = hidden.shape
        v = weight.shape[0]
        c = ctx.chunk
        w = weight if weight.dtype == hidden.dtype else \
            weight.to(hidden.dtype)
        bias_c = None if bias is None else _chunk_rows(bias.float(), c)
        # d(loss)/d(logits) = (softmax - onehot) * g / n, 0 on ignored rows
        scale = (valid.float() * g / n).float()
        h_w = hidden.to(w.dtype)
        dh = torch.zeros((t, h), dtype=torch.float32, device=hidden.device)
        dw_chunks, db_chunks = [], []
        for i, w_c in enumerate(_chunk_rows(w, c)):
            off = i * c
            logits = _chunk_logits(hidden, w_c, None if bias_c is None
                                   else bias_c[i], off, v)
            p = torch.exp(logits - lse[:, None])
            col, inside = _local_labels(labels, off, c)
            # the one-hot, by a gather and scatter over every row (rows
            # whose label lies in another chunk subtract 0): indexing by
            # ``inside`` would sync the host on its nonzero count
            col = col[:, None]
            p.scatter_(1, col, p.gather(1, col) - inside[:, None].float())
            dlog_f = p * scale[:, None]                         # [T, C]
            if bias is not None:
                db_chunks.append(dlog_f.sum(dim=0))
            dlog = dlog_f.to(w.dtype)
            dh = dh + _mm_f32(dlog, w_c)                        # [T, H]
            dw_chunks.append(_mm_f32(dlog.t(), h_w))            # [C, H]
        dw = torch.cat(dw_chunks)[:v].to(weight.dtype)
        dbias = None if bias is None else \
            torch.cat(db_chunks)[:v].to(bias.dtype)
        if ctx.tp is not None:
            from ..parallel.collective import all_reduce_
            all_reduce_(dh, ctx.tp.group)
        return dh.to(hidden.dtype), dw, None, dbias, None, None, None


def fused_linear_cross_entropy(hidden, weight, labels,
                               ignore_index: int = -100,
                               chunk: Optional[int] = None, bias=None,
                               tp=None):
    """Mean cross-entropy of ``softmax(hidden @ weight.T + bias)``
    against ``labels`` without materialising the logits.

    hidden: [T, H] (callers flatten batch/seq); weight: [V, H] (the
    tied-embedding layout); labels: [T] int; bias: optional [V] logits
    bias. ``ignore_index`` rows leave the mean. ``chunk`` (default
    min(8192, V)) need not divide V: the last chunk is zero-padded and
    its pad columns are masked to -inf. ``tp`` (a
    ``parallel.collective.TPGroup``): ``weight`` (and ``bias``) are this
    rank's vocab slice of the tp ranks' equal slices, ``labels`` global
    ids; the loss is the whole vocab's, on every rank."""
    return _FusedLinearCrossEntropy.apply(hidden, weight, labels, bias,
                                          ignore_index, chunk, tp)
