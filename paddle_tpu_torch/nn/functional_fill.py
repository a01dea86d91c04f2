"""The rest of the functional surface (the port's counterpart of
``paddle_tpu/nn/functional_fill.py``): transposed 1-D convolution,
shape utilities, channel dropout in 3-D, randomized ReLU, max pooling
with its argmax mask and the max-unpool family, the margin, triplet,
dice, n-pair, focal, hierarchical-sigmoid, margin-softmax and CTC
losses, the PartialFC class sampler, the beam-search backtrace, block
sparse attention and the inplace-name aliases.

Each function keeps the JAX file's signature, layouts and numbers.
Random draws (``dropout3d``, ``rrelu``, ``class_center_sample``'s seed)
go through JAX's threefry on the key stream (``core.threefry``), so a
seeded draw equals the JAX package's. Masks are flat indices over a
plane's spatial dims, int32 as in the JAX package. The ``*_``
activations return a new tensor, as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import rng as _rng
from ..core import threefry


def _one(v):
    return v if isinstance(v, int) else v[0]


# ---------------------------------------------------------------------------
# conv / shape utilities
# ---------------------------------------------------------------------------

def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """1-D transposed convolution as a width-1 2-D one (weight ``[in,
    out / groups, k]``)."""
    from .functional import conv2d_transpose
    if data_format == "NLC":
        x = x.transpose(1, 2)
    out = conv2d_transpose(
        x[:, :, None, :], weight[:, :, None, :], bias=bias,
        stride=(1, _one(stride)), padding=(0, _one(padding)),
        output_padding=(0, _one(output_padding)),
        dilation=(1, _one(dilation)), groups=groups)[:, :, 0, :]
    if output_size is not None:
        out = out[..., :_one(output_size)]
    if data_format == "NLC":
        out = out.transpose(1, 2)
    return out


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched diagonal embedding: the last dim of ``x`` on the
    ``offset`` diagonal of the planes of dims ``dim1`` and ``dim2``."""
    x = torch.as_tensor(x)
    n = x.shape[-1] + abs(offset)
    out = x.new_zeros(x.shape[:-1] + (n, n))
    idx = torch.arange(x.shape[-1], device=x.device)
    out[..., idx + max(-offset, 0), idx + max(offset, 0)] = x
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    perm = [i for i in range(nd) if i not in (nd - 2, nd - 1)]
    order = sorted([d1, d2])
    perm.insert(order[0], nd - 2 if d1 < d2 else nd - 1)
    perm.insert(order[1], nd - 1 if d1 < d2 else nd - 2)
    if perm == list(range(nd)):
        return out
    return out.permute(*np.argsort(perm).tolist())


def zeropad2d(x, padding, data_format="NCHW", name=None):
    left, right, top, bottom = (padding if not isinstance(padding, int)
                                else (padding,) * 4)
    if data_format == "NHWC":
        return TF.pad(x, (0, 0, left, right, top, bottom))
    return TF.pad(x, (left, right, top, bottom))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n] W[o] x2[n]`` (+ bias)."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Channel-wise 3-D dropout: whole ``[D, H, W]`` features drop, one
    keep draw per (sample, channel) on ``rng.next_key()``, with the JAX
    package's masks; kept features are scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return x
    from .functional import _keep_divisor
    keep = 1.0 - p
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    ch = 1 if data_format == "NCDHW" else x.dim() - 1
    shape[ch] = x.shape[ch]
    mask = threefry.uniform(_rng.next_key(), tuple(shape), device=x.device,
                            rows=_rng.mask_rows(tuple(shape))) < keep
    return torch.where(mask, x / _keep_divisor(keep, x), 0.0).to(x.dtype)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True,
          name=None):
    """Randomized leaky ReLU: slopes drawn from ``uniform(next_key(),
    [lower, upper))`` under threefry when training, their mean in
    eval."""
    if training:
        a = threefry.uniform(_rng.next_key(), x.shape, lower, upper,
                             device=x.device).to(x.dtype)
    else:
        a = (lower + upper) / 2.0
    return torch.where(x >= 0, x, a * x)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    if isinstance(output_size, int):
        output_size = (output_size,) * 3
    n, c, d, h, w = x.shape
    od, oh, ow = output_size
    if d % od or h % oh or w % ow:
        raise ValueError("adaptive_max_pool3d needs divisible sizes")
    if return_mask:
        raise NotImplementedError(
            "return_mask for adaptive 3d pooling is not supported; "
            "use max_pool3d(..., return_mask=True)")
    r = x.reshape(n, c, od, d // od, oh, h // oh, ow, w // ow)
    return r.amax(dim=(3, 5, 7))


# ---------------------------------------------------------------------------
# max-pool argmax masks and the max-unpool family
# ---------------------------------------------------------------------------

def max_pool_with_mask(x, kernel, stride, padding):
    """``(pooled, mask)`` for NC* layouts of any spatial rank. The mask
    holds, per (N, C) plane, the flat index over the input's spatial
    dims of each window's first maximum (in the window's row-major
    order), what ``max_unpoolNd`` consumes. Padding takes the dtype's
    lowest finite value, so a padded cell never wins."""
    nd = len(kernel)
    spatial = x.shape[2:]
    lowest = torch.finfo(x.dtype).min if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    flat_pad = [int(p) for p in reversed(padding) for _ in range(2)]
    xp = TF.pad(x, flat_pad, value=lowest) if any(padding) else x
    win = xp
    for i in range(nd):
        win = win.unfold(2 + i, int(kernel[i]), int(stride[i]))
    out_sp = win.shape[2:2 + nd]
    win = win.reshape(win.shape[:2 + nd] + (-1,))
    vals, local = win.amax(dim=-1), win.argmax(dim=-1)
    # window offset -> per-dim offsets -> input coordinates -> flat index
    local = local.to(torch.int32)
    coords, rem = [], local
    for i in range(nd - 1, -1, -1):
        coords.append(rem % int(kernel[i]))
        rem = torch.div(rem, int(kernel[i]), rounding_mode="floor")
    coords = coords[::-1]
    flat = torch.zeros_like(local)
    for i in range(nd):
        grid = torch.arange(out_sp[i], dtype=torch.int32,
                            device=x.device) * int(stride[i]) - \
            int(padding[i])
        shape = [1] * (2 + nd)
        shape[2 + i] = out_sp[i]
        flat = flat * int(spatial[i]) + coords[i] + grid.reshape(shape)
    return vals, flat


def _unpool(x, indices, spatial_out):
    """Pooled values scattered back at their flat argmax positions per
    (N, C) plane. Where overlapping windows share a position, the last
    window's value is the one written (as XLA's scatter does; the values
    are equal) and only it takes the gradient."""
    n, c = x.shape[:2]
    vals = x.reshape(n, c, -1)
    idx = torch.as_tensor(indices, device=x.device).reshape(n, c, -1) \
        .to(torch.int64)
    size = math.prod(spatial_out)
    pos = torch.arange(idx.shape[-1], device=x.device).expand_as(idx)
    last = torch.full((n, c, size), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(
                          2, idx, pos, "amax", include_self=True)
    keep = last.gather(2, idx) == pos
    out = x.new_zeros((n, c, size)).scatter_add(
        2, idx, torch.where(keep, vals, torch.zeros_like(vals)))
    return out.reshape((n, c) + tuple(int(s) for s in spatial_out))


def _unpool_out_size(in_sz, kernel, stride, padding):
    return (in_sz - 1) * stride - 2 * padding + kernel


def _unpool_nd(x, indices, nd, kernel_size, stride, padding, output_size):
    from .functional import _norm_tuple
    kernel_size = _norm_tuple(kernel_size, nd)
    stride = _norm_tuple(stride or kernel_size, nd)
    padding = _norm_tuple(padding, nd)
    if output_size is None:
        size = tuple(_unpool_out_size(s, k, st, p) for s, k, st, p in
                     zip(x.shape[-nd:], kernel_size, stride, padding))
    else:
        size = tuple(output_size)[-nd:]
    return _unpool(x, indices, size)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCL", name=None):
    return _unpool_nd(x, indices, 1, kernel_size, stride, padding,
                      output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    return _unpool_nd(x, indices, 2, kernel_size, stride, padding,
                      output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCDHW", name=None):
    return _unpool_nd(x, indices, 3, kernel_size, stride, padding,
                      output_size)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2, dim=-1)
        + 1e-12)
    loss = torch.where(label == 1, 1.0 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0,
                        reduction="mean", name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    loss = -(label * TF.logsigmoid(input)
             + (1 - label) * TF.logsigmoid(-input))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss.mean(dim=-1), reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(u, v):
        return ((torch.abs(u - v) + epsilon) ** p).sum(-1) ** (1.0 / p)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None,
                                      margin=1.0, swap=False,
                                      reduction="mean", name=None):
    d = distance_function or (
        lambda u, v: torch.linalg.norm(u - v, dim=-1))
    d_pos, d_neg = d(input, positive), d(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, d(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the Dice coefficient over the last (class probability) axis:
    input ``[N, ..., C]`` probabilities, label ``[N, ..., 1]`` ids."""
    from .functional import one_hot
    y1 = one_hot(label.squeeze(-1), input.shape[-1], input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * y1).sum(red)
    union = input.sum(red) + y1.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """N-pair loss: softmax cross-entropy over ``anchor positive^T``
    with same-label targets, plus L2 on the embeddings."""
    y = labels.reshape(-1)
    sim = anchor @ positive.T
    tgt = (y[:, None] == y[None, :]).to(anchor.dtype)
    tgt = tgt / tgt.sum(-1, keepdim=True)
    ce = (-tgt * torch.log_softmax(sim, dim=-1)).sum(-1).mean()
    reg = l2_reg * ((anchor * anchor).sum(-1)
                    + (positive * positive).sum(-1)).mean() / 2.0
    return ce + reg


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25,
                       gamma=2.0, reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = -(label * TF.logsigmoid(logit)
           + (1 - label) * TF.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree (or
    the given path tables and codes): a binary cross-entropy per node on
    the root-to-leaf path, summed, then the batch mean."""
    x = input
    y = label.reshape(-1)
    code_len = int(math.ceil(math.log2(max(num_classes, 2))))
    if path_table is not None:
        table = torch.as_tensor(path_table, device=x.device)
        codes = torch.as_tensor(path_code, device=x.device).to(x.dtype)
        mask = (table >= 0).to(x.dtype)
        table = torch.clamp(table, min=0)
    else:
        # the complete tree: internal node ids along the root-to-leaf path
        cur = y + num_classes          # the leaf's position in the heap
        steps, code = [], []
        for _ in range(code_len):
            code.append((cur % 2).to(x.dtype))
            cur = torch.div(cur, 2, rounding_mode="floor")
            steps.append(cur)
        table = torch.stack(steps[::-1], dim=1) - 1
        codes = torch.stack(code[::-1], dim=1)
        mask = ((table >= 0) & (table < weight.shape[0])).to(x.dtype)
        table = torch.clamp(table, 0, weight.shape[0] - 1)
    table = table.to(torch.int64)
    logits = torch.einsum("bd,bkd->bk", x, weight[table])
    if bias is not None:
        logits = logits + bias.reshape(-1)[table]
    ce = -(codes * TF.logsigmoid(logits)
           + (1 - codes) * TF.logsigmoid(-logits))
    return (ce * mask).sum(-1, keepdim=True).mean()


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean",
                         name=None):
    """ArcFace-family margin softmax: ``cos(m1 theta + m2) - m3`` on the
    target logit, all logits scaled by ``scale``."""
    from .functional import one_hot
    y = label.reshape(-1)
    cos = torch.clamp(logits, -1.0, 1.0)
    theta = torch.arccos(cos)
    tgt = one_hot(y, logits.shape[-1], logits.dtype)
    adj = torch.cos(margin1 * theta + margin2) - margin3
    out = scale * torch.where(tgt > 0, adj, cos)
    logp = torch.log_softmax(out, dim=-1)
    loss = _reduce(-(tgt * logp).sum(-1), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's sampler: the labels' classes and random other classes
    up to ``num_samples``, sorted, and the labels remapped into them.
    Host-side numpy sampling seeded by a threefry ``randint`` on
    ``rng.next_key()``, as in the JAX package."""
    y = np.asarray(torch.as_tensor(label).cpu()).reshape(-1)
    pos = np.unique(y)
    n_extra = max(0, num_samples - len(pos))
    rest = np.setdiff1d(np.arange(num_classes), pos)
    host_seed = int(threefry.randint(_rng.next_key(), (), 0, 2 ** 31 - 1))
    rs = np.random.RandomState(host_seed)
    neg = rs.choice(rest, size=min(n_extra, len(rest)), replace=False)
    sampled = np.sort(np.concatenate([pos, neg]))
    remap = {c: i for i, c in enumerate(sampled.tolist())}
    new_y = np.asarray([remap[int(v)] for v in y], y.dtype)
    return torch.from_numpy(new_y), torch.from_numpy(sampled)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Connectionist temporal classification by the log-domain forward
    algorithm over time. ``log_probs`` ``[T, N, C]`` are logits: the
    softmax is applied inside, as in the reference."""
    lp = torch.log_softmax(torch.as_tensor(log_probs).float(), -1)
    dev = lp.device
    labels = torch.as_tensor(labels, device=dev).to(torch.int64)
    t_max, n, _ = lp.shape
    s_max = labels.shape[1]
    ext_len = 2 * s_max + 1
    ext = torch.full((n, ext_len), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    in_len = torch.as_tensor(input_lengths, device=dev).reshape(-1)
    lab_len = torch.as_tensor(label_lengths, device=dev).reshape(-1)
    ext_valid = 2 * lab_len + 1
    neg_inf = -1e30
    rows = torch.arange(n, device=dev)
    alpha = torch.full((n, ext_len), neg_inf, device=dev)
    alpha[:, 0] = lp[0, rows, ext[:, 0]]
    if s_max > 0:
        alpha[:, 1] = lp[0, rows, ext[:, 1]]
    same_as_prev2 = torch.cat(
        [torch.ones((n, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    fill1 = torch.full((n, 1), neg_inf, device=dev)
    fill2 = torch.full((n, 2), neg_inf, device=dev)
    for t in range(1, t_max):
        a_shift1 = torch.cat([fill1, alpha[:, :-1]], dim=1)
        a_shift2 = torch.cat([fill2, alpha[:, :-2]], dim=1)
        a_shift2 = torch.where(same_as_prev2, neg_inf, a_shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, a_shift1), a_shift2)
        new = merged + torch.gather(lp[t], 1, ext)
        # frozen past each sample's input length
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = alpha[rows, torch.clamp(ext_valid - 1, min=0)]
    last2 = torch.where(ext_valid >= 2,
                        alpha[rows, torch.clamp(ext_valid - 2, min=0)],
                        neg_inf)
    loss = -torch.logaddexp(last, last2)
    if norm_by_times:
        loss = loss / torch.clamp(in_len, min=1).to(loss.dtype)
    if reduction == "mean":
        # each sample divided by its label length, then the mean
        return (loss / torch.clamp(lab_len, min=1)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def gather_tree(ids, parents):
    """Beam-search backtrace: walk the parent pointers from the last
    step and emit the realigned token ids (``[T, B, K]``)."""
    ids, parents = torch.as_tensor(ids), torch.as_tensor(parents)
    beam = torch.arange(ids.shape[-1], device=ids.device).expand(
        ids.shape[1:])
    toks = []
    for t in range(ids.shape[0] - 1, -1, -1):
        toks.append(torch.gather(ids[t], -1, beam))
        beam = torch.gather(parents[t], -1, beam).to(torch.int64)
    return torch.stack(toks[::-1])


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Block-sparse attention evaluated as masked dense attention
    (``[b, h, s, d]``; the CSR pattern per (b, h))."""
    q, k, v = query, key, value
    offs = torch.as_tensor(sparse_csr_offset, device=q.device)
    cols = torch.as_tensor(sparse_csr_columns, device=q.device) \
        .to(torch.int64)
    b, h, s, d = q.shape
    scores = q @ k.transpose(-1, -2) / math.sqrt(d)
    # nonzero j belongs to row r iff offs[r] <= j < offs[r + 1]
    j = torch.arange(cols.shape[-1], device=q.device)
    starts = offs[..., None, :-1]
    ends = offs[..., None, 1:]
    hits = (j[:, None] >= starts) & (j[:, None] < ends)
    rows = torch.argmax(hits.to(torch.int8), dim=-1)
    mask = torch.zeros((b, h, s, s), dtype=torch.bool, device=q.device)
    bi = torch.arange(b, device=q.device)[:, None, None]
    hi = torch.arange(h, device=q.device)[None, :, None]
    mask[bi, hi, rows, cols] = True
    scores = torch.where(mask, scores, -1e30)
    if key_padding_mask is not None:
        kp = torch.as_tensor(key_padding_mask, device=q.device)[
            :, None, None, :]
        scores = torch.where(kp > 0, scores, -1e30)
    if attn_mask is not None:
        scores = scores + attn_mask
    p = torch.softmax(scores, dim=-1)
    return torch.where(mask, p, 0.0) @ v


# -- the inplace-name aliases (functional: they return) ----------------------

def relu_(x, name=None):
    return torch.relu(x)


def elu_(x, alpha=1.0, name=None):
    return TF.elu(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtype)
    return torch.softmax(x, dim=axis)


def tanh_(x, name=None):
    return torch.tanh(x)
