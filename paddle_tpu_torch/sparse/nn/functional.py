"""Sparse-pattern attention (the port's counterpart of
``paddle_tpu/sparse/nn/functional.py``): SDDMM → sparse softmax → SpMM
at a fixed sparsity pattern, on gathers and segment reductions over the
pattern's coordinate lists."""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import SparseCooTensor, coalesce, segment_softmax


def attention(query, key, value, sparse_mask: SparseCooTensor,
              scaling: Optional[float] = None):
    """Attention restricted to ``sparse_mask``'s nonzero pattern.

    query/key/value: ``[batch, heads, seq, head_dim]``; ``sparse_mask``:
    a 2-D ``[seq, seq]`` SparseCooTensor whose PATTERN selects the
    attendable (q_pos, k_pos) pairs, shared across batch and heads.
    Returns ``[batch, heads, seq, head_dim]``; rows with no admitted key
    return zeros."""
    b, h, s, d = query.shape
    sp = coalesce(sparse_mask)
    if sp.shape != (s, s):
        raise ValueError(
            f"sparse_mask shape {sp.shape} != [seq, seq] = {(s, s)}")
    rows, cols = sp.indices()[0], sp.indices()[1]
    scale = scaling if scaling is not None else 1.0 / math.sqrt(d)
    q = query.reshape(b * h, s, d)
    k = key.reshape(b * h, s, d)
    v = value.reshape(b * h, s, d)
    # SDDMM: logits only at the pattern's coordinates
    logits = (q[:, rows, :] * k[:, cols, :]).sum(-1) * scale   # [bh, nnz]
    p = segment_softmax(logits, rows, s)                         # [bh, nnz]
    out = torch.zeros(b * h, s, d, dtype=p.dtype, device=p.device)
    out = out.index_add(1, rows, p[:, :, None] * v[:, cols, :])
    return out.reshape(b, h, s, d)
