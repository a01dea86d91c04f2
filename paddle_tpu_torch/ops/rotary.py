"""Rotary position embeddings (RoPE), half-split convention
(the port's counterpart of ``paddle_tpu/ops/rotary.py``)."""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def rope_tables(head_dim: int, max_len: int, base: float = 10000.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """float32 cos/sin tables [max_len, head_dim], computed in numpy
    exactly as the JAX package does."""
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2,
                                    dtype=np.float32) / head_dim))
    t = np.arange(max_len, dtype=np.float32)
    freqs = np.outer(t, inv)                        # [L, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)   # [L, D]
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin, position_ids=None):
    """Rotate q/k ([B, S, H, D]) by the table rows at ``position_ids``
    ([B, S], default arange). The tables may be numpy arrays or tensors
    on q's device."""
    s = q.shape[1]
    cos = torch.as_tensor(cos, device=q.device)
    sin = torch.as_tensor(sin, device=q.device)
    if position_ids is None:
        cos_g = cos[None, :s, None, :]
        sin_g = sin[None, :s, None, :]
    else:
        cos_g = cos[position_ids][:, :, None, :]
        sin_g = sin[position_ids][:, :, None, :]
    q_out = q * cos_g + _rotate_half(q) * sin_g
    k_out = k * cos_g + _rotate_half(k) * sin_g
    return q_out.to(q.dtype), k_out.to(k.dtype)
