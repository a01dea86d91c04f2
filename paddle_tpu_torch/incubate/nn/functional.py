"""``incubate.nn.functional`` in the port: ``fused_linear``,
``fused_feedforward`` and ``fused_multi_head_attention`` as the same
math the JAX package composes. The attention core goes through
``nn.functional.scaled_dot_product_attention``, so it takes the flash
kernels B1-B3 where the JAX package's rules allow."""

from __future__ import annotations

from typing import Optional

import torch

from ...nn import functional as F


def fused_linear(x, weight, bias=None, transpose_weight: bool = False):
    if transpose_weight:
        weight = weight.transpose(-1, -2)
    return F.linear(x, weight, bias)


fused_matmul_bias = fused_linear


def fused_feedforward(x, linear1_weight, linear2_weight,
                      linear1_bias=None, linear2_bias=None,
                      ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None,
                      dropout1_rate: float = 0.5,
                      dropout2_rate: float = 0.5,
                      activation: str = "relu",
                      ln_epsilon: float = 1e-5,
                      pre_layer_norm: bool = False,
                      training: bool = True):
    """The residual + LayerNorm + MLP block."""
    residual = x
    d = x.shape[-1]
    if pre_layer_norm:
        x = F.layer_norm(x, d, ln1_scale, ln1_bias, ln_epsilon)
    h = F.linear(x, linear1_weight, linear1_bias)
    h = getattr(F, activation)(h)
    h = F.dropout(h, dropout1_rate, training=training)
    h = F.linear(h, linear2_weight, linear2_bias)
    h = F.dropout(h, dropout2_rate, training=training)
    out = residual + h
    if not pre_layer_norm:
        out = F.layer_norm(out, d, ln2_scale, ln2_bias, ln_epsilon)
    return out


def fused_multi_head_attention(x, qkv_weight, linear_weight,
                               pre_layer_norm: bool = False,
                               pre_ln_scale=None, pre_ln_bias=None,
                               ln_scale=None, ln_bias=None,
                               pre_ln_epsilon: float = 1e-5,
                               qkv_bias=None, linear_bias=None,
                               attn_mask=None,
                               dropout_rate: float = 0.5,
                               attn_dropout_rate: float = 0.5,
                               ln_epsilon: float = 1e-5,
                               training: bool = True,
                               num_heads: Optional[int] = None):
    """Self-attention block. ``qkv_weight``: ``[3, heads, head_dim, D]``
    (the reference layout) or ``[D, 3D]`` with ``num_heads``; the
    attention runs through the flash-dispatching SDPA."""
    residual = x
    b, s, d = x.shape
    if pre_layer_norm:
        x = F.layer_norm(x, d, pre_ln_scale, pre_ln_bias,
                         pre_ln_epsilon)
    if qkv_weight.dim() == 4:  # [3, heads, head_dim, D] reference layout
        n_heads = qkv_weight.shape[1]
        hd = qkv_weight.shape[2]
        w = qkv_weight.movedim(3, 0).reshape(d, 3 * n_heads * hd)
        if qkv_bias is not None and qkv_bias.dim() == 3:
            qkv_bias = qkv_bias.reshape(3 * n_heads * hd)  # [3,H,hd]
    else:
        w = qkv_weight
        n_heads = num_heads
        if n_heads is None:
            raise ValueError("num_heads required for 2D qkv_weight")
        hd = d // n_heads
    qkv = F.linear(x, w, qkv_bias)
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    q = q.reshape(b, s, n_heads, hd)
    k = k.reshape(b, s, n_heads, hd)
    v = v.reshape(b, s, n_heads, hd)
    out = F.scaled_dot_product_attention(
        q, k, v, attn_mask=attn_mask, dropout_p=attn_dropout_rate,
        training=training)
    out = F.linear(out.reshape(b, s, d), linear_weight, linear_bias)
    out = F.dropout(out, dropout_rate, training=training)
    out = residual + out
    if not pre_layer_norm:
        out = F.layer_norm(out, d, ln_scale, ln_bias, ln_epsilon)
    return out
