"""The subset of ``paddle_tpu/nn/functional.py`` that GPT serving uses,
as plain tensor functions with the JAX package's names, arguments and
layouts (``linear`` takes a ``[in, out]`` weight; attention takes
``[batch, seq, heads, head_dim]``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as TF


def gelu(x, approximate: bool = False):
    """Exact erf form by default, as in the JAX package."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def swiglu(x, gate=None):
    """silu(x) * gate, or split the last dim in two when gate is None."""
    if gate is None:
        x, gate = torch.chunk(x, 2, dim=-1)
    return TF.silu(x) * gate


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped [in, out] (Paddle's convention)."""
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight, padding_idx: Optional[int] = None):
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def dropout(x, p: float = 0.5, training: bool = True):
    """Paddle's default "upscale_in_train" dropout."""
    if not training or p == 0.0:
        return x
    return TF.dropout(x, p, training=True)


def _f32_stats(x):
    """Statistics in float32 for half inputs, as the JAX package does."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    y = TF.layer_norm(_f32_stats(x), tuple(normalized_shape),
                      eps=epsilon).to(x.dtype)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    xf = _f32_stats(x)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        y = y * weight
    return y


def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True,
                                 use_flash: bool = True):
    """q, k, v: [batch, seq, heads, head_dim].

    ``use_flash`` selects the flash-attention kernel B1 in the JAX
    package. Until B1 is ported (ROADMAP Queue B), a CUDA tensor with
    ``use_flash=True`` raises rather than quietly filling the kernel's
    place with plain code; CPU tensors run the eager math below."""
    if use_flash and q.is_cuda:
        raise NotImplementedError(
            "flash-attention kernel B1 is not ported yet (ROADMAP Queue "
            "B1); call with use_flash=False")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.shape[2] != k.shape[2]:  # grouped-query: materialize kv repeat
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if is_causal:
        ql, kl = q.shape[1], k.shape[1]
        causal = torch.ones((ql, kl), dtype=torch.bool,
                            device=q.device).tril(kl - ql)
        logits = logits.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        probs = dropout(probs, dropout_p, training=training)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
