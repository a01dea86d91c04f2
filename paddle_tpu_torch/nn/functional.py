"""The subset of ``paddle_tpu/nn/functional.py`` that GPT serving and
training use, as plain tensor functions with the JAX package's names,
arguments and layouts (``linear`` takes a ``[in, out]`` weight;
attention takes ``[batch, seq, heads, head_dim]``). Under
``amp.auto_cast`` the matmul-like ops cast their operands at the same
call sites as in the JAX package."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as TF

from .. import amp
from ..core import flags, rng, threefry


def gelu(x, approximate: bool = False):
    """Exact erf form by default, as in the JAX package."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def swiglu(x, gate=None):
    """silu(x) * gate, or split the last dim in two when gate is None."""
    if gate is None:
        x, gate = torch.chunk(x, 2, dim=-1)
    return TF.silu(x) * gate


def softmax(x, axis: int = -1):
    if amp.op_in_white("softmax"):
        x = x.to(amp.compute_dtype())
    return torch.softmax(x, dim=axis)


def linear(x, weight, bias=None):
    """y = x @ W + b with W shaped [in, out] (Paddle's convention). Under
    amp.auto_cast the matmul runs in the AMP compute dtype; a float32
    bias then promotes the result to float32, as in the JAX package."""
    x, weight = amp.white_cast(x, weight, op="matmul")
    y = torch.matmul(x, weight)
    if bias is not None:
        y = y + bias
    return y


def embedding(ids, weight, padding_idx: Optional[int] = None):
    out = weight[ids]
    if padding_idx is not None:
        out = out * (ids != padding_idx)[..., None].to(out.dtype)
    return out


def dropout(x, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train", rng_name: str = "global"):
    """Dropout with the JAX package's masks: ``uniform(key) < 1 - p``
    under JAX's threefry, on the key ``rng.next_key(rng_name)`` (the
    recipe of ``jax.random.bernoulli``), so that a step under the same
    ``key_guard`` drops the same elements in both packages. As there,
    ``x / keep`` divides by ``keep`` rounded to x's dtype (JAX's weak
    type). The key stays on the host and enters the hash as two ints,
    so a step with dropout copies nothing to the device and does not
    sync. Under ``rng.batch_rows`` (a data-parallel rank) the mask is
    the rank's rows of the global batch's mask, and under
    ``rng.head_slice`` (a tensor-parallel rank's heads) or
    ``rng.seq_slice`` (a sequence-parallel rank's positions) its slice
    of dim 1 of the global mask."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    keep = 1.0 - p
    mask = threefry.uniform(rng.next_key(rng_name), x.shape,
                            device=x.device,
                            rows=rng.mask_rows(x.shape),
                            cols=rng.mask_cols(x.shape)) < keep
    if mode == "upscale_in_train":
        x = x / _keep_divisor(keep, x)
    return torch.where(mask, x, 0.0).to(x.dtype)


def _keep_divisor(keep: float, x):
    """``keep`` rounded to x's dtype (JAX's weak type), as a 0-dim tensor
    filled on x's device: a tensor divisor divides (a host scalar may be
    applied as its reciprocal), and a fill copies nothing to the
    device."""
    return torch.full((), keep, dtype=x.dtype, device=x.device)


def dropout2d(x, p: float = 0.5, training: bool = True,
              data_format: str = "NCHW"):
    """Channel dropout: one keep draw per (sample, channel), on the key
    ``rng.next_key()``, with the JAX package's masks (as :func:`dropout`);
    kept channels are scaled by ``1 / (1 - p)``."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    shape = (x.shape[0], x.shape[1], 1, 1) if data_format == "NCHW" else \
        (x.shape[0], 1, 1, x.shape[3])
    mask = threefry.uniform(rng.next_key(), shape, device=x.device,
                            rows=rng.mask_rows(shape)) < keep
    x = x / _keep_divisor(keep, x)
    return torch.where(mask, x, 0.0).to(x.dtype)


def _f32_stats(x):
    """Statistics in float32 for half inputs, as the JAX package does."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """float32 statistics for half inputs, unless the user
    custom_white_listed layer_norm, which forces the compute dtype."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    if amp.op_in_white("layer_norm"):
        x = xf = x.to(amp.compute_dtype())
    else:
        xf = _f32_stats(x)
    y = TF.layer_norm(xf, tuple(normalized_shape), eps=epsilon).to(x.dtype)
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


def label_smooth(label, epsilon: float = 0.1):
    k = label.shape[-1]
    return (1 - epsilon) * label + epsilon / k


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unknown reduction {reduction!r}")


def cross_entropy(logits, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, label_smoothing: float = 0.0):
    """Paddle's cross_entropy, accumulated in float32 whatever the input
    dtype. Hard labels take the streaming logsumexp form; rows labelled
    ``ignore_index`` are zero and leave the mean's denominator (with
    ``weight``, the denominator is the weight of the valid rows)."""
    if soft_label:
        logp = torch.log_softmax(logits.float(), dim=axis)
        tgt = label.float()
        if label_smoothing:
            tgt = label_smooth(tgt, label_smoothing)
        return _reduce(-(tgt * logp).sum(dim=axis), reduction)
    xf = logits.float()
    label = label.long()
    if label.dim() == xf.dim():  # [..., 1] index form
        label = label.squeeze(axis)
    safe = torch.where(label == ignore_index, torch.zeros_like(label), label)
    m = xf.amax(dim=axis, keepdim=True).detach()
    lse = m.squeeze(axis) + torch.log(torch.exp(xf - m).sum(dim=axis))
    picked = xf.gather(axis, safe.unsqueeze(axis)).squeeze(axis) - lse
    if label_smoothing:
        # mean(log_softmax) == mean(x) - lse
        picked = (1 - label_smoothing) * picked + \
            label_smoothing * (xf.mean(dim=axis) - lse)
    valid = label != ignore_index
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if weight is not None:
        loss = loss * weight[safe]
    if reduction == "mean":
        if weight is not None:
            denom = torch.clamp((weight[safe] * valid).sum(), min=1e-8)
        else:
            denom = torch.clamp(valid.sum(), min=1)
        return loss.sum() / denom
    return _reduce(loss, reduction)


softmax_with_cross_entropy = cross_entropy


def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 scale: Optional[float] = None,
                                 training: bool = True,
                                 use_flash: bool = True):
    """q, k, v: [batch, seq, heads, head_dim].

    Dispatches to the flash kernels (``ops.flash_attention``) exactly
    where the JAX package does: ``use_flash``, the ``flash_attention``
    flag, and a configuration ``flash_attention_available`` admits;
    otherwise it runs the eager math below, on any device."""
    q, k, v = amp.white_cast(q, k, v, op="attention")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_flash and flags.get_flag("flash_attention"):
        from ..ops.flash_attention import (flash_attention,
                                           flash_attention_available)
        if flash_attention_available(q.shape, k.shape, attn_mask,
                                     dropout_p, training,
                                     is_causal=is_causal):
            return flash_attention(q, k, v, causal=is_causal,
                                   sm_scale=scale)
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
