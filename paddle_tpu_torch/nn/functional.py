"""The port's counterpart of ``paddle_tpu/nn/functional.py``: the
functional op library as plain tensor functions, with the JAX package's
names, arguments and layouts (``linear`` takes a ``[in, out]`` weight;
attention takes ``[batch, seq, heads, head_dim]``; convolutions take
``[out, in / groups, *k]`` weights and a ``data_format``). Under
``amp.auto_cast`` the matmul-like ops cast their operands at the same
call sites as in the JAX package. Random draws (dropout, Gumbel noise,
alpha dropout) use JAX's threefry on the key stream
(``core.threefry``), so that a seeded draw equals the JAX package's.
The rest of the surface comes from ``functional_fill`` (star-imported
at the end, as the JAX package does)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as TF

from .. import amp
from ..core import flags, rng, threefry

# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def sigmoid(x):
    return torch.sigmoid(x)


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def silu(x):
    return TF.silu(x)


swish = silu


def elu(x, alpha: float = 1.0):
    return TF.elu(x, alpha)


def selu(x):
    return TF.selu(x)


def glu(x, axis: int = -1):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate: bool = False):
    """Exact erf form by default, as in the JAX package."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def gelu_tanh(x):
    """The tanh approximation (HF gpt2's "gelu_new")."""
    return TF.gelu(x, approximate="tanh")


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def hardtanh(x, min=-1.0, max=1.0):  # noqa: A002 — the JAX names
    return torch.clamp(x, min, max)


def hardsigmoid(x, slope: float = 1 / 6, offset: float = 0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def mish(x):
    return x * torch.tanh(softplus(x))


def softsign(x):
    return x / (1 + torch.abs(x))


def tanhshrink(x):
    return x - torch.tanh(x)


def softshrink(x, threshold: float = 0.5):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardshrink(x, threshold: float = 0.5):
    return torch.where(torch.abs(x) > threshold, x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def prelu(x, weight, data_format: str = "NCHW"):
    """A weight of length C applies along the channel axis (1 for NC*,
    last for N*C), as in the JAX package."""
    w = torch.as_tensor(weight, device=x.device)
    if w.numel() > 1 and x.dim() > 1:
        axis = 1 if data_format.startswith("NC") else x.dim() - 1
        shape = [1] * x.dim()
        shape[axis] = w.numel()
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def softmax(x, axis: int = -1):
    if amp.op_in_white("softmax"):
        x = x.to(amp.compute_dtype())
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature: float = 1.0, hard: bool = False,
                   axis: int = -1):
    """Softmax of ``(x + g) / temperature`` with Gumbel noise ``g`` drawn
    from ``uniform(next_key(), [1e-20, 1))`` under threefry, as in the
    JAX package; ``hard`` takes the one-hot argmax forward and the soft
    gradient backward (straight-through)."""
    u = threefry.uniform(rng.next_key(), x.shape, minval=1e-20, maxval=1.0,
                         device=x.device).to(x.dtype)
    g = -torch.log(-torch.log(u + 1e-20))
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (y_hard - y).detach() + y
    return y


def log_sigmoid(x):
    """The stable ``-softplus(-x)`` form."""
    return -softplus(-x)


def swiglu(x, gate=None):
    """silu(x) * gate, or split the last dim in two when gate is None."""
    if gate is None:
        x, gate = torch.chunk(x, 2, dim=-1)
    return TF.silu(x) * gate


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------

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


def one_hot(x, num_classes: int, dtype=torch.float32):
    """``jax.nn.one_hot``: an id outside ``[0, num_classes)`` gives a
    row of zeros."""
    x = torch.as_tensor(x)
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(dtype)


def label_smooth(label, epsilon: float = 0.1):
    k = label.shape[-1]
    return (1 - epsilon) * label + epsilon / k


# ---------------------------------------------------------------------------
# Convolutions: weights [out, in / groups, *k] (transposed: [in, out /
# groups, *k]), torch's own layouts
# ---------------------------------------------------------------------------

_CHANNELS_LAST = ("NHWC", "NDHWC", "NLC", "NWC")


def _norm_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) == 1:
        return v * n
    return v


def _to_channels_first(x, channels_last: bool):
    return x.movedim(-1, 1) if channels_last else x


def _from_channels_first(x, channels_last: bool):
    return x.movedim(1, -1) if channels_last else x


def _same_pads(in_sizes, k, stride, dilation):
    """XLA's "SAME" padding: (low, high) of each spatial dim, the odd
    element high."""
    pads = []
    for n, ki, s, d in zip(in_sizes, k, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (ki - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def conv_nd(x, weight, bias=None, stride=1, padding=0, dilation=1,
            groups: int = 1, data_format: str = "NCHW",
            preferred_element_type=None):
    """N-d convolution of ``x`` (``[N, C, *spatial]``, or channels last
    for ``NHWC`` / ``NDHWC`` / ``NLC`` / ``NWC``). ``padding`` is an int
    or tuple (symmetric) or ``"SAME"`` / ``"VALID"``. Integer operands
    (quantized serving) accumulate exactly, in float64 here, and return
    ``preferred_element_type``."""
    x, weight = amp.white_cast(x, weight, op="conv2d")
    ndim = x.dim() - 2
    stride = _norm_tuple(stride, ndim)
    dilation = _norm_tuple(dilation, ndim)
    channels_last = data_format in _CHANNELS_LAST
    xc = _to_channels_first(x, channels_last)
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pads = _same_pads(xc.shape[2:], weight.shape[2:], stride,
                              dilation)
            flat = [p for lo_hi in reversed(pads) for p in lo_hi]
            xc = TF.pad(xc, flat)
        pad = 0
    else:
        pad = _norm_tuple(padding, ndim)
    out_dtype = preferred_element_type
    if not xc.is_floating_point():
        xc, weight = xc.double(), weight.double()
        out_dtype = out_dtype or torch.int32
    elif weight.dtype != xc.dtype:
        dt = torch.promote_types(xc.dtype, weight.dtype)
        xc, weight = xc.to(dt), weight.to(dt)
    out = _CONV[ndim](xc, weight, None, stride, pad, dilation, groups)
    if out_dtype is not None:
        out = out.to(out_dtype)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return _from_channels_first(out, channels_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCL"):
    return conv_nd(x, weight, bias, stride, padding, dilation, groups,
                   "NLC" if data_format == "NLC" else "NCHW")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCHW"):
    return conv_nd(x, weight, bias, stride, padding, dilation, groups,
                   data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NCDHW"):
    return conv_nd(x, weight, bias, stride, padding, dilation, groups,
                   "NDHWC" if data_format == "NDHWC" else "NCHW")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """Transposed convolution of any rank, weight ``[in, out / groups,
    *k]``: out = (in - 1) s - 2 p + d (k - 1) + output_padding + 1."""
    ndim = x.dim() - 2
    channels_last = data_format in ("NHWC", "NDHWC")
    xc = _to_channels_first(x, channels_last)
    out = _CONV_T[ndim](xc, weight, None, _norm_tuple(stride, ndim),
                        _norm_tuple(padding, ndim),
                        _norm_tuple(output_padding, ndim), groups,
                        _norm_tuple(dilation, ndim))
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * ndim)
    return _from_channels_first(out, channels_last)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCDHW"):
    return conv2d_transpose(x, weight, bias, stride, padding,
                            output_padding, dilation, groups,
                            "NDHWC" if data_format == "NDHWC" else "NCDHW")


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG_POOL = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _pool(x, kind, kernel, stride, padding, data_format,
          count_include_pad=True):
    """``lax.reduce_window`` pooling: the window pads with -inf (max) or
    0 (avg); an average divides by the window's size, or by its count
    of unpadded elements without ``count_include_pad``."""
    ndim = x.dim() - 2
    kernel = _norm_tuple(kernel, ndim)
    stride = _norm_tuple(stride if stride is not None else kernel, ndim)
    p = _norm_tuple(padding, ndim)
    channels_last = data_format in ("NHWC", "NDHWC", "NLC")
    xc = _to_channels_first(x, channels_last)
    flat = [pi for pi in reversed(p) for _ in range(2)]
    if kind == "max":
        out = _MAX_POOL[ndim](TF.pad(xc, flat, value=float("-inf")),
                              kernel, stride)
    else:
        out = _AVG_POOL[ndim](TF.pad(xc, flat), kernel, stride)
        if not count_include_pad and any(p):
            ones = TF.pad(torch.ones_like(xc[:1, :1]), flat)
            counts = _AVG_POOL[ndim](ones, kernel, stride)
            out = out / counts
    return _from_channels_first(out, channels_last)


def _pool_with_mask(x, nd, layout, data_format, kernel_size, stride,
                    padding):
    """``(pooled, mask)``: ``functional_fill.max_pool_with_mask`` for the
    channels-first layout only, as in the JAX package."""
    from .functional_fill import max_pool_with_mask
    if data_format != layout:
        raise ValueError(f"return_mask supports {layout} only")
    k = _norm_tuple(kernel_size, nd)
    return max_pool_with_mask(x, k, _norm_tuple(stride or k, nd),
                              _norm_tuple(padding, nd))


def max_pool2d(x, kernel_size, stride=None, padding=0,
               return_mask=False, data_format="NCHW"):
    if return_mask:
        return _pool_with_mask(x, 2, "NCHW", data_format, kernel_size,
                               stride, padding)
    return _pool(x, "max", kernel_size, stride, padding, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0,
               count_include_pad=True, data_format="NCHW"):
    return _pool(x, "avg", kernel_size, stride, padding, data_format,
                 count_include_pad)


def max_pool1d(x, kernel_size, stride=None, padding=0,
               return_mask=False, data_format="NCL"):
    if return_mask:
        return _pool_with_mask(x, 1, "NCL", data_format, kernel_size,
                               stride, padding)
    return _pool(x, "max", kernel_size, stride, padding,
                 "NLC" if data_format == "NLC" else "NCHW")


def avg_pool1d(x, kernel_size, stride=None, padding=0,
               count_include_pad=True, data_format="NCL"):
    return _pool(x, "avg", kernel_size, stride, padding,
                 "NLC" if data_format == "NLC" else "NCHW",
                 count_include_pad)


def max_pool3d(x, kernel_size, stride=None, padding=0,
               return_mask=False, data_format="NCDHW"):
    if return_mask:
        return _pool_with_mask(x, 3, "NCDHW", data_format, kernel_size,
                               stride, padding)
    return _pool(x, "max", kernel_size, stride, padding,
                 "NDHWC" if data_format == "NDHWC" else "NCHW")


def avg_pool3d(x, kernel_size, stride=None, padding=0,
               count_include_pad=True, data_format="NCDHW"):
    return _pool(x, "avg", kernel_size, stride, padding,
                 "NDHWC" if data_format == "NDHWC" else "NCHW",
                 count_include_pad)


def _adaptive_1d(x, output_size, reduce_name):
    n = x.shape[-1]
    if n % output_size:
        raise ValueError(
            f"adaptive 1d pooling needs length {n} divisible by "
            f"output_size {output_size} (the JAX package's static-shape "
            f"rule)")
    xr = x.reshape(*x.shape[:-1], output_size, n // output_size)
    return xr.mean(dim=-1) if reduce_name == "mean" else xr.amax(dim=-1)


def adaptive_avg_pool1d(x, output_size):
    return _adaptive_1d(x, output_size, "mean")


def adaptive_max_pool1d(x, output_size):
    return _adaptive_1d(x, output_size, "max")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    out = _norm_tuple(output_size, 3)
    d, h, w = x.shape[2:5] if data_format == "NCDHW" else x.shape[1:4]
    if d % out[0] or h % out[1] or w % out[2]:
        raise ValueError(
            "adaptive 3d pooling needs divisible spatial dims "
            f"({(d, h, w)} vs {out})")
    k = (d // out[0], h // out[1], w // out[2])
    return avg_pool3d(x, k, k, 0, data_format=data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Divisible sizes pool with equal windows; otherwise bin ``i`` of
    an axis spans ``round(i * n / out)`` to ``round((i + 1) * n / out)``
    (Python's round, half to even), as in the JAX package."""
    out = _norm_tuple(output_size, 2)
    axis_h, axis_w = (2, 3) if data_format == "NCHW" else (1, 2)
    h, w = x.shape[axis_h], x.shape[axis_w]
    if h % out[0] == 0 and w % out[1] == 0:
        k = (h // out[0], w // out[1])
        return avg_pool2d(x, k, k, 0, data_format=data_format)

    def bounds(n, m):
        cuts = [0] + [round(i * n / m) for i in range(1, m)] + [n]
        return list(zip(cuts[:-1], cuts[1:]))

    rows = []
    for h0, h1 in bounds(h, out[0]):
        xr = x.narrow(axis_h, h0, h1 - h0)
        rows.append(torch.stack(
            [xr.narrow(axis_w, w0, w1 - w0).mean(dim=(axis_h, axis_w))
             for w0, w1 in bounds(w, out[1])], dim=-1))
    y = torch.stack(rows, dim=-2)
    return y if data_format == "NCHW" else y.movedim(1, -1)


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    out = _norm_tuple(output_size, 2)
    h, w = (x.shape[2], x.shape[3]) if data_format == "NCHW" else \
        (x.shape[1], x.shape[2])
    if h % out[0] != 0 or w % out[1] != 0:
        raise NotImplementedError("adaptive_max_pool2d needs divisible dims")
    k = (h // out[0], w // out[1])
    return max_pool2d(x, k, k, 0, data_format=data_format)


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


def _channel_axis(x, data_format: str) -> int:
    if x.dim() == 2:
        return 1
    return 1 if data_format.startswith("NC") and x.dim() > 1 else \
        x.dim() - 1


class _SumOverRanks(torch.autograd.Function):
    """Sum over the ranks of ``group`` forward, and of the gradient
    backward: the per-rank share of a statistic of the global batch."""

    @staticmethod
    def forward(ctx, x, group):
        from ..parallel.collective import all_reduce_
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collective import all_reduce_
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def _batch_stats(x, axes, group=None):
    """Per-channel mean and (biased) variance over ``axes`` of the global
    batch, in float64 and rounded to float32. With ``group`` (the data
    ranks, each holding its rows) the count and sum, then the centred
    sum of squares, are summed over the ranks, so every rank gets the
    statistics of the whole batch. float64 makes the float32 result
    independent of the device's summation order."""
    xd = x.double()
    count = math.prod(x.shape[i] for i in axes)
    total = xd.sum(dim=axes)
    if group is not None:
        n = torch.tensor([float(count)], dtype=torch.float64,
                         device=x.device)
        both = _SumOverRanks.apply(torch.cat([total, n]), group)
        total, count = both[:-1], both[-1]
    mean = total / count
    shape = [1] * x.dim()
    shape[[i for i in range(x.dim()) if i not in axes][0]] = -1
    sq = (xd - mean.reshape(shape)).square().sum(dim=axes)
    if group is not None:
        sq = _SumOverRanks.apply(sq, group)
    return mean.float(), (sq / count).float()


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               group=None):
    """Returns ``(y, new_running_mean, new_running_var)`` with Paddle's
    momentum: ``running = momentum * running + (1 - momentum) * batch``
    (the opposite of ``torch.nn.BatchNorm``'s convention). ``group``:
    the process group of the data ranks whose rows make the batch (see
    :func:`_batch_stats`); None for one process."""
    channel_axis = _channel_axis(x, data_format)
    axes = tuple(i for i in range(x.dim()) if i != channel_axis)
    if training:
        mean, var = _batch_stats(x, axes, group)
        new_rm = momentum * running_mean + (1 - momentum) * mean
        new_rv = momentum * running_var + (1 - momentum) * var
    else:
        mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var
    shape = [1] * x.dim()
    shape[channel_axis] = -1
    y = (x - mean.reshape(shape).to(x.dtype)) * torch.rsqrt(
        var.reshape(shape).float() + epsilon).to(x.dtype)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y, new_rm, new_rv


def group_norm(x, num_groups: int, weight=None, bias=None,
               epsilon: float = 1e-5, data_format: str = "NCHW"):
    if data_format != "NCHW":
        raise NotImplementedError
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    xg = xg.float()
    axes = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape) \
        .to(x.dtype)
    shape = [1, c] + [1] * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def instance_norm(x, weight=None, bias=None, epsilon: float = 1e-5):
    return group_norm(x, x.shape[1], weight, bias, epsilon)


def normalize(x, p: float = 2, axis: int = 1, epsilon: float = 1e-12):
    norm = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(norm, min=epsilon)


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


def nll_loss(log_probs, label, weight=None, ignore_index: int = -100,
             reduction: str = "mean"):
    """Classes on the LAST axis (the JAX package's layout); the mean
    divides by the count of rows not ``ignore_index``, with or without
    ``weight``."""
    label = label.long()
    safe = torch.where(label == ignore_index, torch.zeros_like(label), label)
    loss = -log_probs.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    valid = label != ignore_index
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum(), min=1)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction: str = "mean"):  # noqa: A002
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction: str = "mean"):  # noqa: A002
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction: str = "mean",  # noqa: A002
                   delta: float = 1.0):
    diff = torch.abs(input - label)
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None,  # noqa: A002
                         reduction: str = "mean"):
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps)) +
             (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction: str = "mean",
                                     pos_weight=None):
    logit = logit.float()
    max_val = torch.clamp(-logit, min=0)
    soft = torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        log_w = (pos_weight - 1) * label + 1
        loss = (1 - label) * logit + log_w * (soft + max_val)
    else:
        loss = (1 - label) * logit + max_val + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction: str = "mean"):  # noqa: A002
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon: float = 1e-4):  # noqa: A002
    """Elementwise negative log likelihood of a probability input (no
    reduction)."""
    return -(label * torch.log(input + epsilon) +
             (1 - label) * torch.log(1 - input + epsilon))


def cosine_similarity(x1, x2, axis: int = 1, eps: float = 1e-8):
    dot = (x1 * x2).sum(dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n1 * n2, min=eps)


def square_error_cost(input, label):  # noqa: A002
    return (input - label).square()


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


# ---------------------------------------------------------------------------
# Shape / misc
# ---------------------------------------------------------------------------

def _pad_index(n: int, lo: int, hi: int, mode: str, device):
    """Source indices of a dim of length ``n`` padded by ``(lo, hi)``:
    ``reflect`` mirrors without the edge (periodically, as ``jnp.pad``),
    ``replicate`` repeats the edge, ``circular`` wraps."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if mode == "circular":
        return i.remainder(n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = i.remainder(period)
    return torch.where(j < n, j, period - j)


def pad(x, pad: Sequence[int], mode: str = "constant",  # noqa: F811
        value: float = 0.0, data_format: str = "NCHW"):
    """Paddle's pad: ``pad`` lists (before, after) pairs, innermost
    SPATIAL dim first (``(left, right, top, bottom)``); ``data_format``
    says where the spatial dims live."""
    if len(pad) % 2 != 0:
        raise ValueError("pad length must be even")
    n = len(pad) // 2
    pairs = [(pad[2 * i], pad[2 * i + 1]) for i in reversed(range(n))]
    if data_format in _CHANNELS_LAST and n == x.dim() - 2:
        cfg = [(0, 0)] + pairs + [(0, 0)]
    else:
        cfg = [(0, 0)] * (x.dim() - n) + pairs
    if mode == "constant":
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return TF.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise KeyError(mode)
    for dim, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                               x.device))
    return x


def pad3d(x, paddings, mode: str = "constant", value: float = 0.0,
          data_format: str = "NCDHW"):
    """5-D pad; ``paddings``: 6 ints, innermost first (w_before, w_after,
    h_before, h_after, d_before, d_after)."""
    if x.dim() != 5:
        raise ValueError(f"pad3d expects a 5-D tensor, got {x.dim()}-D")
    return pad(x, list(paddings), mode=mode, value=value,
               data_format=data_format)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """im2col: ``[N, C * kh * kw, L]``, channel-major."""
    return TF.unfold(x, _norm_tuple(kernel_sizes, 2),
                     _norm_tuple(dilations, 2), _norm_tuple(paddings, 2),
                     _norm_tuple(strides, 2))


def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace`` in float32: ``start (1 - t) + stop t`` for ``t =
    i / (num - 1)``, the last point exactly ``stop``."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=device) / div
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.tensor([stop], dtype=torch.float32,
                                        device=device)])


def _interp_axis_align_corners(x, out_len: int, axis: int):
    """Linear resize along ``axis``: output i samples input coordinate
    ``i (in - 1) / (out - 1)``."""
    in_len = x.shape[axis]
    if out_len == 1 or in_len == 1:
        idx = torch.zeros(out_len, dtype=torch.long, device=x.device)
        return x.index_select(axis, idx)
    coords = _linspace(0.0, float(in_len - 1), out_len, x.device)
    lo = torch.floor(coords).long()
    hi = torch.clamp(lo + 1, max=in_len - 1)
    shape = [1] * x.dim()
    shape[axis] = out_len
    frac = (coords - lo).to(x.dtype).reshape(shape)
    return x.index_select(axis, lo) * (1 - frac) + \
        x.index_select(axis, hi) * frac


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., torch.zeros_like(out), out)


def _resize_weights(in_len: int, out_len: int, kernel, device):
    """``jax.image``'s ``compute_weight_mat`` (antialiased, as
    ``jax.image.resize`` is by default): the ``[in, out]`` float32
    weights of a resize along one axis."""
    inv_scale = 1. / (out_len / in_len)
    kernel_scale = max(inv_scale, 1.)
    sample_f = (torch.arange(out_len, dtype=torch.float32, device=device)
                + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    pos = torch.arange(in_len, dtype=torch.float32, device=device)
    w = kernel(torch.abs(sample_f[None, :] - pos[:, None]) / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000. * float(
        torch.finfo(torch.float32).eps),
        w / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate(x, size=None, scale_factor=None, mode: str = "nearest",
                align_corners: bool = False, data_format: str = "NCHW"):
    """``jax.image.resize`` semantics (NCHW): ``nearest`` samples
    ``floor((i + 0.5) in / out)``; ``bilinear`` / ``bicubic`` (Keys, a =
    -0.5) use half-pixel centres and antialias when downsampling;
    ``align_corners`` bilinear samples ``i (in - 1) / (out - 1)``."""
    if data_format != "NCHW":
        raise NotImplementedError
    n, c, h, w = x.shape
    if size is None:
        sf = _norm_tuple(scale_factor, 2)
        size = (int(h * sf[0]), int(w * sf[1]))
    size = _norm_tuple(size, 2)
    if align_corners and mode in ("bilinear", "linear"):
        out = _interp_axis_align_corners(x, size[0], 2)
        return _interp_axis_align_corners(out, size[1], 3)
    if align_corners and mode == "bicubic":
        raise NotImplementedError(
            "bicubic align_corners=True is not supported; use bilinear")
    kernel = {"nearest": None, "bilinear": _triangle,
              "bicubic": _keys_cubic}[mode]
    if kernel is None:
        for axis, m in ((2, size[0]), (3, size[1])):
            k = x.shape[axis]
            if k != m:
                idx = torch.floor((torch.arange(
                    m, dtype=torch.float32, device=x.device) + 0.5)
                    * k / m).long()
                x = x.index_select(axis, idx)
        return x
    if not x.is_floating_point():
        x = x.float()
    for axis, m in ((2, size[0]), (3, size[1])):
        if x.shape[axis] != m:
            wm = _resize_weights(x.shape[axis], m, kernel, x.device)
            x = torch.tensordot(x, wm.to(x.dtype), dims=([axis], [0])) \
                .movedim(-1, axis)
    return x


def upsample(x, size=None, scale_factor=None, mode: str = "nearest",
             align_corners: bool = False, data_format: str = "NCHW"):
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners, data_format=data_format)


def sequence_mask(lengths, maxlen=None, dtype="bool"):
    """``[..., maxlen]`` mask of positions below each length."""
    from ..core import dtype as dtype_mod
    lengths = torch.as_tensor(lengths)
    if maxlen is None:
        maxlen = int(lengths.max())
    pos = torch.arange(maxlen, dtype=lengths.dtype, device=lengths.device)
    mask = pos < lengths.unsqueeze(-1)
    return mask if dtype == "bool" else mask.to(dtype_mod.dtype(dtype))


def channel_shuffle(x, groups: int, data_format: str = "NCHW"):
    if data_format == "NHWC":
        x = x.movedim(-1, 1)
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by {groups} groups")
    out = x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
        .reshape(n, c, h, w)
    if data_format == "NHWC":
        out = out.movedim(1, -1)
    return out


def affine_grid(theta, out_shape, align_corners: bool = True):
    """``[n, h, w, 2]`` sampling grid (x, y) from ``[n, 2, 3]``
    affine matrices."""
    theta = torch.as_tensor(theta).float()
    _, _, h, w = out_shape
    dev = theta.device
    if align_corners:
        ys = _linspace(-1.0, 1.0, h, dev)
        xs = _linspace(-1.0, 1.0, w, dev)
    else:
        ys = (torch.arange(h, device=dev) + 0.5) * 2.0 / h - 1.0
        xs = (torch.arange(w, device=dev) + 0.5) * 2.0 / w - 1.0
    gy, gx = torch.meshgrid(ys.float(), xs.float(), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nck->nhwc", base, theta)


def grid_sample(x, grid, mode: str = "bilinear",
                padding_mode: str = "zeros", align_corners: bool = True):
    """Sample ``x`` at grid locations in [-1, 1]: a gather of the four
    neighbours and a bilinear blend (or the nearest), zero outside with
    ``zeros``, clamped with ``border``, mirrored with ``reflection``."""
    x = torch.as_tensor(x).float()
    grid = torch.as_tensor(grid).float()
    n, c, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1.0) * (w - 1) / 2.0
        fy = (gy + 1.0) * (h - 1) / 2.0
    else:
        fx = ((gx + 1.0) * w - 1.0) / 2.0
        fy = ((gy + 1.0) * h - 1.0) / 2.0
    if padding_mode == "border":
        fx = torch.clamp(fx, 0, w - 1)
        fy = torch.clamp(fy, 0, h - 1)
    elif padding_mode == "reflection":
        span_x = float(w - 1) if align_corners else float(w)
        span_y = float(h - 1) if align_corners else float(h)
        fx = span_x - torch.abs(torch.remainder(fx, 2 * span_x) - span_x)
        fy = span_y - torch.abs(torch.remainder(fy, 2 * span_y) - span_y)
        fx = torch.clamp(fx, 0, w - 1)
        fy = torch.clamp(fy, 0, h - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode {padding_mode!r}")
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"grid_sample mode {mode!r} not supported "
                         f"(nearest | bilinear)")
    batch = torch.arange(n, device=x.device)[:, None, None]

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = x[batch, :, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, torch.zeros_like(v))

    if mode == "nearest":
        return gather(torch.round(fy).long(),
                      torch.round(fx).long()).movedim(-1, 1)
    y0 = torch.floor(fy).long()
    x0 = torch.floor(fx).long()
    wy1, wx1 = fy - y0, fx - x0
    out = 0.0
    for yi, xi, wgt in ((y0, x0, (1 - wy1) * (1 - wx1)),
                        (y0, x0 + 1, (1 - wy1) * wx1),
                        (y0 + 1, x0, wy1 * (1 - wx1)),
                        (y0 + 1, x0 + 1, wy1 * wx1)):
        out = out + gather(yi, xi) * wgt[..., None]
    return out.movedim(-1, 1)


# the long-tail functionals live beside their layers, as in the JAX package
from .layers.extra import (alpha_dropout, celu, fold,  # noqa: E402,F401
                           local_response_norm, maxout, pairwise_distance,
                           pixel_shuffle, pixel_unshuffle,
                           thresholded_relu)

# the rest of the functional surface
from .functional_fill import *  # noqa: E402,F401,F403
