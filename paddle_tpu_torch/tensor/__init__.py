"""paddle_tpu_torch.tensor — the functional tensor API (the port's
counterpart of ``paddle_tpu/tensor/__init__.py``).

Same names and argument conventions (``x``, ``axis``, ``keepdim``),
returning ``torch.Tensor``. Functions that take a tensor compute on its
device; functions that take none create their result on the device
``set_device`` chose (``core/device.py::current_device``: the card by
default, raising when there is none). Random draws take their keys from
the global stream (``core/rng.py``) in the JAX package's order and draw
JAX's threefry bits (``core/threefry.py``), so a seed gives the JAX
package's numbers.

Where torch and ``jnp`` differ the port follows ``jnp``: ``median``
averages the two middle values, sorts are stable and ``descending``
flips the stable ascending order (ties come out last index first),
``topk`` breaks ties by the lower index, ``mode`` returns the smallest
tied value and the index of its last occurrence, ``cross`` defaults to
the first axis of size 3. Integer results keep torch's dtypes (int64
indices) where the JAX package, with x64 off, has int32: the values are
the same.
"""

from __future__ import annotations

import builtins
import math as _math
from inspect import ismodule as _ismodule

import numpy as np
import torch

from ..core import device as _device
from ..core import dtype as dtype_mod
from ..core import rng
from ..core import threefry as _tf
from ..core import xla_math as _xm


def _dev():
    return _device.current_device()


def _t(x, dtype=None):
    """``x`` as a tensor: a tensor stays on its device, anything else
    lands on the flat API's device."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=_dev())


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _opt_dtype(dtype):
    return dtype_mod.dtype(dtype) if dtype is not None else None


# ---------------------------------------------------------------------------
# creation (ref: python/paddle/tensor/creation.py)
# ---------------------------------------------------------------------------


def to_tensor(data, dtype=None, stop_gradient: bool = True):
    """A tensor of ``data`` on the flat API's device (a tensor keeps its
    device). Without ``dtype`` numpy data keeps its dtype (float64 stays
    float64, where the JAX package narrows to 32 bits); Python floats are
    float32."""
    dt = _opt_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach().clone() if dt is None else data.to(dt)
    else:
        out = torch.tensor(data, dtype=dt, device=_dev())   # a copy
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out


def _default_float(dtype):
    return dtype_mod.dtype(dtype) if dtype is not None \
        else dtype_mod.get_default_dtype()


def zeros(shape, dtype=None):
    return torch.zeros(_shape(shape), dtype=_default_float(dtype),
                       device=_dev())


def ones(shape, dtype=None):
    return torch.ones(_shape(shape), dtype=_default_float(dtype),
                      device=_dev())


def full(shape, fill_value, dtype=None):
    return torch.full(_shape(shape), fill_value, dtype=_default_float(dtype),
                      device=_dev())


def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_opt_dtype(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=_opt_dtype(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, fill_value, dtype=_opt_dtype(dtype))


def arange(start=0, end=None, step=1, dtype=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=_opt_dtype(dtype),
                        device=_dev())


def linspace(start, stop, num, dtype=None):
    return torch.linspace(start, stop, int(num),
                          dtype=_default_float(dtype), device=_dev())


def eye(num_rows, num_columns=None, dtype=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=_default_float(dtype),
                     device=_dev())


def diag(x, offset: int = 0):
    return torch.diag(x, offset)


def tril(x, diagonal: int = 0):
    return torch.tril(x, diagonal)


def triu(x, diagonal: int = 0):
    return torch.triu(x, diagonal)


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*args, indexing="ij"))


def assign(x):
    return _t(x)


def clone(x):
    return x.clone()


# ---------------------------------------------------------------------------
# random (ref: python/paddle/tensor/random.py) — keys from core.rng streams
# ---------------------------------------------------------------------------

def rand(shape, dtype=None):
    return _tf.uniform(rng.next_key(), _shape(shape), device=_dev(),
                       dtype=_default_float(dtype))


def randn(shape, dtype=None):
    return _tf.normal(rng.next_key(), _shape(shape), _dev(),
                      dtype=_default_float(dtype))


def randint(low, high=None, shape=(1,), dtype="int64"):
    """JAX's 32-bit draw (x64 off), in the dtype the caller names."""
    if high is None:
        low, high = 0, low
    return _tf.randint(rng.next_key(), _shape(shape), low, high,
                       _dev()).to(dtype_mod.dtype(dtype))


def uniform(shape, dtype=None, min=-1.0, max=1.0):
    return _tf.uniform(rng.next_key(), _shape(shape), min, max, _dev(),
                       dtype=_default_float(dtype))


def normal(mean=0.0, std=1.0, shape=(1,)):
    return mean + std * _tf.normal(rng.next_key(), _shape(shape), _dev(),
                                   dtype=dtype_mod.get_default_dtype())


def randperm(n, dtype="int64"):
    return _tf.shuffle(rng.next_key(), int(n), _dev()).to(
        dtype_mod.dtype(dtype))


def multinomial(x, num_samples=1, replacement=False):
    logits = _xm.log(torch.clamp(x, min=1e-30).to(torch.float32))
    if replacement:
        return _tf.categorical_shaped(
            rng.next_key(), logits,
            tuple(x.shape[:-1]) + (num_samples,))
    if num_samples > 1:
        # Gumbel top-k trick for without-replacement sampling
        g = _tf.gumbel(rng.next_key(), tuple(x.shape), x.device)
        return torch.argsort(-(logits + g), dim=-1,
                             stable=True)[..., :num_samples]
    return _tf.categorical_shaped(rng.next_key(), logits)[..., None]


def bernoulli(x):
    return _tf.bernoulli(rng.next_key(), x).to(x.dtype)


# ---------------------------------------------------------------------------
# math (ref: python/paddle/tensor/math.py)
# ---------------------------------------------------------------------------

add = torch.add
subtract = torch.subtract
multiply = torch.multiply
divide = torch.true_divide
floor_divide = torch.floor_divide
mod = remainder = torch.remainder
pow = torch.pow
exp = torch.exp
expm1 = torch.expm1
log = torch.log
log2 = torch.log2
log10 = torch.log10
log1p = torch.log1p
sqrt = torch.sqrt
square = torch.square
abs = torch.abs
sign = torch.sign
floor = torch.floor
ceil = torch.ceil
round = torch.round
trunc = torch.trunc
sin = torch.sin
cos = torch.cos
tan = torch.tan
asin = torch.asin
acos = torch.acos
atan = torch.atan
atan2 = torch.atan2
sinh = torch.sinh
cosh = torch.cosh
tanh = torch.tanh
asinh = torch.asinh
acosh = torch.acosh
atanh = torch.atanh
erf = torch.erf
lgamma = torch.lgamma
digamma = torch.digamma
reciprocal = torch.reciprocal
maximum = torch.maximum
minimum = torch.minimum
fmax = torch.fmax
fmin = torch.fmin
logaddexp = torch.logaddexp
hypot = torch.hypot


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def lerp(x, y, w):
    return x + w * (y - x)


def rsqrt(x):
    return torch.rsqrt(x)


def clip(x, min=None, max=None):
    return torch.clamp(x, min, max)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale + bias
    return (x + bias) * scale


def _float_of(x):
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(dtype_mod.get_default_dtype())


def sum(x, axis=None, dtype=None, keepdim=False):
    return torch.sum(x, dim=_dims(axis, x.ndim), keepdim=keepdim,
                     dtype=_opt_dtype(dtype))


def mean(x, axis=None, keepdim=False):
    return torch.mean(_float_of(x), dim=_dims(axis, x.ndim),
                      keepdim=keepdim)


def prod(x, axis=None, keepdim=False):
    if axis is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.ndim) if keepdim else out
    for a in sorted((d % x.ndim for d in _dims(axis, x.ndim)),
                    reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim)
    return x


def max(x, axis=None, keepdim=False):
    return torch.amax(x, dim=_dims(axis, x.ndim), keepdim=keepdim)


def min(x, axis=None, keepdim=False):
    return torch.amin(x, dim=_dims(axis, x.ndim), keepdim=keepdim)


amax = max
amin = min


def std(x, axis=None, unbiased=True, keepdim=False):
    return torch.std(_float_of(x), dim=_dims(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False):
    return torch.var(_float_of(x), dim=_dims(axis, x.ndim),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def median(x, axis=None, keepdim=False):
    """``jnp.median``: an even count averages its two middle values
    (``torch.median`` returns the lower one)."""
    x = _float_of(x)
    if axis is None:
        out = torch.quantile(x.reshape(-1), 0.5, interpolation="midpoint")
        return out.reshape((1,) * x.ndim) if keepdim else out
    return torch.quantile(x, 0.5, dim=int(axis), keepdim=keepdim,
                          interpolation="midpoint")


def quantile(x, q, axis=None, keepdim=False):
    x = _float_of(x)
    qt = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.quantile(x.reshape(-1), qt)
        return out.reshape(out.shape + (1,) * x.ndim) if keepdim else out
    return torch.quantile(x, qt, dim=int(axis), keepdim=keepdim)


def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cumsum(x, dim=axis, dtype=_opt_dtype(dtype))


def cumprod(x, dim=None, dtype=None):
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return torch.cumprod(x, dim=dim, dtype=_opt_dtype(dtype))


def logsumexp(x, axis=None, keepdim=False):
    return torch.logsumexp(x, dim=_dims(axis, x.ndim), keepdim=keepdim)


def logcumsumexp(x, axis=None):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.logcumsumexp(x, dim=axis)


def addmm(input, x, y, beta=1.0, alpha=1.0):
    return beta * input + alpha * (x @ y)


def matmul(x, y, transpose_x=False, transpose_y=False):
    if transpose_x:
        x = torch.swapaxes(x, -1, -2)
    if transpose_y:
        y = torch.swapaxes(y, -1, -2)
    return torch.matmul(x, y)


mm = matmul


def bmm(x, y):
    return torch.matmul(x, y)


def dot(x, y):
    return torch.sum(x * y, dim=-1)


def outer(x, y):
    return torch.outer(x.reshape(-1), y.reshape(-1))


def inner(x, y):
    return torch.inner(x, y)


def kron(x, y):
    return torch.kron(x, y)


def cross(x, y, axis=None):
    """ref: paddle.cross — axis=None means the FIRST axis of size 3
    (the reference's default-axis sentinel), not the last axis."""
    x = _t(x)
    if axis is None or axis == 9:  # 9: paddle's C-side sentinel
        cands = [i for i, d in enumerate(x.shape) if d == 3]
        if not cands:
            raise ValueError(
                f"cross: no axis of size 3 in shape {tuple(x.shape)}")
        axis = cands[0]
    return torch.linalg.cross(x, _t(y), dim=axis)


def trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def diff(x, n=1, axis=-1):
    return torch.diff(x, n=n, dim=axis)


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *operands)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.tensor(torch.allclose(x, y, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


isnan = torch.isnan
isinf = torch.isinf
isfinite = torch.isfinite


# ---------------------------------------------------------------------------
# logic / compare (ref: python/paddle/tensor/logic.py)
# ---------------------------------------------------------------------------

equal = torch.eq
not_equal = torch.ne
greater_than = torch.gt
greater_equal = torch.ge
less_than = torch.lt
less_equal = torch.le
logical_and = torch.logical_and
logical_or = torch.logical_or
logical_not = torch.logical_not
logical_xor = torch.logical_xor
bitwise_and = torch.bitwise_and
bitwise_or = torch.bitwise_or
bitwise_xor = torch.bitwise_xor
bitwise_not = torch.bitwise_not


def equal_all(x, y):
    return torch.tensor(x.shape == y.shape and torch.equal(x, y),
                        device=x.device)


def all(x, axis=None, keepdim=False):
    return torch.all(x.bool(), dim=_dims(axis, x.ndim), keepdim=keepdim)


def any(x, axis=None, keepdim=False):
    return torch.any(x.bool(), dim=_dims(axis, x.ndim), keepdim=keepdim)


# ---------------------------------------------------------------------------
# manipulation (ref: python/paddle/tensor/manipulation.py)
# ---------------------------------------------------------------------------

def cast(x, dtype):
    return x.to(dtype_mod.dtype(dtype))


def reshape(x, shape):
    return torch.reshape(x, _shape(shape))


def transpose(x, perm):
    return x.permute(*perm)


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


def t(x):
    return x.permute(*reversed(range(x.ndim)))


def concat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


def stack(xs, axis=0):
    return torch.stack(list(xs), dim=axis)


def unstack(x, axis=0):
    return list(torch.unbind(x, dim=axis))


def split(x, num_or_sections, axis=0):
    if isinstance(num_or_sections, int):
        n = x.shape[axis]
        if n % num_or_sections:
            raise ValueError(
                f"array split does not result in an equal division: "
                f"{n} by {num_or_sections}")
        return list(torch.split(x, n // num_or_sections, dim=axis))
    return list(torch.split(x, list(num_or_sections), dim=axis))


def chunk(x, chunks, axis=0):
    return list(torch.tensor_split(x, chunks, dim=axis))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=_dims(axis, x.ndim))


def unsqueeze(x, axis):
    out_nd = x.ndim + len(_dims(axis, 0))
    for a in sorted(d % out_nd for d in _dims(axis, 0)):
        x = torch.unsqueeze(x, a)
    return x


def flatten(x, start_axis=0, stop_axis=-1):
    start = start_axis % x.ndim
    stop = stop_axis % x.ndim
    return x.reshape(tuple(x.shape[:start]) + (-1,)
                     + tuple(x.shape[stop + 1:]))


def tile(x, repeat_times):
    return torch.tile(x, _shape(repeat_times))


def expand(x, shape):
    return torch.broadcast_to(x, _shape(shape))


def broadcast_to(x, shape):
    return torch.broadcast_to(x, _shape(shape))


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis):
    return torch.flip(x, _dims(axis, x.ndim))


def roll(x, shifts, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, list(axes))


def _take(x, index, axis):
    axis = axis % x.ndim
    index = _t(index).to(torch.int64)
    out = torch.index_select(x, axis, index.reshape(-1) % x.shape[axis])
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


def gather(x, index, axis=0):
    return _take(x, index, axis)


def _index_tuple(index):
    return tuple(torch.movedim(_t(index).to(torch.int64), -1, 0))


def gather_nd(x, index):
    return x[_index_tuple(index)]


def take_along_axis(x, indices, axis):
    return torch.take_along_dim(x, indices.to(torch.int64), dim=axis)


def put_along_axis(x, indices, values, axis):
    # the reference op casts values to x's dtype (put_along_axis_op.cc)
    indices = indices.to(torch.int64)
    values = torch.broadcast_to(_t(values).to(x.dtype), indices.shape)
    return x.scatter(axis, indices, values)


def scatter(x, index, updates, overwrite=True):
    updates = _t(updates).to(x.dtype)
    index = _t(index).to(torch.int64)
    if overwrite:
        return x.index_put((index,), updates)
    return x.index_put((index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates):
    return x.index_put(_index_tuple(index), _t(updates).to(x.dtype),
                       accumulate=True)


def index_select(x, index, axis=0):
    return _take(x, index, axis)


def index_sample(x, index):
    return torch.take_along_dim(x, index.to(torch.int64), dim=1)


def masked_select(x, mask):
    return x[mask]


def masked_fill(x, mask, value):
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return torch.nonzero(condition, as_tuple=True)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=condition.device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, device=condition.device)
    return torch.where(condition, x, y)


def nonzero(x, as_tuple=False):
    if as_tuple:
        return torch.nonzero(x, as_tuple=True)
    return torch.nonzero(x)


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    """``jnp.unique``: the sorted unique values, then (as asked) the index
    of each one's first occurrence, the inverse and the counts."""
    src = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    out = [vals]
    if return_index:
        n = src.shape[0 if axis is None else axis]
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(
            0, inv, torch.arange(n, device=x.device), "amin"))
    if return_inverse:
        out.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def unbind(x, axis=0):
    return unstack(x, axis)


def repeat_interleave(x, repeats, axis=None):
    return torch.repeat_interleave(x, repeats, dim=axis)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    return torch.stack([real(x), imag(x)], dim=-1)


def numel(x):
    return torch.tensor(x.numel(), device=x.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards
    lo, hi = shard_id * shard_size, (shard_id + 1) * shard_size
    in_shard = (input >= lo) & (input < hi)
    return torch.where(in_shard, input - lo,
                       torch.full_like(input, ignore_value))


# ---------------------------------------------------------------------------
# search / sort (ref: python/paddle/tensor/search.py)
# ---------------------------------------------------------------------------

def _argext(fn, x, axis, keepdim, dtype):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdim:
            out = out.reshape((1,) * x.ndim)
    else:
        out = fn(x, dim=axis, keepdim=keepdim)
    return out.to(dtype_mod.dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64"):
    return _argext(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64"):
    return _argext(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False):
    """Stable ascending order; ``descending`` flips it, so tied elements
    come out last index first (the JAX package's order)."""
    idx = torch.argsort(x, dim=axis, stable=True)
    if descending:
        idx = torch.flip(idx, (axis,))
    return idx


def sort(x, axis=-1, descending=False):
    y = torch.sort(x, dim=axis, stable=True).values
    if descending:
        y = torch.flip(y, (axis,))
    return y


def topk(x, k, axis=-1, largest=True, sorted=True):
    """``lax.top_k``: the ``k`` largest (or smallest) along ``axis``,
    ties broken by the lower index."""
    y = torch.movedim(x, axis, -1)
    if largest:
        vals, idx = torch.sort(y, dim=-1, descending=True, stable=True)
    else:
        vals, idx = torch.sort(y, dim=-1, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis)


def searchsorted(sorted_sequence, values, right=False):
    return torch.searchsorted(sorted_sequence, values, right=right)


def bincount(x, weights=None, minlength=0):
    return torch.bincount(x, weights=weights, minlength=minlength)


def histogram(x, bins=100, min=0, max=0):
    """``jnp.histogram`` counts; ``min == max == 0`` means the data's own
    range. Bins are searched on linspace edges; the last edge closes the
    last bin."""
    x = x.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.as_tensor(min, dtype=x.dtype, device=x.device)
        hi = torch.as_tensor(max, dtype=x.dtype, device=x.device)
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    steps = torch.arange(bins + 1, device=x.device, dtype=x.dtype) / bins
    edges = lo + (hi - lo) * steps
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, bins), idx)
    counts = torch.zeros(bins + 2, dtype=torch.int64, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[1:bins + 1]


# ---------------------------------------------------------------------------
# linalg (ref: python/paddle/tensor/linalg.py) — partial; more in .linalg
# ---------------------------------------------------------------------------

def norm(x, p=2, axis=None, keepdim=False):
    dims = None if axis is None else _dims(axis, x.ndim)
    if p == "fro" or (p == 2 and axis is None):
        return torch.sqrt(torch.sum(torch.square(torch.abs(x)),
                                    dim=dims, keepdim=keepdim))
    if p == _math.inf or p == "inf":
        return torch.amax(torch.abs(x), dim=_dims(axis, x.ndim),
                          keepdim=keepdim)
    if p == -_math.inf:
        return torch.amin(torch.abs(x), dim=_dims(axis, x.ndim),
                          keepdim=keepdim)
    return torch.sum(torch.abs(x) ** p, dim=dims,
                     keepdim=keepdim) ** (1. / p)


def dist(x, y, p=2):
    return norm(x - y, p=p)


def mv(x, vec):
    """Matrix-vector product (ref: python/paddle/tensor/linalg.py mv)."""
    return torch.matmul(x, vec)


def inverse(x):
    """Batched matrix inverse (ref: legacy_api.yaml inverse)."""
    return torch.linalg.inv(x)


def frobenius_norm(x, axis=None, keepdim=False):
    """ref: legacy_api.yaml frobenius_norm — norm(p='fro') kernel form."""
    return norm(x, p="fro", axis=axis, keepdim=keepdim)


def p_norm(x, porder=2.0, axis=None, keepdim=False):
    """ref: legacy_api.yaml p_norm — the vector-norm kernel behind
    paddle.norm(p=float)."""
    return norm(x, p=porder, axis=axis, keepdim=keepdim)


# ---------------------------------------------------------------------------
# complex (ref: python/paddle/tensor/attribute.py real/imag,
# creation.py complex; kernels legacy_api.yaml angle/conj/complex)
# ---------------------------------------------------------------------------

def conj(x):
    return torch.conj_physical(x) if x.is_complex() else x


def real(x):
    return torch.real(x) if x.is_complex() else x


def imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def angle(x):
    return torch.angle(x)


def complex(real, imag):  # noqa: A002 — paddle API name
    return torch.complex(real, imag)


# ---------------------------------------------------------------------------
# search/statistic extras (ref: python/paddle/tensor/search.py kthvalue,
# stat.py mode)
# ---------------------------------------------------------------------------

def kthvalue(x, k, axis=-1, keepdim=False):
    """k-th SMALLEST value + its index along ``axis`` (1-based k), ties
    in the stable order."""
    ax = axis % x.ndim
    i = torch.select(torch.argsort(x, dim=ax, stable=True), ax, k - 1)
    v = torch.take_along_dim(x, i.unsqueeze(ax), dim=ax).squeeze(ax)
    if keepdim:
        v, i = v.unsqueeze(ax), i.unsqueeze(ax)
    return v, i


def mode(x, axis=-1, keepdim=False):
    """Most frequent value + an index of it along ``axis``: a sorted
    run-length scan. Ties resolve to the smallest tied value; the index
    is the LAST occurrence in x."""
    ax = axis % x.ndim
    n = x.shape[ax]
    xs = torch.sort(x, dim=ax, stable=True).values
    first = torch.ones_like(xs.narrow(ax, 0, 1), dtype=torch.bool)
    is_new = torch.cat([first, torch.diff(xs, dim=ax) != 0], dim=ax)
    shape = [1] * x.ndim
    shape[ax] = n
    idx_along = torch.arange(n, device=x.device).reshape(shape).expand(
        xs.shape)
    run_start = torch.cummax(torch.where(is_new, idx_along,
                                         torch.zeros_like(idx_along)),
                             dim=ax).values
    run_len = idx_along - run_start + 1
    best = torch.argmax(run_len, dim=ax)
    mode_val = torch.take_along_dim(xs, best.unsqueeze(ax), dim=ax)
    matches = x == mode_val.expand(x.shape)
    mode_idx = n - 1 - torch.argmax(torch.flip(matches, (ax,)).to(
        torch.uint8), dim=ax)
    if keepdim:
        mode_idx = mode_idx.unsqueeze(ax)
    else:
        mode_val = mode_val.squeeze(ax)
    return mode_val, mode_idx


# ---------------------------------------------------------------------------
# manipulation extras (ref: python/paddle/tensor/manipulation.py)
# ---------------------------------------------------------------------------

def diagonal(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


def diag_embed(x, offset=0, dim1=-2, dim2=-1):
    """Batched vectors → batched diagonal matrices (ref: python/paddle/
    tensor/creation.py diag_embed)."""
    n = x.shape[-1] + builtins.abs(offset)
    out = torch.zeros(tuple(x.shape[:-1]) + (n, n), dtype=x.dtype,
                      device=x.device)
    idx = torch.arange(x.shape[-1], device=x.device)
    rows = idx + (-offset if offset < 0 else 0)
    cols = idx + (offset if offset > 0 else 0)
    out[..., rows, cols] = x
    if (dim1, dim2) != (-2, -1):
        out = torch.movedim(out, (-2, -1), (dim1, dim2))
    return out


def expand_as(x, y):
    return torch.broadcast_to(x, y.shape)


def increment(x, value=1.0):
    return x + value


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None):
    """Deduplicate CONSECUTIVE repeats (ref: python/paddle/tensor/
    manipulation.py unique_consecutive); the output size depends on the
    data."""
    if axis is None:
        flat = x.reshape(-1)
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                          flat[1:] != flat[:-1]])
        out, size = flat[keep], flat.numel()
    else:
        xm = torch.movedim(x, axis, 0)
        neq = (xm[1:] != xm[:-1]).reshape(xm.shape[0] - 1, -1).any(-1) \
            if xm.shape[0] > 1 else torch.zeros(0, dtype=torch.bool,
                                                device=x.device)
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                          neq])
        out, size = torch.movedim(xm[keep], 0, axis), keep.numel()
    results = [out]
    if return_inverse:
        results.append(torch.cumsum(keep.to(torch.int64), 0) - 1)
    if return_counts:
        idx = torch.nonzero(keep).reshape(-1)
        results.append(torch.diff(torch.cat([idx, torch.tensor(
            [size], device=x.device)])))
    return results[0] if len(results) == 1 else tuple(results)


def tril_indices(row, col=None, offset=0):
    return torch.tril_indices(row, row if col is None else col, offset,
                              device=_dev())


def triu_indices(row, col=None, offset=0):
    return torch.triu_indices(row, row if col is None else col, offset,
                              device=_dev())


# ---------------------------------------------------------------------------
# creation extras (ref: python/paddle/tensor/creation.py empty/empty_like)
# ---------------------------------------------------------------------------

def empty(shape, dtype=None):
    """Zeros, as in the JAX package (its lowering has no uninitialized
    memory), with paddle's empty() signature."""
    return zeros(shape, dtype)


def empty_like(x, dtype=None):
    return torch.zeros_like(x, dtype=_opt_dtype(dtype))


# ---------------------------------------------------------------------------
# math/misc kernel-parity ops (ref: paddle/phi/api/yaml/legacy_api.yaml)
# ---------------------------------------------------------------------------

erfinv = torch.erfinv


def add_n(inputs):
    """Sum a list of tensors (ref: legacy_api.yaml add_n / sum_op)."""
    out = inputs[0]
    for t_ in inputs[1:]:
        out = out + t_
    return out


def clip_by_norm(x, max_norm):
    """Scale x so its L2 norm is at most ``max_norm`` (ref:
    legacy_api.yaml clip_by_norm)."""
    n = torch.sqrt(torch.sum(torch.square(x)))
    return x * (max_norm / torch.clamp(n, min=max_norm))


def logit(x, eps=None):
    """log(p / (1-p)) (ref: legacy_api.yaml logit). With ``eps``, p is
    clipped into [eps, 1-eps]; without, out-of-range p gives nan."""
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def poisson(x):
    """Elementwise Poisson sample with rate x (ref: legacy_api.yaml
    poisson); key drawn from the ambient rng stream like rand/randn."""
    return _tf.poisson(rng.next_key(), x).to(x.dtype)


def shape(x):
    """The shape as an int64 tensor (ref: paddle.shape)."""
    return torch.tensor(tuple(x.shape), dtype=torch.int64, device=x.device)


def slice(x, axes, starts, ends):  # noqa: A001 — paddle API name
    """Static multi-axis slice (ref: legacy_api.yaml slice): python int
    ``starts`` / ``ends``, negative allowed, ends clamped."""
    idx = [builtins.slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = builtins.slice(s, e)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides):
    """ref: legacy_api.yaml strided_slice (negative strides supported)."""
    for ax, s, e, st in zip(axes, starts, ends, strides):
        picks = range(*builtins.slice(s, e, st).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(
            list(picks), dtype=torch.int64, device=x.device))
    return x


def multiplex(inputs, index):
    """Row-wise select among candidate tensors: out[i] =
    inputs[index[i]][i] (ref: legacy_api.yaml multiplex)."""
    stacked = torch.stack(list(inputs))                # [K, N, ...]
    idx = index.reshape(-1).to(torch.int64)            # [N]
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def gather_tree(ids, parents):
    """Beam-search back-trace (ref: legacy_api.yaml gather_tree):
    ``ids`` / ``parents`` [max_time, batch, beam]; walks parent pointers
    backwards from the final step."""
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], device=ids.device).expand(
        ids.shape[1:]).contiguous()
    rev = []
    for t_ in range(T - 1, -1, -1):
        rev.append(torch.take_along_dim(ids[t_], beam, dim=-1))
        beam = torch.take_along_dim(parents[t_].to(torch.int64), beam,
                                    dim=-1)
    return torch.stack(rev[::-1])


# ---------------------------------------------------------------------------
# segment ops (ref: legacy_api.yaml segment_pool / graph_send_recv;
# python/paddle/incubate/tensor/math.py segment_{sum,mean,max,min}).
# ``num_segments`` None reads the max id on the host, as the reference's
# data-dependent output size does.
# ---------------------------------------------------------------------------

def _num_segments(segment_ids, num_segments):
    if num_segments is not None:
        return int(num_segments)
    return int(segment_ids.max()) + 1


def _segment(data, segment_ids, n, reduce, init):
    out = torch.full((n,) + tuple(data.shape[1:]), init, dtype=data.dtype,
                     device=data.device)
    idx = segment_ids.to(torch.int64).reshape(
        (-1,) + (1,) * (data.ndim - 1)).expand(data.shape)
    return out.scatter_reduce(0, idx, data, reduce, include_self=False)


def segment_sum(data, segment_ids, num_segments=None):
    n = _num_segments(segment_ids, num_segments)
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids.to(torch.int64), data)


def segment_mean(data, segment_ids, num_segments=None):
    n = _num_segments(segment_ids, num_segments)
    s = segment_sum(data, segment_ids, n)
    cnt = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype,
                                 device=data.device), segment_ids, n)
    return s / torch.clamp(cnt, min=1).reshape(
        (-1,) + (1,) * (data.ndim - 1))


def _lowest(dtype):
    return -_math.inf if dtype.is_floating_point else torch.iinfo(dtype).min


def _highest(dtype):
    return _math.inf if dtype.is_floating_point else torch.iinfo(dtype).max


def segment_max(data, segment_ids, num_segments=None):
    """Empty segments hold the dtype's lowest value (-inf for floats), as
    ``jax.ops.segment_max``."""
    return _segment(data, segment_ids,
                    _num_segments(segment_ids, num_segments), "amax",
                    _lowest(data.dtype))


def segment_min(data, segment_ids, num_segments=None):
    return _segment(data, segment_ids,
                    _num_segments(segment_ids, num_segments), "amin",
                    _highest(data.dtype))


# -- the fills and the inplace family (tensor/extra.py) ---------------------
from .extra import *  # noqa: E402,F401,F403
from . import extra as _extra  # noqa: E402
globals().update(_extra._finalize(globals()))
del _extra

__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and not _ismodule(v)
           and n not in ("annotations", "np", "torch", "builtins", "rng",
                         "dtype_mod")]
