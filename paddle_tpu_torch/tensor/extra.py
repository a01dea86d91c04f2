"""Tensor-surface fills (the port's counterpart of
``paddle_tpu/tensor/extra.py``), with the JAX package's two stances:

- **Inplace ``*_`` family**: every ``x_()`` computes the same value as
  ``x()`` and RETURNS it without mutating its input, as the JAX package
  does (its arrays are immutable). ``y = x.add_(1)`` and chained calls
  behave as in the reference; code that relies on the input changing
  must use the result.
- **Random ``uniform_`` / ``exponential_``**: draw fresh samples of the
  input's shape from the global key stream instead of overwriting it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dtype
from ..core import rng as _rng
from ..core import threefry as _tf

# ---------------------------------------------------------------------------
# elementwise / reduction fills
# ---------------------------------------------------------------------------


def deg2rad(x, name=None):
    return torch.deg2rad(x)


def rad2deg(x, name=None):
    return torch.rad2deg(x)


def frac(x, name=None):
    """Fractional part, sign-preserving: x - trunc(x)."""
    return x - torch.trunc(x)


def gcd(x, y, name=None):
    return torch.gcd(x, y)


def lcm(x, y, name=None):
    return torch.lcm(x, y)


def heaviside(x, y, name=None):
    return torch.heaviside(x, torch.as_tensor(y, dtype=x.dtype,
                                              device=x.device))


def _axes(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(x, dim=_axes(axis, x.ndim), keepdim=keepdim,
                        dtype=_dtype.dtype(dtype) if dtype else None)


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(x, dim=_axes(axis, x.ndim), keepdim=keepdim)


def _nanquantile(x, q, axis, keepdim, interpolation):
    qt = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = torch.nanquantile(x.reshape(-1), qt,
                                interpolation=interpolation)
        return out.reshape(out.shape + (1,) * x.ndim) if keepdim else out
    return torch.nanquantile(x, qt, dim=int(axis), keepdim=keepdim,
                             interpolation=interpolation)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """``jnp.nanmedian``: the two middle non-NaN values averaged."""
    return _nanquantile(x, 0.5, axis, keepdim, "midpoint")


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _nanquantile(x, q, axis, keepdim, "linear")


def neg(x, name=None):
    return -x


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """b * tanh(a * x) (ref operators stanh_op)."""
    return scale_b * torch.tanh(scale_a * x)


def floor_mod(x, y, name=None):
    return torch.remainder(x, y)


def renorm(x, p, axis, max_norm, name=None):
    """Clamp the p-norm of every sub-tensor along ``axis`` to
    ``max_norm`` (ref tensor/math.py renorm)."""
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=reduce_axes,
                      keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


# ---------------------------------------------------------------------------
# shape / indexing fills
# ---------------------------------------------------------------------------


def rank(x, name=None):
    return torch.tensor(x.ndim)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and \
            all(isinstance(a, (list, tuple)) for a in axes):
        axes = tuple(list(a) for a in axes)
    return torch.tensordot(x, y, dims=axes)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def reverse(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(x, tuple(axis))


def scatter_nd(index, updates, shape, name=None):
    """Zeros of ``shape`` with ``updates`` scatter-ADDED at ``index``
    (duplicate indices accumulate — ref operators/scatter_nd_add)."""
    out = torch.zeros(tuple(shape), dtype=updates.dtype,
                      device=updates.device)
    idx = tuple(torch.movedim(index.to(torch.int64), -1, 0))
    return out.index_put(idx, updates, accumulate=True)


def crop(x, shape=None, offsets=None, name=None):
    """Static crop: slice ``shape`` starting at ``offsets`` (-1 in shape
    keeps the remainder); an offset past the end is clamped, as
    ``lax.dynamic_slice`` clamps it."""
    shape = list(x.shape) if shape is None else list(shape)
    offsets = [0] * x.ndim if offsets is None else list(offsets)
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    for ax, (o, n) in enumerate(zip(offsets, shape)):
        o = min(max(int(o), 0), x.shape[ax] - n)
        x = x.narrow(ax, o, n)
    return x


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    from ..core.device import current_device
    dt = _dtype.dtype(dtype) if dtype is not None \
        else _dtype.get_default_dtype()
    return torch.logspace(start, stop, int(num), base=base, dtype=dt,
                          device=current_device())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    want = _dtype.dtype(dtype) if dtype is not None else x.dtype
    out = _tf.randint(_rng.next_key(), tuple(x.shape), low, high, x.device)
    return out.to(want)


def standard_normal(shape, dtype=None, name=None):
    from ..core.device import current_device
    dt = _dtype.dtype(dtype) if dtype is not None \
        else _dtype.get_default_dtype()
    return _tf.normal(_rng.next_key(), tuple(shape), current_device(),
                      dtype=dt)


# ---------------------------------------------------------------------------
# predicates / conversion
# ---------------------------------------------------------------------------


def is_tensor(x):
    return isinstance(x, (torch.Tensor, np.ndarray))


def is_complex(x):
    return torch.as_tensor(x).is_complex()


def is_floating_point(x):
    return torch.as_tensor(x).is_floating_point()


def is_integer(x):
    t = torch.as_tensor(x)
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype is torch.bool)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0)


def tolist(x):
    return x.tolist()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """Printing config (ref framework set_printoptions), forwarded to
    torch's and numpy's printers."""
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    np.set_printoptions(**kw)


# ---------------------------------------------------------------------------
# the inplace (*_) family — functional, see module docstring
# ---------------------------------------------------------------------------


def _functional_inplace(fn_name, base):
    def wrapper(x, *args, **kwargs):
        return base(x, *args, **kwargs)
    wrapper.__name__ = fn_name
    wrapper.__qualname__ = fn_name
    wrapper.__doc__ = (f"Functional form of the reference's inplace "
                       f"``{fn_name}``: returns the result and leaves "
                       f"its input as it was (see tensor/extra.py).")
    return wrapper


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    """Fresh uniform sample of x's shape (functional; see module
    docstring)."""
    return _tf.uniform(_rng.next_key(), tuple(x.shape), min, max,
                       x.device, dtype=x.dtype)


def exponential_(x, lam=1.0, name=None):
    """Fresh Exp(lam) sample of x's shape (functional)."""
    return _tf.exponential(_rng.next_key(), tuple(x.shape), x.device,
                           x.dtype) / lam


# the alias installation must run AFTER tensor/__init__ defines the
# base ops; __init__ imports this module last and calls _finalize().
_INPLACE_BASES = ["add", "ceil", "clip", "exp", "floor", "reshape",
                  "squeeze", "unsqueeze", "tanh", "sqrt", "round",
                  "rsqrt", "scale", "scatter", "subtract", "lerp",
                  "erfinv", "reciprocal", "flatten", "put_along_axis"]

_LINALG_REEXPORTS = ["cholesky", "cholesky_solve", "cond", "corrcoef",
                     "cov", "eig", "eigvals", "eigvalsh", "lstsq",
                     "lu", "lu_unpack", "matrix_power", "multi_dot",
                     "qr", "solve", "triangular_solve"]


def _finalize(tensor_ns: dict) -> dict:
    """Called by tensor/__init__ after all base defs exist. Returns the
    extra names to splice into the tensor namespace."""
    from .. import linalg as L
    out = {}
    for b in _INPLACE_BASES:
        base = tensor_ns.get(b) or globals().get(b)
        if base is not None:
            out[b + "_"] = _functional_inplace(b + "_", base)
    for name in _LINALG_REEXPORTS:
        if name not in tensor_ns:
            out[name] = getattr(L, name)
    return out
