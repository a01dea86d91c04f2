"""Parameter initializers (the port's counterpart of
``paddle_tpu/nn/initializer.py``).

An initializer is a callable ``init(shape, dtype, generator=None)``
returning a CPU tensor. Random ones draw from ``generator``, by default
the global one that :func:`paddle_tpu_torch.seed` sets, so a seed gives
the same weights whatever device the module moves to afterwards; their
numbers differ from ``jax.random``'s (the laws are the JAX package's).
The deterministic ones (``Constant``, ``Assign``, ``Dirac``,
``Bilinear``) give the JAX package's values exactly. Fans follow the
JAX package: ``[in, out]`` for a matrix, ``[out, in/groups, *k]`` for a
conv kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import rng


def _fan_in_out(shape: Sequence[int]):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv kernels are stored [out_c, in_c/groups, *k]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def _draw(shape, dtype, generator, fill):
    """A float32 CPU tensor of ``shape`` filled by ``fill(out, g)`` from
    ``generator`` (the global one by default), cast to ``dtype``."""
    g = generator if generator is not None else rng.generator()
    out = torch.empty(tuple(shape), dtype=torch.float32)
    fill(out, g)
    return out.to(dtype)


class Initializer:
    def __call__(self, shape, dtype, generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator=None):
        return _draw(shape, dtype, generator,
                     lambda o, g: o.uniform_(self.low, self.high,
                                             generator=g))


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None):
        return _draw(shape, dtype, generator,
                     lambda o, g: o.normal_(self.mean, self.std,
                                            generator=g))


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` a standard normal truncated to
    [-2, 2]."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None):
        def fill(o, g):
            torch.nn.init.trunc_normal_(o, 0.0, 1.0, -2.0, 2.0, generator=g)
            o.mul_(self.std).add_(self.mean)
        return _draw(shape, dtype, generator, fill)


class XavierUniform(Initializer):
    """Glorot uniform (the default of ``Linear`` when no initializer is
    given)."""

    def __init__(self, fan_in: Optional[float] = None,
                 fan_out: Optional[float] = None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fans(self, shape):
        fi, fo = _fan_in_out(shape)
        return (self.fan_in if self.fan_in is not None else fi,
                self.fan_out if self.fan_out is not None else fo)

    def __call__(self, shape, dtype, generator=None):
        fi, fo = self._fans(shape)
        limit = self.gain * math.sqrt(6.0 / max(fi + fo, 1))
        return _draw(shape, dtype, generator,
                     lambda o, g: o.uniform_(-limit, limit, generator=g))


class XavierNormal(XavierUniform):
    def __call__(self, shape, dtype, generator=None):
        fi, fo = self._fans(shape)
        std = self.gain * math.sqrt(2.0 / max(fi + fo, 1))
        return _draw(shape, dtype, generator,
                     lambda o, g: o.normal_(0.0, std, generator=g))


class KaimingUniform(Initializer):
    """MSRA init: uniform with limit ``gain * sqrt(3 / fan_in)``."""

    def __init__(self, fan_in: Optional[float] = None,
                 negative_slope: float = 0.0, nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def _fan(self, shape):
        return self.fan_in if self.fan_in is not None \
            else _fan_in_out(shape)[0]

    def __call__(self, shape, dtype, generator=None):
        limit = self._gain() * math.sqrt(3.0 / max(self._fan(shape), 1))
        return _draw(shape, dtype, generator,
                     lambda o, g: o.uniform_(-limit, limit, generator=g))


class KaimingNormal(KaimingUniform):
    def __call__(self, shape, dtype, generator=None):
        std = self._gain() / math.sqrt(max(self._fan(shape), 1))
        return _draw(shape, dtype, generator,
                     lambda o, g: o.normal_(0.0, std, generator=g))


class Assign(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, shape, dtype, generator=None):
        if tuple(self.value.shape) != tuple(shape):
            raise ValueError(f"Assign initializer shape {self.value.shape} "
                             f"!= requested {tuple(shape)}")
        return torch.as_tensor(self.value).to(dtype).clone()


class Orthogonal(Initializer):
    """``gain`` times a random orthogonal matrix over (prod(shape[:-1]),
    shape[-1]): the Q of a QR of a normal matrix, its columns signed by
    R's diagonal (the recipe of ``jax.nn.initializers.orthogonal``)."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, generator=None):
        shape = tuple(shape)
        if len(shape) < 2:
            raise ValueError("Orthogonal needs at least 2 dims")
        rows, cols = int(np.prod(shape[:-1])), shape[-1]
        a = _draw((max(rows, cols), min(rows, cols)), torch.float64,
                  generator, lambda o, g: o.normal_(generator=g))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        if rows < cols:
            q = q.t()
        return (self.gain * q).reshape(shape).to(dtype)


def calculate_gain(nonlinearity: str, param: Optional[float] = None) -> float:
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")


class Dirac(Initializer):
    """Identity-preserving conv init: out channel i passes in channel
    i % fan_in through at the kernel centre; groups partition the
    identity."""

    def __init__(self, groups: int = 1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype, generator=None):
        if len(shape) < 3:
            raise ValueError("Dirac needs a conv weight (>=3 dims)")
        out_c, in_c = shape[0], shape[1]
        if out_c % self.groups:
            raise ValueError("out_channels must divide by groups")
        w = np.zeros(shape, np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        per = out_c // self.groups
        for g in range(self.groups):
            for i in range(min(per, in_c)):
                w[(g * per + i, i) + centers] = 1.0
        return torch.from_numpy(w).to(dtype)


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for a transposed conv (the FCN
    upsampling filter)."""

    def __call__(self, shape, dtype, generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear needs a 4-D conv weight")
        kh, kw = shape[2], shape[3]
        fh, fw = (kh + 1) // 2, (kw + 1) // 2
        cy = (2 * fh - 1 - fh % 2) / (2.0 * fh)
        cx = (2 * fw - 1 - fw % 2) / (2.0 * fw)
        y = np.arange(kh).reshape(-1, 1)
        x = np.arange(kw).reshape(1, -1)
        filt = ((1 - np.abs(y / fh - cy))
                * (1 - np.abs(x / fw - cx))).astype(np.float32)
        w = np.zeros(shape, np.float32)
        for o in range(shape[0]):
            w[o, o % shape[1]] = filt
        return torch.from_numpy(w).to(dtype)


_global_initializer: Optional[Initializer] = None
_global_bias_initializer: Optional[Initializer] = None


def set_global_initializer(weight_init: Optional[Initializer],
                           bias_init: Optional[Initializer] = None):
    """Default weight and bias initializers for parameters created
    afterwards without one (``Layer.create_parameter``, ``Linear``)."""
    global _global_initializer, _global_bias_initializer
    _global_initializer = weight_init
    _global_bias_initializer = bias_init


def get_global_initializer() -> Optional[Initializer]:
    return _global_initializer


def get_global_bias_initializer() -> Optional[Initializer]:
    return _global_bias_initializer
