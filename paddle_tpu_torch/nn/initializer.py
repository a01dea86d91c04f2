"""Parameter initializers (the subset the GPT uses) of
``paddle_tpu/nn/initializer.py``.

An initializer is a callable ``init(shape, dtype, generator=None)``
returning a CPU tensor. Random ones draw from ``generator``, by default
the global one that :func:`paddle_tpu_torch.seed` sets, so a seed gives
the same weights whatever device the module moves to afterwards.
"""

from __future__ import annotations

import math

import torch

from ..core import rng


class Initializer:
    def __call__(self, shape, dtype, generator=None) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None):
        g = generator if generator is not None else rng.generator()
        out = torch.empty(tuple(shape), dtype=torch.float32)
        out.normal_(self.mean, self.std, generator=g)
        return out.to(dtype)


class XavierUniform(Initializer):
    """Glorot uniform over a ``[fan_in, fan_out]`` weight (the default
    of ``Linear`` when no initializer is given)."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, generator=None):
        fan_in, fan_out = (shape[0], shape[-1]) if len(shape) > 1 \
            else (shape[0], shape[0])
        limit = self.gain * math.sqrt(6.0 / max(fan_in + fan_out, 1))
        g = generator if generator is not None else rng.generator()
        out = torch.empty(tuple(shape), dtype=torch.float32)
        out.uniform_(-limit, limit, generator=g)
        return out.to(dtype)
