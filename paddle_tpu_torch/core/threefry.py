"""JAX's threefry2x32 sampling recipe on torch integer tensors.

The JAX engine keys every sampled token on
``fold_in(fold_in(PRNGKey(seed), nonce), position)`` and draws it with
``jax.random.categorical`` (``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``). Porting the recipe bit for bit
keeps ``temperature > 0`` streams token-identical to the JAX engine.

Sources, in ``jax/_src`` of jax 0.9.0: ``prng.py`` ``threefry_2x32``
(the hash), ``threefry_seed``, ``threefry_fold_in``,
``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``;
``random.py`` ``_uniform``, ``_gumbel`` (the default ``mode="low"``)
and ``categorical`` (with replacement).

uint32 values live in int64 tensors and are masked to 32 bits after
every add and shift, which works alike on the CPU and the GPU. A key is
a ``[..., 2]`` tensor; leading dimensions are a batch of keys.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of the count pair ``(x1, x2)`` under key
    ``(k1, k2)``; all four broadcast elementwise."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for ``0 <= seed < 2**31``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: ``data`` (int) broadcasts against the
    key batch ``key.shape[:-1]``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    y1, y2 = threefry_2x32(key[..., 0], key[..., 1],
                           torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(key, num: int = 2):
    """``jax.random.split`` of one key into ``[num, 2]``."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry_2x32(key[0], key[1], torch.zeros_like(counts),
                           counts)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key, shape):
    """32-bit random bits of ``shape`` for each key of the batch
    ``key.shape[:-1]``: the result is ``key.shape[:-1] + shape``."""
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("random bits past 2**32 elements")
    counts = torch.arange(n, dtype=torch.int64,
                          device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    y1, y2 = threefry_2x32(k1, k2, torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, shifted and scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape):
    """``jax.random.gumbel`` in float32, ``mode="low"``."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis (with replacement).
    A batch of keys ``[B, 2]`` draws one sample per row of ``logits``
    ``[B, V]``, as ``jax.vmap(categorical)`` does."""
    lead = key.dim() - 1
    g = gumbel(key, logits.shape[lead:])
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
