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


def random_bits(key, shape, device=None, rows=None, cols=None):
    """32-bit random bits of ``shape`` for each key of the batch
    ``key.shape[:-1]``: the result is ``key.shape[:-1] + shape``, on
    ``device`` (the key's by default). One host key drawing bits on
    another device enters the hash as two host ints, so no copy of it
    reaches the device (a blocking copy would sync the host).

    ``rows`` ``(first, total)``: ``shape`` is rows ``first ..
    first + shape[0]`` of an array of ``total`` rows, and the bits are
    those rows of that array's bits; ``first`` may be a tuple of block
    starts (the leading dim is that many equal blocks of rows). With ``jax_threefry_partitionable``
    an element's bits hash its flat index in the whole shape, so a
    data-parallel rank draws its rows of the global mask without
    drawing the rest. ``cols`` ``(first, total)`` does the same for
    dim 1 (a tensor-parallel rank's heads of an attention mask): the
    flat indices of such a slice are not contiguous, and only the
    slice's are hashed."""
    shape = tuple(shape)
    n = math.prod(shape)
    device = key.device if device is None else torch.device(device)
    r0, nrows = (0, shape[0] if shape else 1) if rows is None else rows
    if isinstance(r0, tuple):   # blocks of rows: their global indices
        per = shape[0] // len(r0)
        row_idx = torch.cat([torch.arange(f, f + per, dtype=torch.int64,
                                          device=device) for f in r0])
    else:
        row_idx = None
    c0, ncols = (0, shape[1] if len(shape) > 1 else 1) if cols is None \
        else cols
    if cols is not None and len(shape) < 2:
        raise ValueError("cols slices dim 1 of a shape of two or more dims")
    inner = math.prod(shape[2:]) if len(shape) > 1 else 1
    total = int(nrows) * (int(ncols) * inner if len(shape) > 1 else
                          math.prod(shape[1:]))
    if total >= 2 ** 32:
        raise NotImplementedError("random bits past 2**32 elements")
    if cols is None and row_idx is None:
        per_row = math.prod(shape[1:])
        offset = int(r0) * per_row
        counts = torch.arange(offset, offset + n, dtype=torch.int64,
                              device=device).reshape(shape)
    elif cols is None:
        per_row = math.prod(shape[1:])
        counts = (row_idx.reshape((-1,) + (1,) * (len(shape) - 1))
                  * per_row + torch.arange(
                      per_row, dtype=torch.int64,
                      device=device).reshape(shape[1:])).reshape(shape)
    else:
        r = row_idx if row_idx is not None else torch.arange(
            shape[0], dtype=torch.int64, device=device) + r0
        c = torch.arange(shape[1], dtype=torch.int64, device=device) + c0
        base = (r[:, None] * int(ncols) + c[None, :]) * inner
        counts = (base[:, :, None] + torch.arange(
            inner, dtype=torch.int64, device=device)).reshape(shape)
    if key.device != device:
        if key.dim() != 1:
            raise ValueError("a batch of keys draws on the keys' device")
        k1, k2 = key.tolist()
    else:
        lead = key.shape[:-1]
        k1 = key[..., 0].reshape(lead + (1,) * len(shape))
        k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    y1, y2 = threefry_2x32(k1, k2, torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, rows=None, cols=None):
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, shifted and scaled into [minval, maxval); on
    ``device`` and of ``rows`` / ``cols`` as in :func:`random_bits`."""
    bits = random_bits(key, shape, device, rows, cols)
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key, shape, minval: int, maxval: int, device=None):
    """``jax.random.randint`` in int32 for ``minval < maxval`` within
    int32: two 32-bit draws on the key's two halves, the high one's
    remainder times ``2**32 % span`` plus the low one's, modulo the span,
    in wrapping uint32 arithmetic."""
    k1, k2 = split(key)
    span = (int(maxval) - int(minval)) & _MASK
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    mult = (2 ** 16 % span) * (2 ** 16 % span) % 2 ** 32 % span
    off = ((hi % span) * mult & _MASK) + (lo % span) & _MASK
    return (int(minval) + off % span).to(torch.int32)


def normal(key, shape, device=None):
    """``jax.random.normal`` in float32: ``sqrt(2) erfinv(u)`` for ``u``
    uniform in ``[nextafter(-1, 0), 1)``."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    return math.sqrt(2) * torch.erfinv(uniform(key, shape, lo, 1.0, device))


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
