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
and ``categorical`` (with replacement), and for the samplers of the
flat tensor API and ``distribution``: ``_randint``, ``_shuffle``,
``_normal_real``, ``_bernoulli``, ``_exponential``, ``_gamma_one``
(Marsaglia-Tsang, in log space), ``_beta``, ``_dirichlet`` and
``_poisson`` (Knuth below rate 10, transformed rejection above).

The rejection samplers run JAX's per-element loops on every element at
once: each element keeps its own keys, and a mask holds the elements
that have accepted while the rest go on, until every element accepts.
Floats come out of the bits through ``core/xla_math.py``'s ``log``,
``log1p``, ``erfinv`` and ``exp`` and its fused multiply-adds, XLA's
own float32 arithmetic built from correctly rounded operations, so a
draw has the JAX package's bits and the same bits on the CPU and the
card. In the gamma sampler an expression whose contraction XLA leaves
open (two products summed) is guessed, and XLA's ``rsqrt`` starts from
a processor-specific estimate (``xla_math.rsqrt``), so a last-ulp
difference can flip an accept: the share of exactly equal draws is
measured (``tests/test_torch_distribution.py``).

uint32 values live in int64 tensors and are masked to 32 bits after
every add and shift, which works alike on the CPU and the GPU. A key is
a ``[..., 2]`` tensor; leading dimensions are a batch of keys.
"""

from __future__ import annotations

import math

import torch

from . import xla_math as _xm

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
    """``jax.random.split`` of one key into ``[num, 2]``; a batch of keys
    ``[..., 2]`` splits each into ``[..., num, 2]``, as ``jax.vmap(split)``
    does."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry_2x32(key[..., 0, None], key[..., 1, None],
                           torch.zeros_like(counts), counts)
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


# (random bits kept, mantissa bits, bits of 1.0, int view) by float type
_UNIFORM_BITS = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.float16: (16, 10, 0x3C00, torch.int16),
    torch.bfloat16: (8, 7, 0x3F80, torch.int16),
}


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None, rows=None, cols=None, dtype=torch.float32):
    """``jax.random.uniform``: random mantissa bits under the exponent
    of 1.0, shifted and scaled into [minval, maxval); on ``device`` and
    of ``rows`` / ``cols`` as in :func:`random_bits`. float32 keeps 23
    of 32 bits, float16 10 of the low 16 and bfloat16 7 of the low 8, as
    JAX does; float64 draws float32 (JAX runs with x64 off) and
    widens."""
    if dtype is torch.float64:
        return uniform(key, shape, minval, maxval, device, rows,
                       cols).double()
    nbits, nmant, one, view = _UNIFORM_BITS[dtype]
    bits = random_bits(key, shape, device, rows, cols)
    if nbits < 32:
        bits = bits & ((1 << nbits) - 1)
    float_bits = (bits >> (nbits - nmant)) | one
    floats = float_bits.to(view).view(dtype) - 1.0
    # filled on the device: a host scalar copied there would synchronize
    lo = torch.full((), minval, dtype=dtype, device=bits.device)
    hi = torch.full((), maxval, dtype=dtype, device=bits.device)
    # XLA contracts the scale and the shift into one FMA, which rounds
    # differently only when both do something (not the [0, 1) of dropout;
    # read on the host: the bounds are Python numbers)
    lo32 = torch.tensor(minval, dtype=torch.float32)
    if dtype is torch.float32 and lo32 != 0 and (
            torch.tensor(maxval, dtype=torch.float32) - lo32) != 1:
        return torch.maximum(lo, _xm.fma(floats, hi - lo, lo))
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


def normal(key, shape, device=None, dtype=torch.float32):
    """``jax.random.normal``: ``sqrt(2) erfinv(u)`` for ``u`` uniform in
    ``[nextafter(-1, 0), 1)``."""
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                         torch.tensor(0.0, dtype=dtype)).item()
    u = uniform(key, shape, lo, 1.0, device, dtype=dtype)
    erfinv = _xm.erfinv if dtype is torch.float32 else torch.erfinv
    return torch.as_tensor(math.sqrt(2), dtype=u.dtype) * erfinv(u)


def gumbel(key, shape, device=None):
    """``jax.random.gumbel`` in float32, ``mode="low"``."""
    return -_xm.log(-_xm.log(uniform(key, shape, _F32_TINY, 1.0, device)))


def categorical(key, logits):
    """``jax.random.categorical`` over the last axis (with replacement).
    A batch of keys ``[B, 2]`` draws one sample per row of ``logits``
    ``[B, V]``, as ``jax.vmap(categorical)`` does. The serving engine's
    sampler: its Gumbel noise takes torch's ``log`` (two kernels over a
    ``[B, V]`` tick, where :func:`gumbel`'s exact log takes dozens), so a
    last-ulp difference from JAX's noise can, rarely, move the argmax."""
    lead = key.dim() - 1
    u = uniform(key, logits.shape[lead:], _F32_TINY, 1.0)
    return torch.argmax(-torch.log(-torch.log(u)) + logits.to(torch.float32),
                        dim=-1)


def categorical_shaped(key, logits, shape=None):
    """``jax.random.categorical(key, logits, shape=shape)`` over the last
    axis of ``logits``: ``shape`` ends with ``logits.shape[:-1]`` and
    its leading dims draw that many independent samples."""
    batch = tuple(logits.shape[:-1])
    shape = batch if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch)]
    g = gumbel(key, prefix + shape[len(prefix):] + (logits.shape[-1],),
               logits.device)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def exponential(key, shape, device=None, dtype=torch.float32):
    """``jax.random.exponential``: ``-log1p(-u)``."""
    u = uniform(key, shape, device=device, dtype=dtype)
    return -(_xm.log1p(-u) if dtype is torch.float32 else torch.log1p(-u))


def bernoulli(key, p, shape=None):
    """``jax.random.bernoulli`` (``mode="low"``): ``u < p`` for ``u``
    uniform in p's float dtype."""
    shape = tuple(p.shape) if shape is None else tuple(shape)
    return uniform(key, shape, device=p.device, dtype=p.dtype) < p


def shuffle(key, n: int, device=None):
    """``jax.random.permutation(key, n)`` (``_shuffle``): rounds of stable
    sorts of ``arange(n)`` by fresh 32-bit keys from split keys, as many
    rounds as ``ceil(3 ln n / ln(2**32 - 1))``."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_MASK))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,), device),
                           stable=True).indices
        x = x[order]
    return x


def _split_each(keys, num):
    """Each key of ``keys [n, 2]`` split into ``num``: a tuple of ``num``
    ``[n, 2]`` key batches."""
    out = split(keys, num)
    return tuple(out[:, i] for i in range(num))


def loggamma(key, alpha):
    """``jax.random.loggamma(key, alpha)`` for a float32 ``alpha`` of the
    sample's shape: Marsaglia and Tsang's method, alpha < 1 boosted to
    alpha + 1 and corrected by ``log(u) / alpha``, on element ``i``'s key
    ``split(key, alpha.numel())[i]``. Every element runs JAX's two
    nested loops; an element leaves a loop once it accepts."""
    shape, dev = alpha.shape, alpha.device
    a = alpha.reshape(-1).to(torch.float32)
    n = a.numel()
    if n == 0:
        return alpha.to(torch.float32)
    keys = split(key.to(dev), n)                        # [n, 2]
    keys, sub = _split_each(keys, 2)
    one = torch.ones((), dtype=torch.float32, device=dev)
    third = torch.tensor(1.0 / 3.0, dtype=torch.float32, device=dev)
    boost = a >= one
    a_b = torch.where(boost, a, a + one)
    d = a_b - third
    c = _xm.rsqrt(d) * third     # XLA's rewrite of third / sqrt(d)
    X = torch.zeros(n, dtype=torch.float32, device=dev)
    V = torch.ones(n, dtype=torch.float32, device=dev)
    U = torch.full((n,), 2.0, dtype=torch.float32, device=dev)

    def again(X, V, U, d):
        return (U >= _xm.fma(X * X, -0.0331, one)) & (
            _xm.log(U) >= _xm.fma(d, (one - V) + _xm.log(V), X * 0.5))

    live = torch.arange(n, device=dev)
    while live.numel():
        k, xk, uk = _split_each(keys[live], 3)
        keys[live] = k
        cl = c[live]
        x = torch.zeros(live.numel(), dtype=torch.float32, device=dev)
        v = torch.full_like(x, -1.0)
        inner = torch.arange(live.numel(), device=dev)
        while inner.numel():
            xk_i, s = _split_each(xk[inner], 2)
            xk[inner] = xk_i
            xi = normal(s, ())
            x[inner] = xi
            v[inner] = _xm.fma(xi, cl[inner], one)
            inner = inner[v[inner] <= 0]
        X[live] = x * x
        V[live] = v * v * v
        U[live] = uniform(uk, ())
        live = live[again(X[live], V[live], U[live], d[live])]
    log_samples = -exponential(sub, ())
    log_boost = torch.where(boost | (log_samples == 0),
                            torch.zeros_like(a),
                            log_samples * (one / a))
    return (_xm.log(d) + _xm.log(V) + log_boost).reshape(shape)


def beta(key, a, b, shape):
    """``jax.random.beta``: two log-gamma draws on split keys, combined
    without losing precision."""
    ka, kb = split(key)
    la = loggamma(ka, torch.broadcast_to(a, shape).to(torch.float32))
    lb = loggamma(kb, torch.broadcast_to(b, shape).to(torch.float32))
    m = torch.maximum(la, lb)
    ea, eb = _xm.exp(la - m), _xm.exp(lb - m)
    return ea / (ea + eb)


def dirichlet(key, alpha, shape):
    """``jax.random.dirichlet``: a softmax of log-gamma draws of
    ``shape + alpha.shape[-1:]``."""
    lg = loggamma(key, torch.broadcast_to(
        alpha, tuple(shape) + tuple(alpha.shape[-1:])).to(torch.float32))
    e = _xm.exp(lg - lg.amax(-1, keepdim=True))
    # the sum left to right, as XLA reduces a short axis: torch's CUDA
    # reduction adds in another order
    total = e[..., 0]
    for i in range(1, e.shape[-1]):
        total = total + e[..., i]
    return e / total[..., None]


_INT32_MAX = 2 ** 31 - 1


def _poisson_knuth(key, lam):
    dev = lam.device
    k = torch.zeros(lam.shape, dtype=torch.int32, device=dev)
    log_prod = torch.zeros(lam.shape, dtype=torch.float32, device=dev)
    i = 0
    while bool((log_prod > -lam).any()) and i < _INT32_MAX:
        key, sub = split(key)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + _xm.log(uniform(sub, lam.shape, device=dev))
        i += 1
    return k - 1


def _poisson_rejection(key, lam):
    dev = lam.device
    log_lam = _xm.log(lam)
    b = _xm.fma(_xm.sqrt(lam), 2.53, 0.931)
    a = _xm.fma(b, 0.02483, -0.059)
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(lam.shape, -1.0, dtype=torch.float32, device=dev)
    accepted = torch.zeros(lam.shape, dtype=torch.bool, device=dev)
    i = 0
    while not bool(accepted.all()) and i < _INT32_MAX:
        key, s0, s1 = split(key, 3)
        u = uniform(s0, lam.shape, device=dev) - 0.5
        v = uniform(s1, lam.shape, device=dev)
        us = 0.5 - torch.abs(u)
        k = torch.floor(_xm.fma(2 * a / us + b, u, lam) + 0.43)
        s = _xm.log(v * inv_alpha / (a / (us * us) + b))
        t = _xm.fma(k, log_lam, -lam) - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
        i += 1
    return k_out


def poisson(key, lam):
    """``jax.random.poisson(key, lam)`` (int32) for a float32 ``lam``:
    Knuth's product of uniforms below rate 10, Hormann's transformed
    rejection from 10 up, both loops over the whole array on the same
    key, as JAX runs them."""
    lam = lam.to(torch.float32)
    knuth = torch.isnan(lam) | (lam < 10)
    lk = torch.where(knuth, lam, torch.zeros_like(lam))
    lr = torch.where(knuth, torch.full_like(lam, 1e5), lam)
    out = torch.where(knuth, _poisson_knuth(key, lk),
                      _poisson_rejection(key, lr).to(torch.int32))
    return torch.where(lam == 0, torch.zeros_like(out), out)
