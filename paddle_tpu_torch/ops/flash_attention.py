"""Flash attention (the port's counterpart of
``paddle_tpu/ops/flash_attention.py``).

:func:`flash_attention` takes and returns BSHD tensors
(``[batch, seq, heads, head_dim]``) and is differentiable: a
``torch.autograd.Function`` takes the place of the JAX package's
``custom_vjp``. Its forward runs kernel B1 (``(o, lse)``), its backward
kernels B2 (dQ) and B3 (dK, dV) from the saved ``(q, k, v, o, lse)``.
The three kernels are hand-written CUDA for sm_90a
(``csrc/flash_attention.cu``); each wrapper launches its kernel for a
CUDA tensor and runs the plain twin (:func:`flash_attention_fwd_torch`,
:func:`flash_attention_bwd_torch`: dense ``[sq, sk]`` scores with the
same mask and the same casts) for a CPU tensor. Setting the module
attribute ``impl`` to ``"plain"`` runs the twins on any device, so that
a run on the card can be compared with its kernels.

The kernels read q/k/v through their (b, s, h) strides, so the strided
views GPT's attention cuts from its fused qkv projection are not copied.
Every head dim that is a multiple of 8 runs in a kernel
(:func:`kernel_route` picks it from dtype and shape before the launch):
in bfloat16 and float16 up to 128, B1, B2 and B3 are Hopper kernels
(TMA loads through a ring of shared-memory stages, ``wgmma`` from
consumer warpgroups of 64 rows each); from 136 to 256 they run on the
tensor cores with ``mma.sync``; all of them at a padded head dim D
(tiles loaded with zeros in columns d..D-1, which change neither QK^T
nor the written columns, and stored in columns < d only); float32, and
the half types above 256, run the SIMT kernels, which sum the score
tiles over d in 64- or 128-column slices, so their shared memory does
not grow with d. B2 and B3 read delta = rowsum(O dO) from a buffer that
the backward computes once. The kernels take any sequence lengths, as
the TPU kernel does (it tiles down to blocks of 1): they tile by 64 rows
and mask a partial last tile.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.utils.flop_counter

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# launches of kernels B1, B2 and B3 since the last reset; each wrapper adds
# one per launch and nothing else touches them but a caller's reset to 0
launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}

# dtype codes of csrc/flash_attention.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FWD, _BWD_DQ, _BWD_DKV = 0, 1, 2
# design codes of csrc/flash_attention.cu
_DESIGN_CODES = {"simt": 0, "split": 0, "mma": 1, "wgmma": 2}
_launcher = None

# "kernel": CUDA tensors launch B1-B3; "plain": the twins run everywhere
impl = "kernel"


def kernel_route(d: int, dtype: torch.dtype):
    """``(design, D)``: the kernels B1, B2 and B3 that run head dim ``d``
    in ``dtype`` and the head dim D they are built at. ``"wgmma"``: the
    Hopper kernels (TMA, wgmma) at D = 64 or 128 >= d (bfloat16 and
    float16 up to 128); ``"mma"``: the ``mma.sync`` kernels at D = 256
    (bfloat16 and float16 from 136 to 256, where a Hopper consumer's
    registers would not hold the accumulators); ``"simt"``: the float32
    SIMT kernels at D = 64 or 128 >= d; ``"split"``: the SIMT kernels
    at D = 64 summing over d in 64-column slices (float32 above 128,
    the half types above 256). None for a d that is not a positive
    multiple of 8 (rows of whole 16-byte chunks), which
    ``flash_attention_available`` never admits."""
    if d <= 0 or d % 8:
        return None
    if dtype != torch.float32 and d <= 256:
        D = next(D for D in (64, 128, 256) if d <= D)
        return ("wgmma" if D <= 128 else "mma"), D
    if dtype == torch.float32 and d <= 128:
        return "simt", 64 if d <= 64 else 128
    return "split", 64


def _pick_block(seq: int, target: int) -> int:
    """Largest power-of-two divisor of ``seq`` that is <= target."""
    b = 1
    while b * 2 <= min(seq, target) and seq % (b * 2) == 0:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def _scores(q, k, sm_scale, causal):
    """f32 scores [b, hq, sq, sk] with the bottom-right causal mask at the
    kernels' finite mask value; k/v heads expanded over the GQA group."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        seen = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        s = s.masked_fill(~seen, DEFAULT_MASK_VALUE)
    return s


def _expand_kv(x, hq):
    group = hq // x.shape[2]
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def flash_attention_fwd_torch(q, k, v, sm_scale: float, causal: bool):
    """Plain twin of kernel B1: ``(o, lse)``, o [b, sq, hq, d] in q's
    dtype and lse [b, hq, sq] f32. P is rounded to v's dtype before P.V,
    as the kernel does."""
    hq = q.shape[2]
    k, v = _expand_kv(k, hq), _expand_kv(v, hq)
    s = _scores(q, k, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = pv / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_torch(q, k, v, o, lse, do, sm_scale: float,
                              causal: bool):
    """Plain twin of kernels B2 and B3: ``(dq, dk, dv)`` in the dtypes of
    q, k and v. P = exp(S - lse) stays f32 (no rounding in the
    backward); delta = rowsum(o * do) from the stored o; dK and dV are
    summed over the GQA group before the cast."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    kf, vf = _expand_kv(k, hq), _expand_kv(v, hq)
    s = _scores(q, kf, sm_scale, causal)
    p = torch.exp(s - lse[..., None])                          # [b,h,q,k]
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf.float())
    delta = (o.float() * dof).sum(dim=-1).permute(0, 2, 1)     # [b,h,q]
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if hkv != hq:
        sk = k.shape[1]
        dk = dk.reshape(b, sk, hkv, hq // hkv, d).sum(dim=3)
        dv = dv.reshape(b, sk, hkv, hq // hkv, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels B1, B2, B3 (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

def _load_launcher():
    global _launcher
    if _launcher is None:
        fn = _kernels.library("flash_attention").flash_attention_launch
        i = ctypes.c_int
        fn.argtypes = [i, i, i, i, i, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i,
                       ctypes.c_float, i, i, ctypes.c_void_p]
        fn.restype = i
        _launcher = fn
    return _launcher


def _check_cuda_args(q, k, v, *more):
    """Raise on what the kernels do not take."""
    dev = q.device
    for x in (q, k, v, *more):
        if x.device != dev:
            raise ValueError(f"flash attention operands must all be on "
                             f"{dev}, got {x.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [b, sq, hq, d] and matching k/v [b, sk, hkv, "
                         f"d] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one of float32/bfloat16/"
                         f"float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kernel_route(d, q.dtype) is None:
        raise NotImplementedError(
            f"the flash kernels take head dims that are positive multiples "
            f"of 8, got {d}")
    for x in (q, k, v, *more):
        if x.stride(-1) != 1:
            raise ValueError("flash attention operands need unit stride "
                             "on the head dim")


def _strides(x):
    return list(x.stride()[:3]) if x is not None else [0, 0, 0]


def _aligned(x):
    """Input ``x`` itself if its rows start on 16 bytes (the kernels copy
    whole 16-byte chunks; TMA takes such strides only) and no dimension
    longer than 1 repeats rows (stride 0), else a contiguous copy."""
    if x is None or (x.data_ptr() % 16 == 0 and all(
            st * x.element_size() % 16 == 0 and (st or n == 1)
            for st, n in zip(x.stride()[:3], x.shape[:3]))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _launch(which, q, k, v, o, do, lse, delta, dq, dk, dv, sm_scale,
            causal, delta_ready=False):
    fn = _load_launcher()
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    if which != _FWD:   # B1 writes o, B2 and B3 read it
        o = _aligned(o)
    ptrs = (ctypes.c_void_p * 10)(*[
        None if x is None else x.data_ptr()
        for x in (q, k, v, o, do, lse, delta, dq, dk, dv)])
    st = sum((_strides(x) for x in (q, k, v, o, do, dq, dk, dv)), [])
    strides = (ctypes.c_longlong * 24)(*st)
    b, sq, hq, d = q.shape
    design, padded = kernel_route(d, q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(which, _DESIGN_CODES[design], _DTYPE_CODES[q.dtype], d, padded,
             ptrs, strides, b, sq, k.shape[1], hq, k.shape[2],
             float(sm_scale), int(causal), int(delta_ready), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel {which} launch failed: "
                           f"cudaError {err}")


def _matmul_flops(q_shape, k_shape, matmuls: int) -> float:
    """FLOPs of ``matmuls`` products of [sq, d] by [d, sk] for every
    batch row and query head: the count of torch's SDPA formulas (the
    causal mask is not discounted)."""
    b, sq, hq, d = q_shape
    return 2.0 * matmuls * b * hq * sq * k_shape[1] * d


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def _fwd_launch(q, k, v, sm_scale: float, causal: bool):
    """B1 on CUDA tensors: checks, launch, count."""
    _check_cuda_args(q, k, v)
    b, sq, hq, d = q.shape
    o = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    _launch(_FWD, q, k, v, o, None, lse, None, None, None, None, sm_scale,
            causal)
    launches["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_fwd_kernel(q, k, v, sm_scale: float, causal: bool):
    """Kernel B1: ``(o, lse)``, the contract of
    :func:`flash_attention_fwd_torch`. A CUDA tensor launches the kernel
    (raising on what it does not take, or on a failed launch) and
    reports its work to a counting ``cost_model``; a CPU tensor runs the
    plain twin."""
    if not q.is_cuda:
        return flash_attention_fwd_torch(q, k, v, sm_scale, causal)
    o, lse = _fwd_launch(q, k, v, sm_scale, causal)
    _kernels.report_cost("flash_attention_fwd",
                         _matmul_flops(q.shape, k.shape, 2),
                         _nbytes(q, k, v, o, lse))
    return o, lse


def _check_residuals(q, o, lse, do):
    b, sq, hq, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError("o and do must match q's shape (and o its dtype)")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) or \
            not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous f32 [{b}, {hq}, {sq}]")
    if do.dtype != q.dtype:
        raise ValueError(f"do must be {q.dtype}, got {do.dtype}")


def _delta_buffer(q, lse, delta):
    if delta is None:
        return torch.empty_like(lse)
    if delta.dtype != torch.float32 or delta.shape != lse.shape or \
            delta.device != q.device or not delta.is_contiguous():
        raise ValueError(f"delta must be a contiguous f32 "
                         f"{list(lse.shape)} on {q.device}")
    return delta


def flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, sm_scale: float,
                                  causal: bool, delta=None,
                                  delta_ready: bool = False):
    """Kernel B2: dQ in q's dtype (the first output of
    :func:`flash_attention_bwd_torch`, which a CPU tensor runs). On the
    card a first kernel computes delta = rowsum(O dO) [b, hq, sq] in
    float32; into ``delta`` if it is given, so that B3 can read it. With
    ``delta_ready``, ``delta`` already holds it (an earlier launch on the
    same o and dO wrote it: the ring's blocks share one) and B2 reads
    it."""
    if not q.is_cuda:
        return flash_attention_bwd_torch(q, k, v, o, lse, do, sm_scale,
                                         causal)[0]
    _check_cuda_args(q, k, v, o, do, lse)
    _check_residuals(q, o, lse, do)
    if delta_ready and delta is None:
        raise ValueError("delta_ready needs the delta buffer")
    delta = _delta_buffer(q, lse, delta)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(_BWD_DQ, q, k, v, o, do, lse, delta, dq, None, None, sm_scale,
            causal, delta_ready=delta_ready)
    launches["flash_attention_bwd_dq"] += 1
    # S recomputed, dP = dO V^T and dQ = dS K: three products
    _kernels.report_cost("flash_attention_bwd_dq",
                         _matmul_flops(q.shape, k.shape, 3),
                         _nbytes(q, k, v, o, lse, do, delta, dq))
    return dq


def flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, sm_scale: float,
                                   causal: bool, delta=None):
    """Kernel B3: ``(dk, dv)`` in k's and v's dtype, summed over the GQA
    group (the last two outputs of :func:`flash_attention_bwd_torch`,
    which a CPU tensor runs). ``delta``: rowsum(O dO) as B2 wrote it;
    if None, a first kernel computes it."""
    if not q.is_cuda:
        return flash_attention_bwd_torch(q, k, v, o, lse, do, sm_scale,
                                         causal)[1:]
    _check_cuda_args(q, k, v, o, do, lse)
    _check_residuals(q, o, lse, do)
    ready = delta is not None
    delta = _delta_buffer(q, lse, delta)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch(_BWD_DKV, q, k, v, o, do, lse, delta, None, dk, dv, sm_scale,
            causal, delta_ready=ready)
    launches["flash_attention_bwd_dkv"] += 1
    # dK = dS^T Q and dV = P^T dO; the S and dP it recomputes are
    # counted once, in B2, as the plain backward computes them once
    _kernels.report_cost("flash_attention_bwd_dkv",
                         _matmul_flops(q.shape, k.shape, 2),
                         _nbytes(q, k, v, o, lse, do, delta, dk, dv))
    return dk, dv


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """forward -> B1; backward -> B2 + B3 from (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, plain):
        if plain:
            o, lse = flash_attention_fwd_torch(q, k, v, sm_scale, causal)
        else:
            o, lse = flash_attention_fwd_kernel(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.sm_scale, ctx.causal, ctx.plain = sm_scale, causal, plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        args = (q, k, v, o, lse, do.contiguous(), ctx.sm_scale, ctx.causal)
        if ctx.plain or not q.is_cuda:
            dq, dk, dv = flash_attention_bwd_torch(*args)
        else:
            delta = torch.empty_like(lse)   # B2 writes it, B3 reads it
            dq = flash_attention_bwd_dq_kernel(*args, delta=delta)
            dk, dv = flash_attention_bwd_dkv_kernel(*args, delta=delta)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# kernel B1 as a registered op (what torch.export records)
# ---------------------------------------------------------------------------

@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, sm_scale: float,
                           causal: bool) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Kernel B1 as the op ``torch.ops.paddle_tpu_torch.
    flash_attention_fwd``: ``(o, lse)``. A program that
    ``torch.export`` traced through :func:`flash_attention` records this
    op, not the twin's math, so the loaded program launches B1 on the
    card (and adds to ``launches`` each call); on the CPU it runs the
    twin, as the wrappers do. ``impl = "plain"`` runs the twin on the
    card too."""
    return flash_attention_fwd_torch(q, k, v, sm_scale, causal)


@flash_attention_fwd_op.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, sm_scale, causal):
    if impl == "plain":
        return flash_attention_fwd_torch(q, k, v, sm_scale, causal)
    return _fwd_launch(q, k, v, sm_scale, causal)


@flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, sm_scale, causal):
    b, sq, hq, d = q.shape
    return (q.new_empty((b, sq, hq, d)),
            q.new_empty((b, hq, sq), dtype=torch.float32))


@torch.utils.flop_counter.register_flop_formula(
    torch.ops.paddle_tpu_torch.flash_attention_fwd)
def _flash_attention_fwd_flops(q_shape, k_shape, v_shape, sm_scale, causal,
                               *args, out_shape=None, **kwargs) -> int:
    return int(_matmul_flops(q_shape, k_shape, 2))


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 512):
    """Memory-efficient attention. q: [b, s_q, h, d]; k/v: [b, s_k, h_kv,
    d] with h % h_kv == 0 (grouped-query). Returns [b, s_q, h, d].

    Differentiable (B1 forward, B2 + B3 backward); under
    ``torch.export`` the forward is the op
    :func:`flash_attention_fwd_op`. ``block_q`` and
    ``block_k`` are the TPU kernel's block targets, kept for the JAX
    package's signature: the CUDA kernels tile by 64 rows (any ``s_q``,
    ``s_k``), and the result does not depend on the tiling."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq % hkv != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if causal and sq > sk:
        raise ValueError(
            f"causal flash attention requires s_q <= s_k, got {sq} > {sk}: "
            "leading query rows would have no visible keys")
    sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if impl not in ("kernel", "plain"):
        raise ValueError(f"flash_attention.impl must be 'kernel' or "
                         f"'plain', got {impl!r}")
    if torch.compiler.is_exporting():
        # an exported forward records B1 as one op (no backward)
        return flash_attention_fwd_op(q, k, v, sm_scale, causal)[0]
    plain = impl == "plain"
    return _FlashAttention.apply(q, k, v, sm_scale, causal, plain)


def flash_attention_available(q_shape, k_shape, attn_mask, dropout_p,
                              training, is_causal: bool = False) -> bool:
    """Whether the flash path handles this configuration (the JAX
    package's rules, unchanged, except in a program ``torch.export``
    traces: there every length takes B1)."""
    if attn_mask is not None:
        return False
    if dropout_p > 0.0 and training:
        return False
    if len(q_shape) != 4:
        return False
    b, sq, hq, d = q_shape
    sk, hkv = k_shape[1], k_shape[2]
    if hq % hkv != 0:
        return False
    if is_causal and sq > sk:
        return False
    if torch.compiler.is_exporting():
        # an exported program takes any length (its sequence dims are
        # symbolic), and so do the CUDA kernels: the TPU kernel's block
        # rule below is not applied to it
        return d >= 64 and d % 8 == 0
    return (d >= 64 and d % 8 == 0 and
            _pick_block(sq, 512) >= 128 and _pick_block(sk, 512) >= 128)
