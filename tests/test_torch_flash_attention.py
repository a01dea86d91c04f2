"""The port's flash attention (plain twins of kernels B1-B3, the
autograd Function, the dispatch rules) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, at the shapes
of tests/test_flash_attention.py.

Tolerances: float32 2e-5 for the forward and 5e-5 for gradients, the
JAX package's own kernel-vs-dense tolerances (the twins are dense, the
Pallas kernels tile with an online softmax: the two differ in summation
order only). bfloat16 3e-2: both sides round P to bf16 before P.V, but
relative to different running maxima, and round O, dQ, dK, dV to bf16.

The kernels themselves run only on the card: the tests marked ``cuda``
skip without one. On the card's machine, which has no JAX, run them
alone: ``python -m pytest -m cuda --noconftest
tests/test_torch_flash_attention.py``."""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.core import flags as tflags  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

try:
    import jax
    import jax.numpy as jnp
    # the package re-exports a function under the module's name
    jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
    from paddle_tpu.nn import functional as JF
except ImportError:
    # the card's machine has no JAX; it runs only the cuda-marked tests
    jax = jnp = jfa = JF = None

TOL_F32_FWD = 2e-5
TOL_F32_GRAD = 5e-5
TOL_BF16 = 3e-2

# (q shape, k/v shape, causal, dtype)
FWD_CASES = {
    "mha": ((2, 256, 4, 64), (2, 256, 4, 64), False, "float32"),
    "mha-causal": ((2, 256, 4, 64), (2, 256, 4, 64), True, "float32"),
    "gqa-causal": ((1, 128, 8, 64), (1, 128, 2, 64), True, "float32"),
    "cross": ((1, 128, 2, 64), (1, 256, 2, 64), False, "float32"),
    "cross-causal": ((1, 128, 2, 64), (1, 256, 2, 64), True, "float32"),
    "bf16-causal": ((1, 128, 2, 64), (1, 128, 2, 64), True, "bfloat16"),
    # head dims the kernels run padded to 128
    "d80-causal": ((1, 128, 2, 80), (1, 128, 2, 80), True, "float32"),
    "d96-gqa": ((1, 128, 4, 96), (1, 128, 2, 96), False, "float32"),
}
GRAD_CASES = {
    "mha": ((1, 128, 2, 64), (1, 128, 2, 64), False, "float32"),
    "mha-causal": ((1, 128, 2, 64), (1, 128, 2, 64), True, "float32"),
    "gqa-causal": ((1, 128, 4, 64), (1, 128, 2, 64), True, "float32"),
    "cross-causal": ((1, 128, 2, 64), (1, 256, 2, 64), True, "float32"),
    "bf16-causal": ((1, 128, 2, 64), (1, 128, 2, 64), True, "bfloat16"),
    "d80-causal": ((1, 128, 2, 80), (1, 128, 2, 80), True, "float32"),
    "d96-gqa-causal": ((1, 128, 4, 96), (1, 128, 2, 96), True, "float32"),
}


def _inputs(qs, ks, dtype, seed=0):
    """q, k, v as numpy float32, rounded once to ``dtype``."""
    r = np.random.RandomState(seed)
    arrs = [r.randn(*qs), r.randn(*ks), r.randn(*ks)]
    return [np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
            for a in arrs]


def _torch(arrs, dtype, requires_grad=False):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            .requires_grad_(requires_grad) for a in arrs]


def _tol(dtype, grad=False):
    if dtype == "bfloat16":
        return TOL_BF16
    return TOL_F32_GRAD if grad else TOL_F32_FWD


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_forward_matches_pallas_interpret(case):
    qs, ks, causal, dtype = FWD_CASES[case]
    arrs = _inputs(qs, ks, dtype)
    want = jfa.flash_attention(*[jnp.asarray(a, dtype) for a in arrs],
                               causal=causal, interpret=True)
    got = tfa.flash_attention(*_torch(arrs, dtype), causal=causal)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", ["mha-causal", "gqa-causal",
                                  "cross-causal"])
def test_lse_matches_pallas_interpret(case):
    """The twin's log-sum-exp against the TPU kernel's lane-replicated
    residual ([b, h, s, 128] there, [b, h, s] here)."""
    qs, ks, causal, dtype = FWD_CASES[case]
    arrs = _inputs(qs, ks, dtype, seed=1)
    scale = 1.0 / math.sqrt(qs[-1])
    qt, kt, vt = [jnp.asarray(a).transpose(0, 2, 1, 3) for a in arrs]
    _, want = jfa._fwd(qt, kt, vt, scale, causal, 128, 128, True)
    _, got = tfa.flash_attention_fwd_torch(*_torch(arrs, dtype), scale,
                                           causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               atol=TOL_F32_FWD, rtol=TOL_F32_FWD)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grads_match_pallas_interpret(case):
    """jax.grad through the Pallas custom_vjp (B2 + B3 in interpret
    mode) against backward() through the port's Function, with the
    non-trivial cotangent of tests/test_flash_attention.py."""
    qs, ks, causal, dtype = GRAD_CASES[case]
    arrs = _inputs(qs, ks, dtype, seed=2)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o * jnp.cos(o))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *[jnp.asarray(a, dtype) for a in arrs])
    q, k, v = _torch(arrs, dtype, requires_grad=True)
    o = tfa.flash_attention(q, k, v, causal=causal)
    (o * torch.cos(o)).sum().backward()
    tol = _tol(dtype, grad=True)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(t.grad.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol, err_msg=f"d{name}")


def test_bwd_twin_matches_autograd_of_fwd_twin():
    """In float32 the backward twin is the gradient of the forward twin
    (a dense softmax attention), GQA and causal, to summation order."""
    r = np.random.RandomState(3)
    q, k, v, do = [torch.from_numpy(r.randn(*s).astype(np.float32))
                   for s in ((1, 64, 4, 64), (1, 128, 2, 64),
                             (1, 128, 2, 64), (1, 64, 4, 64))]
    for t in (q, k, v):
        t.requires_grad_(True)
    o, lse = tfa.flash_attention_fwd_torch(q, k, v, 0.125, True)
    (o * do).sum().backward()
    with torch.no_grad():
        got = tfa.flash_attention_bwd_torch(q, k, v, o, lse, do, 0.125,
                                            True)
    for name, t, g in zip("qkv", (q, k, v), got):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(),
                                   atol=TOL_F32_GRAD, rtol=TOL_F32_GRAD,
                                   err_msg=f"d{name}")


def test_result_does_not_depend_on_block_arguments():
    arrs = _inputs((1, 256, 2, 64), (1, 256, 2, 64), "float32", seed=4)
    a = tfa.flash_attention(*_torch(arrs, "float32"), causal=True)
    b = tfa.flash_attention(*_torch(arrs, "float32"), causal=True,
                            block_q=128, block_k=64)
    assert torch.equal(a, b)


# (q shape, k shape, attn_mask, dropout_p, training, is_causal)
AVAIL_CASES = {
    "ok-causal": ((2, 256, 4, 64), (2, 256, 4, 64), None, 0.0, True, True),
    "mask": ((2, 256, 4, 64), (2, 256, 4, 64), "mask", 0.0, True, False),
    "dropout-train": ((2, 256, 4, 64), (2, 256, 4, 64), None, 0.1, True,
                      True),
    "dropout-eval": ((2, 256, 4, 64), (2, 256, 4, 64), None, 0.1, False,
                     True),
    "3d": ((256, 4, 64), (256, 4, 64), None, 0.0, True, False),
    "heads-not-multiple": ((1, 256, 6, 64), (1, 256, 4, 64), None, 0.0,
                           True, False),
    "causal-longer-q": ((1, 256, 2, 64), (1, 128, 2, 64), None, 0.0, True,
                        True),
    "noncausal-longer-q": ((1, 256, 2, 64), (1, 128, 2, 64), None, 0.0,
                           True, False),
    "d32": ((1, 256, 2, 32), (1, 256, 2, 32), None, 0.0, True, True),
    "d72": ((1, 256, 2, 72), (1, 256, 2, 72), None, 0.0, True, True),
    "d68": ((1, 256, 2, 68), (1, 256, 2, 68), None, 0.0, True, True),
    "d128": ((1, 256, 2, 128), (1, 256, 2, 128), None, 0.0, True, True),
    "seq17": ((1, 17, 2, 64), (1, 17, 2, 64), None, 0.0, True, True),
    "seq64": ((1, 64, 2, 64), (1, 64, 2, 64), None, 0.0, True, True),
    "seq384": ((1, 384, 2, 64), (1, 384, 2, 64), None, 0.0, True, True),
    "seq1024": ((1, 1024, 2, 64), (1, 1024, 2, 64), None, 0.0, True, True),
}


@pytest.mark.parametrize("case", list(AVAIL_CASES))
def test_available_rules_match_jax(case):
    qs, ks, mask, p, training, causal = AVAIL_CASES[case]
    m = np.zeros((1,)) if mask else None
    assert tfa.flash_attention_available(qs, ks, m, p, training, causal) \
        == jfa.flash_attention_available(qs, ks, m, p, training, causal)


@pytest.mark.parametrize("n", [1, 3, 64, 100, 128, 256, 384, 1000, 1024,
                               4096])
def test_pick_block_matches_jax(n):
    assert tfa._pick_block(n, 512) == jfa._pick_block(n, 512)
    assert tfa._pick_block(n, 128) == jfa._pick_block(n, 128)


@pytest.mark.parametrize("d,D,D_f32", [
    (64, 64, 64), (8, 64, 64), (56, 64, 64), (72, 128, 128),
    (80, 128, 128), (96, 128, 128), (128, 128, 128), (136, 256, None),
    (192, 256, None), (256, 256, None), (264, None, None),
    (68, None, None), (0, None, None)])
def test_padded_head_dim(d, D, D_f32):
    """Every head dim flash_attention_available admits up to 256 runs
    at a built padded dim in the half types, and up to 128 in float32;
    what stays out (ROADMAP Queue C) is float32 above 128, any dtype above
    256, and what no 16-byte row holds."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.padded_head_dim(d, dtype) == D
    assert tfa.padded_head_dim(d, torch.float32) == D_f32
    if D is not None:
        assert d <= D and D in tfa.PADDED_HEAD_DIMS


def test_mask_value_matches_jax():
    assert tfa.DEFAULT_MASK_VALUE == jfa.DEFAULT_MASK_VALUE


@pytest.mark.parametrize("qs,ks,causal,match", [
    ((1, 256, 6, 64), (1, 256, 4, 64), False, "multiple of kv heads"),
    ((1, 256, 2, 64), (1, 128, 2, 64), True, "s_q <= s_k"),
], ids=["heads", "causal-longer-q"])
def test_value_errors_match_jax(qs, ks, causal, match):
    z = np.zeros(qs, np.float32)
    zk = np.zeros(ks, np.float32)
    with pytest.raises(ValueError, match=match):
        jfa.flash_attention(jnp.asarray(z), jnp.asarray(zk),
                            jnp.asarray(zk), causal=causal, interpret=True)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(torch.from_numpy(z), torch.from_numpy(zk),
                            torch.from_numpy(zk), causal=causal)


@pytest.mark.parametrize("seq,flash", [(17, False), (256, True)],
                         ids=["17-eager", "256-flash"])
def test_sdpa_dispatch_matches_jax(seq, flash, monkeypatch):
    """F.scaled_dot_product_attention takes the flash path exactly where
    the JAX package does, and gives the JAX package's numbers either
    way; a 17-token input runs the eager math."""
    calls = []
    real = tfa.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    arrs = _inputs((1, seq, 2, 64), (1, seq, 2, 64), "float32", seed=5)
    got = TF.scaled_dot_product_attention(*_torch(arrs, "float32"),
                                          is_causal=True)
    want = JF.scaled_dot_product_attention(
        *[jnp.asarray(a) for a in arrs], is_causal=True)
    assert bool(calls) == flash
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL_F32_FWD, rtol=TOL_F32_FWD)


def test_sdpa_flag_off_runs_eager(monkeypatch):
    monkeypatch.setattr(tfa, "flash_attention", None)  # must not be called
    arrs = _inputs((1, 256, 2, 64), (1, 256, 2, 64), "float32", seed=6)
    tflags.set_flags({"flash_attention": False})
    try:
        got = TF.scaled_dot_product_attention(*_torch(arrs, "float32"),
                                              is_causal=True)
    finally:
        tflags.set_flags({"flash_attention": True})
    got2 = TF.scaled_dot_product_attention(*_torch(arrs, "float32"),
                                           is_causal=True, use_flash=False)
    assert torch.equal(got, got2)


def test_cpu_wrappers_take_the_twins_without_launching():
    before = dict(tfa.launches)
    arrs = _inputs((1, 128, 4, 64), (1, 128, 2, 64), "float32", seed=7)
    q, k, v = _torch(arrs, "float32")
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, 0.125, True)
    want_o, want_lse = tfa.flash_attention_fwd_torch(q, k, v, 0.125, True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    do = torch.ones_like(o)
    dq = tfa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, 0.125,
                                           True)
    dk, dv = tfa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, 0.125,
                                                True)
    want = tfa.flash_attention_bwd_torch(q, k, v, o, lse, do, 0.125, True)
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)
    assert tfa.launches == before


def test_impl_switch_validates(monkeypatch):
    monkeypatch.setattr(tfa, "impl", "pallas")
    z = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="'kernel' or 'plain'"):
        tfa.flash_attention(z, z, z, causal=True)


# ---------------------------------------------------------------------------
# on the card: kernels B1, B2, B3 against their twins
# ---------------------------------------------------------------------------

CARD_CASES = {
    # (b, sq, sk, hq, hkv, d, causal, dtype)
    "f32-causal": (2, 128, 128, 4, 4, 64, True, "float32"),
    "f32": (1, 192, 192, 2, 2, 64, False, "float32"),
    "bf16-causal": (2, 256, 256, 4, 4, 64, True, "bfloat16"),
    "bf16-gqa-d128": (1, 256, 256, 8, 2, 128, True, "bfloat16"),
    "f32-gqa-d128": (1, 128, 128, 4, 2, 128, True, "float32"),
    "bf16-cross-causal": (1, 128, 256, 2, 2, 64, True, "bfloat16"),
    "f16-cross": (1, 128, 256, 2, 2, 64, False, "float16"),
    "f16-causal": (2, 256, 256, 4, 4, 64, True, "float16"),
    "bf16-d80-causal": (2, 256, 256, 4, 4, 80, True, "bfloat16"),
    "f32-d80-causal": (1, 192, 192, 2, 2, 80, True, "float32"),
    "f16-gqa-d96": (1, 128, 256, 4, 2, 96, True, "float16"),
    "bf16-d72": (1, 128, 128, 2, 2, 72, False, "bfloat16"),
    "bf16-d256-causal": (1, 192, 192, 2, 2, 256, True, "bfloat16"),
    "f16-gqa-d192": (1, 128, 256, 4, 2, 192, True, "float16"),
}


# element by element, |kernel - twin| <= atol + rtol * |twin|, as (rtol,
# atol): half types rtol 2 eps, atol eps/4 (each side rounds its output
# once, from f32 values that differ in summation order and, in B1, in
# the running max P is rounded against); f32 1e-5 (summation order)
CARD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -6, 2 ** -9),
            "float16": (2 ** -9, 2 ** -12)}


def _close(got, want, dtype):
    rtol, atol = CARD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_match_twins_on_card(case):
    """B1, B2 and B3 against the twins on the card. q/k/v are strided
    views of one fused [b, s, (hq + 2 hkv) d] tensor, as GPT's attention
    hands them over."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    b, sq, sk, hq, hkv, d, causal, dtype = CARD_CASES[case]
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(d)
    if sq == sk:
        qkv = torch.randn(b, sq, (hq + 2 * hkv) * d, generator=g,
                          device="cuda").to(dt)
        q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
        q = q.reshape(b, sq, hq, d)
        k, v = k.reshape(b, sk, hkv, d), v.reshape(b, sk, hkv, d)
    else:
        q = torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
    do = torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dt)
    before = dict(tfa.launches)
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, scale, causal)
    want_o, want_lse = tfa.flash_attention_fwd_torch(q, k, v, scale, causal)
    dq = tfa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, scale,
                                           causal)
    dk, dv = tfa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, scale,
                                                causal)
    want = tfa.flash_attention_bwd_torch(q, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    assert {n: tfa.launches[n] - before[n] for n in before} == \
        {n: 1 for n in before}
    assert o.dtype == dt and dq.dtype == dt and dk.dtype == dt
    _close(o, want_o, dtype)
    _close(lse, want_lse, "float32")   # f32 on both sides
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, dtype)


@pytest.mark.cuda
def test_kernel_refuses_unbuilt_head_dim_on_card():
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    for d, dtype in ((256, torch.float32), (264, torch.bfloat16)):
        q = torch.zeros(1, 128, 2, d, device="cuda", dtype=dtype)
        with pytest.raises(NotImplementedError, match="Queue C"):
            tfa.flash_attention_fwd_kernel(q, q, q, 0.1, True)


@pytest.mark.cuda
def test_misaligned_views_give_the_aligned_result_on_card():
    """Operands whose rows do not start on 16 bytes are copied before
    the launch, not read astray."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(1)
    base = torch.randn(1, 128, 2 * 64 + 1, generator=g,
                       device="cuda").to(torch.bfloat16)
    q = base[..., 1:].reshape(1, 128, 2, 64)   # 2-byte offset
    o, lse = tfa.flash_attention_fwd_kernel(q, q, q, 0.125, True)
    want, want_lse = tfa.flash_attention_fwd_kernel(q.contiguous(),
                                                    q.contiguous(),
                                                    q.contiguous(), 0.125,
                                                    True)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
