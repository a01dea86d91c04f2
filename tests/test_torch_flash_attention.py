"""The port's flash attention (plain twins of kernels B1-B3, the
autograd Function, the dispatch rules) against the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, at the shapes
of tests/test_flash_attention.py.

Head dims 64-320 (64/80/96 and, in the split-d kernels' range, 256 in
float32 and 320 in bfloat16). Sequence lengths that are no multiple of
the kernels' 64-row tile (96, 97, 1, 200 against 136), which the TPU
kernel runs in blocks of 32, 8 or 1.

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
from torch_gc_barrier import collect_cycles  # noqa: F401

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
    # head dims the card runs in the split-d SIMT kernels
    "d256-causal": ((1, 128, 2, 256), (1, 128, 2, 256), True, "float32"),
    "bf16-d320-causal": ((1, 128, 2, 320), (1, 128, 2, 320), True,
                         "bfloat16"),
    # lengths that end in a partial 64-row tile on the card
    "s96": ((1, 96, 2, 64), (1, 96, 2, 64), False, "float32"),
    "s96-causal": ((1, 96, 2, 64), (1, 96, 2, 64), True, "float32"),
    "q200-k136": ((1, 200, 2, 64), (1, 136, 2, 64), False, "float32"),
    "q136-k200-causal": ((1, 136, 2, 64), (1, 200, 2, 64), True,
                         "float32"),
    "s1-causal": ((1, 1, 2, 64), (1, 1, 2, 64), True, "float32"),
    "s97-gqa-causal": ((1, 97, 4, 64), (1, 97, 2, 64), True, "float32"),
}
GRAD_CASES = {
    "mha": ((1, 128, 2, 64), (1, 128, 2, 64), False, "float32"),
    "mha-causal": ((1, 128, 2, 64), (1, 128, 2, 64), True, "float32"),
    "gqa-causal": ((1, 128, 4, 64), (1, 128, 2, 64), True, "float32"),
    "cross-causal": ((1, 128, 2, 64), (1, 256, 2, 64), True, "float32"),
    "bf16-causal": ((1, 128, 2, 64), (1, 128, 2, 64), True, "bfloat16"),
    "d80-causal": ((1, 128, 2, 80), (1, 128, 2, 80), True, "float32"),
    "d96-gqa-causal": ((1, 128, 4, 96), (1, 128, 2, 96), True, "float32"),
    "d256-causal": ((1, 128, 2, 256), (1, 128, 2, 256), True, "float32"),
    "bf16-d320-causal": ((1, 128, 2, 320), (1, 128, 2, 320), True,
                         "bfloat16"),
    "s96": ((1, 96, 2, 64), (1, 96, 2, 64), False, "float32"),
    "s96-causal": ((1, 96, 2, 64), (1, 96, 2, 64), True, "float32"),
    "q200-k136": ((1, 200, 2, 64), (1, 136, 2, 64), False, "float32"),
    "q136-k200-causal": ((1, 136, 2, 64), (1, 200, 2, 64), True,
                         "float32"),
    "s1-causal": ((1, 1, 2, 64), (1, 1, 2, 64), True, "float32"),
    "s97-gqa-causal": ((1, 97, 4, 64), (1, 97, 2, 64), True, "float32"),
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
    (64, ("mma", 64), ("simt", 64)), (8, ("mma", 64), ("simt", 64)),
    (56, ("mma", 64), ("simt", 64)), (72, ("mma", 128), ("simt", 128)),
    (80, ("mma", 128), ("simt", 128)), (96, ("mma", 128), ("simt", 128)),
    (128, ("mma", 128), ("simt", 128)), (136, ("mma", 256), ("split", 64)),
    (192, ("mma", 256), ("split", 64)), (256, ("mma", 256), ("split", 64)),
    (264, ("split", 64), ("split", 64)), (68, None, None), (0, None, None)])
def test_padded_head_dim(d, D, D_f32):
    """The kernels and the head dim D they run head dim d at: B1, B2
    and B3 in the half types on the Hopper kernels (wgmma) up to 128 and
    on the tensor cores with mma.sync at D 256 above; the float32 SIMT
    kernels up to 128, the split-d SIMT kernels above; nothing for what
    no 16-byte row holds."""
    for dtype in (torch.bfloat16, torch.float16):
        want = ("wgmma", D[1]) if D is not None and D[0] == "mma" and \
            D[1] <= 128 else D
        assert tfa.kernel_route(d, dtype) == want
    assert tfa.kernel_route(d, torch.float32) == D_f32
    if D is not None and D[0] == "mma":
        assert d <= D[1]


@pytest.mark.parametrize("d,route", [
    (8, ("wgmma", 64)), (64, ("wgmma", 64)), (72, ("wgmma", 128)),
    (80, ("wgmma", 128)), (128, ("wgmma", 128)), (136, ("mma", 256)),
    (256, ("mma", 256)), (264, ("split", 64))])
def test_backward_route_of_the_half_types(d, route):
    """B2 and B3 in bfloat16 and float16: the Hopper kernels at D 64 or
    128, the mma.sync kernels from 136 to 256, split d above; one route
    for B1, B2 and B3."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.kernel_route(d, dtype) == route


@pytest.mark.parametrize("d,route", [
    (8, ("wgmma", 64)), (64, ("wgmma", 64)), (72, ("wgmma", 128)),
    (128, ("wgmma", 128)), (136, ("mma", 256)), (256, ("mma", 256)),
    (264, ("split", 64))])
def test_forward_route_of_the_half_types(d, route):
    """B1 in bfloat16 and float16: the Hopper kernel (flash_fwd_wgmma)
    at D 64 or 128, mma.sync at D 256 from 136, split d above; float32
    keeps the SIMT kernels."""
    for dtype in (torch.bfloat16, torch.float16):
        assert tfa.kernel_route(d, dtype) == route
    assert tfa.kernel_route(d, torch.float32)[0] == \
        ("simt" if d <= 128 else "split")


@pytest.mark.parametrize("d", range(64, 513, 8))
def test_every_admitted_head_dim_has_a_kernel(d):
    """Every head dim flash_attention_available admits maps to a kernel
    in every dtype, as the JAX package runs every one of them."""
    shape = (1, 256, 2, d)
    assert jfa.flash_attention_available(shape, shape, None, 0.0, True,
                                         True)
    assert tfa.flash_attention_available(shape, shape, None, 0.0, True,
                                         True)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        design, D = tfa.kernel_route(d, dtype)
        assert design == ("wgmma" if dtype != torch.float32 and d <= 128
                          else "mma" if dtype != torch.float32 and d <= 256
                          else "simt" if d <= 128 else "split")


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
    # split d: SIMT kernels summing the scores over 64-column slices
    "f32-d256-causal": (1, 192, 192, 2, 2, 256, True, "float32"),
    "f32-gqa-d136": (1, 128, 256, 4, 2, 136, True, "float32"),
    "bf16-d320-causal": (1, 128, 128, 2, 2, 320, True, "bfloat16"),
    "bf16-d264": (1, 128, 128, 2, 2, 264, False, "bfloat16"),
    "f16-gqa-d264": (1, 128, 192, 2, 1, 264, True, "float16"),
    # lengths with a partial last tile (the mask, zero-filled rows, the
    # stores that stop at the end)
    "f32-s96-causal": (1, 96, 96, 2, 2, 64, True, "float32"),
    "bf16-s96": (1, 96, 96, 2, 2, 64, False, "bfloat16"),
    "f32-q200-k136": (1, 200, 136, 2, 2, 64, False, "float32"),
    "bf16-q136-k200-causal": (1, 136, 200, 2, 2, 64, True, "bfloat16"),
    "f16-gqa-s97-causal": (2, 97, 97, 4, 2, 64, True, "float16"),
    "f32-gqa-s97-d80": (1, 97, 97, 4, 2, 80, False, "float32"),
    "bf16-s1-causal": (1, 1, 1, 2, 2, 64, True, "bfloat16"),
    "f32-s1-k97": (1, 1, 97, 2, 2, 64, False, "float32"),
    "bf16-gqa-s200-d80-causal": (1, 200, 200, 4, 2, 80, True, "bfloat16"),
    "bf16-gqa-q97-k136-d64": (1, 97, 136, 8, 2, 64, True, "bfloat16"),
    "f32-d256-s97-causal": (1, 97, 97, 2, 2, 256, True, "float32"),
    "bf16-d320-q136-k200": (1, 136, 200, 2, 2, 320, False, "bfloat16"),
    # the Hopper B2 / B3 (bf16 / f16, d <= 128) and the edge of their
    # route (d 136 stays on mma.sync); 128-row blocks of two 64-row
    # warpgroups, with a partial block and a warpgroup past the end
    "bf16-d128-causal": (2, 256, 256, 4, 4, 128, True, "bfloat16"),
    "f16-d128-s200": (1, 200, 200, 2, 2, 128, False, "float16"),
    "bf16-d136-causal": (1, 192, 192, 2, 2, 136, True, "bfloat16"),
    "f16-gqa4-d80-causal": (1, 200, 200, 8, 2, 80, True, "float16"),
    "bf16-gqa4-s97-causal": (2, 97, 97, 8, 2, 64, True, "bfloat16"),
    "bf16-s97-d128-causal": (1, 97, 97, 2, 2, 128, True, "bfloat16"),
    "f16-q200-k136": (2, 200, 136, 4, 4, 64, False, "float16"),
    "bf16-q136-k200-d80-causal": (1, 136, 200, 4, 2, 80, True, "bfloat16"),
    "f16-s64-causal": (1, 64, 64, 2, 2, 64, True, "float16"),
    "bf16-d8-s300-causal": (1, 300, 300, 2, 2, 8, True, "bfloat16"),
    # the Hopper B1: causal offsets (sk - sq) of 64 and 127, where some
    # rows of a block see nothing of its diagonal tile, at D 64 and 128
    "bf16-q100-k227-causal": (2, 100, 227, 4, 4, 64, True, "bfloat16"),
    "f16-gqa4-q100-k227-d128-causal": (1, 100, 227, 8, 2, 128, True,
                                       "float16"),
    "f16-q136-k200-d128-causal": (1, 136, 200, 2, 2, 128, True, "float16"),
    "bf16-s300-d128-causal": (1, 300, 300, 2, 2, 128, True, "bfloat16"),
    "f16-d80-s300": (1, 300, 300, 2, 2, 80, False, "float16"),
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
def test_kernel_refuses_head_dim_not_a_multiple_of_8_on_card():
    """What flash_attention_available never admits and no kernel takes
    raises on the card (the CPU runs the twins)."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    for d, dtype in ((68, torch.float32), (100, torch.bfloat16)):
        q = torch.zeros(1, 128, 2, d, device="cuda", dtype=dtype)
        with pytest.raises(NotImplementedError, match="multiples of 8"):
            tfa.flash_attention_fwd_kernel(q, q, q, 0.1, True)


@pytest.mark.cuda
def test_backward_shares_delta_on_card():
    """B3 reading the delta B2 wrote gives what B3 alone computes."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = [torch.randn(1, 128, 2, 64, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4)]
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, 0.125, True)
    delta = torch.empty_like(lse)
    tfa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, 0.125, True,
                                      delta=delta)
    want = (o.float() * do.float()).sum(-1).permute(0, 2, 1)
    torch.testing.assert_close(delta, want, rtol=1e-5, atol=1e-5)
    shared = tfa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, 0.125,
                                                True, delta=delta)
    alone = tfa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do, 0.125,
                                               True)
    for a, b in zip(shared, alone):
        assert torch.equal(a, b)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, "bfloat16"), (128, "float16"),
                                     (80, "bfloat16"), (136, "bfloat16")])
def test_forward_is_deterministic_on_card(d, dtype):
    """Two launches of B1 on the same inputs give bit-identical o and
    lse (no atomics), on strided q/k/v views of one [b, s, (hq + 2 hkv)
    d] projection, which the kernel reads in place (GQA group 4)."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 runs only on a CUDA card")
    b, s, hq, hkv = 2, 300, 8, 2
    dt = getattr(torch, dtype)
    assert tfa.kernel_route(d, dt)[0] == ("wgmma" if d <= 128 else "mma")
    g = torch.Generator(device="cuda").manual_seed(4)
    qkv = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g,
                      device="cuda").to(dt)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, s, hq, d)
    k, v = k.reshape(b, s, hkv, d), v.reshape(b, s, hkv, d)
    assert not q.is_contiguous()
    assert all(tfa._aligned(x) is x for x in (q, k, v))   # not copied
    scale = 1.0 / math.sqrt(d)
    runs = [tfa.flash_attention_fwd_kernel(q, k, v, scale, True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    want_o, want_lse = tfa.flash_attention_fwd_torch(q, k, v, scale, True)
    _close(runs[0][0], want_o, dtype)
    _close(runs[0][1], want_lse, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, "bfloat16"), (128, "float16"),
                                     (80, "bfloat16")])
def test_backward_is_deterministic_on_card(d, dtype):
    """Two launches of B2 and of B3 on the same inputs give bit-identical
    dq, dk and dv: every sum runs in a fixed order, with no atomics. q,
    k, v are strided views of one [b, s, (hq + 2 hkv) d] projection, as
    the model passes them (GQA group 4)."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1-B3 run only on a CUDA card")
    b, s, hq, hkv = 2, 384, 8, 2
    dt = getattr(torch, dtype)
    assert tfa.kernel_route(d, dt)[0] == "wgmma"
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn(b, s, (hq + 2 * hkv) * d, generator=g,
                      device="cuda").to(dt)
    q, k, v = torch.split(qkv, [hq * d, hkv * d, hkv * d], dim=-1)
    q = q.reshape(b, s, hq, d)
    k, v = k.reshape(b, s, hkv, d), v.reshape(b, s, hkv, d)
    assert not q.is_contiguous()
    do = torch.randn(b, s, hq, d, generator=g, device="cuda").to(dt)
    scale = 1.0 / math.sqrt(d)
    o, lse = tfa.flash_attention_fwd_kernel(q, k, v, scale, True)
    runs = []
    for _ in range(2):
        dq = tfa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, scale,
                                               True)
        runs.append((dq,) + tfa.flash_attention_bwd_dkv_kernel(
            q, k, v, o, lse, do, scale, True))
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    want = tfa.flash_attention_bwd_torch(q, k, v, o, lse, do, scale, True)
    for got, w in zip(runs[0], want):
        _close(got, w, dtype)
