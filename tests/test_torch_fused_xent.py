"""The port's fused vocab loss, cross_entropy and GPT criteria against
the JAX package's, on the same numpy inputs.

Tolerances: float32 operands 1e-5 for the loss and 1e-5 (abs, on
gradients of magnitude ~1e-2) for the gradients: both sides run the
same chunked online logsumexp in float32 and differ in summation order.
bfloat16 operands: the chunk products take bf16 operands with float32
results on both sides, so the loss agrees to 1e-5 as well; the
gradients are rounded to bf16 (dW, dh) and agree to one bf16 ulp of
their magnitude (2e-2 relative)."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.ops.fused_xent import \
    fused_linear_cross_entropy as jfused  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops.fused_xent import \
    fused_linear_cross_entropy as tfused  # noqa: E402

TOL = 1e-5
TOL_BF16_GRAD = 2e-2


def _data(t=12, h=16, v=40, seed=0, ignore=()):
    r = np.random.RandomState(seed)
    hid = (r.randn(t, h) * 0.5).astype(np.float32)
    w = (r.randn(v, h) * 0.5).astype(np.float32)
    bias = (r.randn(v) * 0.1).astype(np.float32)
    lb = r.randint(0, v, (t,)).astype(np.int64)
    lb[list(ignore)] = -100
    return hid, w, bias, lb


# (vocab, chunk, bias, ignored rows, dtype)
CASES = {
    "one-chunk": (40, None, False, (), "float32"),
    "chunk8": (40, 8, False, (), "float32"),
    "chunk40": (40, 40, False, (), "float32"),
    "padded-vocab": (37, 8, False, (), "float32"),
    "ignore-index": (40, 8, False, (0, 5), "float32"),
    "bias-padded": (37, 8, True, (3,), "float32"),
    "bf16": (40, 8, False, (), "bfloat16"),
    "bf16-padded-ignore": (37, 16, False, (2,), "bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_loss_and_grads_match_jax(case):
    v, chunk, use_bias, ignore, dtype = CASES[case]
    hid, w, bias, lb = _data(v=v, seed=len(case), ignore=ignore)
    jb = jnp.asarray(bias) if use_bias else None

    def jloss(h, w_, b_):
        return jfused(h, w_, jnp.asarray(lb), -100, chunk, b_)
    jargs = (jnp.asarray(hid, dtype), jnp.asarray(w, dtype), jb)
    want, jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2) if use_bias else (0, 1))(*jargs)

    th = torch.from_numpy(hid).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(w).to(getattr(torch, dtype)).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_() if use_bias else None
    got = tfused(th, tw, torch.from_numpy(lb), -100, chunk, tb)
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    tgrads = (th.grad, tw.grad) + ((tb.grad,) if use_bias else ())
    for name, g, jg in zip(("dh", "dW", "dbias"), tgrads, jgrads):
        assert g.dtype == (torch.float32 if name == "dbias"
                           else getattr(torch, dtype))
        jg = np.asarray(jg, np.float32)
        if dtype == "bfloat16":
            tol = TOL_BF16_GRAD * np.abs(jg).max()
            np.testing.assert_allclose(g.float().numpy(), jg, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), jg, atol=TOL, rtol=1e-4,
                                       err_msg=name)
    for i in ignore:
        assert torch.count_nonzero(th.grad[i]) == 0


def test_fused_matches_dense_cross_entropy():
    hid, w, _, lb = _data(seed=9, ignore=(1,))
    th, tw = torch.from_numpy(hid), torch.from_numpy(w)
    got = tfused(th, tw, torch.from_numpy(lb), -100, 8)
    ref = TF.cross_entropy(th @ tw.t(), torch.from_numpy(lb))
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL)


def test_mixed_dtype_operands_take_the_activation_dtype():
    """bf16 activations with an f32 weight: the weight is cast to bf16
    for the products and its gradient comes back f32 (as in JAX)."""
    hid, w, _, lb = _data(seed=10)
    th = torch.from_numpy(hid).bfloat16().requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = tfused(th, tw, torch.from_numpy(lb), -100, 8)
    got.backward()
    want = jfused(jnp.asarray(hid, jnp.bfloat16), jnp.asarray(w),
                  jnp.asarray(lb), -100, 8)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    assert tw.grad.dtype == torch.float32 and th.grad.dtype == torch.bfloat16


# (reduction, weight, label_smoothing, ignored rows, logits dtype)
CE_CASES = {
    "mean": ("mean", False, 0.0, (), "float32"),
    "mean-ignore": ("mean", False, 0.0, (1, 4), "float32"),
    "sum": ("sum", False, 0.0, (2,), "float32"),
    "none": ("none", False, 0.0, (2,), "float32"),
    "weight-mean": ("mean", True, 0.0, (3,), "float32"),
    "smoothing": ("mean", False, 0.1, (0,), "float32"),
    "bf16-logits": ("mean", False, 0.0, (), "bfloat16"),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_jax(case):
    reduction, use_w, smooth, ignore, dtype = CE_CASES[case]
    r = np.random.RandomState(11)
    logits = (r.randn(8, 13) * 2).astype(np.float32)
    lb = r.randint(0, 13, (8,))
    lb[list(ignore)] = -100
    wt = r.rand(13).astype(np.float32) + 0.5

    def jce(x):
        return JF.cross_entropy(x, jnp.asarray(lb),
                                weight=jnp.asarray(wt) if use_w else None,
                                reduction=reduction,
                                label_smoothing=smooth)
    jx = jnp.asarray(logits, dtype)
    want = jce(jx)
    tx = torch.from_numpy(logits).to(getattr(torch, dtype)) \
        .requires_grad_()
    got = TF.cross_entropy(tx, torch.from_numpy(lb),
                           weight=torch.from_numpy(wt) if use_w else None,
                           reduction=reduction, label_smoothing=smooth)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    jg = jax.grad(lambda x: jnp.sum(jce(x)))(jx)
    got.sum().backward()
    tol = 1e-2 if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jg, np.float32), atol=tol)


def test_cross_entropy_soft_label_and_index_form_match_jax():
    r = np.random.RandomState(12)
    logits = r.randn(6, 5).astype(np.float32)
    soft = r.rand(6, 5).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(soft),
                            soft_label=True, label_smoothing=0.1)
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           soft_label=True, label_smoothing=0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    idx = r.randint(0, 5, (6, 1))
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(idx))
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(idx))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_gpt_criteria_match_jax(fused):
    r = np.random.RandomState(13)
    hidden = r.randn(2, 9, 16).astype(np.float32)
    w = (r.randn(40, 16) * 0.3).astype(np.float32)
    labels = r.randint(0, 40, (2, 9))
    labels[0, 3] = -100
    if fused:
        want = jgpt.GPTFusedPretrainingCriterion()(
            jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(labels))
        got = tgpt.GPTFusedPretrainingCriterion()(
            torch.from_numpy(hidden), torch.from_numpy(w),
            torch.from_numpy(labels))
    else:
        logits = hidden @ w.T
        want = jgpt.GPTPretrainingCriterion()(jnp.asarray(logits),
                                              jnp.asarray(labels))
        got = tgpt.GPTPretrainingCriterion()(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_fused_criterion_eval_branch_is_dense():
    """Two arguments (eval-mode logits, labels): the dense criterion."""
    r = np.random.RandomState(14)
    logits = torch.from_numpy(r.randn(2, 7, 11).astype(np.float32))
    labels = torch.from_numpy(r.randint(0, 11, (2, 7)))
    a = tgpt.GPTFusedPretrainingCriterion()(logits, labels)
    b = tgpt.GPTPretrainingCriterion()(logits, labels)
    assert torch.equal(a, b)
