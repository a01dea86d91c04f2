"""The port's nn layers and functions against the JAX package's, on the
same numpy inputs and weights (carried across by identical state-dict
key). Tolerance 1e-5: both sides compute in float32 on the CPU and
differ only in summation order."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.ops import rotary as jrot  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.ops import rotary as trot  # noqa: E402

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jax_layer, torch_layer, perturb=True):
    """Randomize the JAX layer's parameters, then copy them across."""
    state = {k: np.asarray(v) for k, v in jax_layer.state_dict().items()}
    if perturb:
        state = {k: _rand(*v.shape, seed=i + 7) for i, (k, v)
                 in enumerate(sorted(state.items()))}
        jax_layer.set_state_dict(state)
    load_reference_state(torch_layer, state)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
def test_linear_matches_jax(bias):
    jl = jnn.Linear(6, 5, bias_attr=None if bias else False)
    tl = tnn.Linear(6, 5, bias_attr=None if bias else False)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert tuple(tl.weight.shape) == (6, 5)   # Paddle's [in, out]
    _carry(jl, tl)
    x = _rand(3, 4, 6)
    _close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))


@pytest.mark.parametrize("padding_idx", [None, 2])
def test_embedding_matches_jax(padding_idx):
    je = jnn.Embedding(11, 8, padding_idx=padding_idx)
    te = tnn.Embedding(11, 8, padding_idx=padding_idx)
    _carry(je, te)
    ids = np.random.RandomState(1).randint(0, 11, (2, 9))
    _close(te(torch.from_numpy(ids)), je(jnp.asarray(ids)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    jl, tl = jnn.LayerNorm(16), tnn.LayerNorm(16)
    _carry(jl, tl)
    x = _rand(2, 5, 16) * 3 + 1
    want = jl(jnp.asarray(x, dtype))
    got = tl(torch.from_numpy(x).to(getattr(torch, dtype)))
    # bf16: statistics in f32 on both sides; the result rounds to bf16
    tol = TOL if dtype == "float32" else 2e-2
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    jl, tl = jnn.RMSNorm(16), tnn.RMSNorm(16)
    _carry(jl, tl)
    x = _rand(2, 5, 16) * 2
    want = jl(jnp.asarray(x, dtype))
    got = tl(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = TOL if dtype == "float32" else 2e-2
    _close(got.float(), np.asarray(want, np.float32), tol)


@pytest.mark.parametrize("approximate", [False, True],
                         ids=["erf", "tanh"])
def test_gelu_matches_jax(approximate):
    x = _rand(4, 33) * 3
    _close(TF.gelu(torch.from_numpy(x), approximate=approximate),
           JF.gelu(jnp.asarray(x), approximate=approximate))


@pytest.mark.parametrize("split", [True, False], ids=["split", "gate"])
def test_swiglu_matches_jax(split):
    x, gate = _rand(3, 8), _rand(3, 8, seed=1)
    if split:
        _close(TF.swiglu(torch.from_numpy(x)), JF.swiglu(jnp.asarray(x)))
    else:
        _close(TF.swiglu(torch.from_numpy(x), torch.from_numpy(gate)),
               JF.swiglu(jnp.asarray(x), jnp.asarray(gate)))


def test_rope_tables_identical():
    for a, b in zip(trot.rope_tables(16, 40), jrot.rope_tables(16, 40)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("with_positions", [False, True],
                         ids=["arange", "position_ids"])
def test_apply_rotary_pos_emb_matches_jax(with_positions):
    q, k = _rand(2, 5, 4, 16), _rand(2, 5, 2, 16, seed=1)
    cos, sin = jrot.rope_tables(16, 40)
    pos = np.random.RandomState(2).randint(0, 40, (2, 5)) \
        if with_positions else None
    jq, jk = jrot.apply_rotary_pos_emb(
        jnp.asarray(q), jnp.asarray(k), cos, sin,
        position_ids=None if pos is None else jnp.asarray(pos))
    tq, tk = trot.apply_rotary_pos_emb(
        torch.from_numpy(q), torch.from_numpy(k), cos, sin,
        position_ids=None if pos is None else torch.from_numpy(pos))
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("case", ["causal", "gqa-causal", "mask"])
def test_sdpa_eager_math_matches_jax(case):
    q = _rand(2, 6, 4, 8)
    kvh = 2 if case == "gqa-causal" else 4
    k, v = _rand(2, 6, kvh, 8, seed=1), _rand(2, 6, kvh, 8, seed=2)
    mask = None
    if case == "mask":
        mask = np.where(np.random.RandomState(3).rand(2, 1, 6, 6) > 0.3,
                        0.0, -1e30).astype(np.float32)
    causal = case != "mask"
    want = JF.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        attn_mask=None if mask is None else jnp.asarray(mask),
        is_causal=causal, training=False, use_flash=False)
    got = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=None if mask is None else torch.from_numpy(mask),
        is_causal=causal, training=False, use_flash=True)
    _close(got, want)


def test_dropout_is_identity_in_eval():
    d = tnn.Dropout(0.5).eval()
    x = torch.from_numpy(_rand(4, 4))
    assert torch.equal(d(x), x)
