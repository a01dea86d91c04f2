"""The port's weight reparameterizations, parameter packing and depth
loop (``paddle_tpu_torch/nn/utils.py``) and the fused functionals of
``incubate.nn`` against the JAX package's, the counterpart of
``tests/test_nn_utils.py``. Tolerance 1e-5 in float32 (summation order
only); dropout masks inside the fused ops and the scanned stack come
from threefry on the same keys, so the outputs agree to that
tolerance only if the masks are the same."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu.incubate.nn import functional as JIF  # noqa: E402
from paddle_tpu.nn import utils as JU  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.incubate.nn import functional as TIF  # noqa: E402
from paddle_tpu_torch.nn import utils as TU  # noqa: E402
from torch_nn_common import both, carry, close, rand  # noqa: E402


@pytest.mark.parametrize("dim", [0, -1])
def test_weight_norm_matches_jax(dim):
    jl, tl = both("Linear", 6, 4)
    carry(jl, tl)
    JU.weight_norm(jl, "weight", dim=dim)
    TU.weight_norm(tl, "weight", dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict())
    for k, v in jl.state_dict().items():
        close(tl.state_dict()[k], v)
    x = rand(3, 6)
    close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
    params, bufs = jnn.split_state(jl)
    jg = jax.grad(lambda p: jnp.sum(jnn.functional_call(
        jl, p, bufs, jnp.asarray(x))[0] ** 2))(params)
    (tl(torch.from_numpy(x)) ** 2).sum().backward()
    for k, p in tl.named_parameters():
        close(p.grad, jg[k], what=k)
    with pytest.raises(ValueError, match="not a parameter"):
        TU.weight_norm(tl)
    JU.remove_weight_norm(jl)
    TU.remove_weight_norm(tl)
    assert list(tl.state_dict()) == list(jl.state_dict())
    close(tl.weight, jl.weight)


def test_weight_norm_keeps_frozen_flag_and_axes():
    lin = tnn.Linear(4, 3, axes=("embed", "mlp"))
    lin.weight.requires_grad_(False)
    TU.weight_norm(lin)
    meta = lin.param_meta()
    assert not meta["weight_v"].trainable and not meta["weight_g"].trainable
    assert meta["weight_v"].axes == ("embed", "mlp")
    assert tuple(dict(lin.named_parameters())["weight_g"].shape) == (4, 1)


@pytest.mark.parametrize("dim, iters", [(0, 1), (1, 2)])
def test_spectral_norm_matches_jax(dim, iters):
    """The power-iteration vector starts at JAX's ``normal(key(0))`` draw
    and advances once a forward: three forwards' outputs and ``u``
    agree with the JAX package's."""
    jl, tl = both("Linear", 5, 7)
    carry(jl, tl)
    JU.spectral_norm(jl, "weight", iters, dim=dim)
    TU.spectral_norm(tl, "weight", iters, dim=dim)
    assert list(tl.state_dict()) == list(jl.state_dict())
    close(tl.weight_u, jl.weight_u, 1e-6)
    for i in range(3):
        x = rand(4, 5, seed=i)
        close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))
        close(tl.weight_u, jl.weight_u)
    close(tl.weight, jl.weight)
    assert tl.weight_u.dtype == torch.float32


def test_spectral_norm_validates_iterations():
    with pytest.raises(ValueError, match=">= 1"):
        TU.spectral_norm(tnn.Linear(4, 4), n_power_iterations=0)


def test_parameter_vector_round_trip():
    net = tnn.Sequential(tnn.Linear(3, 4), tnn.Linear(4, 2))
    params = list(net.parameters())
    vec = TU.parameters_to_vector(params)
    want = JU.parameters_to_vector([jnp.asarray(p.detach().numpy())
                                    for p in params])
    close(vec, want)
    back = TU.vector_to_parameters(vec * 2, params)
    for b, p in zip(back, params):
        close(b, p.detach().numpy() * 2)


def test_scan_stacked_apply_matches_jax():
    """Three blocks with dropout, each under ``fold_in(next_key, i)``,
    as the JAX package's scan runs them."""
    def block(nn_):
        return nn_.Sequential(nn_.Linear(8, 8), nn_.Dropout(0.2))
    jblocks = [block(jnn) for _ in range(3)]
    tblocks = [block(tnn) for _ in range(3)]
    for jb, tb in zip(jblocks, tblocks):
        carry(jb, tb)
    x = rand(4, 8)
    jstack = {k: jnp.stack([jnn.split_state(b)[0][k] for b in jblocks])
              for k in jnn.split_state(jblocks[0])[0]}
    tstack = {k: torch.stack([dict(b.named_parameters())[k]
                              for b in tblocks])
              for k in dict(tblocks[0].named_parameters())}
    for remat in (False, True):
        jrng.seed(2)
        trng.seed(2)
        want = JU.scan_stacked_apply(jblocks[0], jstack, jnp.asarray(x),
                                     remat=remat, training=True)
        got = TU.scan_stacked_apply(tblocks[0], tstack,
                                    torch.from_numpy(x), remat=remat,
                                    training=True)
        close(got, want)


def test_fused_linear_matches_jax():
    x, w, b = rand(2, 4), rand(4, 3, seed=1), rand(3, seed=2)
    t = torch.from_numpy
    close(TIF.fused_linear(t(x), t(w), t(b)),
          JIF.fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    close(TIF.fused_matmul_bias(t(x), t(w.T.copy()), transpose_weight=True),
          JIF.fused_linear(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_fused_feedforward_matches_jax(pre_ln, training):
    r = np.random.RandomState(1)
    arrs = [r.randn(*s).astype(np.float32) for s in
            [(2, 4, 8), (8, 16), (16, 8), (16,), (8,), (8,), (8,), (8,),
             (8,)]]
    kw = dict(dropout1_rate=0.1, dropout2_rate=0.2, activation="gelu",
              pre_layer_norm=pre_ln, training=training)
    jrng.seed(4)
    trng.seed(4)
    want = JIF.fused_feedforward(*[jnp.asarray(a) for a in arrs], **kw)
    got = TIF.fused_feedforward(*[torch.from_numpy(a) for a in arrs], **kw)
    close(got, want)


@pytest.mark.parametrize("layout", ["2d", "4d", "4d-bias"])
@pytest.mark.parametrize("training", [False, True])
def test_fused_multi_head_attention_matches_jax(layout, training):
    r = np.random.RandomState(2)
    b, s, d, h = 2, 6, 8, 2
    x = r.randn(b, s, d).astype(np.float32)
    wo = (r.randn(d, d) * 0.3).astype(np.float32)
    kw = dict(dropout_rate=0.1, attn_dropout_rate=0.1, training=training,
              pre_layer_norm=layout == "4d")
    if layout == "2d":
        qkv = (r.randn(d, 3 * d) * 0.3).astype(np.float32)
        kw["num_heads"] = h
        extra = {}
    else:
        qkv = (r.randn(3, h, d // h, d) * 0.3).astype(np.float32)
        extra = {"qkv_bias": (r.randn(3, h, d // h) * 0.1).astype(
            np.float32)} if layout == "4d-bias" else {}
    jrng.seed(6)
    trng.seed(6)
    want = JIF.fused_multi_head_attention(
        jnp.asarray(x), jnp.asarray(qkv), jnp.asarray(wo),
        **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    got = TIF.fused_multi_head_attention(
        torch.from_numpy(x), torch.from_numpy(qkv), torch.from_numpy(wo),
        **{k: torch.from_numpy(v) for k, v in extra.items()}, **kw)
    close(got, want)


def test_fused_layer_names_alias_the_standard_layers():
    from paddle_tpu_torch import incubate
    assert incubate.nn.FusedMultiHeadAttention is tnn.MultiHeadAttention
    assert incubate.FusedTransformerEncoderLayer is \
        tnn.TransformerEncoderLayer
    assert incubate.MoELayer is tnn.MoELayer
