"""The port's MoE layers (``paddle_tpu_torch/nn/layers/moe.py``) against
the JAX package's on the same numpy inputs and carried weights: the
three gates, the capacity rule and the dropped tokens, the dispatch
positions (the JAX dispatch tensor is read off its dispatch einsum), the
aux loss, an argmax tie, and the gradients of every parameter through
the output and the aux loss. Tolerance 1e-5 in float32 (summation order
only); dispatch tensors and drop counts compared exactly."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.nn.layers import moe as jmoe  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from torch_nn_common import carry, close, rand  # noqa: E402

D, F, E = 8, 16, 4


class _EinsumTap:
    """``jnp`` for the JAX moe module, recording the dispatch tensor of
    its ``gsec,gsd->egcd`` einsum."""

    def __init__(self):
        self.dispatch = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "gsec,gsd->egcd":
            self.dispatch = np.asarray(ops[0])
        return jnp.einsum(spec, *ops, **kw)


def _pair(gate, cf=1.25, top_k=2, training=True):
    kw = dict(d_model=D, d_hidden=F, num_experts=E, gate=gate, top_k=top_k,
              capacity_factor=cf)
    jl, tl = jnn.MoELayer(**kw), tnn.MoELayer(**kw)
    carry(jl, tl)
    jl.train() if training else jl.eval()
    tl.train(training)
    return jl, tl


def _jax_run(jl, x, monkeypatch):
    tap = _EinsumTap()
    monkeypatch.setattr(jmoe, "jnp", tap)
    out, aux = jl.forward_with_aux(jnp.asarray(x))
    monkeypatch.setattr(jmoe, "jnp", jnp)
    return out, aux, tap.dispatch


CASES = [("naive", 1.25, 2), ("gshard", 1.25, 2), ("switch", 1.25, 1),
         ("gshard", 0.3, 2), ("switch", 0.2, 1), ("gshard", 4.0, 2),
         ("naive", 1.0, 3)]


@pytest.mark.parametrize("gate, cf, top_k", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_moe_matches_jax(gate, cf, top_k, monkeypatch):
    x = rand(3, 24, D)
    jl, tl = _pair(gate, cf, top_k)
    jout, jaux, jdispatch = _jax_run(jl, x, monkeypatch)
    dispatch, combine, taux = tl.route(torch.from_numpy(x))
    assert tl._capacity(24) == jl._capacity(24)
    np.testing.assert_array_equal(dispatch.numpy(), jdispatch)
    out, aux = tl.forward_with_aux(torch.from_numpy(x))
    close(out, jout)
    close(aux, jaux)
    routed = int(dispatch.sum())
    dropped = 3 * 24 * tl.top_k - routed
    assert dropped == 3 * 24 * tl.top_k - int(jdispatch.sum())
    if cf < 1:
        assert dropped > 0


def test_capacity_rule_and_minimum_of_four():
    for s, cf, top_k in [(24, 1.25, 2), (5, 0.1, 1), (512, 1.25, 1),
                         (7, 2.0, 2)]:
        jl, tl = _pair("naive", cf, top_k)
        assert tl._capacity(s) == jl._capacity(s) == max(
            int(np.ceil(s * top_k * cf / E)), 4)
    jl, tl = _pair("gshard", 1.0, 2, training=False)
    jl.eval_capacity_factor = tl.eval_capacity_factor = 3.0
    assert tl._capacity(24) == jl._capacity(24) == 36


def test_argmax_ties_take_the_first_expert(monkeypatch):
    """Zero gate weights tie every expert: both packages route each
    token's first choice to expert 0 and its second to expert 1, in
    token order, dropping past the capacity."""
    x = rand(2, 16, D)
    jl, tl = _pair("gshard", 1.0, 2)
    zero = {"gate.weight": np.zeros((D, E), np.float32)}
    jl.set_state_dict({**{k: np.asarray(v) for k, v in
                          jl.state_dict().items()}, **zero})
    with torch.no_grad():
        tl.gate.weight.zero_()
    _, _, jdispatch = _jax_run(jl, x, monkeypatch)
    dispatch, _, _ = tl.route(torch.from_numpy(x))
    np.testing.assert_array_equal(dispatch.numpy(), jdispatch)
    c = tl._capacity(16)
    per_expert = dispatch.sum(dim=(1, 3))
    assert per_expert[:, 0].tolist() == [c, c]
    assert per_expert[:, 1].tolist() == [c, c]
    assert float(per_expert[:, 2:].sum()) == 0.0
    assert dispatch[0, 0, 0, 0] == 1 and dispatch[0, c, 0].sum() == 0


@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
def test_gradients_reach_every_part(gate):
    x = rand(2, 16, D)
    jl, tl = _pair(gate, 2.0)
    params, bufs = jnn.split_state(jl)

    def loss(p):
        with jmoe.collect_aux_losses() as get_aux:
            out, _ = jnn.functional_call(jl, p, bufs, jnp.asarray(x))
        return (out ** 2).mean() + get_aux()

    jloss, jg = jax.value_and_grad(loss)(params)
    with tnn.collect_aux_losses() as get_aux:
        out = tl(torch.from_numpy(x))
    tloss = (out ** 2).mean() + get_aux()
    tloss.backward()
    close(tloss, jloss)
    for k, p in tl.named_parameters():
        close(p.grad, jg[k], what=k)
        assert float(p.grad.abs().sum()) > 0 or k.endswith(("b_in",
                                                            "b_out")), k


def test_aux_loss_attribute_and_param_axes():
    jl, tl = _pair("switch")
    x = rand(2, 8, D)
    jl(jnp.asarray(x))
    tl(torch.from_numpy(x))
    close(tl.aux_loss, jl.aux_loss)
    meta = tl.param_meta()
    assert meta["experts.w_in"].axes == ("expert", "embed", "mlp")
    assert meta["gate.weight"].axes == ("embed", None)
    assert {k: m.axes for k, m in meta.items()} == \
        {k: m.axes for k, m in jl.param_meta().items()}
