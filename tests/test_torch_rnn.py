"""The port's recurrent layers (``paddle_tpu_torch/nn/layers/rnn.py``)
against the JAX package's: every cell and stack, one and two layers,
forward and bidirectional, with and without sequence lengths, time-major
with initial states, and inter-layer dropout (threefry masks on the same
keys). The JAX weights are carried across by state dict key (the packed
``weight_ih`` ``[in, G * H]`` layout is the same in both packages); the
outputs, the final states and the gradients of every parameter agree
within 1e-5 (float32 on the CPU, summation order only)."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from torch_nn_common import both, carry, close, rand  # noqa: E402

B, T, IN, H = 3, 5, 4, 6


def _flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _flat(t)]
    return [tree]


def _check(jl, tl, args, jkw=None, training=False, seed=None):
    """Outputs and final states of ``layer(*args)`` equal, and the
    gradients of a random projection of all of them."""
    carry(jl, tl)
    jl.train() if training else jl.eval()
    tl.train(training)
    params, bufs = jnn.split_state(jl)
    jargs = [None if a is None else jnp.asarray(a) for a in args]
    targs = [None if a is None else torch.from_numpy(np.array(a))
             for a in args]

    def run(p):
        if seed is not None:
            jrng.seed(seed)
        return jnn.functional_call(jl, p, bufs, *jargs, **(jkw or {}),
                                   training=training)[0]

    if seed is not None:
        trng.seed(seed)
    tout = _flat(tl(*targs, **(jkw or {})))
    rs = [rand(*o.shape, seed=40 + i) for i, o in enumerate(tout)]
    if seed is None:   # one compile of the forward and its vjp
        jout, jg = jax.jit(lambda p: _out_and_grad(run, p, rs))(params)
    else:              # the key stream is host state: run eagerly
        jout, jg = _out_and_grad(run, params, rs)
    assert len(tout) == len(jout)
    for got, want in zip(tout, jout):
        close(got, want)
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(tout, rs)) \
        .backward()
    for k, p in tl.named_parameters():
        close(p.grad, jg[k], what=k)


def _out_and_grad(run, params, rs):
    outs, vjp = jax.vjp(lambda p: _flat(run(p)), params)
    return outs, vjp([jnp.asarray(r) for r in rs])[0]


CELLS = [("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
         ("LSTMCell", {}), ("GRUCell", {})]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("name, kw", CELLS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CELLS)])
def test_cells_match_jax(name, kw, with_state):
    jl, tl = both(name, IN, H, **kw)
    x = rand(B, IN)
    if not with_state:
        _check(jl, tl, [x])
        return
    states = rand(B, H, seed=3) if name != "LSTMCell" else None
    if states is None:
        carry(jl, tl)
        hs = (rand(B, H, seed=3), rand(B, H, seed=4))
        close(tl(torch.from_numpy(x), tuple(torch.from_numpy(s)
                                            for s in hs))[0],
              jl(jnp.asarray(x), tuple(jnp.asarray(s) for s in hs))[0])
        return
    _check(jl, tl, [x, states])


@pytest.mark.parametrize("lengths", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("name", ["SimpleRNN", "LSTM", "GRU"])
def test_stacks_match_jax(name, layers, direction, lengths):
    jl, tl = both(name, IN, H, num_layers=layers, direction=direction)
    args = [rand(B, T, IN), None,
            np.array([5, 2, 3]) if lengths else None]
    _check(jl, tl, args)


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
def test_time_major_with_initial_states(name):
    jl, tl = both(name, IN, H, num_layers=2, direction="bidirect",
                  time_major=True)
    h0 = rand(4, B, H, seed=5)
    state = (h0, rand(4, B, H, seed=6)) if name == "LSTM" else h0
    carry(jl, tl)
    x = rand(T, B, IN)
    jstate = tuple(jnp.asarray(s) for s in state) if name == "LSTM" \
        else jnp.asarray(state)
    tstate = tuple(torch.from_numpy(s) for s in state) if name == "LSTM" \
        else torch.from_numpy(state)
    for got, want in zip(_flat(tl(torch.from_numpy(x), tstate)),
                         _flat(jl(jnp.asarray(x), jstate))):
        close(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_driver_and_birnn(reverse):
    jcell, tcell = both("GRUCell", IN, H)
    jl, tl = jnn.RNN(jcell, is_reverse=reverse), \
        tnn.RNN(tcell, is_reverse=reverse)
    _check(jl, tl, [rand(B, T, IN), None, np.array([5, 1, 4])])
    jb = jnn.BiRNN(jnn.LSTMCell(IN, H), jnn.LSTMCell(IN, H))
    tb = tnn.BiRNN(tnn.LSTMCell(IN, H), tnn.LSTMCell(IN, H))
    assert list(tb.state_dict()) == list(jb.state_dict())
    _check(jb, tb, [rand(B, T, IN)])


def test_padded_steps_carry_state_and_emit_zeros():
    """A sequence cut by its length ends in the state of the truncated
    sequence, and its padded outputs are zero."""
    net = tnn.LSTM(IN, H)
    x = torch.from_numpy(rand(2, 6, IN))
    out, (h, c) = net(x, sequence_length=torch.tensor([6, 3]))
    _, (h_t, _) = net(x[1:2, :3])
    close(h[0, 1], h_t[0, 0].detach().numpy())
    assert float(out[1, 3:].detach().abs().max()) == 0.0


def test_interlayer_dropout_draws_jax_masks():
    jl, tl = both("LSTM", IN, H, num_layers=3, dropout=0.3)
    _check(jl, tl, [rand(B, T, IN)], training=True, seed=9)
