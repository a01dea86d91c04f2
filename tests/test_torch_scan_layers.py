"""The port's ``GPTConfig(scan_layers=True)``, ``GPTConfig(remat=True)``
and ``GPTGreedyDecoder`` against the JAX package's.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 97, seq 32), weights
carried from the JAX package by ``load_reference_state``; three
``Model.train_batch`` steps of AdamW 1e-4 under O0 with keys from
``seed(3)``. At dropout 0.1 the scan draws each layer's masks from
``fold_in(next_key("scan_trunk"), i)`` and remat must replay the forward's
masks in the recompute, so a wrong key stream shows in the losses.

Tolerances, each with its reason:
- scan or remat against the plain loop in the port (dropout 0; remat
  also at 0.1): equal, bit for bit (the same ops on the same inputs);
- against the JAX package's same configuration: per-step losses 1e-5
  relative, parameters 1e-5 absolute after 3 steps (float32 autograd in
  two frameworks, ``tests/test_torch_train.py``'s O0 limits);
- the greedy decoder: token-identical to the JAX package's and to
  ``generate``."""

import functools
import threading

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch import amp as tamp  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.nn import utils as tutils  # noqa: E402

SEQ, VOCAB, STEPS = 32, 97, 3
MODES = {"plain": {}, "remat": {"remat": True},
         "scan": {"scan_layers": True},
         "scan+remat": {"scan_layers": True, "remat": True}}


def _cfg(m, mode="plain", dropout=0.0):
    return m.gpt_config("gpt2-small", num_layers=2, hidden_size=64,
                        num_heads=4, vocab_size=VOCAB,
                        max_position_embeddings=64, hidden_dropout=dropout,
                        attention_dropout=dropout, **MODES[mode])


@functools.lru_cache(maxsize=None)
def _init_state():
    jpt.seed(0)
    return {k: np.asarray(v) for k, v in
            jgpt.GPTForCausalLM(_cfg(jgpt)).state_dict().items()}


def _net(pkg, mode="plain", dropout=0.0):
    if pkg is jpt:
        net = jgpt.GPTForCausalLM(_cfg(jgpt, mode, dropout))
        net.set_state_dict({k: np.array(v) for k, v in
                            _init_state().items()})
    else:
        net = tgpt.GPTForCausalLM(_cfg(tgpt, mode, dropout), device="cpu")
        load_reference_state(net, _init_state())
    return net


def _ids(n=STEPS):
    ids = np.random.RandomState(0).randint(0, VOCAB, (n, 2, SEQ + 1))
    return ids[..., :-1], ids[..., 1:]


def _train(pkg, mode, dropout):
    net = _net(pkg, mode, dropout)
    gpt = jgpt if pkg is jpt else tgpt
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.AdamW(1e-4, parameters=net, weight_decay=0.01),
              gpt.GPTPretrainingCriterion())
    pkg.seed(3)
    x, y = _ids()
    losses = [float(np.asarray(m.train_batch([x[i]], [y[i]])["loss"]))
              for i in range(STEPS)]
    if pkg is jpt:
        m.sync_weights()
    params = {k: np.asarray(v) if pkg is jpt else v.detach().numpy()
              for k, v in net.state_dict().items()}
    return losses, params


@functools.lru_cache(maxsize=None)
def _jax_train(mode, dropout):
    return _train(jpt, mode, dropout)


@pytest.mark.parametrize("mode", ["remat", "scan", "scan+remat"])
def test_scan_and_remat_forward_equal_the_loop(mode):
    x, _ = _ids(1)
    ids = torch.from_numpy(x[0])
    plain, other = _net(tpt), _net(tpt, mode)
    for train in (False, True):
        plain.train(train)
        other.train(train)
        assert torch.equal(other(ids), plain(ids))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["remat", "scan", "scan+remat"])
def test_training_matches_jax(mode, dropout):
    """At dropout 0.1 the JAX package's remat without scan raises
    (``jax.checkpoint`` of a block whose dropout draws from the stateful
    key stream leaks a tracer); its keys would be the plain loop's,
    drawn once at trace time, so the port's remat is held to the JAX
    plain loop there."""
    got_l, got_p = _train(tpt, mode, dropout)
    want_l, want_p = _jax_train(
        "plain" if (mode, dropout) == ("remat", 0.1) else mode, dropout)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_equals_the_plain_loop_bit_for_bit(dropout):
    """The recompute replays the forward's dropout keys: remat trains
    exactly as the plain loop does, at dropout 0.1 too."""
    pl, pp = _train(tpt, "plain", dropout)
    rl, rp = _train(tpt, "remat", dropout)
    assert rl == pl
    for k in pp:
        np.testing.assert_array_equal(rp[k], pp[k], err_msg=k)
    if dropout == 0.0:
        sl, sp = _train(tpt, "scan", dropout)
        assert sl == pl


def test_scan_keys_differ_from_the_loop_keys_at_dropout():
    """With dropout, the scan's masks are the JAX scan's, not the
    loop's (one key folded with the layer index)."""
    pl, _ = _train(tpt, "plain", 0.1)
    sl, _ = _train(tpt, "scan", 0.1)
    assert sl != pl
    np.testing.assert_allclose(sl, _jax_train("scan", 0.1)[0], rtol=1e-5)


def test_checkpoint_recomputes_under_the_forward_state_on_another_thread():
    """A recompute on another thread (the autograd engine's device
    thread on a card) runs under the forward's auto_cast state and key
    stream: the gradients equal the plain block's."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.core import threefry
    net = _net(tpt, "plain", 0.1).train()
    layer = net.gpt.layers[0]
    x0 = torch.randn(2, SEQ, 64)

    def grads(remat):
        x = x0.clone().requires_grad_(True)
        with rng.key_guard(threefry.prng_key(5)), tamp.auto_cast():
            y = tutils.checkpoint(layer, x) if remat else layer(x)
        assert y.dtype == torch.float32
        box = {}
        t = threading.Thread(target=lambda: box.update(
            g=torch.autograd.grad(y.float().sum(), x)[0]))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        return box["g"]
    assert torch.equal(grads(True), grads(False))


def test_scan_with_caches_takes_the_loop():
    """Decoding with a KV cache runs the plain loop in both modes, so
    generate is the same."""
    x, _ = _ids(1)
    ids = torch.from_numpy(x[0][:, :9])
    want = _net(tpt).generate(ids, max_new_tokens=6)
    got = _net(tpt, "scan+remat").generate(ids, max_new_tokens=6)
    assert torch.equal(got, want)


def test_scan_rejects_blocks_that_differ():
    a = tpt.nn.Linear(4, 4)
    b = tpt.nn.Linear(4, 3)
    with pytest.raises(ValueError, match="identical"):
        tutils.scan_layer_stack([a, b], torch.zeros(1, 4))


@pytest.mark.parametrize("n_new", [1, 7])
def test_greedy_decoder_matches_jax_and_generate(n_new):
    x, _ = _ids(1)
    prompt = x[0][:, :11]
    want = np.asarray(jgpt.GPTGreedyDecoder(_net(jpt), n_new)(
        jnp.asarray(prompt)))
    tnet = _net(tpt)
    got = tgpt.GPTGreedyDecoder(tnet, n_new)(torch.from_numpy(prompt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    gen = tnet.generate(torch.from_numpy(prompt), max_new_tokens=n_new)
    assert torch.equal(gen.to(torch.int32), got)
    with pytest.raises(ValueError, match="max_new_tokens"):
        tgpt.GPTGreedyDecoder(tnet, 0)
    with pytest.raises(ValueError, match="exceeds"):
        tgpt.GPTGreedyDecoder(tnet, 60)(torch.from_numpy(prompt))
