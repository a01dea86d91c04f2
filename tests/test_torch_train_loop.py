"""The port's fused K-step loop (``Model.train_loop_batch``,
``fit(steps_per_loop=K)``) against K ``train_batch`` calls and against
the JAX package's ``train_loop_batch`` and fit.

A tiny GPT (2 layers, hidden 128, 2 heads of d 64, vocab 97, seq 128:
the flash path, fused loss, AdamW 1e-3 / wd 0.01), weights carried from
the JAX package by ``load_reference_state``; residual and embedding
dropout 0.1 (attention dropout 0, so the flash path runs), keys from
``seed(3)``. JAX runs its Pallas kernels in interpret mode, the port its
plain twins; the JAX runs are shared through ``lru_cache``.

Tolerances, each with its reason:
- the port's K-step slab against K ``train_batch`` calls: equal, bit for
  bit (losses and parameters; the same ops in the same order);
- against the JAX package's ``train_loop_batch``: per-step losses 1e-5
  relative under O0 and 1e-4 under O1 (``tests/test_torch_hapi.py``'s
  limits: bf16 products round differently in XLA and in torch);
- ``fit(steps_per_loop=4)`` with a ragged tail: losses, callback events
  and instrument counts equal to ``fit(steps_per_loop=1)``'s in the
  port; losses against the JAX fit at the limits above."""

import functools

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.observability import metrics as jobs  # noqa: E402
from paddle_tpu.observability import tracing as jtrace  # noqa: E402
from paddle_tpu_torch.core import flags as tflags  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.observability import metrics as tobs  # noqa: E402
from paddle_tpu_torch.observability import tracing as ttrace  # noqa: E402

SEQ, VOCAB, K = 128, 97, 4
TOL = {None: 1e-5, "O1": 1e-4}


def _cfg(m):
    return m.gpt_config("gpt2-small", num_layers=2, hidden_size=128,
                        num_heads=2, vocab_size=VOCAB,
                        max_position_embeddings=SEQ, hidden_dropout=0.1,
                        attention_dropout=0.0, fused_loss=True)


@functools.lru_cache(maxsize=None)
def _init_state():
    jpt.seed(0)
    return {k: np.asarray(v) for k, v in
            jgpt.GPTForCausalLM(_cfg(jgpt)).state_dict().items()}


def _model(pkg, amp):
    if pkg is jpt:
        net = jgpt.GPTForCausalLM(_cfg(jgpt))
        net.set_state_dict({k: np.array(v) for k, v in
                            _init_state().items()})
        gpt = jgpt
    else:
        net = tgpt.GPTForCausalLM(_cfg(tgpt), device="cpu")
        load_reference_state(net, _init_state())
        gpt = tgpt
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.AdamW(1e-3, parameters=net, weight_decay=0.01),
              gpt.GPTFusedPretrainingCriterion(), amp_configs=amp)
    pkg.seed(3)
    return m


def _ids(n):
    ids = np.random.RandomState(0).randint(0, VOCAB, (n, 2, SEQ + 1))
    return ids[..., :-1], ids[..., 1:]


def _slabs(m, x, y):
    out = []
    for s in range(0, len(x), K):
        out += [float(lg["loss"])
                for lg in m.train_loop_batch([x[s:s + K]], [y[s:s + K]])]
    return out


@functools.lru_cache(maxsize=None)
def _jax_loop(amp):
    x, y = _ids(2 * K)
    return _slabs(_model(jpt, amp), x, y)


@pytest.mark.parametrize("amp", [None, "O1"])
def test_slab_equals_k_train_batch_calls(amp):
    torch.set_num_threads(1)   # bf16 CPU ops reproducible run to run
    x, y = _ids(2 * K)
    one = _model(tpt, amp)
    want = [float(one.train_batch([x[i]], [y[i]])["loss"])
            for i in range(2 * K)]
    loop = _model(tpt, amp)
    got = _slabs(loop, x, y)
    assert got == want
    assert loop._step_count == one._step_count == 2 * K
    for (n, a), b in zip(one.network.named_parameters(),
                         loop.network.parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("amp", [None, "O1"])
def test_slab_losses_match_jax_loop(amp):
    x, y = _ids(2 * K)
    got = _slabs(_model(tpt, amp), x, y)
    np.testing.assert_allclose(got, _jax_loop(amp), rtol=TOL[amp])


def test_slab_logs_are_lazy_and_stacked():
    x, y = _ids(K)
    m = _model(tpt, None)
    logs = m.train_loop_batch([x], [y])
    assert len(logs) == K
    arr = logs[0]["loss"]._arr
    assert isinstance(arr, torch.Tensor) and arr.shape == (K,)
    assert all(lg["loss"]._arr is arr for lg in logs)
    assert np.asarray(logs[2]["loss"]).shape == ()


# ---------------------------------------------------------------------------
# fit(steps_per_loop=K): 10 batches an epoch, slabs 4, 4 and a ragged 2
# ---------------------------------------------------------------------------

_COUNTED = ("train_step_seconds", "train_loop_dispatch_seconds",
            "train_loop_slab_size", "train_compile_count")


def _counts(reg):
    out = {}
    for n in _COUNTED:
        fam = reg.get(n)
        out[n] = 0 if fam is None else (
            fam.count if fam.kind == "histogram" else fam.value)
    return out


def _fit(pkg, k):
    """fit over 20 sequences in batches of 2 (slabs 4, 4, 2) for 2
    epochs: losses, callback events, instrument deltas, span counts."""
    reg = (jobs if pkg is jpt else tobs).default_registry()
    trace = jtrace if pkg is jpt else ttrace
    m = _model(pkg, None)
    events, losses = [], []

    class Rec(pkg.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            events.append(f"begin {step}")

        def on_train_batch_end(self, step, logs=None):
            events.append(f"end {step}")
            losses.append(float(logs["loss"]))

        def on_epoch_end(self, epoch, logs=None):
            events.append(f"epoch {epoch}")

    ids = np.random.RandomState(1).randint(0, VOCAB, (20, SEQ + 1))
    ds = pkg.io.TensorDataset([ids[:, :-1], ids[:, 1:]])
    kw = {"device": "cpu"} if pkg is tpt else {}
    loader = pkg.io.DataLoader(ds, batch_size=2, shuffle=True, **kw)
    before = _counts(reg)
    trace.clear()
    trace.enable()
    try:
        pkg.seed(3)
        m.fit(loader, epochs=2, verbose=0, callbacks=[Rec()],
              steps_per_loop=k)
        spans = {n: r["count"] for n, r in trace.rollup("train.").items()}
        dispatch = [dict(sp["attrs"]) for sp in trace.finished_spans()
                    if sp["name"] == "train.dispatch"]
    finally:
        trace.disable()
        trace.clear()
    after = _counts(reg)
    return dict(losses=losses, events=events, spans=spans,
                counts={n: after[n] - before[n] for n in _COUNTED},
                steps=m._step_count, dispatch=dispatch)


@functools.lru_cache(maxsize=None)
def _jax_fit(k):
    return _fit(jpt, k)


def test_fit_k4_with_ragged_tail_equals_k1_and_jax():
    torch.set_num_threads(1)
    k1, k4 = _fit(tpt, 1), _fit(tpt, K)
    assert k4["losses"] == k1["losses"]
    assert k4["events"] == k1["events"]
    assert k4["steps"] == k1["steps"] == 20
    jk4 = _jax_fit(K)
    assert k4["events"] == jk4["events"]
    np.testing.assert_allclose(k4["losses"], jk4["losses"], rtol=1e-5)
    # per epoch: 2 slabs of 4 dispatched, the ragged 2 step by step
    assert k4["counts"] == jk4["counts"] == {
        "train_step_seconds": 2 * (2 + 2),
        "train_loop_dispatch_seconds": 2 * 2,
        "train_loop_slab_size": 2 * 2,
        "train_compile_count": 2}
    assert k4["spans"]["train.dispatch"] == \
        jk4["spans"]["train.dispatch"] == 4
    assert k4["spans"]["train.step"] == jk4["spans"]["train.step"] == 4
    assert k4["spans"]["train.epoch"] == jk4["spans"]["train.epoch"] == 2


def test_steps_per_loop_flag_matches_jax():
    for name in ("steps_per_loop", "numeric_guard"):
        assert tflags.get_flag(name) == jflags.get_flag(name)
    assert tflags.get_flag("steps_per_loop") == 1
    with pytest.raises(ValueError):
        tflags.set_flags({"steps_per_loop": 0})
    tflags.set_flags({"steps_per_loop": K})
    try:
        got = _fit(tpt, None)
    finally:
        tflags.set_flags({"steps_per_loop": 1})
    assert got["counts"]["train_loop_slab_size"] == 4
    assert got["spans"]["train.dispatch"] == 4


def test_dispatch_span_attrs_match_jax():
    """Each slab's ``train.dispatch`` span carries k, the batch and its
    first step, as in the JAX package."""
    got, want = _fit(tpt, K)["dispatch"], _jax_fit(K)["dispatch"]
    assert [{k: d[k] for k in ("k", "batch", "step0")} for d in got] == \
        [{k: d[k] for k in ("k", "batch", "step0")} for d in want] == \
        [{"k": K, "batch": 2, "step0": s} for s in (0, 4, 10, 14)]
