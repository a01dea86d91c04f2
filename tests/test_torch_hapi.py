"""The port's ``Model.fit``/``evaluate``/``predict``, callbacks,
``save``/``load`` and ``summary`` against the JAX package's, from the
same weights, data and seeds (both packages seeded alike, so both
DataLoaders shuffle the same batches into the same order).

Tolerances, each with its reason:
- a tiny GPT (2 layers, hidden 128, 2 heads of d 64, vocab 97, seq 128:
  the flash path, fused loss, AdamW) fit for 2 epochs: per-step losses
  within ``tests/test_torch_train.py``'s limits, 1e-5 relative under O0
  and 1e-4 under O1 (bf16 products round differently in XLA and in
  torch); eval losses 1e-5 under O0, 1e-4 under O1;
- a two-``Linear`` classifier (float32) with ``Accuracy(topk=(1, 2))``:
  accumulated accuracies equal (the same counts) and losses 1e-5;
- ``predict`` logits 1e-4 absolute (``test_eval_and_predict_batches_
  match_jax``'s limit);
- weights and optimizer state crossing in ``.pdparams``/``.pdopt``: the
  eval loss and the next two step losses 1e-5 relative (float32; the
  second step's loss moves with the loaded moments).
JAX runs its Pallas kernels in interpret mode, the port its plain
twins; the JAX runs are shared through ``lru_cache``."""

import csv
import functools
import os
import tempfile

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.observability import metrics as jobs  # noqa: E402
from paddle_tpu.observability import tracing as jtrace  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.observability import metrics as tobs  # noqa: E402
from paddle_tpu_torch.observability import tracing as ttrace  # noqa: E402

SEQ, VOCAB = 128, 97


def _tiny(m, **over):
    return m.gpt_config("gpt2-small", num_layers=2, hidden_size=128,
                        num_heads=2, vocab_size=VOCAB,
                        max_position_embeddings=SEQ, hidden_dropout=0.0,
                        attention_dropout=0.0, fused_loss=True, **over)


def _jax_gpt_state():
    jpt.seed(0)
    return jgpt.GPTForCausalLM(_tiny(jgpt))


def _torch_gpt(state):
    net = tgpt.GPTForCausalLM(_tiny(tgpt), device="cpu")
    load_reference_state(net, state)
    return net


def _state(jnet):
    return {k: np.asarray(v) for k, v in jnet.state_dict().items()}


def _gpt_data():
    ids = np.random.RandomState(0).randint(0, VOCAB, (12, SEQ + 1))
    train = (ids[:8, :-1], ids[:8, 1:])
    evals = (ids[8:, :-1], ids[8:, 1:])
    return train, evals


def _recorder(base):
    """A callback of package ``base`` keeping every event, its logs'
    keys and each step's loss as a float."""

    class Recorder(base):
        def __init__(self):
            super().__init__()
            self.events, self.losses = [], []

        def _note(self, name, logs):
            self.events.append((name, tuple(sorted(logs or {}))))

        def on_train_begin(self, logs=None):
            self._note("train_begin", logs)

        def on_train_end(self, logs=None):
            self._note("train_end", logs)

        def on_epoch_begin(self, epoch, logs=None):
            self._note(f"epoch_begin {epoch}", logs)

        def on_epoch_end(self, epoch, logs=None):
            self._note(f"epoch_end {epoch}", logs)
            self.epoch_logs = {k: float(v) for k, v in logs.items()}

        def on_train_batch_begin(self, step, logs=None):
            self._note(f"batch_begin {step}", logs)

        def on_train_batch_end(self, step, logs=None):
            self._note(f"batch_end {step}", logs)
            self.losses.append(float(logs["loss"]))

        def on_eval_begin(self, logs=None):
            self._note("eval_begin", logs)

        def on_eval_end(self, logs=None):
            self._note("eval_end", logs)

        def on_eval_batch_begin(self, step, logs=None):
            self._note(f"eval_batch_begin {step}", logs)

        def on_eval_batch_end(self, step, logs=None):
            self._note(f"eval_batch_end {step}", logs)
    return Recorder()


_COUNTED = ("train_step_seconds", "train_examples_per_second",
            "train_compile_count", "train_compile_seconds",
            "train_loop_drain_seconds", "dataloader_next_wait_seconds",
            "dataloader_batches")


def _counts(reg):
    """Counter values and histogram counts of the train/dataloader
    instruments, by name (0 for one not registered yet)."""
    out = {}
    for n in _COUNTED:
        fam = reg.get(n)
        if fam is None:
            out[n] = 0
        elif fam.kind == "histogram":
            out[n] = fam.count
        else:
            out[n] = fam.value
    return out


def _fit(pkg, gpt, net, amp, tmp, metrics=None, loss=None, opt=None,
         callbacks=(), fit_kw=None):
    """Fit ``net`` with ``pkg``'s Model under tracing; returns the
    recorder, the model, the CSV rows and the instruments' deltas with
    the count of each ``train.*`` and ``io.*`` span."""
    reg = (jobs if pkg is jpt else tobs).default_registry()
    trace = jtrace if pkg is jpt else ttrace
    model = pkg.Model(net)
    model.prepare(opt or pkg.optimizer.AdamW(1e-4, parameters=net,
                                             weight_decay=0.01),
                  loss or gpt.GPTFusedPretrainingCriterion(),
                  metrics=metrics, amp_configs=amp)
    rec = _recorder(pkg.callbacks.Callback)
    path = os.path.join(tmp, "log.csv")
    before = _counts(reg)
    pkg.seed(11)
    trace.clear()
    trace.enable()
    try:
        model.fit(callbacks=[rec, pkg.callbacks.CSVLogger(path),
                             *callbacks], **fit_kw)
        spans = {n: r["count"] for pre in ("train.", "io.")
                 for n, r in trace.rollup(pre).items()}
    finally:
        trace.disable()
        trace.clear()
    after = _counts(reg)
    with open(path) as f:
        rows = list(csv.reader(f))
    counts = {k: after[k] - before[k] for k in _COUNTED}
    counts["spans"] = spans
    return rec, model, rows, counts


def _gpt_fit_kw(io, train, evals):
    """Datasets: each Model builds its loaders (the port's on its
    network's device)."""
    return dict(train_data=io.TensorDataset(list(train)),
                eval_data=io.TensorDataset(list(evals)), batch_size=2,
                epochs=2, shuffle=True, verbose=0)


@functools.lru_cache(maxsize=None)
def _jax_gpt_fit(amp):
    jnet = _jax_gpt_state()
    init = _state(jnet)
    train, evals = _gpt_data()
    tmp = tempfile.mkdtemp()
    rec, model, rows, counts = _fit(
        jpt, jgpt, jnet, amp, tmp,
        fit_kw=_gpt_fit_kw(jpt.io, train, evals))
    out = dict(init=init, events=rec.events, losses=rec.losses,
               epoch_logs=rec.epoch_logs, rows=rows, counts=counts,
               model=model, eval=model.evaluate(
                   jpt.io.TensorDataset(list(evals)), batch_size=2,
                   verbose=0))
    if amp is None:   # predict runs without AMP: once is enough
        out["pred"] = np.asarray(model.predict(
            jpt.io.TensorDataset([evals[0]]), batch_size=2,
            stack_outputs=True))
        out["pred_list"] = [np.asarray(p) for p in model.predict(
            jpt.io.TensorDataset([evals[0]]), batch_size=3)]
        # the fitted model saved, then its eval loss and next two steps
        path = os.path.join(tmp, "ckpt", "jax")
        model.save(path)
        ids = evals[0][:2]
        out["saved"] = dict(path=path, eval=float(model.eval_batch(
            [ids], [ids])["loss"]), next=_two_steps(model, ids))
    return out


@pytest.mark.parametrize("amp,tol", [(None, 1e-5), ("O1", 1e-4)],
                         ids=["O0", "O1"])
def test_gpt_fit_matches_jax(amp, tol, tmp_path):
    """fit of the tiny GPT, 2 epochs of 4 shuffled steps with an eval
    pass each: per-step losses, the callback event sequence with each
    event's log keys, the epoch logs, the CSV columns and rows, the
    instruments' deltas and span counts, ``evaluate``, and under O0
    ``predict`` (which runs without AMP either way)."""
    want = _jax_gpt_fit(amp)
    train, evals = _gpt_data()
    tnet = _torch_gpt(want["init"])
    rec, model, rows, counts = _fit(
        tpt, tgpt, tnet, amp, str(tmp_path),
        fit_kw=_gpt_fit_kw(tpt.io, train, evals))
    assert rec.events == want["events"]
    np.testing.assert_allclose(rec.losses, want["losses"], rtol=tol)
    assert rec.epoch_logs.keys() == want["epoch_logs"].keys() == \
        {"loss", "eval_loss"}
    for k, v in want["epoch_logs"].items():
        np.testing.assert_allclose(rec.epoch_logs[k], v, rtol=tol)
    assert rows[0] == want["rows"][0] and len(rows) == 3
    np.testing.assert_allclose(np.float64(rows[1:]),
                               np.float64(want["rows"][1:]), rtol=tol)
    ev = model.evaluate(tpt.io.DataLoader(
        tpt.io.TensorDataset(list(evals)), batch_size=2, device="cpu"),
        verbose=0)
    assert ev.keys() == want["eval"].keys()
    np.testing.assert_allclose(ev["loss"], want["eval"]["loss"], rtol=tol)
    assert counts == want["counts"]
    if amp is not None:
        return
    pred = model.predict(tpt.io.TensorDataset([evals[0]]), batch_size=2,
                         stack_outputs=True)
    assert isinstance(pred, np.ndarray) and \
        pred.shape == (4, SEQ, VOCAB)
    np.testing.assert_allclose(pred, want["pred"], atol=1e-4)
    pred_list = model.predict(tpt.io.TensorDataset([evals[0]]),
                              batch_size=3)
    assert [p.shape[0] for p in pred_list] == \
        [p.shape[0] for p in want["pred_list"]] == [3, 1]


# ---------------------------------------------------------------------------
# a two-Linear classifier with metrics
# ---------------------------------------------------------------------------

class _JNet(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jpt.nn.Linear(8, 16)
        self.fc2 = jpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnp.tanh(self.fc1(x)))


class _TNet(tpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpt.nn.Linear(8, 16)
        self.fc2 = tpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _jce(logits, label):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         label, axis=-1))


def _tce(logits, label):
    return -torch.log_softmax(logits, -1).gather(-1, label).mean()


def _cls_data():
    r = np.random.RandomState(2)
    x = r.randn(80, 8).astype(np.float32)
    y = (np.abs(x[:, :4]).argmax(-1)[:, None]).astype(np.int64)
    return (x[:64], y[:64]), (x[64:], y[64:])


def _cls_fit(pkg, net, tmp, callbacks=(), epochs=2):
    train, evals = _cls_data()
    io = pkg.io
    kw = {"device": "cpu"} if pkg is tpt else {}
    return _fit(
        pkg, None, net, None, tmp,
        metrics=pkg.metric.Accuracy(topk=(1, 2)),
        loss=_jce if pkg is jpt else _tce,
        opt=pkg.optimizer.Adam(0.05, parameters=net),
        callbacks=callbacks,
        fit_kw=dict(train_data=io.DataLoader(
            io.TensorDataset(list(train)), batch_size=16, shuffle=True,
            **kw), eval_data=io.DataLoader(
                io.TensorDataset(list(evals)), batch_size=8, **kw),
            epochs=epochs, verbose=2, log_freq=2))


@functools.lru_cache(maxsize=None)
def _jax_cls(early):
    jpt.seed(3)
    jnet = _JNet()
    init = _state(jnet)
    cbs = (jpt.callbacks.EarlyStopping(monitor="loss", baseline=0.0,
                                       patience=2),) if early else ()
    rec, model, rows, counts = _fit_cls_j(jnet, cbs, 4 if early else 2)
    return dict(init=init, events=rec.events, losses=rec.losses,
                epoch_logs=rec.epoch_logs, rows=rows, counts=counts,
                acc=model._metrics[0].accumulate())


def _fit_cls_j(jnet, cbs, epochs):
    return _cls_fit(jpt, jnet, tempfile.mkdtemp(), cbs, epochs)


def _torch_cls(init):
    tpt.seed(3)
    net = _TNet()
    load_reference_state(net, init)
    return net


def test_classifier_fit_with_accuracy_matches_jax(tmp_path, capsys):
    """The accumulated top-1/top-2 accuracies (lazy metric logs read at
    each epoch's end, and after fit), losses, CSV, the instruments'
    deltas (steps, compiles, drains, loader batches) and the
    ProgBarLogger's lines."""
    want = _jax_cls(False)
    capsys.readouterr()
    rec, model, rows, counts = _cls_fit(tpt, _torch_cls(want["init"]),
                                        str(tmp_path))
    assert rec.events == want["events"]
    np.testing.assert_allclose(rec.losses, want["losses"], rtol=1e-5)
    assert rec.epoch_logs.keys() == want["epoch_logs"].keys() == {
        "loss", "acc_top1", "acc_top2", "eval_loss", "eval_acc_top1",
        "eval_acc_top2"}
    for k, v in want["epoch_logs"].items():
        np.testing.assert_allclose(rec.epoch_logs[k], v, rtol=1e-5,
                                   err_msg=k)
    assert model._metrics[0].accumulate() == want["acc"]
    assert rows[0] == want["rows"][0] and len(rows) == 3
    assert counts == want["counts"] and counts["train_loop_drain_seconds"]
    assert set(counts["spans"]) == {"train.step", "train.epoch",
                                    "train.metric_drain", "io.next_wait"}
    out = capsys.readouterr().out
    assert "Epoch 2/2" in out and "step 3/4" in out and "acc_top2" in out


def test_early_stopping_stops_at_the_same_epoch(tmp_path):
    want = _jax_cls(True)
    rec, model, _, _ = _cls_fit(
        tpt, _torch_cls(want["init"]), str(tmp_path),
        (tpt.callbacks.EarlyStopping(monitor="loss", baseline=0.0,
                                     patience=2),), epochs=4)
    assert rec.events == want["events"]
    assert [e for e, _ in rec.events if e.startswith("epoch_end")] == \
        ["epoch_end 0", "epoch_end 1"]
    assert model.stop_training


def test_metric_logs_drain_lazily_without_a_read():
    """train_batch buffers the metric's device outputs: nothing is
    folded until a log value is read or drain_metrics runs, and a run
    of more than _PENDING_DRAIN_CAP steps drains on its own."""
    (x, y), _ = _cls_data()
    m = tpt.Model(_TNet())
    acc = tpt.metric.Accuracy()
    m.prepare(tpt.optimizer.SGD(0.1, parameters=m.network), _tce,
              metrics=[acc])
    logs = m.train_batch([x[:8]], [y[:8]])
    assert acc.count == 0 and len(m._metric_pending) == 1
    first = float(logs["acc"])
    assert acc.count == 8 and not m._metric_pending
    assert float(logs["acc"]) == first       # memoized
    for _ in range(m._PENDING_DRAIN_CAP + 1):
        m.eval_batch([x[:8]], [y[:8]])
    assert len(m._metric_pending) == 1 and acc.count == 8 + 8 * 64
    m.drain_metrics()
    assert not m._metric_pending


def test_check_nan_inf_raises_at_the_drain():
    (x, y), _ = _cls_data()
    m = tpt.Model(_TNet())
    m.prepare(tpt.optimizer.SGD(0.1, parameters=m.network), _tce)
    bad = x[:8].copy()
    bad[0, 0] = np.nan
    prev = tpt.core.flags.get_flag("check_nan_inf")
    tpt.core.flags.set_flags({"check_nan_inf": True})
    try:
        m.train_batch([x[:8]], [y[:8]])
        m.train_batch([bad], [y[:8]])       # buffered, no raise yet
        with pytest.raises(FloatingPointError, match="at step 1"):
            m.drain_metrics()
    finally:
        tpt.core.flags.set_flags({"check_nan_inf": prev})


# ---------------------------------------------------------------------------
# save / load across the packages
# ---------------------------------------------------------------------------

def _two_steps(model, ids):
    return [float(model.train_batch([ids], [ids])["loss"])
            for _ in range(2)]


def _port_gpt_model(net):
    m = tpt.Model(net)
    m.prepare(tpt.optimizer.AdamW(1e-4, parameters=net,
                                  weight_decay=0.01),
              tgpt.GPTFusedPretrainingCriterion())
    return m


def test_jax_checkpoint_loads_into_the_port():
    """The JAX model after its fit (8 AdamW steps) saved; a port model
    of another init loads it: the same eval loss and next two steps."""
    want = _jax_gpt_fit(None)["saved"]
    m = _port_gpt_model(tgpt.GPTForCausalLM(_tiny(tgpt), device="cpu"))
    m.load(want["path"])
    assert m._step_count == 8 and m._opt_state["t"] == 8
    ids = _gpt_data()[1][0][:2]
    np.testing.assert_allclose(float(m.eval_batch([ids], [ids])["loss"]),
                               want["eval"], rtol=1e-5)
    np.testing.assert_allclose(_two_steps(m, ids), want["next"],
                               rtol=1e-5)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """A port model after 2 steps saved; the JAX model loads it (over
    its own fitted state): the same eval loss and next two steps as the
    port model's own."""
    cached = _jax_gpt_fit(None)
    m = _port_gpt_model(_torch_gpt(cached["init"]))
    ids = _gpt_data()[1][0][:2]
    _two_steps(m, ids)
    path = str(tmp_path / "port")
    m.save(path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdopt")
    want_eval = float(m.eval_batch([ids], [ids])["loss"])
    want_next = _two_steps(m, ids)
    jm = cached["model"]
    jm.load(path)
    assert jm._step_count == 2
    np.testing.assert_allclose(float(jm.eval_batch([ids], [ids])["loss"]),
                               want_eval, rtol=1e-5)
    np.testing.assert_allclose(_two_steps(jm, ids), want_next, rtol=1e-5)


def test_summary_counts_match_jax(capsys):
    jnet = _jax_gpt_state()
    tnet = _torch_gpt(_state(jnet))
    want = jpt.Model(jnet).summary(input_size=(1, 16), dtype="int64")
    got = tpt.Model(tnet).summary(input_size=(1, 16), dtype="int64")
    assert got == want
    assert tpt.summary(tnet, print_table=False) == \
        jpt.summary(jnet, print_table=False)
    out = capsys.readouterr().out
    assert "Total params" in out and "Embedding" in out
    assert tpt.flops(tnet, (1, 16), dtypes=["int64"]) == \
        jpt.flops(jnet, (1, 16), dtypes=["int64"])


def test_entry_points_raise_what_is_not_there(tmp_path):
    """No card: a network or a device DataLoader with no ``device``
    raises. A live sp axis, the multi-node launcher, fit's
    checkpointing, the fused loop, the numeric guard and the
    auto-parallel planner, each once raising, now run (an sp mesh takes
    the sequence-parallel GPT and refuses a network that does not slice
    the sequence)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgpt.GPTForCausalLM(_tiny(tgpt))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpt.io.DataLoader(tpt.io.TensorDataset([np.zeros((2, 2))]))
    from paddle_tpu_torch import parallel as tpar
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        tpar.distributed_model(tpt.Model(_TNet()),
                               mesh=tpar.DeviceMesh(devices=2, sp=2))
    sp_net = tgpt.GPTForCausalLM(_tiny(tgpt, sequence_parallel=True),
                                 device="cpu")
    assert tpar.distributed_model(
        tpt.Model(sp_net), mesh=tpar.DeviceMesh(devices=2, sp=2))._mesh \
        .axis_size("sp") == 2
    try:
        planned = tpar.distributed_model(tpt.Model(_TNet()), global_batch=8)
        assert planned._plan.axes == {"dp": 1, "fsdp": 1, "tp": 1}
    finally:
        tpar.set_mesh(None)
    m = tpt.Model(_TNet())
    m.prepare(tpt.optimizer.SGD(0.1, parameters=m.network), _tce)
    (x, y), _ = _cls_data()
    ds = tpt.io.TensorDataset([x, y])
    m.fit(ds, checkpoint_dir=str(tmp_path / "ck"), verbose=0)
    assert os.path.exists(tmp_path / "ck" / f"manifest-{m._step_count}.json")
    m.fit(ds, checkpoint_dir=str(tmp_path / "ck"), resume="auto",
          epochs=2, verbose=0)
    # the fused K-step loop and the numeric guard are ported
    m.fit(ds, steps_per_loop=2, verbose=0)
    assert m._loop_built
    m.prepare(loss=_tce, numeric_guard=True)
    assert m._guard is not None
