"""Preemption-safe training in the port's ``Model.fit`` against the JAX
package's, after ``tests/test_preemption_resume.py`` and
``tests/test_numeric_guard.py``: a two-``Linear`` classifier with AdamW
1e-2 and ``Accuracy``, the same weights in both packages
(``load_reference_state``), the same data and seeds.

- Resume: a fit stopped mid-epoch and resumed (``resume="auto"``, a
  fresh ``Model``) gives losses bit-identical to the uninterrupted port
  run at ``steps_per_loop`` 1 and 4 (one torch thread: CPU float32
  reductions are not reproducible across thread counts); every
  manifest's ``state`` (step, epoch, loader cursor, rng) equals the
  JAX run's at the same step (``metrics`` holds each package's own
  pickled objects and is not compared); the metric accumulators resume;
  ``resume=1`` and ``resume=0`` are explicit steps; the elastic env pin
  falls back when its step is corrupt.
- Guard rollback: the same ``data.poison`` rule in both packages gives
  the same rollback count, restored step, fast-forward target, final
  step and verified steps; the rollback ignores the env pin.
- Preemption: ``PreemptionGuard.trigger()`` in-process flushes, exits
  ``SystemExit(67)`` and resumes equal; a worker subprocess (a fresh
  interpreter, with a timeout) preempted by SIGTERM resumes losslessly,
  and one SIGKILLed between a step's data commit and its manifest loses
  that checkpoint only.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.io.checkpoint import \
    CheckpointManager as JManager  # noqa: E402
from paddle_tpu.reliability import faults as jfaults  # noqa: E402
from paddle_tpu.reliability import guard as jguard  # noqa: E402
from paddle_tpu_torch.distributed import (RESTART_EXIT_CODE,  # noqa: E402
                                          PreemptionGuard)
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.io.checkpoint import \
    CheckpointManager as TManager  # noqa: E402
from paddle_tpu_torch.reliability import faults as tfaults  # noqa: E402
from paddle_tpu_torch.reliability import guard as tguard  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_no_faults():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jfaults.reset()
    tfaults.reset()
    yield
    torch.set_num_threads(n)
    jfaults.reset()
    tfaults.reset()


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


@functools.lru_cache(maxsize=None)
def _init_state():
    jpt.seed(0)
    return {k: np.asarray(v) for k, v in _JNet().state_dict().items()}


def _data(n=32):
    rs = np.random.RandomState(3)
    return rs.randn(n, 8).astype(np.float32), rs.randint(0, 4, (n, 1))


def _tap(pkg, epoch_steps=8):
    """A callback of ``pkg`` keeping each global step's loss as hex."""

    class Tap(pkg.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = {}

        def on_epoch_begin(self, epoch, logs=None):
            self._epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            g = self._epoch * epoch_steps + step
            self.losses[g] = float(logs["loss"]).hex()
    return Tap()


def _model(pkg, policy=None):
    pkg.seed(0)
    if pkg is jpt:
        net = _JNet()
        net.set_state_dict({k: jnp.asarray(v)
                            for k, v in _init_state().items()})
    else:
        net = _TNet()
        load_reference_state(net, _init_state())
    guard = jguard if pkg is jpt else tguard
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.AdamW(learning_rate=1e-2, parameters=net),
              _jce if pkg is jpt else _tce, metrics=pkg.metric.Accuracy(),
              numeric_guard=None if policy is None
              else guard.GuardPolicy(**policy))
    return m


def _fit(pkg, tap, ckpt_dir=None, epochs=2, resume=None, k=1,
         stop_after=None, freq=3, shuffle=True, policy=None,
         preempt_after=None, keep=3):
    """Fit ``pkg``'s classifier; ``stop_after`` raises from a callback
    once that many steps ran, ``preempt_after`` triggers a
    ``PreemptionGuard`` there instead."""
    m = _model(pkg, policy)
    x, y = _data()
    cbs = [tap]
    guard = None
    if stop_after is not None or preempt_after is not None:
        if preempt_after is not None:
            guard = PreemptionGuard(install=False)

        class Stop(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                if stop_after is not None and len(tap.losses) >= stop_after:
                    raise RuntimeError("synthetic preemption")
                if preempt_after is not None \
                        and len(tap.losses) >= preempt_after:
                    guard.trigger()
        cbs.append(Stop())
    kw = {}
    if ckpt_dir is not None:
        kw = dict(checkpoint_dir=ckpt_dir, checkpoint_freq=freq,
                  resume=resume, keep_checkpoints=keep,
                  preemption_guard=guard)
    if pkg is jpt:
        loader = jpt.io.DataLoader(jpt.io.TensorDataset([x, y]),
                                   batch_size=4, shuffle=shuffle)
    else:
        loader = tpt.io.DataLoader(tpt.io.TensorDataset([x, y]),
                                   batch_size=4, shuffle=shuffle,
                                   device="cpu")
    m.fit(loader, epochs=epochs, verbose=0, steps_per_loop=k,
          callbacks=cbs, **kw)
    return m


@functools.lru_cache(maxsize=None)
def _port_base(k, epochs=2):
    tap = _tap(tpt)
    m = _fit(tpt, tap, epochs=epochs, k=k)
    return dict(tap.losses), float(m._metrics[0].accumulate())


def _states(directory, pkg):
    mgr = (JManager if pkg is jpt else TManager)(directory,
                                                 async_save=False)
    try:
        out = {}
        for s in mgr.verified_steps():
            st = dict(mgr.read_state(s))
            st.pop("metrics", None)
            out[s] = st
        return out
    finally:
        mgr.close()


@functools.lru_cache(maxsize=None)
def _jax_interrupted(k, tmp):
    d = os.path.join(tmp, f"jax_k{k}")
    with pytest.raises(RuntimeError, match="synthetic preemption"):
        _fit(jpt, _tap(jpt), ckpt_dir=d, k=k, stop_after=5)
    _fit(jpt, _tap(jpt), ckpt_dir=d, resume="auto", k=k)
    return _states(d, jpt)


@pytest.mark.parametrize("k", [1, 4])
def test_fit_resume_bit_identical_and_state_equals_jax(tmp_path, k,
                                                       tmp_path_factory):
    base, _ = _port_base(k)
    assert sorted(base) == list(range(16))
    d = str(tmp_path / "ck")
    tap = _tap(tpt)
    with pytest.raises(RuntimeError, match="synthetic preemption"):
        _fit(tpt, tap, ckpt_dir=d, k=k, stop_after=5)
    resumed = _tap(tpt)
    _fit(tpt, resumed, ckpt_dir=d, resume="auto", k=k)
    assert min(resumed.losses) > 0
    combined = dict(tap.losses)
    combined.update(resumed.losses)
    assert combined == base
    want = _jax_interrupted(k, str(tmp_path_factory.getbasetemp()))
    got = _states(d, tpt)
    assert sorted(got) == sorted(want) and len(got) >= 2
    assert got == want


def test_fit_resume_restores_metric_accumulators(tmp_path):
    _, acc_ref = _port_base(1, epochs=1)
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, stop_after=5)
    m = _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, resume="auto")
    assert float(m._metrics[0].accumulate()) == acc_ref


def test_resume_explicit_steps_one_and_zero(tmp_path):
    """resume=1 means STEP 1 (1 == True in Python) and resume=0 step 0:
    both raise when that step was never saved; an explicit step that
    exists restores it."""
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="synthetic preemption"):
        _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, stop_after=5, freq=2)
    with TManager(d, async_save=False) as mgr:
        assert mgr.verified_steps() == [2, 4]
    with pytest.raises(FileNotFoundError):
        _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, resume=1)
    with pytest.raises(FileNotFoundError):
        _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, resume=0)
    resumed = _tap(tpt)
    _fit(tpt, resumed, ckpt_dir=d, epochs=1, resume=2, freq=2)
    assert min(resumed.losses) == 2
    base, _ = _port_base(1, epochs=1)
    for s, h in resumed.losses.items():
        assert base[s] == h


def test_env_pin_falls_back_when_corrupt(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    with pytest.raises(RuntimeError):
        _fit(tpt, _tap(tpt), ckpt_dir=d, stop_after=7, freq=3)
    with TManager(d, async_save=False) as mgr:
        steps = mgr.verified_steps()
    assert steps == [3, 6]
    path = os.path.join(d, "manifest-6.json")
    man = json.load(open(path))
    man["digests"][sorted(man["digests"])[0]] = "0" * 32
    json.dump(man, open(path, "w"))
    monkeypatch.setenv("PADDLE_ELASTIC_RESUME_STEP", "6")
    resumed = _tap(tpt)
    _fit(tpt, resumed, ckpt_dir=d, resume="auto")
    assert min(resumed.losses) == 3
    base, _ = _port_base(1)
    for s, h in resumed.losses.items():
        assert base[s] == h


# -- guard rollback ----------------------------------------------------------

def _rollback_run(pkg, tmp, env_pin=None, monkeypatch=None, k=1):
    faults = jfaults if pkg is jpt else tfaults
    policy = dict(on_nonfinite="rollback", max_rollbacks=3)
    faults.reset()
    faults.enable(seed=7)
    faults.inject("data.poison", nth=(6,))
    if env_pin is not None:
        monkeypatch.setenv("PADDLE_ELASTIC_RESUME_STEP", str(env_pin))
    d = os.path.join(tmp, f"rb_{pkg.__name__}_{env_pin}_{k}")
    tap = _tap(pkg)
    try:
        m = _fit(pkg, tap, ckpt_dir=d, shuffle=False, policy=policy,
                 freq=2, keep=8, k=k)
    finally:
        faults.reset()
    with (JManager if pkg is jpt else TManager)(d, async_save=False) as g:
        verified = g.verified_steps()
    return dict(rollbacks=m._guard.n_rollbacks, steps=m._step_count,
                verified=verified)


@pytest.mark.parametrize("k", [1, 2])
def test_guard_rollback_matches_jax(tmp_path, capfd, k):
    """Trip at step 5 (the 6th poison check): the newest verified step
    at or below the trip (4) restores, the cursor jumps past the
    poisoned batch, training completes: 16 batches - 1 discarded - 1
    skipped = 14 steps, the same in both packages, message for
    message."""
    out = {}
    msgs = {}
    for pkg in (jpt, tpt):
        out[pkg.__name__] = _rollback_run(pkg, str(tmp_path), k=k)
        msgs[pkg.__name__] = [
            line for line in capfd.readouterr().err.splitlines()
            if line.startswith("[numeric-guard] rollback")]
    assert out["paddle_tpu_torch"] == out["paddle_tpu"]
    assert out["paddle_tpu"]["rollbacks"] == 1
    assert msgs["paddle_tpu_torch"] == msgs["paddle_tpu"]
    assert len(msgs["paddle_tpu"]) == 1
    if k == 1:
        assert out["paddle_tpu"]["steps"] == 14
        assert "restored verified step 4" in msgs["paddle_tpu"][0]


def test_rollback_ignores_elastic_env_pin(tmp_path, monkeypatch):
    got = _rollback_run(tpt, str(tmp_path), env_pin=2,
                        monkeypatch=monkeypatch)
    assert got["rollbacks"] == 1 and got["steps"] == 14


def test_rollback_before_any_checkpoint_escalates(tmp_path):
    """A trip before the first checkpoint committed has nothing to
    restore: GuardAbort, as in the JAX package."""
    for pkg, guard in ((jpt, jguard), (tpt, tguard)):
        faults = jfaults if pkg is jpt else tfaults
        faults.reset()
        faults.enable(seed=7)
        faults.inject("data.poison", nth=(2,))
        try:
            with pytest.raises(guard.GuardAbort,
                               match="before any verified checkpoint"):
                _fit(pkg, _tap(pkg), ckpt_dir=str(
                    tmp_path / pkg.__name__), shuffle=False,
                    policy=dict(on_nonfinite="rollback"), freq=4)
        finally:
            faults.reset()


def test_guard_state_rides_the_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    m = _fit(tpt, _tap(tpt), ckpt_dir=d, epochs=1, freq=2, shuffle=False,
             policy=dict(on_nonfinite="skip", warmup_steps=2))
    n = int(m._guard_state["n"])
    assert n == 8 and float(m._guard_state["ema"]) > 0
    fresh = _model(tpt, dict(on_nonfinite="skip"))
    with TManager(d, async_save=False) as mgr:
        fresh._restore_training_state(mgr, "auto", tpt.io.DataLoader(
            tpt.io.TensorDataset(list(_data())), batch_size=4,
            device="cpu"))
    assert int(fresh._guard_state["n"]) == n
    assert torch.equal(fresh._guard_state["ema"], m._guard_state["ema"])


# -- preemption --------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_preemption_guard_flushes_exits_67_and_resumes(tmp_path, k):
    base, _ = _port_base(k)
    d = str(tmp_path / "ck")
    tap = _tap(tpt)
    with pytest.raises(SystemExit) as ei:
        _fit(tpt, tap, ckpt_dir=d, k=k, preempt_after=5, freq=100)
    assert ei.value.code == RESTART_EXIT_CODE
    ran = max(tap.losses) + 1
    with TManager(d, async_save=False) as mgr:
        # the flush committed the step the guard stopped at
        assert mgr.latest_step() == ran
        assert mgr.read_state(ran)["step"] == ran
    resumed = _tap(tpt)
    _fit(tpt, resumed, ckpt_dir=d, k=k, resume="auto", freq=100)
    assert min(resumed.losses) == ran
    combined = dict(tap.losses)
    combined.update(resumed.losses)
    assert combined == base


_WORKER = r'''
import json, os, signal, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as tpt
from paddle_tpu_torch.distributed import PreemptionGuard
from paddle_tpu_torch.io import checkpoint as ck

work, mode = sys.argv[1], sys.argv[2]
out = open(os.path.join(work, "losses.jsonl"), "a")


class Net(tpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpt.nn.Linear(8, 16)
        self.fc2 = tpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


class Tap(tpt.callbacks.Callback):
    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch

    def on_train_batch_end(self, step, logs=None):
        g = self.epoch * 8 + step
        out.write(json.dumps([g, float(logs["loss"]).hex()]) + "\n")
        out.flush()
        if mode == "sigterm" and g == 4:
            open(os.path.join(work, "ready"), "w").close()
            t0 = time.time()
            while not guard.triggered and time.time() - t0 < 60:
                time.sleep(0.01)


if mode == "sigkill":
    orig = ck.CheckpointManager._write_manifest

    def write_manifest(self, step, digests, state):
        if step == 4:   # killed between step 4's data commit and manifest
            open(os.path.join(work, "ready"), "w").close()
            time.sleep(60)
        return orig(self, step, digests, state)
    ck.CheckpointManager._write_manifest = write_manifest

guard = PreemptionGuard()
tpt.seed(0)
torch.manual_seed(0)
net = Net()
m = tpt.Model(net)
m.prepare(tpt.optimizer.AdamW(learning_rate=1e-2, parameters=net),
          lambda lo, la: -torch.log_softmax(lo, -1).gather(-1, la).mean())
rs = np.random.RandomState(3)
x, y = rs.randn(32, 8).astype(np.float32), rs.randint(0, 4, (32, 1))
loader = tpt.io.DataLoader(tpt.io.TensorDataset([x, y]), batch_size=4,
                           shuffle=True, device="cpu")
m.fit(loader, epochs=2, verbose=0, callbacks=[Tap()],
      checkpoint_dir=os.path.join(work, "ck"), checkpoint_freq=2,
      resume="auto", preemption_guard=guard)
'''


def _run_worker(work, mode, signum=None):
    """Run the worker in a fresh interpreter; with ``signum``, send it
    once the worker wrote ``ready``. Returns the exit code."""
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    ready = os.path.join(work, "ready")
    if os.path.exists(ready):
        os.unlink(ready)
    p = subprocess.Popen([sys.executable, script, work, mode], env=env,
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        if signum is not None:
            t0 = time.time()
            while not os.path.exists(ready):
                assert p.poll() is None, p.stderr.read().decode()
                assert time.time() - t0 < 60, "worker never got ready"
                time.sleep(0.02)
            p.send_signal(signum)
        _, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=10)
    return p.returncode, err.decode()


def _worker_losses(work):
    rows = [json.loads(line) for line in
            open(os.path.join(work, "losses.jsonl"))]
    return rows


@functools.lru_cache(maxsize=None)
def _worker_base(tmp):
    work = os.path.join(tmp, "worker_base")
    os.makedirs(work, exist_ok=True)
    rc, err = _run_worker(work, "plain")
    assert rc == 0, err
    rows = _worker_losses(work)
    assert [g for g, _ in rows] == list(range(16))
    return dict(rows)


@pytest.mark.parametrize("mode", ["sigterm", "sigkill"])
def test_worker_subprocess_preempted_resumes(tmp_path, tmp_path_factory,
                                            mode):
    """SIGTERM at step 5: the guard's flush commits step 5 and the
    worker exits 67; the rerun resumes there. SIGKILL while step 4's
    manifest is being written: step 4's data directory is debris, the
    rerun resumes from step 2 and re-runs steps 2-3. Either way the
    stream equals the uninterrupted worker's."""
    base = _worker_base(str(tmp_path_factory.getbasetemp()))
    work = str(tmp_path)
    rc, err = _run_worker(work, mode, signal.SIGTERM if mode == "sigterm"
                          else signal.SIGKILL)
    if mode == "sigterm":
        assert rc == RESTART_EXIT_CODE, err
        assert "[preemption] emergency checkpoint flush: committed" in err
    else:
        assert rc == -signal.SIGKILL
        assert os.path.isdir(os.path.join(work, "ck", "4"))
        assert not os.path.exists(os.path.join(work, "ck",
                                               "manifest-4.json"))
    first = len(_worker_losses(work))
    want_resume = 5 if mode == "sigterm" else 2
    with TManager(os.path.join(work, "ck"), async_save=False) as mgr:
        assert mgr.latest_step() == want_resume
        assert not os.path.exists(os.path.join(work, "ck", "4")) \
            or mode == "sigterm"
    rc, err = _run_worker(work, "plain")
    assert rc == 0, err
    rows = _worker_losses(work)
    assert rows[first][0] == want_resume
    got = {}
    for g, h in rows:
        got[g] = h
    assert got == base
