"""The port's numeric guard (``reliability/guard.py`` and its
``Model`` integration) against the JAX package's, after
``tests/test_numeric_guard.py``: a two-``Linear`` classifier with Adam
1e-2, the same weights in both packages (``load_reference_state``), the
same batches and the same seeded fault rules in each package's
``faults``.

Tolerances, each with its reason:
- verdicts: equal; grad norms and losses 1e-5 relative (float32
  autograd in two frameworks);
- a skipped step against the clean stream minus that batch, in the
  port: equal, bit for bit (parameters and losses); the port's
  parameters against the JAX package's poisoned run: 1e-5 relative;
- host-side policy (budgets, strides, messages, the ``/statusz`` row,
  instrument deltas, fault schedules): equal."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.core import flags as jflags  # noqa: E402
from paddle_tpu.io import stack_batches as jstack  # noqa: E402
from paddle_tpu.observability import metrics as jobs  # noqa: E402
from paddle_tpu.reliability import faults as jfaults  # noqa: E402
from paddle_tpu.reliability import guard as jguard  # noqa: E402
from paddle_tpu_torch.core import flags as tflags  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.io import stack_batches as tstack  # noqa: E402
from paddle_tpu_torch.observability import metrics as tobs  # noqa: E402
from paddle_tpu_torch.reliability import faults as tfaults  # noqa: E402
from paddle_tpu_torch.reliability import guard as tguard  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
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


def _build(pkg, policy_kw=None, metrics=None, linear=False):
    """A Model of ``pkg`` on the shared weights; ``policy_kw`` None
    leaves the guard off. ``linear``: one Linear layer (no saturating
    activation to clamp a blowup)."""
    jpt.seed(0)
    jnet = jpt.nn.Linear(8, 4) if linear else _JNet()
    if pkg is jpt:
        net = jnet
    else:
        net = tpt.nn.Linear(8, 4) if linear else _TNet()
        load_reference_state(net, {k: np.asarray(v) for k, v in
                                   jnet.state_dict().items()})
    guard = jguard if pkg is jpt else tguard
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.Adam(1e-2, parameters=net),
              _jce if pkg is jpt else _tce, metrics=metrics,
              numeric_guard=None if policy_kw is None
              else guard.GuardPolicy(**policy_kw))
    return m


def _batches(n=8, batch=4, seed=5):
    rs = np.random.RandomState(seed)
    return [(rs.randn(batch, 8).astype(np.float32),
             rs.randint(0, 4, (batch, 1))) for _ in range(n)]


def _run_k1(m, batches, skip=()):
    losses = []
    for i, (x, y) in enumerate(batches):
        if i not in skip:
            losses.append(float(np.asarray(
                m.train_batch([x], [y])["loss"])))
    m.drain_metrics()
    return losses


def _run_k4(m, batches):
    stack = jstack if isinstance(m, jpt.Model) else tstack
    losses = []
    for lo in range(0, len(batches), 4):
        slab = stack(batches[lo:lo + 4])
        losses += [float(lg["loss"])
                   for lg in m.train_loop_batch([slab[0]], [slab[1]])]
    m.drain_metrics()
    return losses


def _params(m):
    if isinstance(m, jpt.Model):
        m.sync_weights()
        return {k: np.asarray(v) for k, v in
                m.network.state_dict().items()}
    return {k: v.detach().numpy().copy()
            for k, v in m.network.state_dict().items()}


def _faults(site, seed=11, **rule):
    for f in (jfaults, tfaults):
        f.enable(seed=seed)
        f.inject(site, **rule)


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["healthy", "nan-grad", "inf-loss",
                                  "spike", "negative-ema", "cold"])
def test_inspect_equals_jax(case):
    """The device verdict and grad norm of the same loss, gradients and
    EMA state, including a negative-loss objective (the threshold scales
    with |ema|)."""
    r = np.random.RandomState(0)
    grads = {"w": r.randn(3, 4).astype(np.float32),
             "b": r.randn(4).astype(np.float32)}
    loss, ema, n = 2.0, 1.5, 100
    if case == "nan-grad":
        grads["b"][1] = np.nan
    elif case == "inf-loss":
        loss = np.inf
    elif case == "spike":
        loss = 9.0
    elif case == "negative-ema":
        loss, ema = 25.0, -10.0
    elif case == "cold":
        loss, n = 9.0, 3
    kw = dict(spike_factor=4.0, spike_margin=0.5, warmup_steps=16)
    jv, jn = jguard.inspect(
        jnp.float32(loss), {k: jnp.asarray(v) for k, v in grads.items()},
        {"ema": jnp.float32(ema), "n": jnp.int32(n)}, **kw)
    tv, tn = tguard.inspect(
        torch.tensor(loss, dtype=torch.float32),
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {"ema": torch.tensor(ema), "n": torch.tensor(n, dtype=torch.int32)},
        **kw)
    assert int(tv) == int(jv)
    assert tv.dtype == torch.int32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for spikes in (False, True):
        assert bool(tguard.apply_mask(tv, spikes)) == \
            bool(jguard.apply_mask(jv, spikes))
    for applied in (False, True):
        js = jguard.update_state({"ema": jnp.float32(ema),
                                  "n": jnp.int32(n)}, jnp.float32(loss),
                                 jnp.asarray(applied), 0.9)
        ts = tguard.update_state({"ema": torch.tensor(ema),
                                  "n": torch.tensor(n, dtype=torch.int32)},
                                 torch.tensor(loss), torch.tensor(applied),
                                 0.9)
        assert float(ts["ema"]) == float(js["ema"])
        assert int(ts["n"]) == int(js["n"])


def test_verdicts_and_grad_norms_equal_jax():
    """Six guarded steps, the 3rd poisoned: the buffered verdicts, grad
    norms and losses of the port equal the JAX package's."""
    batches = _batches(6)
    out = {}
    for pkg in (jpt, tpt):
        _faults("data.poison", nth=(3,))
        m = _build(pkg, {})
        for x, y in batches:
            m.train_batch([x], [y])
        pend = list(m._guard_pending)
        out[pkg.__name__] = [
            np.stack([np.asarray(p[i], np.float64).reshape(-1)
                      if not isinstance(p[i], torch.Tensor)
                      else p[i].double().numpy().reshape(-1)
                      for p in pend]) for i in range(3)]
        m.drain_metrics()
        assert m._guard.n_skipped == 1
    (jv, jn, jl), (tv, tn, tl) = out["paddle_tpu"], \
        out["paddle_tpu_torch"]
    np.testing.assert_array_equal(tv, jv)
    assert tv.reshape(-1).tolist() == [0, 0, 1, 0, 0, 0]
    ok = np.isfinite(jn)
    np.testing.assert_allclose(tn[ok], jn[ok], rtol=RTOL)
    assert not np.isfinite(tn[~ok]).any()
    np.testing.assert_allclose(tl[ok], jl[ok], rtol=RTOL)


@pytest.mark.parametrize("policy", ["skip", "allow"])
def test_spike_skip_and_allow(policy):
    """A batch scaled by 1e4 after warm-up trips verdict 2: masked with
    on_spike="skip", applied and only counted with "allow"; the JAX
    package decides alike."""
    batches = _batches(6)
    kw = dict(on_spike=policy, spike_factor=3.0, warmup_steps=3)
    res = {}
    for pkg in (jpt, tpt):
        m = _build(pkg, kw, linear=True)
        _run_k1(m, batches[:5])
        before = _params(m)
        m.train_batch([batches[5][0] * 1e4], [batches[5][1]])
        m.drain_metrics()
        after = _params(m)
        same = all(np.array_equal(before[k], after[k]) for k in before)
        res[pkg.__name__] = (m._guard.n_trips, m._guard.n_skipped,
                             m._guard.n_allowed_spikes,
                             m._guard.last_trip_kind, same)
    assert res["paddle_tpu_torch"] == res["paddle_tpu"]
    assert res["paddle_tpu"][4] == (policy == "skip")


# ---------------------------------------------------------------------------
# skip: an exact no-op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("site", ["data.poison", "grad.nonfinite"])
def test_skip_equals_stream_minus_batch(site, k):
    batches = _batches(8)
    _faults(site, nth=(3,))
    got = _build(tpt, {})
    (_run_k1 if k == 1 else _run_k4)(got, batches)
    assert got._guard.n_skipped == 1
    jm = _build(jpt, {})
    (_run_k1 if k == 1 else _run_k4)(jm, batches)
    tfaults.reset()
    clean = _build(tpt, {})
    _run_k1(clean, batches, skip=(2,))
    p_got, p_clean, p_jax = _params(got), _params(clean), _params(jm)
    for name in p_got:
        np.testing.assert_array_equal(p_got[name], p_clean[name])
        np.testing.assert_allclose(p_got[name], p_jax[name], rtol=RTOL,
                                   atol=1e-6, err_msg=name)
    # optimizer state too: moments and the device step counter
    st, cst = got._opt_state, clean._opt_state
    assert int(st["t"]) == int(cst["t"]) == 7
    for g in ("m", "v"):
        for name in st[g]:
            assert torch.equal(st[g][name], cst[g][name]), (g, name)


def test_mid_slab_poison_leaves_the_rest_of_the_slab_intact():
    batches = _batches(4)
    _faults("data.poison", nth=(2,))
    m = _build(tpt, {})
    losses = _run_k4(m, batches)
    tfaults.reset()
    clean = _run_k1(_build(tpt, {}), batches, skip=(1,))
    assert not np.isfinite(losses[1])
    assert [losses[0], losses[2], losses[3]] == clean


def test_guard_off_equals_guard_on_without_faults():
    """With nothing to trip, the guarded step (update out of place, the
    step counter on the device) gives the unguarded step's bits."""
    batches = _batches(8)
    a, b = _build(tpt, None), _build(tpt, {})
    assert _run_k1(a, batches) == _run_k1(b, batches)
    pa, pb = _params(a), _params(b)
    assert all(np.array_equal(pa[k], pb[k]) for k in pa)
    assert isinstance(a._opt_state["t"], int)
    assert isinstance(b._opt_state["t"], torch.Tensor)
    assert a._guard_pending == [] and a._nan_pending == []


@pytest.mark.parametrize("k", [1, 4])
def test_skip_drops_tripped_metric_rows(k):
    """A skipped step's metric row is dropped at the drain: the
    accumulators equal the clean run minus that batch's, and the JAX
    package's."""
    batches = _batches(8)
    _faults("data.poison", nth=(3,))
    accs = {}
    for pkg in (jpt, tpt):
        m = _build(pkg, {}, metrics=[pkg.metric.Accuracy()])
        (_run_k1 if k == 1 else _run_k4)(m, batches)
        accs[pkg.__name__] = m._metrics[0].accumulate()
    tfaults.reset()
    clean = _build(tpt, {}, metrics=[tpt.metric.Accuracy()])
    _run_k1(clean, batches, skip=(2,))
    assert np.isfinite(accs["paddle_tpu_torch"])
    assert accs["paddle_tpu_torch"] == accs["paddle_tpu"] == \
        clean._metrics[0].accumulate()


# ---------------------------------------------------------------------------
# the policy engine
# ---------------------------------------------------------------------------

def test_budget_exhausted_escalates_to_abort():
    batches = _batches(6)
    _faults("data.poison", seed=3, nth=(1, 2, 3))
    msgs = {}
    for pkg, guard in ((jpt, jguard), (tpt, tguard)):
        m = _build(pkg, dict(budget=2))
        with pytest.raises(guard.GuardAbort,
                           match="skip budget exhausted") as ei:
            _run_k1(m, batches)
        assert m._guard.n_skipped == 3
        msgs[pkg.__name__] = str(ei.value).split("; replay:")[0]
    assert msgs["paddle_tpu_torch"] == msgs["paddle_tpu"]


def test_rollback_stride_doubles_then_aborts():
    pol = tguard.GuardPolicy(on_nonfinite="rollback", max_rollbacks=3)
    strides = []
    for step in (5, 9, 13):
        with pytest.raises(tguard.GuardRollback) as ei:
            pol.process(torch.tensor([1]), torch.tensor([np.nan]),
                        torch.tensor([np.nan]), step)
        strides.append(ei.value.stride)
        assert ei.value.step == step
    assert strides == [1, 2, 4]
    with pytest.raises(tguard.GuardAbort, match="rollback budget"):
        pol.process(np.asarray([1]), np.asarray([np.nan]),
                    np.asarray([np.nan]), 17)


@pytest.mark.parametrize("k", [1, 2])
def test_rollback_without_checkpoint_dir_escalates(k):
    """fit without a ``checkpoint_dir`` has nothing to roll back to: a
    rollback escalates to GuardAbort in both packages, the same message
    up to the replay hint (with a ``checkpoint_dir`` it restores:
    ``tests/test_torch_preemption.py``)."""
    rs = np.random.RandomState(3)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randint(0, 4, (16, 1))
    _faults("data.poison", seed=7, nth=(2,))
    msgs = {}
    for pkg, guard in ((jpt, jguard), (tpt, tguard)):
        m = _build(pkg, dict(on_nonfinite="rollback"))
        kw = {"device": "cpu"} if pkg is tpt else {}
        loader = pkg.io.DataLoader(pkg.io.TensorDataset([x, y]),
                                   batch_size=4, shuffle=False, **kw)
        with pytest.raises(guard.GuardAbort,
                           match="no checkpoint_dir") as ei:
            m.fit(loader, epochs=1, verbose=0, steps_per_loop=k)
        msgs[pkg.__name__] = str(ei.value).split("; replay:")[0]
    assert msgs["paddle_tpu_torch"] == msgs["paddle_tpu"]


def test_abort_message_carries_report_and_replay():
    batches = _batches(2)
    _faults("data.poison", seed=9, nth=(2,))
    msgs = {}
    for pkg, guard in ((jpt, jguard), (tpt, tguard)):
        m = _build(pkg, dict(on_nonfinite="abort"))
        with pytest.raises(guard.GuardAbort) as ei:
            _run_k1(m, batches)
        msgs[pkg.__name__] = str(ei.value)
    msg = msgs["paddle_tpu_torch"]
    assert "nonfinite at step 1" in msg and "non-finite tensors" in msg
    assert "replay: faults.enable(seed=9)" in msg
    assert msg.split("; replay:")[0] == \
        msgs["paddle_tpu"].split("; replay:")[0]


@pytest.mark.parametrize("site", ["data.poison", "grad.nonfinite"])
def test_fault_site_preview_matches_live(site):
    batches = _batches(8)
    _faults(site, seed=21, p=0.3, times=3)
    m = _build(tpt, dict(budget=8))
    _run_k1(m, batches)
    n = tfaults.call_count(site)
    assert n == 8
    want = tfaults.preview(site, n)
    assert want == jfaults.preview(site, n)
    got = [c for s, c in tfaults.injected_log() if s == site]
    assert got == want
    assert m._guard.n_skipped == len(want)


def test_grad_nonfinite_preview_matches_live_k4():
    batches = _batches(8)
    _faults("grad.nonfinite", seed=22, nth=(2, 7))
    m = _build(tpt, dict(budget=8))
    _run_k4(m, batches)
    assert tfaults.call_count("grad.nonfinite") == 8
    got = [c for s, c in tfaults.injected_log() if s == "grad.nonfinite"]
    assert got == tfaults.preview("grad.nonfinite", 8) == [2, 7]
    assert m._guard.n_skipped == 2


def test_numeric_guard_flag_arms_default_policy():
    tflags.set_flags({"numeric_guard": True})
    try:
        m = _build(tpt, None)
        assert isinstance(m._guard, tguard.GuardPolicy)
    finally:
        tflags.set_flags({"numeric_guard": False})
    assert _build(tpt, None)._guard is None
    assert tflags.get_flag("numeric_guard") == \
        jflags.get_flag("numeric_guard") is False


# ---------------------------------------------------------------------------
# check_nan_inf, /statusz, instruments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 4])
def test_check_nan_inf_reports_the_step_inside_a_slab(k):
    batches = _batches(4)
    msgs = {}
    for pkg, fl in ((jpt, jflags), (tpt, tflags)):
        fl.set_flags({"check_nan_inf": True})
        try:
            _faults("data.poison", seed=2, nth=(3,))
            m = _build(pkg, None)
            if k == 1:
                for x, y in batches:
                    m.train_batch([x], [y])
                assert len(m._nan_pending) == 4   # buffered, not synced
            else:
                stack = jstack if pkg is jpt else tstack
                slab = stack(batches)
                m.train_loop_batch([slab[0]], [slab[1]])
            with pytest.raises(FloatingPointError) as ei:
                m.drain_metrics()
            msgs[pkg.__name__] = str(ei.value)
            assert m._nan_pending == []
        finally:
            fl.set_flags({"check_nan_inf": False})
    want = "step 2 (step 2 of a 4-step slab)" if k == 4 else "step 2;"
    assert want in msgs["paddle_tpu_torch"]
    assert msgs["paddle_tpu_torch"] == msgs["paddle_tpu"]


def test_statusz_row_equals_jax():
    from paddle_tpu.observability import server as jsrv
    from paddle_tpu_torch.observability import server as tsrv
    batches = _batches(4)
    _faults("grad.nonfinite", nth=(2,))
    rows = {}
    for pkg, srv in ((jpt, jsrv), (tpt, tsrv)):
        m = _build(pkg, dict(budget=5))
        _run_k1(m, batches)
        rows[pkg.__name__] = srv._providers[
            f"train_model_{id(m):x}"]()["numeric_guard"]
    assert rows["paddle_tpu_torch"] == rows["paddle_tpu"]
    assert rows["paddle_tpu"]["skipped"] == 1
    assert rows["paddle_tpu"]["skip_budget_left"] == 4


def _guard_counts(reg):
    out = {}
    for n in ("guard_skipped_steps_total", "guard_rollbacks_total"):
        fam = reg.get(n)
        out[n] = fam.value if fam is not None else 0
    fam = reg.get("guard_trips_total")
    for kind, action in (("nonfinite", "skip"), ("spike", "allow")):
        out[f"{kind}/{action}"] = fam.labels(kind, action).value \
            if fam is not None else 0
    return out


def test_guard_metric_deltas_equal_jax():
    batches = _batches(8)
    _faults("data.poison", nth=(2, 5))
    deltas, norms = {}, {}
    for pkg, obs in ((jpt, jobs), (tpt, tobs)):
        reg = obs.default_registry()
        before = _guard_counts(reg)
        m = _build(pkg, dict(budget=8))
        _run_k1(m, batches)
        after = _guard_counts(reg)
        deltas[pkg.__name__] = {k: after[k] - before[k] for k in after}
        norms[pkg.__name__] = reg.get("train_grad_norm").value
    assert deltas["paddle_tpu_torch"] == deltas["paddle_tpu"]
    assert deltas["paddle_tpu"]["guard_skipped_steps_total"] == 2
    np.testing.assert_allclose(norms["paddle_tpu_torch"],
                               norms["paddle_tpu"], rtol=RTOL)
