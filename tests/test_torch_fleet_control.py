"""The serving fleet's host-side control logic, port against the JAX
package: each scenario below is scripted once and run through both
packages' classes on the same inputs (fake clocks, stub replicas,
injected sensors), and must give the same state or action trace.

Covered: ``CircuitBreaker``, ``affinity_key`` / ``rendezvous_pick``,
``SLOTracker`` burn rates, ``TenantQuota`` at the router,
``AIMDLimiter``, ``BrownoutLadder``, ``ServiceTimeEstimator``,
``OverloadController`` and the ``Autoscaler`` in the fake-clock harness
of ``tests/test_autoscaler.py`` (square wave, backoff, dwell, spawn
faults, drain, min/max bounds); then ``parse_prometheus_text`` on each
package's own ``/metrics`` text after a request served by
``serve_llm``."""

import importlib
import json
import threading
import time
from types import SimpleNamespace
from urllib.request import Request, urlopen

import numpy as np
import pytest

pytest.importorskip("torch")

from test_autoscaler import FakeClient, FakeHandle, FakeRouter  # noqa: E402


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
    return SimpleNamespace(
        root=root, serving=mod("serving"), router=mod("serving.router"),
        overload=mod("serving.overload"), slo=mod("observability.slo"),
        metrics=mod("observability.metrics"),
        faults=mod("reliability.faults"), llm=mod("inference.llm"))


JAX, PORT = _pkg("paddle_tpu"), _pkg("paddle_tpu_torch")


def clock(start=0.0):
    t = [start]
    return t, (lambda: t[0])


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def breaker_trip_half_open_close(P):
    t, clk = clock()
    b = P.serving.CircuitBreaker(fail_threshold=3, open_for=5.0,
                                 half_open_probes=1, clock=clk)
    trace = []
    for at, op in ((0.0, "fail"), (0.1, "fail"), (0.2, "allow"),
                   (0.3, "fail"), (0.4, "allow"), (4.9, "allow"),
                   (5.3, "allow"), (5.3, "allow"), (5.4, "ok"),
                   (5.5, "allow")):
        t[0] = at
        if op == "fail":
            b.record_failure()
            trace.append((at, op, b.state))
        elif op == "ok":
            b.record_success()
            trace.append((at, op, b.state))
        else:
            trace.append((at, op, b.allow(), b.state))
    assert ("half_open" in {x[-1] for x in trace}) and b.state == "closed"
    return trace + [b.n_opens]


def breaker_failed_probe_reopens(P):
    t, clk = clock()
    b = P.serving.CircuitBreaker(fail_threshold=1, open_for=2.0,
                                 clock=clk)
    trace = []
    b.record_failure()
    for at, op in ((2.5, "allow"), (2.5, "fail"), (4.0, "allow"),
                   (4.6, "allow"), (4.6, "ok")):
        t[0] = at
        if op == "allow":
            trace.append((at, b.allow(), b.state))
        else:
            (b.record_failure if op == "fail" else b.record_success)()
            trace.append((at, op, b.state))
    assert b.n_opens == 2
    return trace


def breaker_streak_and_reset(P):
    b = P.serving.CircuitBreaker(fail_threshold=2, open_for=1e9)
    trace = []
    for op in ("fail", "ok", "fail", "fail", "reset", "fail"):
        {"fail": b.record_failure, "ok": b.record_success,
         "reset": b.reset}[op]()
        trace.append((op, b.state, b.allow()))
    assert trace[3][1] == "open" and trace[4][1] == "closed"
    return trace


# ---------------------------------------------------------------------------
# affinity and rendezvous
# ---------------------------------------------------------------------------

def affinity_families(P):
    rng = np.random.RandomState(0)
    prefix = rng.randint(0, 97, 32).tolist()
    prompts = [prefix + rng.randint(0, 97, n).tolist() for n in (3, 17, 40)]
    prompts += [[7] + prefix[1:] + [1, 2], [1, 2, 3], [1, 2, 4], [5]]
    keys = [P.router.affinity_key(p, ps, ap).hex() for p in prompts
            for ps, ap in ((16, 2), (4, 2), (4, 1), (16, 1))]
    assert keys[0] == keys[4] == keys[8]          # one prefix family
    return keys


def rendezvous_churn(P):
    rng = np.random.RandomState(1)
    keys = [bytes(rng.bytes(16)) for _ in range(64)]
    trace = []
    for names in (["r0", "r1", "r2", "r3"], ["r0", "r1", "r3"],
                  ["r0", "r1", "r3", "r4"], ["pre0"], []):
        trace.append([P.router.rendezvous_pick(k, names) for k in keys])
    assert set(trace[0]) == {"r0", "r1", "r2", "r3"}
    return trace


# ---------------------------------------------------------------------------
# SLO burn rates
# ---------------------------------------------------------------------------

def slo_burn_rates(P):
    t, clk = clock()
    tr = P.slo.SLOTracker(targets={"gold": 0.99, "bronze": 0.9},
                          windows=(10.0, 40.0), min_samples=3,
                          breach_threshold=5.0,
                          registry=P.metrics.MetricRegistry(), clock=clk)
    script = [("gold", "t0", 0.2, "ok"), ("gold", "t0", 0.4, "ok"),
              ("bronze", "t1", 1.5, "deadline"), ("gold", "t1", 0.3, "ok"),
              ("bronze", "t1", 0.9, "ok"), ("gold", "t0", 2.0, "shed"),
              (None, None, 0.1, "cancelled"), ("gold", "t0", 3.0,
                                               "deadline"),
              ("bronze", "t2", 0.5, "unavailable"), ("gold", "t2", 0.2,
                                                     "error")]
    trace = []
    for i, (cls, tenant, lat, outcome) in enumerate(script):
        t[0] = 1.0 * i
        tr.record(cls, tenant, lat, outcome, had_deadline=cls is not None)
        trace.append((t[0], tr.window_status(), tr.breached()))
    for at in (15.0, 45.0, 100.0):
        t[0] = at
        tr.refresh()
        trace.append((at, tr.window_status(), tr.breached()))
    report = tr.report()
    for c in report["classes"].values():
        c.pop("breached_at", None)          # wall time of the latch
    trace.append(report)
    tr.reset_breach()
    trace.append(tr.breached())
    assert any(s[2] for s in trace[:-2] if isinstance(s, tuple))
    return json.loads(json.dumps(trace, default=str))


# ---------------------------------------------------------------------------
# the router's tenant quota, over stub replicas
# ---------------------------------------------------------------------------

class Stub:
    """A replica that answers every submit with max_new_tokens ones,
    after ``block`` is set."""

    def __init__(self, block):
        self.block = block
        self.calls = 0

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               deadline_s=None, priority=0, nonce=None,
               trace_context=None, tenant=None):
        self.calls += 1
        self.block.wait(30)
        return {"output_ids": [1] * max_new_tokens, "tenant": tenant}

    def health(self):
        return "healthy"

    def cancel(self, request_id):
        return False

    def close(self):
        pass


def tenant_quota(P):
    gate = threading.Event()
    stub = Stub(gate)
    r = P.serving.Router(
        {"a": stub}, page_size=4, health_poll_interval=5.0,
        tenants={"acme": P.serving.TenantQuota(max_inflight=2),
                 "big": P.serving.TenantQuota(max_inflight=5,
                                              slo="gold")},
        slo_classes={"gold": P.serving.SLOClass("gold", priority=3)},
        name="quota")
    try:
        futs = [r.submit([1, 2, 3 + i], max_new_tokens=2, tenant=tn)
                for i, tn in enumerate(["acme", "acme", "acme", "big",
                                        "acme", None])]
        deadline = time.monotonic() + 30
        while stub.calls < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        early = [f.done() for f in futs]
        gate.set()
        trace = [early]
        for f in futs:
            e = f.exception(timeout=30)
            trace.append(("ok", f.result()["tenant"]) if e is None else
                         (type(e).__name__, getattr(e, "reason", None)))
        trace.append((r.n_submitted, r.n_shed, stub.calls))
        # the quota is released as requests resolve
        trace.append(r.submit([9], max_new_tokens=1,
                              tenant="acme").result(30)["tenant"])
    finally:
        gate.set()
        r.close()
    assert trace[3][0] == "AdmissionShed" and trace[1][0] == "ok"
    return trace


# ---------------------------------------------------------------------------
# overload control
# ---------------------------------------------------------------------------

def aimd_limiter(P):
    t, clk = clock(100.0)
    lim = P.serving.AIMDLimiter(floor=2, ceiling=8, initial=4,
                                raise_step=1.0, cut_factor=0.5,
                                cut_interval_s=0.25, clock=clk)
    trace = []
    for step, (dt, op, name) in enumerate(
            [(0, "ok", "r0"), (0, "ok", "r0"), (0.1, "miss", "r0"),
             (0.1, "miss", "r0"), (0.2, "miss", "r0"), (0, "ok", "r1")]
            + [(0.3, "miss", "r1")] * 4 + [(0, "ok", "r0")] * 9
            + [(0, "forget", "r1")]):
        t[0] += dt
        res = {"ok": lim.on_success, "miss": lim.on_miss,
               "forget": lim.forget}[op](name)
        trace.append((step, op, name, res, lim.state(),
                      lim.has_room(name, 3), lim.n_cuts))
    return trace


def brownout_ladder(P):
    t, clk = clock(100.0)
    lad = P.serving.BrownoutLadder(up_dwell_s=0.5, down_dwell_s=2.0,
                                   backoff_base_s=1.0, backoff_cap_s=8.0,
                                   healthy_dwell_s=6.0, clock=clk)
    trace = []
    # a square wave faster than the dwell, then a long storm, a quiet
    # stretch, a forced (chaos) step and the walk back
    for i in range(240):
        t[0] += 0.1
        pressure = (i // 5) % 2 == 0 if i < 120 else 120 <= i < 160
        trace.append(lad.step(pressure, inputs={"i": i}))
    lad.force(3, reason="chaos")
    for _ in range(20):
        t[0] += 1.0
        trace.append(lad.step(False))
    trace.append(lad.transitions())
    trace.append((lad.n_transitions, lad._flips, lad.level))
    assert max(trace[:240]) >= 2 and lad.level == 0
    return trace


def service_time_estimator(P):
    trace = []
    for rates in ((2000.0, 50.0), (0.0, 50.0), None):
        est = P.serving.ServiceTimeEstimator(safety_factor=2.0,
                                             source=lambda r=rates: r)
        for prompt, new, queue, deadline in ((100, 10, 0.0, 1.0),
                                             (900, 32, 0.5, 0.3),
                                             (17, 64, 0.0, None),
                                             (512, 1, 2.0, 1.2)):
            p = est.predict(prompt, new, queue_s=queue)
            trace.append((rates, prompt, new, queue, p,
                          est.hopeless(p, deadline)))
    with pytest.raises(ValueError):
        P.serving.ServiceTimeEstimator(safety_factor=0.5)
    assert any(x[-1] for x in trace) and not all(x[-1] for x in trace)
    return trace


class OverloadRouter:
    """The Router surface OverloadController reads."""

    def __init__(self, P, clk):
        self.name = "ovl"
        self.slo = P.slo.SLOTracker(
            targets={"gold": 0.99, "bronze": 0.9}, windows=(5.0, 20.0),
            min_samples=3, breach_threshold=2.0,
            registry=P.metrics.MetricRegistry(), clock=clk)
        self.inflight = 0

    def fleet_load(self, slots_per_replica=None):
        return {"ready": 2, "warming": 0, "inflight": self.inflight}


def overload_controller(P):
    t, clk = clock(100.0)
    ctl = P.serving.OverloadController(
        estimator=P.serving.ServiceTimeEstimator(
            source=lambda: (4000.0, 40.0)),
        limiter=P.serving.AIMDLimiter(ceiling=8, clock=clk),
        ladder=P.serving.BrownoutLadder(up_dwell_s=0.5, down_dwell_s=1.0,
                                        clock=clk),
        bronze_max_new_tokens=16, registry=P.metrics.MetricRegistry(),
        clock=clk)
    router = OverloadRouter(P, clk)
    ctl.bind(router)

    def verdict(v):
        s = v.get("shed")
        return {k: (val if k != "shed" else
                    (type(s).__name__, s.reason, s.retry_after_s))
                for k, val in sorted(v.items())}

    trace = []
    try:
        for i in range(24):
            t[0] += 0.5
            if 4 <= i < 14:                 # a storm of bronze misses
                router.slo.record("bronze", None, 2.0, "deadline",
                                  had_deadline=True)
            router.inflight = i % 5
            ctl.on_outcome("r%d" % (i % 2), ("ok", "deadline", "shed")[
                i % 3], 0.5, 0.4 + 0.1 * (i % 4))
            level = ctl.tick()
            row = [level, ctl.allow_optional_work(), ctl.retry_after_s(),
                   round(ctl.queue_estimate(), 9), ctl.limiter.state()]
            for slo, prompt, new, dl in (("gold", 900, 64, 0.5),
                                         ("bronze", 64, 32, 2.0),
                                         ("bronze", 900, 64, 1.0),
                                         (None, 17, 8, None)):
                row.append(verdict(ctl.admit(slo, prompt, new, dl)))
            trace.append(row)
        trace.append(ctl._overloadz()["transitions"])
        trace.append(dict(ctl.n_shed))
    finally:
        ctl.unbind()
    assert max(r[0] for r in trace[:24]) >= 2 and ctl.n_shed
    return json.loads(json.dumps(trace))


# ---------------------------------------------------------------------------
# the autoscaler in the fake-clock harness of tests/test_autoscaler.py
# ---------------------------------------------------------------------------

class Harness:
    def __init__(self, P, **kw):
        self.t = [0.0]
        self.router = FakeRouter(slots=kw.get("replica_slots", 4))
        self.router.attach("r0", FakeClient())
        self.burn = {}
        self.spawn_calls = []
        self.handles = {}

        def spawner(name):
            self.spawn_calls.append(name)
            h = FakeHandle()
            self.handles[name] = h
            return FakeClient(), h

        for k, v in dict(min_replicas=1, max_replicas=4,
                         backoff_base_s=1.0, backoff_cap_s=60.0,
                         dwell_s=8.0, low_water=0.1, drain_deadline_s=5.0,
                         spawn_backoff_s=0.01).items():
            kw.setdefault(k, v)
        self.scaler = P.serving.Autoscaler(
            self.router, spawner, synchronous=True,
            clock=lambda: self.t[0],
            sleep=lambda s: self.t.__setitem__(0, self.t[0] + s),
            burn_fn=lambda: self.burn, **kw)

    def trip(self, burn=50.0):
        w = {"burn_rate": burn, "requests": 99, "eligible": True}
        self.burn = {"gold": {"tripped": True,
                              "windows": {"short": w, "long": w}}}

    def run(self, seconds, dt=0.25):
        actions = []
        end = self.t[0] + seconds
        while self.t[0] < end:
            a = self.scaler.tick()
            if a:
                actions.append((round(self.t[0], 3), a))
            self.t[0] += dt
        return actions

    def trace(self, actions):
        return {"actions": actions,
                "decisions": [{k: v for k, v in d.items() if k != "wall"}
                              for d in self.scaler.decisions()],
                "spawned": self.spawn_calls,
                "terminated": sorted(n for n, h in self.handles.items()
                                     if h.terminated),
                "load": self.router.fleet_load(),
                "counts": (self.scaler.n_scale_out,
                           self.scaler.n_scale_in)}


def autoscale_square_wave(P):
    h = Harness(P)
    actions = []
    for _ in range(30):
        h.trip()
        actions += h.run(2.0)
        h.burn = {}
        actions += h.run(2.0)
    assert 1 <= len(actions) <= 19
    return h.trace(actions)


def autoscale_backoff(P):
    h = Harness(P, max_replicas=8)
    h.trip()
    actions = h.run(20.0, dt=0.05)
    outs = [t for t, a in actions if a == "scale_out"]
    assert len(outs) >= 4 and outs[2] - outs[1] >= 1.95
    return h.trace(actions)


def autoscale_dwell(P):
    h = Harness(P)
    h.trip()
    actions = [(0.0, h.scaler.tick())]
    h.burn = {}
    actions += h.run(7.5) + h.run(2.0)
    assert [a for _, a in actions] == ["scale_out", "scale_in"]
    return h.trace(actions)


def autoscale_spawn_faults(P):
    P.faults.reset()
    try:
        h = Harness(P)
        P.faults.enable(seed=7)
        P.faults.inject("autoscale.spawn", nth=(1, 3, 4, 5))
        h.trip()
        actions = h.run(6.0)
        log = P.faults.injected_log()
    finally:
        P.faults.reset()
    out = h.trace(actions)
    out["faults"] = log
    assert any(d["action"] == "scale_out_failed"
               for d in out["decisions"])
    return out


def autoscale_drain(P):
    P.faults.reset()
    try:
        h = Harness(P)
        h.trip()
        actions = [(0.0, h.scaler.tick())]
        h.burn = {}
        h.scaler.low_water = 0.6
        name = h.scaler.decisions()[-1]["replica"]
        h.t[0] += h.scaler.dwell_s + 1
        t_empty = h.t[0] + 0.8
        h.router.inflight[name] = lambda: 3 if h.t[0] < t_empty else 0
        actions.append((h.t[0], h.scaler.tick()))
        # a second managed replica that never drains: the deadline
        # kills it with stragglers, and a drain fault expires it at once
        h.trip()
        h.t[0] += h.scaler.dwell_s + 1
        actions.append((h.t[0], h.scaler.tick()))
        h.burn = {}
        name2 = h.scaler.decisions()[-1]["replica"]
        h.router.inflight[name2] = 2
        h.scaler.drain_deadline_s = 1.5
        P.faults.enable(seed=3)
        P.faults.inject("autoscale.drain", nth=(1,))
        h.t[0] += h.scaler.dwell_s + 1
        actions.append((h.t[0], h.scaler.tick()))
        log = P.faults.injected_log()
    finally:
        P.faults.reset()
    out = h.trace(actions)
    out["faults"] = log
    assert [a for _, a in actions] == ["scale_out", "scale_in",
                                       "scale_out", "scale_in"]
    return out


def autoscale_bounds(P):
    h = Harness(P, max_replicas=2)
    h.trip()
    actions = h.run(30.0)
    at_max = h.router.fleet_load()["ready"]
    h.burn = {}
    actions += h.run(60.0)
    assert at_max == 2 and h.router.fleet_load()["ready"] == 1
    boot = Harness(P, min_replicas=2, max_replicas=3)
    boot_actions = boot.run(5.0)
    return {"bounds": h.trace(actions), "bootstrap": boot.trace(
        boot_actions)}


SCENARIOS = {f.__name__: f for f in (
    breaker_trip_half_open_close, breaker_failed_probe_reopens,
    breaker_streak_and_reset, affinity_families, rendezvous_churn,
    slo_burn_rates, tenant_quota, aimd_limiter, brownout_ladder,
    service_time_estimator, overload_controller, autoscale_square_wave,
    autoscale_backoff, autoscale_dwell, autoscale_spawn_faults,
    autoscale_drain, autoscale_bounds)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_same_trace_as_reference(scenario):
    want = SCENARIOS[scenario](JAX)
    got = SCENARIOS[scenario](PORT)
    assert got == want


# ---------------------------------------------------------------------------
# parse_prometheus_text on each package's own /metrics text
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def metrics_texts():
    """Each package's ``prometheus_text()`` after one request through
    its own ``serve_llm`` over HTTP (engines of
    ``make_engine_from_spec``'s geometry)."""
    spec = {"vocab": 97, "layers": 2, "hidden": 64}
    texts = {}
    for P, extra in ((JAX, {}), (PORT, {"device": "cpu"})):
        eng = P.serving.make_engine_from_spec(dict(spec, **extra))
        srv = P.llm.serve_llm(eng)
        try:
            base = "http://%s:%d" % srv.server_address[:2]
            body = json.dumps({"prompt_ids": [4, 5, 6, 7, 8],
                               "max_new_tokens": 4, "temperature": 0.7,
                               "nonce": 3, "tenant": "acme"}).encode()
            with urlopen(Request(base + "/generate", data=body),
                         timeout=120) as r:
                assert r.status == 200
        finally:
            srv.shutdown()
            srv.server_close()
            eng.close()
        obs = importlib.import_module(f"{P.root}.observability")
        texts[P.root] = obs.prometheus_text()
    return texts


@pytest.mark.parametrize("text_of", ["paddle_tpu", "paddle_tpu_torch"])
def test_parse_prometheus_text_same_as_reference(metrics_texts, text_of):
    text = metrics_texts[text_of]
    want = JAX.serving.parse_prometheus_text(text)
    got = PORT.serving.parse_prometheus_text(text)
    assert got == want
    assert want["llm_tokens_generated"]["samples"]
    assert want["llm_served_flops_total"]["samples"]


def test_engine_metric_families_same_as_reference(metrics_texts):
    """The ``llm_*`` families the fleet federates: the same names and
    types in both packages' text."""
    fams = {root: {k: v["type"] for k, v in
                   JAX.serving.parse_prometheus_text(text).items()
                   if k.startswith("llm_")}
            for root, text in metrics_texts.items()}
    assert fams["paddle_tpu_torch"] == fams["paddle_tpu"]
    assert len(fams["paddle_tpu"]) > 10
