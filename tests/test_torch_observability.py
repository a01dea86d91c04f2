"""The port's control-plane observability against the JAX package's on
the CPU: the copied stdlib modules (metrics exposition, stream-audit
chains, W3C trace propagation, deadlines, backoff, seeded fault
schedules) agree with the originals; after the same traffic the two
engines count the same ``llm_*`` totals and build the same span tree;
the ``/memz`` pool rows tile the pool; and the engine's analytic
program FLOPs agree with ``torch.utils.flop_counter`` on the plain-twin
forward."""

import importlib
import json
import random
import threading
from urllib.request import urlopen

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.observability import audit as taudit  # noqa: E402
from paddle_tpu_torch.observability import exporters as texp  # noqa: E402
from paddle_tpu_torch.observability import memory as tmem  # noqa: E402
from paddle_tpu_torch.observability import metrics as tmetrics  # noqa: E402
from paddle_tpu_torch.observability import perf as tperf  # noqa: E402
from paddle_tpu_torch.observability import propagation as tprop  # noqa: E402
from paddle_tpu_torch.observability import server as tserver  # noqa: E402
from paddle_tpu_torch.observability import tracing as ttracing  # noqa: E402
from paddle_tpu_torch.reliability import faults as tfaults  # noqa: E402
from paddle_tpu_torch.reliability import retry as tretry  # noqa: E402

from test_torch_engine import pair  # noqa: E402
from test_torch_reliability import held  # noqa: E402
from test_torch_serving import make_engines  # noqa: E402

jaudit = importlib.import_module("paddle_tpu.observability.audit")
jexp = importlib.import_module("paddle_tpu.observability.exporters")
jmetrics = importlib.import_module("paddle_tpu.observability.metrics")
jprop = importlib.import_module("paddle_tpu.observability.propagation")
jtracing = importlib.import_module("paddle_tpu.observability.tracing")
jfaults = importlib.import_module("paddle_tpu.reliability.faults")
jretry = importlib.import_module("paddle_tpu.reliability.retry")


@pytest.fixture(scope="module")
def engines():
    jeng, teng = make_engines()
    yield jeng, teng
    jeng.close()
    teng.close()


# -- the copied stdlib modules ----------------------------------------------


def _registry_ops(metrics):
    reg = metrics.MetricRegistry()
    reg.counter("llm_tokens_generated", "tokens").inc(7)
    reg.counter("kv_migrate_pages_total", "pages",
                label_names=("direction",)).labels("export").inc(3)
    reg.gauge("llm_health_state", "health").set(2)
    h = reg.histogram("llm_ttft_seconds", "ttft")
    for v in (0.001, 0.02, 0.3, 4.0, 70.0):
        h.observe(v)
    reg.histogram("llm_batch_occupancy", "occ",
                  buckets=metrics.RATIO_BUCKETS).observe(0.5)
    reg.counter("checkpoint.save", "dotted name").inc()
    return reg


def test_prometheus_text_is_byte_identical():
    assert texp.prometheus_text(_registry_ops(tmetrics)) == \
        jexp.prometheus_text(_registry_ops(jmetrics))


def test_stream_chains_agree():
    rng = np.random.RandomState(0)
    for nonce in (0, 7, 2 ** 31 - 1):
        toks = rng.randint(0, 50304, 40).tolist()
        assert taudit.chain_of(nonce, toks) == jaudit.chain_of(nonce, toks)
        assert taudit.heads_of(nonce, toks[:5]) == \
            jaudit.heads_of(nonce, toks[:5])
    assert taudit.first_divergence([1, 2, 3], [1, 5, 3]) == \
        jaudit.first_divergence([1, 2, 3], [1, 5, 3]) == 1


def test_traceparent_parse_and_format_agree():
    good = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    for value in (good, good.upper(), "00-" + "0" * 32 + "-" + "cd" * 8
                  + "-01", "garbage", "", None, "01-xx-yy-zz"):
        t, j = tprop.parse_traceparent(value), jprop.parse_traceparent(value)
        assert (t is None) == (j is None), value
        if t is not None:
            assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
            assert tprop.format_traceparent(t) == \
                jprop.format_traceparent(j)


def test_deadlines_and_backoff_agree():
    for mod in (tretry, jretry):
        past = mod.Deadline.after(-1.0)
        assert past.expired and past.clamp(3.0) == 0.0
        assert mod.Deadline.after(10.0).clamp(1.0) == 1.0
        assert mod.as_deadline(None) is None
        with pytest.raises(mod.DeadlineExceeded):
            past.raise_if_expired("unit test")
    for i in range(8):
        assert tretry.backoff_delay(i, 0.5, cap=4.0) == \
            jretry.backoff_delay(i, 0.5, cap=4.0)
        assert tretry.backoff_delay(i, 1.0, jitter=0.5,
                                    rng=random.Random(i)) == \
            jretry.backoff_delay(i, 1.0, jitter=0.5, rng=random.Random(i))


def test_seeded_fault_schedule_over_1000_checks_agrees():
    logs = []
    for faults in (tfaults, jfaults):
        faults.reset()
        faults.inject("device.dispatch", p=0.05)
        faults.inject("device.transfer", nth=(3, 500, 999), times=2)
        faults.enable(seed=11)
        try:
            fired = []
            for i in range(1000):
                for site in ("device.dispatch", "device.transfer"):
                    try:
                        faults.check(site)
                    except faults.FaultInjected:
                        fired.append((site, i))
            logs.append((fired, faults.injected_log(),
                         faults.preview("device.dispatch", 1000)))
        finally:
            faults.reset()
    assert logs[0] == logs[1]
    assert 20 < len(logs[0][0]) < 90


# -- the engines after the same traffic -------------------------------------

COUNTERS = ("llm_tokens_generated", "llm_prefills", "llm_requests_completed",
            "llm_prompt_tokens", "llm_prefix_cache_hit_tokens")
SYSTEM = list(range(3, 23))            # a 20-token shared prefix


def _value(metrics, name):
    fam = metrics.default_registry().get(name)
    return fam.value if fam is not None else 0.0


def _traffic(eng):
    eng.submit(SYSTEM + [1], max_new_tokens=3).result(timeout=60)
    with held(eng):
        futs = [eng.submit(SYSTEM + [30 + i] * (i + 1), max_new_tokens=4,
                           temperature=0.9 * (i % 2), nonce=i)
                for i in range(4)]
    return [f.result(timeout=60)["output_ids"] for f in futs]


def test_llm_counters_equal_after_the_same_traffic(engines):
    deltas, outs = [], []
    for eng, metrics in zip(engines, (jmetrics, tmetrics)):
        before = {n: _value(metrics, n) for n in COUNTERS}
        outs.append(_traffic(eng))
        deltas.append({n: _value(metrics, n) - before[n]
                       for n in COUNTERS})
    assert outs[1] == outs[0]
    assert deltas[1] == deltas[0]
    assert deltas[1]["llm_prefix_cache_hit_tokens"] == 4 * 20


def _span_tree(tracing, eng):
    tracing.enable()
    try:
        tracing.clear()
        eng.submit([5, 6, 7, 8, 9, 10], max_new_tokens=3,
                   trace_context="00-" + "ef" * 16 + "-" + "12" * 8 +
                   "-01").result(timeout=60)
        spans = tracing.finished_spans()
    finally:
        tracing.disable()
        tracing.clear()
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], names.get(s["parent_id"], s["parent_id"]),
                   s["trace_id"], s["attrs"].get("outcome"))
                  for s in spans)


def test_span_trees_are_equal(engines):
    trees = [_span_tree(tr, eng)
             for eng, tr in zip(engines, (jtracing, ttracing))]
    assert trees[1] == trees[0]
    assert [n for n, *_ in trees[1]] == sorted(
        ["llm.request", "llm.queue", "llm.prefill", "llm.first_token",
         "llm.decode"])


def test_memz_pool_rows_tile_the_pool(engines):
    _, teng = engines
    srv = tserver.DebugServer(port=0).start()
    try:
        with held(teng):
            futs = [teng.submit(SYSTEM + [40 + i], max_new_tokens=30)
                    for i in range(3)]
            with urlopen(f"http://127.0.0.1:{srv.port}/memz",
                         timeout=30) as r:
                memz = json.loads(r.read())
        for f in futs:
            f.result(timeout=60)
    finally:
        srv.stop()
    rows = [r for r in memz["owners"]
            if r["owner"] == "kv_pool" and r["scope"] == teng._mem_scope]
    pbk = teng._tgt_page_bytes
    assert sum(r["bytes"] for r in rows) == teng.num_pages * pbk
    assert {r["kind"] for r in rows} >= {"free", "private",
                                         "prefix_shared", "scratch"}
    assert memz["unattributed_bytes"] is None      # no card on the CPU
    assert tmem.instance().headroom()["kv_pages_addable"] > 0


def test_perfz_resolves_the_programs(engines):
    _, teng = engines
    teng.submit(SYSTEM, max_new_tokens=6).result(timeout=60)
    teng.submit(SYSTEM[:9], max_new_tokens=6).result(timeout=60)
    progs = [p for p in tperf.perfz_payload()["programs"]
             if p["scope"] == teng._perf_scope]
    kinds = {p["kind"] for p in progs}
    assert {"mixed_tick", "decode_step"} <= kinds
    assert all(p["cost_resolved"] and p["flops"] > 0 for p in progs)


# -- analytic FLOPs against torch's flop counter ----------------------------

FLOP_TOL = 0.10   # relative; biases and layer norms are in the analytic
# count and not in the counter's, and the plain twin attends each row's
# whole table span where the analytic count takes its context length


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        with torch.inference_mode():
            fn()
    return fc.get_total_flops()


def test_analytic_flops_match_the_flop_counter():
    net = pair("gpt2")[1]
    cfg = net.cfg
    B, ps, P = 4, 4, 4           # a table of 4 pages spans 16 tokens
    eng_cost = tllm._model_cost(net, torch.zeros(
        (cfg.num_layers, 32, ps, cfg.num_kv_heads, cfg.head_dim)))
    kp = torch.zeros((cfg.num_layers, 32, ps, cfg.num_kv_heads,
                      cfg.head_dim))
    vp = torch.zeros_like(kp)
    tables = torch.arange(1, 1 + B * P, dtype=torch.int32).reshape(B, P)
    key = torch.tensor([0, 0], dtype=torch.int64)
    temps = torch.zeros(B)
    nonces = torch.zeros(B, dtype=torch.int64)
    # a decode tick: B rows at context 16 (the table's whole span)
    lens = torch.full((B,), 16, dtype=torch.int32)
    decode = tllm._PagedDecode(net, "plain")
    got = _counted(lambda: decode(
        torch.ones(B, dtype=torch.int64), torch.full((B,), 15), tables,
        lens, kp, vp, temps, nonces, key, any_sampled=False))
    want = tllm._pass_cost(eng_cost, B, int(lens.sum()), int(lens.sum()),
                           B)[0]
    assert abs(want - got) <= FLOP_TOL * got, (want, got)
    # a prefill chunk: one prompt's 16 rows, limits 1..16
    T = 16
    pos = torch.arange(T)
    lim = (pos + 1).int()
    chunk = tllm._ChunkedPrefill(net, "plain")
    got = _counted(lambda: chunk(
        torch.ones(T, dtype=torch.int64), pos, lim,
        tables[:1].repeat(T, 1), torch.zeros(B, dtype=torch.int64),
        torch.zeros(B, dtype=torch.int64), kp, vp, temps, nonces, key,
        any_sampled=False))
    want = tllm._pass_cost(eng_cost, T, int(lim.sum()), T, B)[0]
    assert abs(want - got) <= FLOP_TOL * got, (want, got)


def test_served_flops_and_knobs_ride_the_result(engines):
    outs = [eng.submit([1, 2, 3, 4, 5], max_new_tokens=4, nonce=9)
            .result(timeout=60) for eng in engines]
    assert outs[1]["served_flops"] == outs[0]["served_flops"]
    assert outs[1]["knobs"] == outs[0]["knobs"]
    assert outs[1]["stream_digest"] == outs[0]["stream_digest"]


# -- the time ledger past its soft cap ---------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _ledger_pair():
    jgood = importlib.import_module("paddle_tpu.observability.goodput")
    from paddle_tpu_torch.observability import goodput as tgood
    jc, tc = _Clock(), _Clock()
    return ((jc, jgood.TimeLedger(clock=jc,
                                  registry=jmetrics.MetricRegistry())),
            (tc, tgood.TimeLedger(clock=tc,
                                  registry=tmetrics.MetricRegistry())),
            tgood)


@pytest.mark.parametrize("clock", ["dyadic", "random"])
def test_time_ledger_past_the_soft_cap_equals_jax(clock):
    """9,600 notes at ~31 a second, so that past ~265 s more than
    PENDING_SOFT_CAP = 8192 intervals are pending within the 300 s
    horizon, a few notes reaching back past the horizon: the port's totals, clipped seconds and gap splits
    equal the JAX ledger's. ``dyadic`` times (multiples of 1/64 s) sum
    exactly in float64, so the totals are equal; ``random`` times within
    1e-9 relative (the port folds in batches, so its float sums run in
    another order). The port sweeps the pending list once per fold, not
    once per note."""
    (jc, jled), (tc, tled), tgood = _ledger_pair()
    rs = np.random.RandomState(0)
    n = 9600
    steps = rs.exponential(0.032, n)
    durs = rs.exponential(0.015, n)
    durs[rs.rand(n) < 0.002] = 350.0
    if clock == "dyadic":
        steps = np.round(steps * 64) / 64
        durs = np.ceil(durs * 64) / 64
    buckets = rs.randint(0, len(tgood.BUCKETS), n)
    sweeps = {"n": 0}
    real_sweep = tgood._sweep

    def counting_sweep(*a):
        sweeps["n"] += 1
        return real_sweep(*a)

    tgood._sweep = counting_sweep
    try:
        peak = 0
        for i in range(n):
            jc.t += float(steps[i])
            tc.t += float(steps[i])
            b = tgood.BUCKETS[buckets[i]]
            jled.note(b, float(durs[i]))
            tled.note(b, float(durs[i]))
            peak = max(peak, len(jled._pending))
    finally:
        tgood._sweep = real_sweep
    assert peak > tgood.PENDING_SOFT_CAP
    want, got = jled.totals(), tled.totals()
    assert got.keys() == want.keys()
    if clock == "dyadic":
        assert got == want
        assert tled._clipped_s == jled._clipped_s
    else:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                       atol=1e-9)
        np.testing.assert_allclose(tled._clipped_s, jled._clipped_s,
                                   rtol=1e-9)
    assert tled._split_gaps == jled._split_gaps
    notes_past_cap = n - tgood.PENDING_SOFT_CAP
    assert sweeps["n"] < notes_past_cap / 100


# -- the registries' GC finalizers never block on their own lock -------------

@pytest.mark.parametrize("registry", ["perf", "memory"])
def test_finalizer_inside_the_registry_lock_does_not_deadlock(registry):
    """A garbage owner (a reference cycle) whose scope finalizer runs in
    a collection that starts while the registry's own lock is held (an
    allocation inside ``register_program`` / ``set_entry``): the
    finalizer must not block on the non-reentrant lock. The scope is
    dropped by the lock's next holder."""
    import gc
    mod = tperf if registry == "perf" else tmem
    mod.reset()
    reg = mod.instance()

    class Owner:
        pass

    owner = Owner()
    owner.cycle = owner
    scope = mod.next_scope()
    if registry == "perf":
        reg.register_program("train", "step", sig=("x",), scope=scope)
    else:
        reg.set_entry(scope, "owner", "kind", 64.0)
    mod.finalize_scope(owner, scope)
    del owner
    done = threading.Event()

    def collect_under_lock():
        with reg._mu:
            gc.collect()
        done.set()

    was = gc.isenabled()
    gc.disable()
    try:
        t = threading.Thread(target=collect_under_lock, daemon=True)
        t.start()
        t.join(timeout=30)
    finally:
        if was:
            gc.enable()
    assert done.is_set(), "the finalizer deadlocked on the registry lock"
    if registry == "perf":
        reg.register_program("train", "step", sig=("y",))
        assert reg.get_program("train", "step", ("x",), scope=scope) is None
    else:
        assert not [r for r in reg.rows() if r.get("scope") == scope]
    mod.reset()
