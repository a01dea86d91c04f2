"""The port's profiler and its consumers (``export_chrome_tracing``,
``POST /profilez``, ``Model.fit``'s model-perspective buckets), the
tuning facade (``DataLoader(num_workers="auto")``), ``sysconfig`` and
``version`` against the JAX package's.

Scheduler states, summary rows (names and calls) and fit buckets must be
equal; the JAX package's profiler rules (the stale-stop rule, the
interval-overlap export, the 409 of ``/profilez``) are run on the port.
The JAX profiler traces nothing here: its ``start_trace`` would write an
XProf dump, so the JAX side runs with the trace slot's two calls
replaced by no-ops (``_start_trace`` / ``_stop_trace`` of the instance),
which leaves the host tables, the windows and the schedule as they
are."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import profiler as jprof  # noqa: E402
from paddle_tpu_torch import profiler as tprof  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.observability import server as tserver  # noqa: E402
from paddle_tpu_torch.observability import tracing as ttrace  # noqa: E402


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _untraced(prof):
    """A JAX Profiler whose device trace (an XProf dump) is not taken:
    only its window bookkeeping runs."""
    def start():
        if not prof._tracing:
            prof._tracing = True
            prof._windows.append([time.perf_counter(), None])

    def stop():
        if prof._tracing:
            prof._tracing = False
            if prof._windows and prof._windows[-1][1] is None:
                prof._windows[-1][1] = time.perf_counter()
            if prof.on_trace_ready:
                prof.on_trace_ready(prof)
    prof._start_trace, prof._stop_trace = start, stop
    return prof


SCHEDULES = [dict(closed=1, ready=1, record=3),
             dict(closed=0, ready=0, record=1),
             dict(closed=2, ready=1, record=2, repeat=2),
             dict(closed=1, ready=2, record=1, skip_first=3),
             dict(closed=3, ready=0, record=4, repeat=1, skip_first=2)]


@pytest.mark.parametrize("kw", SCHEDULES,
                         ids=["c1r1R3", "R1", "repeat2", "skip3",
                              "repeat1skip2"])
def test_make_scheduler_states_equal_jax(kw):
    js, ts = jprof.make_scheduler(**kw), tprof.make_scheduler(**kw)
    assert [ts(i).name for i in range(30)] == [js(i).name for i in range(30)]


def _summary_rows(text):
    rows = []
    for line in text.splitlines():
        if line.startswith(("----", "Event")) or not line.strip():
            continue
        if line.startswith("no device events"):
            continue
        rows.append((line[:40].strip(), int(line[40:48])))
    return rows


def _events_script(mod, prof):
    """The same RecordEvent sequence in either package: steps with nested
    events and one from a worker thread."""
    prof.start()
    for i in range(4):
        with mod.RecordEvent("TrainStep"):
            with mod.RecordEvent("forward"):
                pass
            if i % 2:
                with mod.RecordEvent("Callbacks"):
                    pass
        with mod.RecordEvent("Dataloader"):
            pass
        prof.step()
    t = threading.Thread(target=lambda: mod.RecordEvent("worker").__enter__()
                         .__exit__(None, None, None))
    t.start()
    t.join()
    prof.stop()
    return _summary_rows(prof.summary(sorted_by="calls"))


def test_summary_rows_equal_jax(tmp_path):
    sched = dict(closed=1, ready=0, record=2)
    want = _events_script(jprof, _untraced(jprof.Profiler(
        scheduler=jprof.make_scheduler(**sched))))
    got = _events_script(tprof, tprof.Profiler(
        scheduler=tprof.make_scheduler(**sched),
        log_dir=str(tmp_path / "t")))
    assert sorted(got) == sorted(want)
    assert ("TrainStep", 4) in got and ("worker", 1) in got


def _fit_buckets(pkg, prof_mod, prof, device=None):
    x = np.random.RandomState(0).randn(24, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, (24, 1)).astype(np.int64)
    pkg.seed(0)
    net = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                            pkg.nn.Linear(16, 4))
    if device:
        net = net.to(device)
    m = pkg.Model(net)
    m.prepare(pkg.optimizer.SGD(learning_rate=0.1, parameters=net),
              pkg.nn.CrossEntropyLoss())
    ds = pkg.io.TensorDataset([x, y])
    prof.start()
    try:
        m.fit(ds, eval_data=pkg.io.TensorDataset([x[:8], y[:8]]),
              batch_size=8, epochs=2, verbose=0, shuffle=False)
    finally:
        prof.stop()
    return {k: len(v) for k, v in prof_mod._events.stats.items()
            if k in ("Dataloader", "TrainStep", "Callbacks", "Eval")}


def test_fit_buckets_equal_jax(tmp_path):
    want = _fit_buckets(jpt, jprof, _untraced(jprof.Profiler()))
    got = _fit_buckets(tpt, tprof, tprof.Profiler(
        log_dir=str(tmp_path / "t")), device="cpu")
    assert got == want
    assert got == {"Dataloader": 8, "TrainStep": 6, "Callbacks": 6,
                   "Eval": 2}


def test_fit_records_nothing_without_a_profiler():
    tprof._events.stats.clear()
    _fit_buckets(tpt, tprof, type("P", (), {"start": lambda s: None,
                                            "stop": lambda s: None})(),
                 device="cpu")
    assert dict(tprof._events.stats) == {}


def test_window_writes_a_torch_trace(tmp_path):
    prof = tprof.Profiler(log_dir=str(tmp_path / "p"))
    prof.start()
    with tprof.RecordEvent("annotated"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    prof.stop()
    (row,) = prof.trace_files
    assert row["device_events"] is None       # no card here
    names = {e.get("name") for e in json.load(open(row["path"]))[
        "traceEvents"]}
    assert "annotated" in names and "aten::mm" in names


def test_second_trace_refused_while_one_records(tmp_path):
    a = tprof.Profiler(log_dir=str(tmp_path / "a"))
    b = tprof.Profiler(log_dir=str(tmp_path / "b"))
    a.start()
    try:
        with pytest.raises(RuntimeError, match="already running"):
            b._start_trace()
    finally:
        a.stop()
    b.start()                                 # the slot is free again
    b.stop()
    assert len(b.trace_files) == 1


def test_ready_warms_the_session_and_stop_releases_it(tmp_path):
    """READY opens the process's one session (kineto's warmup) a step
    ahead of the window; a stop during READY releases it unrecorded."""
    a = tprof.Profiler(scheduler=tprof.make_scheduler(closed=0, ready=2,
                                                      record=1),
                       log_dir=str(tmp_path / "a"))
    a.start()                                    # step 0: READY
    with pytest.raises(RuntimeError, match="already running"):
        tprof.Profiler(log_dir=str(tmp_path / "b")).start()
    a.stop()
    assert a.trace_files == [] and tprof._trace_slot is None
    b = tprof.Profiler(log_dir=str(tmp_path / "b"))
    b.start()
    b.stop()
    assert len(b.trace_files) == 1


def test_profiler_stop_does_not_kill_newer_profiler(tmp_path):
    """tests/test_tracing.py's stale-stop rule, run on the port."""
    a = tprof.Profiler(log_dir=str(tmp_path / "a"))
    a.start()
    a._stop_trace()                     # release the trace slot
    b = tprof.Profiler(log_dir=str(tmp_path / "b"))
    b.start()                           # b now owns the event stream
    b._stop_trace()
    a.stop()                            # stale stop: must be a no-op
    assert tprof._events.active is True
    b.stop()
    assert tprof._events.active is False


def test_chrome_export_keeps_spans_overlapping_window(tmp_path):
    """tests/test_tracing.py's interval-overlap rule, run on the port."""
    ttrace.enable()
    try:
        prof = tprof.Profiler(
            scheduler=tprof.make_scheduler(closed=1, ready=0, record=1),
            log_dir=str(tmp_path / "prof"))
        prof.start()                        # step 0: CLOSED
        root = ttrace.start_span("long.root")
        prof.step()                         # step 1: window opens
        ttrace.start_span("child", parent=root).end()
        root.end()
        prof.stop()
        trace = json.load(open(tpt.observability.export_chrome_tracing(
            prof, str(tmp_path / "t.json"))))
        xs = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "span"}
        assert "long.root" in xs and "child" in xs
        assert xs["child"]["args"]["parent_id"] == \
            xs["long.root"]["args"]["span_id"]
        prof2 = tprof.Profiler(
            scheduler=lambda step: tprof.ProfilerState.CLOSED,
            log_dir=str(tmp_path / "p2"))
        prof2.start()
        ttrace.start_span("recorded.anyway").end()
        prof2.stop()
        trace = json.load(open(tprof.export_chrome_tracing(
            prof2, str(tmp_path / "t2.json"))))
        assert any(e["name"] == "recorded.anyway"
                   for e in trace["traceEvents"])
    finally:
        ttrace.disable()


def test_export_filters_host_events_to_the_window(tmp_path):
    prof = tprof.Profiler(
        scheduler=tprof.make_scheduler(closed=1, ready=1, record=2),
        log_dir=str(tmp_path / "p"))
    prof.start()
    for i in range(5):
        with tprof.RecordEvent(f"step{i}"):
            pass
        prof.step()
    prof.stop()
    trace = json.load(open(tprof.export_chrome_tracing(
        prof, str(tmp_path / "t.json"))))
    host = sorted(e["name"] for e in trace["traceEvents"]
                  if e.get("cat") == "host")
    assert host == ["step2", "step3"]
    assert len(prof.trace_files) == 1


def _post(base, body):
    req = urllib.request.Request(base + "/profilez",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_profilez_arms_refuses_and_disarms(tmp_path):
    srv = tserver.DebugServer(port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        st, body = _post(base, {"duration_s": 0.5,
                                "log_dir": str(tmp_path / "od")})
        assert st == 200 and body["armed"]["duration_s"] == 0.5
        st2, body2 = _post(base, {"duration_s": 0.5})
        assert st2 == 409 and body2["armed"] is not None
        with tprof.RecordEvent("inside.window"):
            torch.ones(8) + 1
        deadline = time.monotonic() + 30
        while json.loads(urllib.request.urlopen(
                base + "/profilez").read())["armed"] is not None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert tprof._events.active is False
        assert len(os.listdir(tmp_path / "od")) == 1
        assert _post(base, {"duration_s": 0.1,
                            "log_dir": str(tmp_path / "od")})[0] == 200
    finally:
        time.sleep(0.3)
        srv.stop()


def test_profilez_refuses_while_job_profiler_records(tmp_path):
    """tests/test_tracing.py's rule, run on the port."""
    prof = tprof.Profiler(log_dir=str(tmp_path / "job"))
    prof.start()
    try:
        srv = tserver.DebugServer(port=0)
        assert srv._arm.arm(0.2, str(tmp_path / "od")) is None
        srv._httpd.server_close()
    finally:
        prof.stop()


def test_num_workers_auto_follows_autotune():
    from paddle_tpu.incubate import autotune as ja
    from paddle_tpu_torch.incubate import autotune as ta
    ds = tpt.io.TensorDataset([np.zeros((4, 2), np.float32)])
    try:
        for cfg in (None, {"dataloader": {"enable": False}},
                    {"kernel": {"tuning_range": [1, 3]}}):
            ja.set_config(cfg)
            ta.set_config(cfg)
            assert ta.get_config() == ja.get_config()
            assert ta.suggested_num_workers() == ja.suggested_num_workers()
            dl = tpt.io.DataLoader(ds, num_workers="auto", device="cpu")
            assert dl.num_workers == ja.suggested_num_workers()
        with pytest.raises(ValueError, match="unknown autotune"):
            ta.set_config({"nope": {}})
    finally:
        for mod in (ja, ta):
            mod._config = {"kernel": {"enable": True, "tuning_range": None},
                           "layout": {"enable": True},
                           "dataloader": {"enable": False}}


def test_sysconfig_and_version():
    from paddle_tpu import version as jv
    assert tpt.__version__ == jpt.__version__
    assert (tpt.version.full_version, tpt.version.major,
            tpt.version.minor, tpt.version.patch) == \
        (jv.full_version, jv.major, jv.minor, jv.patch)
    inc = tpt.sysconfig.get_include()
    assert os.path.isfile(os.path.join(inc, "flash_attention.cu"))
    assert tpt.sysconfig.get_lib().endswith(os.path.join(
        "build", "paddle_tpu_torch"))


def test_top_level_repairs():
    """Queue C 15: DataParallel and distributed at the top level, as
    ``paddle_tpu/__init__.py`` exports them; ``jit`` is the module."""
    assert tpt.DataParallel is tpt.parallel.DataParallel
    assert tpt.distributed.__name__ == "paddle_tpu_torch.distributed"
    assert tpt.jit.save is not None and callable(tpt.compile)
