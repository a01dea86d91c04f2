"""Exporters over the metrics registry.

Reference being replaced (SURVEY.md §5): ``ChromeTracingLogger``
(paddle/fluid/platform/profiler/dump/chrometracing_logger.cc) — the
reference serializes its profiler event tree to a chrome://tracing
JSON; and the monitor stats that PS-mode jobs scraped ad hoc. Here the
same two sinks are first-class:

- ``prometheus_text()`` / ``write_prometheus()`` — text exposition
  (0.0.4 format) of every family in the registry, the standard lens
  for serving metrics (TTFT, tokens/sec — see "Ragged Paged
  Attention", PAPERS.md).
- ``JSONLReporter`` — a background thread appending registry snapshots
  to a .jsonl file on an interval; survives crashes (line-buffered,
  each line self-contained) and shuts down cleanly.
- ``sample_device_memory()`` — ``torch.cuda.memory_stats()`` into
  per-device gauges, the HBM-leak detector.

- ``export_chrome_tracing()`` — the profiler's host events and the
  span table in one chrome://tracing file, filtered to a profiler's
  RECORD windows (the card's kernels are in the profiler's own
  torch.profiler traces under its ``log_dir``).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional

from .metrics import (MetricRegistry, _format_labels, default_registry)

# ---------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4)
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    """Metric names here use dots (checkpoint.save); Prometheus wants
    [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _prom_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def prometheus_text(registry: Optional[MetricRegistry] = None) -> str:
    """Render every family as Prometheus text exposition."""
    registry = registry or default_registry()
    lines = []
    seen: Dict[str, str] = {}
    for fam in registry.families():
        pname = _prom_name(fam.name)
        # two dotted names can sanitize to one exposition name; a
        # duplicate (worse: kind-conflicting) metric invalidates the
        # whole scrape, so disambiguate deterministically
        while seen.get(pname, fam.name) != fam.name:
            pname += "_" + fam.kind
        seen[pname] = fam.name
        if fam.help:
            lines.append(f"# HELP {pname} {fam.help}")
        lines.append(f"# TYPE {pname} {fam.kind}")
        for child in fam.children():
            labels = _format_labels(fam.label_names, child.label_values)
            if fam.kind in ("counter", "gauge"):
                lines.append(f"{pname}{labels} {_prom_num(child.value)}")
                continue
            # histogram: cumulative buckets + _sum/_count, le merged
            # into any existing labels
            base = list(zip(fam.label_names, child.label_values))
            for le, cum in child.bucket_counts():
                pairs = base + [("le", _prom_num(le))]
                inner = ",".join(f'{k}="{v}"' for k, v in pairs)
                lines.append(f"{pname}_bucket{{{inner}}} {cum}")
            lines.append(f"{pname}_sum{labels} {_prom_num(child.sum)}")
            lines.append(f"{pname}_count{labels} {child.count}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str,
                     registry: Optional[MetricRegistry] = None) -> str:
    text = prometheus_text(registry)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


# ---------------------------------------------------------------------------
# Chrome trace (ref: ChromeTracingLogger)
# ---------------------------------------------------------------------------


def _overlaps_window(t0: float, t1: float, windows) -> bool:
    """Interval overlap, not point-in-window: a long-lived span (an
    llm.request root, a train.epoch) that STARTED before a RECORD
    window but runs through it must export, or its children would
    carry dangling parent_ids."""
    return any(t0 <= e and s <= t1 for s, e in windows)


def export_chrome_tracing(profiler=None, path: str = "trace.json",
                          include_spans: bool = True) -> str:
    """Dump the profiler facade's recorded host annotations AND the
    tracing span table as ONE chrome://tracing-loadable JSON file:
    complete ("ph": "X") events with microsecond timestamps, one row
    (tid) per recording thread, ``process_name``/``thread_name``
    metadata records (ph "M") so Perfetto labels rows instead of
    showing bare tids, and span events as instants (ph "i").

    ``profiler``: when a Profiler instance is passed, output is
    filtered to that profiler's RECORD windows (``make_scheduler``
    cycles: events from CLOSED/READY phases are dropped); ``None``
    exports everything in the process-wide tables. Spans carry their
    ids in ``args`` ({trace_id, span_id, parent_id, ...attributes}),
    so parent links survive the export.
    """
    from ..profiler import _events
    from . import tracing as _tracing
    with _events.lock:
        events = list(_events.trace)
    spans = _tracing.finished_spans() if include_spans else []
    windows = None
    if profiler is not None and hasattr(profiler, "recording_windows"):
        # a profiler that never reached a RECORD phase has no windows;
        # fall back to exporting everything it recorded rather than
        # silently producing an empty trace
        windows = profiler.recording_windows() or None
    if windows is not None:
        events = [ev for ev in events
                  if _overlaps_window(ev["ts"], ev["ts"] + ev["dur"],
                                      windows)]
        spans = [sp for sp in spans
                 if _overlaps_window(sp["ts"],
                                     sp["ts"] + (sp["dur"] or 0.0),
                                     windows)]
    pid = os.getpid()
    trace_events = [{
        "name": "process_name", "ph": "M", "pid": pid,
        "args": {"name": f"paddle_tpu_torch[{pid}]"},
    }]
    tnames = {}
    for ev in events:
        tnames.setdefault(ev["tid"], ev.get("tname"))
    for sp in spans:
        tnames.setdefault(sp["tid"], sp.get("tname"))
    for tid, tname in sorted(tnames.items(), key=lambda kv: kv[0] or 0):
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": tname or f"thread-{tid}"},
        })
    trace_events += [{
        "name": ev["name"],
        "ph": "X",
        "cat": "host",
        "ts": round(ev["ts"] * 1e6, 3),       # seconds → microseconds
        "dur": round(ev["dur"] * 1e6, 3),
        "pid": pid,
        "tid": ev["tid"],
    } for ev in events]
    for sp in spans:
        trace_events.append({
            "name": sp["name"],
            "ph": "X",
            "cat": "span",
            "ts": round(sp["ts"] * 1e6, 3),
            "dur": round((sp["dur"] or 0.0) * 1e6, 3),
            "pid": pid,
            "tid": sp["tid"],
            "args": {"trace_id": sp["trace_id"],
                     "span_id": sp["span_id"],
                     "parent_id": sp["parent_id"],
                     "status": sp["status"],
                     **sp["attrs"]},
        })
        for ev in sp["events"]:
            trace_events.append({
                "name": f"{sp['name']}:{ev['name']}",
                "ph": "i",
                "s": "t",                     # thread-scoped instant
                "cat": "span_event",
                "ts": round(ev["ts"] * 1e6, 3),
                "pid": pid,
                "tid": sp["tid"],
                "args": {"span_id": sp["span_id"],
                         **(ev.get("attrs") or {})},
            })
    payload = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "paddle_tpu_torch.observability"},
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


# ---------------------------------------------------------------------------
# periodic JSONL reporter
# ---------------------------------------------------------------------------


class JSONLReporter:
    """Append ``{"ts": ..., "metrics": {...}}`` snapshot lines to a
    file on a background thread.

    Clean-shutdown contract: ``stop()`` (or context exit) wakes the
    thread, writes ONE final snapshot so the last partial interval is
    never lost, joins the thread, and closes the file. Lines are
    flushed as written — a killed process keeps every completed line.
    A reporter never explicitly stopped still flushes its final
    snapshot at interpreter exit (atexit): short-lived jobs whose whole
    life fits inside one interval don't lose everything, and a job
    crashing through sys.exit keeps its last numbers.
    """

    def __init__(self, path: str, interval: float = 10.0,
                 registry: Optional[MetricRegistry] = None):
        import atexit
        self.path = os.path.abspath(path)
        self.interval = float(interval)
        self.registry = registry or default_registry()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._f = open(self.path, "a")
        self._stop = threading.Event()
        self._mu = threading.Lock()   # file handle guard (stop vs tick)
        self._atexit = atexit
        atexit.register(self.stop)
        self._thread = threading.Thread(
            target=self._loop, name="jsonl-metrics-reporter", daemon=True)
        self._thread.start()

    def _write_snapshot(self) -> None:
        line = json.dumps({"ts": time.time(),
                           "metrics": self.registry.snapshot()})
        with self._mu:
            if self._f.closed:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self._write_snapshot()

    def report_now(self) -> None:
        """Synchronous snapshot outside the cadence (step boundaries,
        end of a bench config)."""
        self._write_snapshot()

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        try:                       # registered at __init__; a stopped
            self._atexit.unregister(self.stop)   # reporter must not
        except Exception:          # re-flush at interpreter exit
            pass
        self._thread.join(timeout=10)
        self._write_snapshot()      # final flush — never lose the tail
        with self._mu:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# CUDA device-memory gauges
# ---------------------------------------------------------------------------


def sample_device_memory(registry: Optional[MetricRegistry] = None
                         ) -> Dict[str, Dict[str, float]]:
    """Sample ``torch.cuda.memory_stats()`` of every visible card into
    ``device_memory_bytes{device=..., kind=...}`` gauges; returns the
    raw per-device dicts (the allocator's current, peak and reserved
    bytes and the card's total). A process without a card contributes
    NO device gauge — a hole, never zeros (a zero would read as "HBM
    empty" to every consumer of the series). When no device reported
    anything, the documented fallback gauge ``host_rss_bytes``
    (process resident set size) is set instead so the process still
    has ONE memory trend line."""
    import torch
    registry = registry or default_registry()
    gauge = registry.gauge(
        "device_memory_bytes",
        "torch.cuda.memory_stats() sampled by the observability layer",
        label_names=("device", "kind"))
    out: Dict[str, Dict[str, float]] = {}
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for i in range(n_dev):
        stats = torch.cuda.memory_stats(i)
        name = f"cuda:{i}"
        row = {
            "bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0)),
            "peak_bytes_in_use": float(
                stats.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": float(
                stats.get("reserved_bytes.all.current", 0)),
            "bytes_limit": float(
                torch.cuda.get_device_properties(i).total_memory),
        }
        out[name] = row
        for k, v in row.items():
            gauge.labels(device=name, kind=k).set(v)
    if not out:
        from .memory import host_rss_bytes
        rss = host_rss_bytes()
        if rss is not None:
            registry.gauge(
                "host_rss_bytes",
                "process resident set size — the fallback memory "
                "signal on processes without a CUDA device").set(rss)
    return out
