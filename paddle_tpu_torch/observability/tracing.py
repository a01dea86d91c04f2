"""Request-scoped tracing: Span / SpanContext over a bounded table.

The missing layer between the process-wide metric aggregates and "why was
THIS request slow": causal span trees with ids, parent links,
attributes, and events, recorded into one bounded process-wide table
(the same ring the flight recorder dumps on crash). The reference's
analog is the profiler event tree ``ChromeTracingLogger`` serialized
(SURVEY.md §5) — but that tree is profiler-window-scoped and
process-perspective; spans here are REQUEST/STEP-scoped and stay cheap
enough to leave on in production (and are off by default with
near-zero overhead: one module-flag check per instrumentation site).

Two propagation modes, because the hot paths need both:

- thread-local (``with span("train.epoch"): ...``) — nested blocks on
  one thread parent automatically, like the reference's RecordEvent
  nesting;
- explicit (``start_span(name, parent=other)``) — the LLM engine's
  request trees span the submitter thread and the engine loop thread,
  so parents are carried on the request object, not the stack.

Finished spans land in the bounded table (``finished_spans()``); live
ones are tracked (``live_spans()``) so a crash dump shows what was
in flight. When a profiler is actively recording, span durations also feed its
``summary()`` aggregates (stats only — the trace row comes from this
table, so nothing renders twice).

Stdlib-only by design (like metrics.py): any module may import it
without cycles, and enabling tracing never drags torch in.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

# cap on the finished-span ring (the flight recorder's window) and on
# per-span event lists — a long-lived serving process must not grow
# host memory without bound no matter how chatty the instrumentation
DEFAULT_TABLE_CAP = 16384
MAX_EVENTS_PER_SPAN = 128
# per-span link cap (failover chains are short; a retry storm must
# not grow one span without bound)
MAX_LINKS_PER_SPAN = 32

_enabled = False
_lock = threading.Lock()
_ids = itertools.count(1)
# ids are W3C-sized and PROCESS-UNIQUE: a random per-process prefix
# plus a counter. Before trace propagation this didn't matter — every
# table was process-local — but a fleet merges span tables from K
# replicas + a router onto one timeline (tools/trace_merge.py), where
# counter-only ids from different processes would collide and cross-
# link unrelated trees. 16-hex span ids / 32-hex trace ids are exactly
# the W3C traceparent field widths, so inject/extract never pads.
_SPAN_ID_PREFIX = os.urandom(4).hex()      # 8 hex + 8-hex counter
_TRACE_ID_PREFIX = os.urandom(8).hex()     # 16 hex + the span id
_table: deque = deque(maxlen=DEFAULT_TABLE_CAP)
_live: Dict[str, "Span"] = {}
_tls = threading.local()

# wall-clock anchor: spans carry perf_counter timestamps (monotonic,
# merge-compatible with profiler._events); dumps convert via this pair
_EPOCH_WALL = time.time()
_EPOCH_PERF = time.perf_counter()


def perf_to_wall(ts: float) -> float:
    return _EPOCH_WALL + (ts - _EPOCH_PERF)


class SpanContext:
    """The propagatable identity of a span: (trace_id, span_id)."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


class Span:
    """One timed operation. Explicit ``t0``/``end(t1)`` timestamps let
    instrumentation hand a single perf_counter sample to a parent's
    end AND a sibling's start, so phase spans tile an interval exactly
    (the llm request tree's children sum to its end-to-end latency by
    construction)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "attrs", "events", "links", "tid", "tname", "status",
                 "_dropped_events")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None,
                 t0: Optional[float] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.events: List[Tuple[float, str, Optional[dict]]] = []
        self.links: List[dict] = []
        t = threading.current_thread()
        self.tid = t.ident
        self.tname = t.name
        self.status = "ok"
        self._dropped_events = 0

    # -- identity -------------------------------------------------------
    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def ended(self) -> bool:
        return self.t1 is not None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    # -- mutation -------------------------------------------------------
    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, attrs: Optional[dict] = None,
                  ts: Optional[float] = None) -> "Span":
        if len(self.events) >= MAX_EVENTS_PER_SPAN:
            self._dropped_events += 1
            return self
        self.events.append((time.perf_counter() if ts is None else ts,
                            name, attrs))
        return self

    def add_link(self, context, attrs: Optional[dict] = None) -> "Span":
        """Record a causal association with another span that is NOT a
        parent/child edge — the fleet router links a failover
        re-dispatch back to the attempt it replaces, so a cross-replica
        retry reads as one story instead of two disconnected trees.
        ``context`` is any Span/SpanContext (possibly from another
        process)."""
        if len(self.links) >= MAX_LINKS_PER_SPAN:
            return self
        tid = getattr(context, "trace_id", "")
        sid = getattr(context, "span_id", "")
        if not sid:
            return self          # a noop/disabled-side context: no-op
        link = {"trace_id": tid, "span_id": sid}
        if attrs:
            link["attrs"] = dict(attrs)
        self.links.append(link)
        return self

    def set_status(self, status: str) -> "Span":
        self.status = status
        return self

    def end(self, t1: Optional[float] = None) -> None:
        """Idempotent: the first end wins (error paths and the normal
        path may both try to close a request's spans)."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter() if t1 is None else t1
        with _lock:
            _live.pop(self.span_id, None)
            _table.append(self.to_dict())
        # while a profiler is recording, span durations feed its
        # summary() aggregates (stats ONLY — the chrome-trace row is
        # rendered from the span table, never twice). sys.modules
        # check: tracing must not import a profiler just because a span ended.
        prof = sys.modules.get("paddle_tpu_torch.profiler")
        if prof is not None and prof._events.active:
            prof._events.record_stat(self.name, self.t1 - self.t0)

    # -- context-manager protocol (thread-local nesting) ---------------
    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.status = "error"
            self.set_attr("error", f"{exc_type.__name__}: {exc}")
        self.end()

    def to_dict(self) -> dict:
        # /tracez and flight dumps snapshot LIVE spans while the owning
        # thread mutates attrs/events lock-free; a dict resize mid-copy
        # raises RuntimeError, which must not cost us the crash dump —
        # retry the cheap copy, settle for what we have on a hot loser
        for _ in range(4):
            try:
                attrs = dict(self.attrs)
                events = list(self.events)
                links = list(self.links)
                break
            except RuntimeError:
                continue
        else:
            attrs, events, links = {}, [], []
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.t0,
            "dur": (self.t1 - self.t0) if self.t1 is not None else None,
            "tid": self.tid,
            "tname": self.tname,
            "status": self.status,
            "attrs": attrs,
            "events": [{"ts": ts, "name": n,
                        **({"attrs": a} if a else {})}
                       for ts, n, a in events],
        }
        if links:
            d["links"] = links
        if self._dropped_events:
            d["dropped_events"] = self._dropped_events
        return d

    def __repr__(self):
        state = "live" if self.t1 is None else f"{self.duration:.6f}s"
        return f"Span({self.name!r}, {self.span_id}, {state})"


class _NoopSpan:
    """Shared do-nothing span returned while tracing is disabled —
    instrumentation can call through unconditionally; the only cost of
    disabled tracing is the ``enabled()`` flag check."""

    __slots__ = ()
    name = "noop"
    trace_id = span_id = parent_id = ""
    # real timestamps so a caller that sampled `enabled()` just before
    # a concurrent disable() (and now holds the noop) can still read
    # t0/t1 — e.g. start_span(..., t0=root.t0) must not raise
    t0 = t1 = 0.0
    attrs: Dict[str, Any] = {}
    events: List[Any] = []
    status = "ok"
    ended = True
    duration = 0.0
    context = SpanContext("", "")

    def set_attr(self, key, value):
        return self

    def add_event(self, name, attrs=None, ts=None):
        return self

    def add_link(self, context, attrs=None):
        return self

    def set_status(self, status):
        return self

    def end(self, t1=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NOOP_SPAN = _NoopSpan()

# sentinel: "parent not passed → inherit the thread-local current span"
_USE_CURRENT = object()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


# ---------------------------------------------------------------------------
# module controls
# ---------------------------------------------------------------------------


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (optionally resizing the finished-span ring).
    Off by default: the instrumented hot paths pay one flag check."""
    global _enabled
    if capacity is not None:
        set_capacity(capacity)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def set_capacity(n: int) -> None:
    """Resize the finished-span ring, keeping the newest entries."""
    global _table
    with _lock:
        _table = deque(_table, maxlen=max(int(n), 1))


def clear() -> None:
    with _lock:
        _table.clear()
        _live.clear()


def _new_id() -> str:
    """A 16-hex (W3C span-id width) process-unique id: random
    per-process prefix + counter."""
    return f"{_SPAN_ID_PREFIX}{next(_ids) & 0xFFFFFFFF:08x}"


def _resolve_parent(parent) -> Tuple[Optional[str], Optional[str]]:
    """→ (trace_id, parent_span_id); None parent means root."""
    if parent is None:
        return None, None
    if isinstance(parent, (Span, SpanContext, _NoopSpan)):
        if isinstance(parent, _NoopSpan):
            return None, None
        return parent.trace_id, parent.span_id
    if isinstance(parent, str):          # a bare span_id: same trace n/a
        return None, parent
    raise TypeError(f"unsupported parent {parent!r}")


def start_span(name: str, parent=_USE_CURRENT,
               attrs: Optional[Dict[str, Any]] = None,
               t0: Optional[float] = None) -> Span:
    """Create a live span (caller owns ``end()``). ``parent`` defaults
    to the calling thread's current ``span()`` block; pass ``None``
    for an explicit root, or any Span/SpanContext for cross-thread
    trees."""
    if not _enabled:
        return NOOP_SPAN
    if parent is _USE_CURRENT:
        parent = current_span()
    trace_id, parent_id = _resolve_parent(parent)
    span_id = _new_id()
    # a root span mints a 32-hex (W3C trace-id width) trace id so the
    # identity can ride a traceparent header unmodified
    sp = Span(name, trace_id or f"{_TRACE_ID_PREFIX}{span_id}",
              span_id, parent_id, attrs=attrs, t0=t0)
    with _lock:
        _live[span_id] = sp
    return sp


def span(name: str, attrs: Optional[Dict[str, Any]] = None,
         parent=_USE_CURRENT) -> Span:
    """Context-manager form: ``with span("phase"): ...`` — pushes onto
    the thread-local stack so nested blocks parent automatically."""
    return start_span(name, parent=parent, attrs=attrs)


def current_span() -> Optional[Span]:
    s = getattr(_tls, "stack", None)
    return s[-1] if s else None


# ---------------------------------------------------------------------------
# readout
# ---------------------------------------------------------------------------


def finished_spans() -> List[dict]:
    with _lock:
        return list(_table)


def live_spans() -> List[dict]:
    with _lock:
        return [sp.to_dict() for sp in _live.values()]


def rollup(prefix: Optional[str] = None,
           exclude: Sequence[str] = ()) -> Dict[str, dict]:
    """Aggregate the finished table by span name → ``{name: {count,
    total_s, share}}`` (share of the summed total across the returned
    names). ``exclude`` drops names from BOTH the output and the share
    denominator — e.g. ``rollup(prefix="llm.",
    exclude=("llm.request",))`` yields phase shares that sum to 1
    without the root double-counting its children. The per-phase
    breakdown BENCH rows attach."""
    agg: Dict[str, dict] = {}
    for s in finished_spans():
        if prefix and not s["name"].startswith(prefix):
            continue
        if s["name"] in exclude or s["dur"] is None:
            continue
        a = agg.setdefault(s["name"], {"count": 0, "total_s": 0.0})
        a["count"] += 1
        a["total_s"] += s["dur"]
    total = sum(a["total_s"] for a in agg.values())
    for a in agg.values():
        # share from the RAW total — rounding first would skew shares
        # for microsecond-scale spans (sum drifts off 1.0)
        a["share"] = round(a["total_s"] / total, 4) if total else 0.0
        a["total_s"] = round(a["total_s"], 9)
    return agg
