"""Continuous perf observability — the program cost registry.

A process-wide registry that

- records the **analytic cost** (FLOPs, bytes accessed) of every
  program signature the hot paths dispatch — the engine's decode tick,
  decode slab per length, mixed slab per length, prefill chunk and spec
  slab per length register here at their first dispatch, each
  dispatch's cost computed from the model's configuration and the
  dispatch's rows (the JAX package reads XLA's cost analysis of the
  compiled program instead; PyTorch eager has no such program);
- combines it with the **measured dispatch wall time** those hot
  paths already record (no added host syncs: the registry only reuses
  ``time.perf_counter``/``time.monotonic`` deltas the instrumentation
  measures anyway) into live roofline gauges: ``perf_mfu``,
  ``perf_hbm_bw_util``, ``perf_flops_per_second`` over a sliding
  window, against a per-device peak table with override knobs
  (``FLAGS.perf_peak_flops`` / ``FLAGS.perf_peak_hbm_gbps``) and a
  nominal CPU fallback;
- accumulates a **step-time breakdown** per component (llm: decode vs
  prefill time between fetches, the first fetch of each program —
  its kernels' first build and launch — as "compile"), so /perfz can
  say WHERE wall time goes, not just that totals moved.

Surfaces: ``GET /perfz`` on the debug server (this module's
:func:`perfz_payload`), ``perf_*`` rows on ``/metrics`` and
``/statusz``.

Disabled cost is ONE module-flag check on the hot path (the
``perf_observability`` flag sets the initial state;
:func:`enable`/:func:`disable` flip it at runtime). When enabled, the
per-dispatch cost is a dict lookup and a few float adds. A program
registered without a usable cost increments
``perf_cost_analysis_failures_total`` and stays out of MFU.

MFU semantics: the denominator is attributed BUSY seconds, not
wall-clock — ``perf_mfu`` reads "model FLOPs per second while
dispatching, over peak", so an idle process holds its last-window
value instead of decaying toward zero. On the CPU the peak is a
nominal placeholder (absolute MFU is meaningless there).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import flags as _flags
from ._gclock import GcSafeLock
from .metrics import default_registry

# same cap discipline as Model._guard_recompiles / the engine guard:
# a long dynamic-shape run cannot grow host memory without bound
PROGRAM_CAP = 4096

# sliding window the live gauges aggregate over
WINDOW_S = 60.0

# -- enable flag (pinned: one module-bool check on the hot path) -----------

_ENABLED = bool(_flags.get_flag("perf_observability"))


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


# -- per-backend peak table ------------------------------------------------

# (device_kind substring, bf16 peak FLOP/s, HBM bytes/s) — public
# figures per chip; first match wins, so more specific rows first.
# H100: SXM5 data sheet, dense bf16 tensor-core rate, HBM3.
PEAK_TABLE: Tuple[Tuple[str, float, float], ...] = (
    ("h100", 989e12, 3.35e12),
    ("v6e", 918e12, 1640e9),
    ("v6 lite", 918e12, 1640e9),
    ("v5p", 459e12, 2765e9),
    ("v5 lite", 197e12, 819e9),
    ("v5litepod", 197e12, 819e9),
    ("v5e", 197e12, 819e9),
    ("v5", 459e12, 2765e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 46e12, 700e9),
)

# nominal CPU placeholder (a few vector cores' worth): keeps MFU
# nonzero and run-to-run comparable on the CPU backend; the absolute
# value is NOT meaningful there — docs/OBSERVABILITY.md
CPU_FALLBACK_PEAKS = (1e11, 5e10)


@dataclass
class PeakSpec:
    flops: float            # peak FLOP/s
    hbm_bytes_per_s: float  # peak HBM bandwidth
    source: str             # "table" | "override" | "cpu-fallback"
    device_kind: str


def peak_flops_for(device_kind: str) -> Optional[float]:
    """Table lookup only (no fallback): the peak FLOP/s for a known
    accelerator kind, or None — what bench.py's MFU column wants (an
    unknown/CPU backend reports mfu=null, not a made-up number)."""
    kind = (device_kind or "").lower()
    for sub, flops, _bw in PEAK_TABLE:
        if sub in kind:
            return flops
    return None


def detect_peaks(device_kind: Optional[str] = None) -> PeakSpec:
    """Resolve the peak (FLOP/s, HBM B/s) this process measures MFU
    against: flag overrides win (``perf_peak_flops`` in FLOP/s,
    ``perf_peak_hbm_gbps`` in GB/s — the knob for TPU generations the
    table doesn't know), then the device-name table, then the CPU
    fallback."""
    if device_kind is None:
        import torch
        device_kind = torch.cuda.get_device_name() \
            if torch.cuda.is_available() else ""
    flops = peak_flops_for(device_kind)
    kind = (device_kind or "").lower()
    bw = None
    for sub, _f, b in PEAK_TABLE:
        if sub in kind:
            bw = b
            break
    source = "table" if flops is not None else "cpu-fallback"
    if flops is None:
        flops, bw = CPU_FALLBACK_PEAKS
    f_over = float(_flags.get_flag("perf_peak_flops") or 0.0)
    b_over = float(_flags.get_flag("perf_peak_hbm_gbps") or 0.0) * 1e9
    if f_over > 0:
        flops, source = f_over, "override"
    if b_over > 0:
        bw = b_over
        source = "override" if f_over > 0 else source + "+bw-override"
    return PeakSpec(float(flops), float(bw), source, device_kind or "")


# process-unique owner tokens (NOT id(): CPython reuses addresses
# after GC, and a new engine aliasing a dead one's cost entries would
# read a stale network's FLOPs)
_scope_counter = itertools.count()


def next_scope() -> str:
    """A process-unique scope token for register_program(scope=)."""
    return f"s{next(_scope_counter)}"


def _cleanup_scope(scope: str) -> None:
    """The GC finalizer's removal, which never blocks on the registry's
    lock (:class:`GcSafeLock`). The process-wide registry is read
    without ``instance()``'s lock for the same reason (no registry, no
    entries to drop)."""
    reg = _instance
    if reg is None:
        return
    try:
        reg._mu.call_or_defer(reg._drop_scope_locked, scope)
    except Exception:  # noqa: BLE001 — interpreter-shutdown tolerance
        pass


def finalize_scope(owner, scope: str):
    """Attach a GC finalizer releasing ``scope``'s program entries
    when ``owner`` is collected — the backstop for owners discarded
    without their explicit cleanup path (Model re-prepare, engine
    close). Returns the ``weakref.finalize`` handle."""
    import weakref
    return weakref.finalize(owner, _cleanup_scope, scope)


class ProgramHandle:
    """One registered program signature: cost + measured dispatch
    accounting. ``record`` is the hot-path entry — registry lock,
    float adds only. ``flops`` / ``bytes_accessed`` are the analytic
    cost of the dispatch that registered the program; each ``record``
    may pass the cost of the dispatches it covers (their rows differ in
    context length), else the registered cost times ``dispatches``."""

    __slots__ = ("key", "component", "kind", "sig", "scope", "steps",
                 "flops", "bytes_accessed", "cost_failed",
                 "cost_resolved", "dispatches", "seconds", "tokens",
                 "flops_total", "_reg")

    def __init__(self, reg: "PerfRegistry", component: str, kind: str,
                 sig: Tuple, steps: int, scope: str = ""):
        self.key = (component, kind, scope) + tuple(sig)
        self.component = component
        self.kind = kind
        self.scope = scope
        self.sig = tuple(sig)
        self.steps = int(steps)
        self.flops: Optional[float] = None
        self.bytes_accessed: Optional[float] = None
        self.cost_failed = False
        self.cost_resolved = False
        self.dispatches = 0
        self.seconds = 0.0
        self.tokens = 0
        self.flops_total = 0.0
        self._reg = reg

    def record(self, seconds: float, tokens: int = 0,
               dispatches: int = 1,
               cost: Optional[Tuple[float, float]] = None) -> None:
        """Attribute ``seconds`` of measured busy wall time covering
        ``dispatches`` executions of this program. ``cost``: the
        (FLOPs, bytes) those executions did, when the caller knows it;
        else the registered cost times ``dispatches``."""
        self._reg._record(self, float(seconds), int(tokens),
                          int(dispatches), cost)

    def to_dict(self) -> dict:
        fps = (self.flops_total / self.seconds
               if self.flops_total and self.seconds else None)
        return {
            "component": self.component,
            "kind": self.kind,
            "sig": list(self.sig),
            "scope": self.scope,
            "steps_per_dispatch": self.steps,
            "dispatches": self.dispatches,
            "seconds": round(self.seconds, 6),
            "tokens": self.tokens,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "cost_source": "analytic",
            "cost_resolved": self.cost_resolved,
            "cost_failed": self.cost_failed,
            "flops_per_second": fps,
        }


class PerfRegistry:
    """Process-wide program cost + dispatch-time registry (singleton
    via :func:`instance`; tests build private ones)."""

    def __init__(self):
        # the scope finalizers' removals queue here while it is held
        self._mu = GcSafeLock()
        self._programs: Dict[Tuple, ProgramHandle] = {}
        self._phases: Dict[Tuple[str, str], float] = {}
        # sliding-window accumulators: per-second buckets of
        # (flops, bytes, busy_seconds) keyed by int(wall_ts). O(1)
        # per record, O(WINDOW_S) memory, and the window NEVER
        # truncates under load (a capped event list would silently
        # shrink the documented 60 s window at high record rates)
        self._buckets: Dict[int, List[float]] = {}
        self._peaks: Optional[PeakSpec] = None
        # last nonzero-window rates: an idle process HOLDS its last
        # value instead of decaying to 0 (documented semantics — a
        # fleet must not read "went idle" as "lost its roofline")
        self._last_rates: Optional[Dict[str, float]] = None
        self.t_start = time.time()

    # -- registration (cold path: once per compiled signature) ----------
    def register_program(self, component: str, kind: str,
                         sig: Tuple = (),
                         cost: Optional[Tuple[float, float]] = None,
                         steps: int = 1,
                         scope: str = "") -> Optional[ProgramHandle]:
        """Register a program signature; returns its handle (existing
        one if already registered) or None past the PROGRAM_CAP bound.
        ``cost``: the analytic (FLOPs, bytes accessed) of one dispatch;
        None or zero FLOPs marks the cost failed (the program still
        accumulates dispatch time, outside MFU). ``scope``
        disambiguates owners — two engines with the SAME (kind, sig)
        but different networks are different programs."""
        key = (component, kind, scope) + tuple(sig)
        with self._mu:
            h = self._programs.get(key)
            if h is not None:
                return h
            if len(self._programs) >= PROGRAM_CAP:
                return None
            h = ProgramHandle(self, component, kind, sig, steps,
                              scope=scope)
            self._programs[key] = h
            flops = float(cost[0]) if cost else 0.0
            if flops > 0:
                h.flops = flops
                h.bytes_accessed = float(cost[1])
                h.cost_resolved = True
            else:
                h.cost_failed = True
        if not h.cost_resolved:
            default_registry().counter(
                "perf_cost_analysis_failures_total",
                "programs registered without a usable analytic cost "
                "(MFU excludes them; the gauge surfaces silent holes "
                "in the roofline view)").inc()
        return h

    def remove_scope(self, scope: str) -> int:
        """Drop every program registered under ``scope`` — called by
        owners on teardown (engine close, Model re-prepare) so a
        long-lived process creating engines/models in a loop can't
        fill PROGRAM_CAP with dead entries and silently stop covering
        new programs. Already-windowed events stay (they were real
        work); returns the number removed."""
        with self._mu:
            return self._drop_scope_locked(scope)

    def _drop_scope_locked(self, scope: str) -> int:
        dead = [k for k, h in self._programs.items()
                if h.scope == scope]
        for k in dead:
            self._programs.pop(k, None)
        return len(dead)

    def get_program(self, component: str, kind: str, sig: Tuple = (),
                    scope: str = "") -> Optional[ProgramHandle]:
        with self._mu:
            return self._programs.get(
                (component, kind, scope) + tuple(sig))

    # -- hot-path accounting --------------------------------------------
    def _record(self, h: ProgramHandle, seconds: float,
                tokens: int, dispatches: int = 1,
                cost: Optional[Tuple[float, float]] = None) -> None:
        """Float adds under the registry lock — NOTHING else on the
        hot path. Programs registered without a cost are EXCLUDED
        from MFU (visible via the failure counter + /perfz
        cost_failed), never folded in as zero-FLOP busy time that
        would deflate the ratio."""
        with self._mu:
            h.dispatches += dispatches
            h.seconds += seconds
            h.tokens += tokens
            if h.cost_resolved:
                f, b_ = cost if cost is not None else (
                    h.flops * dispatches,
                    (h.bytes_accessed or 0.0) * dispatches)
                h.flops_total += f
                b = self._buckets.setdefault(
                    int(time.time()), [0.0, 0.0, 0.0])
                b[0] += f
                b[1] += b_
                b[2] += seconds

    def record_phase(self, component: str, phase: str,
                     seconds: float) -> None:
        """Accumulate one step-time-breakdown phase (train: dispatch /
        compile / drain; llm: decode / prefill). Callers pass the SAME
        wall-time deltas their existing histograms observe — the
        breakdown adds no clocks of its own."""
        with self._mu:
            k = (component, phase)
            self._phases[k] = self._phases.get(k, 0.0) + float(seconds)

    # -- readout ---------------------------------------------------------
    def peaks(self) -> PeakSpec:
        if self._peaks is None:
            self._peaks = detect_peaks()
        return self._peaks

    def set_peaks(self, peaks: Optional[PeakSpec]) -> None:
        """Pin (or clear, with None) the peak spec — tests and the
        override flags' re-read path."""
        self._peaks = peaks

    def _window(self) -> Tuple[float, float, float]:
        """(flops, bytes, busy_seconds) summed over the sliding
        window (per-second buckets; expired ones pruned here)."""
        cutoff = int(time.time() - WINDOW_S)
        f = b = s = 0.0
        with self._mu:
            dead = [k for k in self._buckets if k < cutoff]
            for k in dead:
                del self._buckets[k]
            for bf, bb, bs in self._buckets.values():
                f += bf
                b += bb
                s += bs
        return f, b, s

    def rates(self) -> Dict[str, float]:
        """Windowed achieved rates + utilizations (the gauge values).
        An empty window (idle process) returns the LAST computed
        rates rather than zeros — "busy MFU" holds while idle."""
        f, b, s = self._window()
        if s <= 0:
            with self._mu:
                if self._last_rates is not None:
                    return dict(self._last_rates)
            return {"flops_per_second": 0.0, "bytes_per_second": 0.0,
                    "mfu": 0.0, "hbm_bw_util": 0.0}
        peaks = self.peaks()
        out = {
            "flops_per_second": f / s,
            "bytes_per_second": b / s,
            "mfu": (f / s) / peaks.flops if peaks.flops else 0.0,
            "hbm_bw_util": (b / s) / peaks.hbm_bytes_per_s
            if peaks.hbm_bytes_per_s else 0.0,
        }
        with self._mu:
            self._last_rates = dict(out)
        return out

    def update_gauges(self) -> Dict[str, float]:
        """Refresh the live ``perf_*`` gauges in the default metric
        registry (looked up idempotently so a test-time registry reset
        can't leave stale family handles). A process that has NEVER
        completed costed work exports no perf gauges at all — a
        warming replica must read as a HOLE in fleet_mfu, not as a
        0.0 dragging the fleet mean down."""
        r = self.rates()
        with self._mu:
            if self._last_rates is None:
                return r
        reg = default_registry()
        reg.gauge("perf_mfu",
                  "achieved model FLOPs/s over peak, sliding window "
                  "(busy-time denominator; docs/OBSERVABILITY.md)"
                  ).set(r["mfu"])
        reg.gauge("perf_hbm_bw_util",
                  "achieved bytes-accessed/s over peak HBM bandwidth, "
                  "sliding window").set(r["hbm_bw_util"])
        reg.gauge("perf_flops_per_second",
                  "achieved analytic FLOPs per busy second, "
                  "sliding window").set(r["flops_per_second"])
        return r

    def breakdown(self) -> Dict[str, dict]:
        """Step-time breakdown per component: accumulated phase
        seconds + shares of the component's busy total. Phases tile
        the measured busy time by construction (they are the same
        deltas the dispatch/drain instrumentation observes)."""
        with self._mu:
            phases = dict(self._phases)
        out: Dict[str, dict] = {}
        for (comp, phase), secs in phases.items():
            d = out.setdefault(comp, {"phases": {}, "busy_s": 0.0})
            d["phases"][phase] = round(secs, 6)
            d["busy_s"] = round(d["busy_s"] + secs, 6)
        for d in out.values():
            total = d["busy_s"] or 1.0
            d["phase_shares"] = {p: round(s / total, 4)
                                 for p, s in d["phases"].items()}
        return out

    def programs(self) -> List[ProgramHandle]:
        with self._mu:
            return list(self._programs.values())

    def _peaks_if_active(self) -> Optional[PeakSpec]:
        """Peaks only when this process has actually registered perf
        programs (or already detected them): peak detection queries
        the CUDA device name, which would initialize a CUDA context —
        a metrics-only process answering /statusz must not."""
        with self._mu:
            if self._peaks is None and not self._programs:
                return None
        return self.peaks()

    def status_summary(self) -> dict:
        """Cheap /statusz row: recorded data only."""
        r = self.rates()
        with self._mu:
            n = len(self._programs)
            failed = sum(1 for h in self._programs.values()
                         if h.cost_failed)
        peaks = self._peaks_if_active()
        return {
            "enabled": enabled(),
            "programs": n,
            "cost_failed": failed,
            "mfu": round(r["mfu"], 4),
            "flops_per_second": r["flops_per_second"],
            "hbm_bw_util": round(r["hbm_bw_util"], 4),
            "peak_flops": peaks.flops if peaks else None,
            "peak_source": peaks.source if peaks else None,
        }

    def payload(self) -> dict:
        """The GET /perfz body: refresh gauges, report programs +
        aggregates + breakdown."""
        rates = self.update_gauges()
        peaks = self._peaks_if_active()
        progs = sorted((h.to_dict() for h in self.programs()),
                       key=lambda d: -d["seconds"])
        return {
            "enabled": enabled(),
            "uptime_s": round(time.time() - self.t_start, 3),
            "window_s": WINDOW_S,
            "peaks": {"flops": peaks.flops,
                      "hbm_bytes_per_s": peaks.hbm_bytes_per_s,
                      "source": peaks.source,
                      "device_kind": peaks.device_kind}
            if peaks else None,
            "mfu": round(rates["mfu"], 6),
            "hbm_bw_util": round(rates["hbm_bw_util"], 6),
            "flops_per_second": rates["flops_per_second"],
            "bytes_per_second": rates["bytes_per_second"],
            "programs": progs,
            "breakdown": self.breakdown(),
            "cost_failures": sum(1 for p in progs if p["cost_failed"]),
        }


_instance: Optional[PerfRegistry] = None
_instance_mu = threading.Lock()


def instance() -> PerfRegistry:
    global _instance
    with _instance_mu:
        if _instance is None:
            _instance = PerfRegistry()
        return _instance


def reset() -> None:
    """Drop the process-wide registry (test isolation)."""
    global _instance
    with _instance_mu:
        _instance = None


# -- module-level conveniences (what the hot paths call) -------------------

def register_program(component: str, kind: str, sig: Tuple = (),
                     cost: Optional[Tuple[float, float]] = None,
                     steps: int = 1,
                     scope: str = "") -> Optional[ProgramHandle]:
    return instance().register_program(component, kind, sig=sig,
                                       cost=cost, steps=steps,
                                       scope=scope)


def record_phase(component: str, phase: str, seconds: float) -> None:
    instance().record_phase(component, phase, seconds)


def perfz_payload() -> dict:
    return instance().payload()


def status_summary() -> dict:
    return instance().status_summary()
