"""SLO monitoring: error-budget burn rates over router request outcomes.

The metrics layer says how the system is doing; nothing so far
says whether that is GOOD ENOUGH — whether the latency tier a tenant
paid for (the router's SLO classes) is actually being met, and
how fast the error budget is being spent when it isn't.
:class:`SLOTracker` closes that loop with the standard SRE machinery:

- every resolved router request is recorded against its SLO class
  (and tenant): latency histogram, outcome counter, deadline hit/miss;
- each class has a TARGET success ratio (e.g. 0.99 → a 1% error
  budget). The tracker maintains TWO rolling windows (short/long) of
  request outcomes and publishes **burn rates**: the window's error
  rate divided by the budget. Burn 1.0 = spending the budget exactly
  as provisioned; burn 20 = the budget burns 20× too fast;
- the classic multi-window alert rule latches a BREACH when *both*
  windows burn above ``breach_threshold`` (the short window proves
  it's happening now, the long one proves it's not a blip). The latch
  is sticky — visible on ``/healthz`` as a degraded component until an
  operator resets it (``POST /reset_health``), because an SLO that
  was violated needs a human to acknowledge it even after traffic
  recovers.

Surfaces: ``GET /sloz`` (full JSON report), ``/statusz`` (same report
as a status provider), Prometheus gauges (``slo_burn_rate{slo,
window}``, ``slo_deadline_hit_ratio{slo}``, ``slo_breach_latched
{slo}``) plus per-class/per-tenant request histograms and counters.

Stdlib-only, injectable clock (tests drive the windows without
sleeping), registry-injectable (tests stay isolated).

Outcome semantics: ``ok`` consumes no budget; ``cancelled`` is a
client choice and is excluded from the budget entirely; everything
else (deadline, shed, unavailable, error, closed) burns budget — a
refusal is not success just because it was typed.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Dict, Optional, Tuple

from .metrics import MetricRegistry, default_registry

# (short, long) rolling windows, seconds — the 5m/1h pair of the
# classic multi-window burn-rate alert
DEFAULT_WINDOWS: Tuple[float, float] = (300.0, 3600.0)
_WINDOW_NAMES = ("short", "long")
# how finely each window is bucketed (granularity of expiry)
_BUCKETS_PER_WINDOW = 12
# outcomes that do NOT burn error budget
_NON_ERROR = ("ok", "cancelled")


class _RollingWindow:
    """Time-bucketed (total, errors) counts over a sliding window.
    O(buckets) memory regardless of traffic; expired buckets are
    dropped on touch. Callers hold the tracker lock."""

    __slots__ = ("span", "width", "_buckets")

    def __init__(self, span_s: float):
        self.span = float(span_s)
        self.width = self.span / _BUCKETS_PER_WINDOW
        self._buckets: Dict[int, list] = {}   # idx -> [total, errors]

    def _gc(self, now: float) -> None:
        floor = int(now / self.width) - _BUCKETS_PER_WINDOW
        for idx in [i for i in self._buckets if i <= floor]:
            del self._buckets[idx]

    def record(self, now: float, error: bool) -> None:
        self._gc(now)
        b = self._buckets.setdefault(int(now / self.width), [0, 0])
        b[0] += 1
        b[1] += int(error)

    def totals(self, now: float) -> Tuple[int, int]:
        self._gc(now)
        total = sum(b[0] for b in self._buckets.values())
        errors = sum(b[1] for b in self._buckets.values())
        return total, errors


class _ClassState:
    __slots__ = ("target", "windows", "deadline_hits",
                 "deadline_misses", "breached", "breached_at")

    def __init__(self, target: float, window_spans):
        self.target = float(target)
        self.windows = tuple(_RollingWindow(s) for s in window_spans)
        self.deadline_hits = 0
        self.deadline_misses = 0
        self.breached = False
        self.breached_at: Optional[float] = None


class SLOTracker:
    """Per-SLO-class (and per-tenant) outcome accounting + burn-rate
    gauges + the multi-window breach latch.

    ``targets``: mapping SLO-class name → target success ratio; classes
    not listed use ``default_target``. Requests with no class record
    under ``"default"``. ``min_samples``: a window with fewer requests
    than this reports its burn rate but cannot latch a breach (one
    early error must not page anyone)."""

    def __init__(self, targets: Optional[Dict[str, float]] = None,
                 default_target: float = 0.99,
                 windows: Tuple[float, float] = DEFAULT_WINDOWS,
                 breach_threshold: float = 10.0,
                 min_samples: int = 10,
                 registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        if len(windows) != len(_WINDOW_NAMES):
            raise ValueError(f"exactly {len(_WINDOW_NAMES)} windows "
                             f"(short, long), got {windows!r}")
        self.targets = dict(targets or {})
        self.default_target = float(default_target)
        self.window_spans = tuple(float(w) for w in windows)
        self.breach_threshold = float(breach_threshold)
        self.min_samples = int(min_samples)
        self.registry = registry or default_registry()
        self._clock = clock
        self._mu = threading.Lock()
        self._classes: Dict[str, _ClassState] = {}
        reg = self.registry
        self._m_latency = reg.histogram(
            "slo_request_seconds",
            "router request latency by SLO class and tenant",
            label_names=("slo", "tenant"))
        self._m_outcomes = reg.counter(
            "slo_requests_total",
            "router request outcomes by SLO class",
            label_names=("slo", "outcome"))
        self._m_hit_ratio = reg.gauge(
            "slo_deadline_hit_ratio",
            "fraction of deadline-carrying requests that met their "
            "deadline (cumulative)",
            label_names=("slo",))
        self._m_burn = reg.gauge(
            "slo_burn_rate",
            "error-budget burn rate: windowed error rate / "
            "(1 - target); 1.0 spends the budget exactly on schedule",
            label_names=("slo", "window"))
        self._m_breach = reg.gauge(
            "slo_breach_latched",
            "1 while the multi-window burn-rate breach latch is set "
            "(sticky until reset_health)",
            label_names=("slo",))

    # -- recording ------------------------------------------------------
    def _class(self, slo: str) -> _ClassState:
        st = self._classes.get(slo)
        if st is None:
            st = _ClassState(
                self.targets.get(slo, self.default_target),
                self.window_spans)
            self._classes[slo] = st
            self._m_breach.labels(slo).set(0)
        return st

    def record(self, slo: Optional[str], tenant: Optional[str],
               latency_s: float, outcome: str,
               had_deadline: bool = False) -> None:
        """One resolved request. ``outcome`` is the router's verdict
        string (ok/deadline/shed/cancelled/unavailable/error/closed);
        ``had_deadline`` gates the deadline-hit ratio (requests
        without one neither hit nor miss)."""
        slo = slo or "default"
        tenant = tenant or ""
        error = outcome not in _NON_ERROR
        counted = outcome != "cancelled"   # client choice: no budget
        now = self._clock()
        self._m_latency.labels(slo, tenant).observe(latency_s)
        self._m_outcomes.labels(slo, outcome).inc()
        with self._mu:
            st = self._class(slo)
            if had_deadline:
                if outcome == "ok":
                    st.deadline_hits += 1
                elif outcome == "deadline":
                    st.deadline_misses += 1
            if counted:
                for w in st.windows:
                    w.record(now, error)
            self._publish_locked(slo, st, now)

    def _publish_locked(self, slo: str, st: _ClassState,
                        now: float) -> None:
        budget = max(1.0 - st.target, 1e-9)
        burns, eligible = [], []
        for wname, w in zip(_WINDOW_NAMES, st.windows):
            total, errors = w.totals(now)
            rate = (errors / total) if total else 0.0
            burn = rate / budget
            self._m_burn.labels(slo, wname).set(burn)
            burns.append(burn)
            eligible.append(total >= self.min_samples)
        n_dl = st.deadline_hits + st.deadline_misses
        if n_dl:
            self._m_hit_ratio.labels(slo).set(st.deadline_hits / n_dl)
        if (not st.breached and all(eligible)
                and all(b > self.breach_threshold for b in burns)):
            st.breached = True
            st.breached_at = time.time()
            self._m_breach.labels(slo).set(1)
            # goodput forensics: snapshot which time-ledger bucket
            # grew since the last watermark — the first question a
            # burn-rate page asks ("did we lose the seconds to
            # compiles? retries? input?"). Best-effort: the latch
            # must publish even if the ledger is mid-reset.
            try:
                from . import goodput as _goodput
                _goodput.note_trip(f"slo_breach:{slo}")
            except Exception:  # noqa: BLE001
                pass

    def refresh(self) -> None:
        """Recompute and republish the windowed gauges. record() only
        publishes on traffic — without this, ``slo_burn_rate`` on
        /metrics would FREEZE at its last value when a storm ends and
        traffic stops, keeping alerts firing long after the windows
        emptied (the router calls this on its health-poll cadence)."""
        now = self._clock()
        with self._mu:
            for slo, st in self._classes.items():
                self._publish_locked(slo, st, now)

    def _merged_latency(self, slo: str) -> Optional[Dict[str, float]]:
        """Class-level latency percentiles merged across ALL tenant
        children of ``slo_request_seconds{slo,tenant}`` — /sloz must
        report the class's latency, not just the untenanted subset.
        Children of one family share bucket bounds AND one lock, so
        the merge is a single locked pass summing per-bucket counts,
        then the same clamped interpolation HistogramChild uses."""
        children = [c for c in self._m_latency.children()
                    if c.label_values[0] == slo]
        if not children:
            return None
        lock = children[0]._lock      # one lock per family, shared
        with lock:
            bounds = list(children[0]._bounds)
            counts = [0] * (len(bounds) + 1)
            total = 0
            mn, mx = math.inf, -math.inf
            for c in children:
                for i, v in enumerate(c._counts):
                    counts[i] += v
                total += c._count
                mn = min(mn, c._min)
                mx = max(mx, c._max)
        if not total:
            return None
        out = {}
        for q in (0.50, 0.90, 0.99):
            rank = q * total
            cum, lo, est = 0.0, mn, mx
            for bound, cnt in zip(bounds, counts):
                if cum + cnt >= rank and cnt > 0:
                    hi = min(bound, mx)
                    est = min(max(lo + (hi - lo) * ((rank - cum) / cnt),
                                  mn), mx)
                    break
                if cnt > 0:
                    lo = bound
                cum += cnt
            out[f"p{q * 100:g}"] = round(est, 6)
        return out

    # -- readout --------------------------------------------------------
    def burn_rates(self, slo: str) -> Dict[str, float]:
        now = self._clock()
        with self._mu:
            st = self._classes.get(slo)
            if st is None:
                return {}
            out = {}
            budget = max(1.0 - st.target, 1e-9)
            for wname, w in zip(_WINDOW_NAMES, st.windows):
                total, errors = w.totals(now)
                out[wname] = ((errors / total) / budget) if total \
                    else 0.0
            return out

    def window_status(self, slo: Optional[str] = None) -> dict:
        """The controller query API (the serving autoscaler's sensor):
        LIVE window state per class — burn rate, sample count, and
        min-samples eligibility per window, plus ``tripped``: True
        while EVERY window burns above ``breach_threshold`` with
        enough samples (the same multi-window rule the breach latch
        fires on, but computed from the live windows, not the sticky
        latch). An acknowledged breach (``reset_breach``) therefore
        does NOT read as tripped once the windows have decayed — a
        controller keyed on this re-acts only when the windows
        re-trip, never on a stale acknowledgment."""
        now = self._clock()
        with self._mu:
            items = (self._classes.items() if slo is None else
                     [(slo, self._classes[slo])]
                     if slo in self._classes else [])
            out = {}
            for name, st in items:
                budget = max(1.0 - st.target, 1e-9)
                windows = {}
                tripped = bool(st.windows)
                for wname, w in zip(_WINDOW_NAMES, st.windows):
                    total, errors = w.totals(now)
                    burn = ((errors / total) / budget) if total else 0.0
                    eligible = total >= self.min_samples
                    windows[wname] = {"burn_rate": round(burn, 4),
                                      "requests": total,
                                      "eligible": eligible}
                    tripped = tripped and eligible \
                        and burn > self.breach_threshold
                out[name] = {"windows": windows, "tripped": tripped,
                             "breached": st.breached}
            return out

    def tripped_classes(self) -> list:
        """Classes whose live windows ALL burn above the threshold
        right now (see :meth:`window_status`)."""
        return sorted(s for s, st in self.window_status().items()
                      if st["tripped"])

    def breached(self):
        with self._mu:
            return sorted(s for s, st in self._classes.items()
                          if st.breached)

    def reset_breach(self) -> None:
        """Operator acknowledgment: clear every latch (wired into
        POST /reset_health alongside engine health and breaker
        resets)."""
        with self._mu:
            for slo, st in self._classes.items():
                st.breached = False
                st.breached_at = None
                self._m_breach.labels(slo).set(0)

    def health(self) -> str:
        """The /healthz component verdict: a latched breach reads as
        degraded — visibly unhealthy, still routable (an SLO breach
        means "look at me", not "pull me from rotation")."""
        return "degraded" if self.breached() else "healthy"

    def report(self) -> dict:
        """The /sloz payload."""
        now = self._clock()
        with self._mu:
            classes = {}
            for slo, st in self._classes.items():
                budget = max(1.0 - st.target, 1e-9)
                windows = {}
                for wname, w in zip(_WINDOW_NAMES, st.windows):
                    total, errors = w.totals(now)
                    rate = (errors / total) if total else 0.0
                    # reading IS republishing: /sloz and /metrics must
                    # agree about the same quantity
                    self._m_burn.labels(slo, wname).set(rate / budget)
                    windows[wname] = {
                        "window_s": w.span,
                        "requests": total,
                        "errors": errors,
                        "error_rate": round(rate, 6),
                        "burn_rate": round(rate / budget, 4),
                    }
                n_dl = st.deadline_hits + st.deadline_misses
                entry = {
                    "target": st.target,
                    "error_budget": round(budget, 6),
                    "windows": windows,
                    "deadline_hits": st.deadline_hits,
                    "deadline_misses": st.deadline_misses,
                    "deadline_hit_ratio": (
                        round(st.deadline_hits / n_dl, 6)
                        if n_dl else None),
                    "breached": st.breached,
                }
                if st.breached_at is not None:
                    entry["breached_at"] = st.breached_at
                lat = self._merged_latency(slo)
                if lat is not None:
                    entry["latency_s"] = lat
                classes[slo] = entry
            return {
                "breach_threshold": self.breach_threshold,
                "min_samples": self.min_samples,
                "breached": sorted(s for s, st in self._classes.items()
                                   if st.breached),
                "classes": classes,
            }
