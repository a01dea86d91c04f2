"""The goodput ledger: every wall-clock second has an owner (/goodputz).

The memory ledger gives every device byte an owner and the perf
registry every program a roofline; this module does the same for the
scarcest fleet resource — wall-clock time. A process-wide :class:`TimeLedger`
attributes every second since arming to exactly one bucket:

- ``productive`` — device compute: the same wall-time deltas the perf
  registry already observes (train dispatch, llm decode/prefill
  fetch intervals);
- ``compile`` — compile and kernel-build waits (first-signature train steps, each
  engine program's first fetch);
- ``input_wait`` — the dataloader/prefetch starvation the
  ``io.next_wait`` span and ``*_next_wait_seconds`` histograms measure;
- ``ckpt_stall`` — the train loop's checkpoint exposure: the
  device→host snapshot plus the emergency-flush barrier window;
- ``recovery`` — RetryPolicy backoff sleeps, engine device-retry
  re-admissions, elastic restart backoff: time spent limping;
- ``migration`` — disaggregated-fleet KV-page migration wall time
  (prefill fill + export + verified import, success or fallback):
  seconds a request spent waiting on a page transfer instead of
  decoding;
- ``audit`` — stream-integrity shadow re-executions
  (``FLAGS.audit_shadow_rate``): the wall cost of proving the fleet's
  determinism in production;
- ``shed`` — time requests spent in the fleet before a shed verdict
  resolved them (router quota/overload/brownout sheds): the wall cost
  of refusing work, named so an overload event reads as SHED on the
  ledger instead of vanishing into queue_wait;
- ``queue_wait`` — llm admission queue residency (wall-clock coverage,
  not per-request sums — see "tolerance" below);
- ``host_gap`` — short uncovered gaps between attributed intervals
  (≤ :data:`HOST_GAP_MAX_S`): the dispatch-overhead residual;
- ``unattributed`` — the explicit closing line: long uncovered
  stretches (idle, or instrumentation we don't have). The /memz
  residual discipline: Σ buckets + unattributed == elapsed, ALWAYS.

ATTRIBUTION MODEL. Call sites report post-hoc durations at interval
end (``note(bucket, seconds)``); the ledger stamps the interval
``[clock()-seconds, clock()]`` — exact for every wired site, since all
of them observe right as the interval closes (the same dt their
histograms observe: zero new clocks, zero host syncs). Reads run an
exact interval sweep: overlapping same-bucket intervals UNION (ten
queued requests over one second are one second of queue_wait, not
ten); cross-bucket overlap resolves by documented precedence —
``productive > compile > ckpt_stall > input_wait > recovery >
migration > audit > shed > queue_wait > host_gap`` (the device owning
the second is the strongest claim; migration — cross-replica KV-page
transfer wall time — audit — shadow re-execution wall time — and
shed — time spent refusing doomed work — beat queue_wait because
their seconds have a NAMED cause, and a fleet drowning in page
transfers, determinism proofs, or load shedding must not
masquerade as queueing; a queued request overlaps nearly everything,
so its claim is nearly the weakest; a directly-noted drain sync
yields to all). Every second is counted exactly once, by exactly one
bucket.

TOLERANCE vs the histograms. Bucket totals are wall-clock coverage;
the existing histograms (``train_loop_dispatch_seconds``,
``llm_queue_wait_seconds``, ...) are per-event sums. On a serial
workload (one train loop, one engine loop, no overlap) the two agree
to within float noise — obs_smoke pins that. Under concurrency the
ledger is ≤ the histogram sum by construction (overlap unions);
that difference is the point, not drift.

MEMORY BOUND. Intervals older than :data:`SETTLE_LAG_S` fold into
per-bucket settled totals once the pending list exceeds
:data:`PENDING_SOFT_CAP` — the settle point lands on the end of a
covered interval, so a gap is never split mid-classification (the
forced path past :data:`PENDING_HARD_CAP` may split one gap; its
settled part classifies by its own length — a bounded, counted
degradation, never an accounting leak). Past the cap a note finds the
settle point by bisecting the pending list (ordered by end time) and
folds only once :data:`SETTLE_BATCH` intervals have crossed the
horizon; the clip floor still moves at every note, where the JAX
package folds, so the totals are the JAX package's (up to the order of
the float sums).

Disabled cost is ONE module-flag check (``FLAGS.goodput_observability``,
pinned like tracing/perf/mem). Surfaces: ``GET /goodputz``,
``goodput_fraction`` / ``badput_seconds_total{cause}`` on ``/metrics``
(never-armed process exports neither — fleet federation reads the
absence as a HOLE, the fleet_mfu semantics), a ``/statusz`` row, and
span-tagged watermarks: an SLO burn-rate trip snapshots the delta of
which bucket grew since the last watermark (docs/OBSERVABILITY.md
"Goodput surfaces").
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..core import flags as _flags
from .metrics import default_registry

# attribution buckets, PRECEDENCE ORDER (index 0 wins every overlap).
# host_gap is both recordable (the train loop's measured metric-drain
# sync — a known host-overhead window — notes it directly, with the
# weakest claim) and derived (short uncovered gaps classify into it)
BUCKETS: Tuple[str, ...] = ("productive", "compile", "ckpt_stall",
                            "input_wait", "recovery", "migration",
                            "audit", "shed", "queue_wait", "host_gap")
# derived only from uncovered timeline segments — the closing line
DERIVED: Tuple[str, ...] = ("unattributed",)
# every cause badput_seconds_total{cause=} exports (all but productive)
BADPUT_CAUSES: Tuple[str, ...] = BUCKETS[1:] + DERIVED

# an uncovered gap this short between attributed intervals is host
# dispatch overhead (host_gap); anything longer is idle (unattributed)
HOST_GAP_MAX_S = 1.0

# settle intervals at least this old (longest expected single post-hoc
# interval — a 2-minute compile — must still land unclipped)
SETTLE_LAG_S = 300.0
PENDING_SOFT_CAP = 8192
PENDING_HARD_CAP = 4 * PENDING_SOFT_CAP
# past the soft cap, intervals that crossed the settle horizon fold in
# batches of at least this many (one O(n log n) sweep per batch, not
# per note)
SETTLE_BATCH = 512

# bounded forensics ring: one entry per SLO trip / explicit watermark
TRIP_CAP = 16

# -- enable flag (pinned: one module-bool check on the hot path) -----------

_ENABLED = bool(_flags.get_flag("goodput_observability"))


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _active_phase() -> str:
    """Watermark span tag (the memory ledger's discipline): the caller
    thread's open span, else the newest live span anywhere, else
    "(untraced)"."""
    from . import tracing
    sp = tracing.current_span()
    if sp is not None:
        return sp.name
    if tracing.enabled():
        live = tracing.live_spans()
        if live:
            return live[-1]["name"]
    return "(untraced)"


def _end(interval: Tuple[float, float, int]) -> float:
    return interval[1]


def _sweep(intervals: List[Tuple[float, float, int]], start: float,
           end: float) -> Tuple[List[float], List[Tuple[float, float]]]:
    """Exact owner sweep over ``[start, end]``: returns per-bucket
    covered seconds (precedence-resolved, union within a bucket) and
    the uncovered gap segments in order. O(n log n) in intervals."""
    covered = [0.0] * len(BUCKETS)
    gaps: List[Tuple[float, float]] = []
    events: List[Tuple[float, int, int]] = []
    for t0, t1, prio in intervals:
        t0, t1 = max(t0, start), min(t1, end)
        if t1 > t0:
            events.append((t0, 1, prio))
            events.append((t1, -1, prio))
    if not events:
        if end > start:
            gaps.append((start, end))
        return covered, gaps
    events.sort(key=lambda e: (e[0], -e[1]))
    active = [0] * len(BUCKETS)
    cursor = start
    gap_open = start

    def close_segment(upto: float) -> None:
        nonlocal cursor, gap_open
        if upto <= cursor:
            return
        owner = next((i for i, n in enumerate(active) if n), None)
        if owner is None:
            cursor = upto
            return
        if gap_open < cursor:
            gaps.append((gap_open, cursor))
        covered[owner] += upto - cursor
        cursor = upto
        gap_open = upto

    for t, delta, prio in events:
        close_segment(t)
        active[prio] += delta
    close_segment(end)
    if gap_open < end:
        gaps.append((gap_open, end))
    return covered, gaps


class TimeLedger:
    """Process-wide wall-clock attribution (singleton via
    :func:`instance`; tests build private ones with injected clocks).

    Arms lazily at the first :meth:`note` (or explicitly via
    :meth:`arm`); a never-armed ledger exports NO gauges — the hole
    the fleet federation is specified to read."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 registry=None,
                 gap_max_s: float = HOST_GAP_MAX_S):
        self._clock = clock
        self._registry = registry
        self.gap_max_s = float(gap_max_s)
        self._mu = threading.Lock()
        self._armed_t: Optional[float] = None
        self._armed_wall: Optional[float] = None
        self._pending: List[Tuple[float, float, int]] = []
        self._settled = {b: 0.0 for b in BUCKETS + DERIVED}
        self._settled_until: Optional[float] = None
        # where the JAX package's ledger would have settled: notes
        # reaching below it are clipped; folds catch up in batches
        self._clip_floor: Optional[float] = None
        self._clipped_s = 0.0       # arrived below the settle horizon
        self._split_gaps = 0        # forced-settle gap splits (rare)
        # watermark: last snapshot the trip forensics diff against
        self._watermark: Optional[dict] = None
        self._trips: deque = deque(maxlen=TRIP_CAP)
        # lazily-minted gauges/counters (hole semantics: a never-armed
        # process must export neither family)
        self._g_fraction = None
        self._c_badput = None
        self._exported = {c: 0.0 for c in BADPUT_CAUSES}

    # -- recording ------------------------------------------------------
    def arm(self, t: Optional[float] = None) -> None:
        with self._mu:
            self._arm_locked(t)

    def _arm_locked(self, t: Optional[float] = None) -> None:
        if self._armed_t is None:
            self._armed_t = self._clock() if t is None else float(t)
            self._armed_wall = time.time()
            self._settled_until = self._armed_t
            self._clip_floor = self._armed_t

    def note(self, bucket: str, seconds: float) -> None:
        """Attribute the just-closed interval of ``seconds`` ending now
        to ``bucket``. The hot-path entry point: call sites observe
        post-hoc, the same dt their histograms record."""
        if seconds <= 0:
            return
        prio = BUCKETS.index(bucket)
        with self._mu:
            t1 = self._clock()
            # lazy-arm at the START of the first observed interval, so
            # the arming note keeps its own seconds (arming at t1 would
            # clamp it to zero length)
            self._arm_locked(t1 - float(seconds))
            t0 = max(t1 - float(seconds), self._armed_t)
            if t0 < self._clip_floor:
                # reaches into the settled region: those seconds were
                # already closed out (as gap or another owner) — clamp
                # and count, never double-book
                self._clipped_s += self._clip_floor - t0
                t0 = self._clip_floor
            if t1 > t0:
                self._pending.append((t0, t1, prio))
            if len(self._pending) > PENDING_SOFT_CAP:
                self._settle_locked(t1)

    # -- settling (memory bound) ----------------------------------------
    def _settle_locked(self, now: float) -> None:
        horizon = now - SETTLE_LAG_S
        # the pending list is ordered by end time (each note ends at the
        # clock's now), so the intervals ended by the horizon are a
        # prefix
        n = bisect.bisect_right(self._pending, horizon, key=_end)
        if n == 0:
            if len(self._pending) <= PENDING_HARD_CAP:
                return
            point = horizon     # forced: may split one open gap
            self._split_gaps += 1
            fold = True
        else:
            point = self._pending[n - 1][1]
            fold = n >= SETTLE_BATCH or \
                len(self._pending) > PENDING_HARD_CAP
        if point <= self._clip_floor:
            return
        self._clip_floor = point
        if fold:
            self._fold_locked(point)

    def _fold_locked(self, point: float) -> None:
        """Fold everything before ``point`` into the settled totals."""
        covered, gaps = _sweep(self._pending, self._settled_until,
                               point)
        for i, b in enumerate(BUCKETS):
            self._settled[b] += covered[i]
        for g0, g1 in gaps:
            key = "host_gap" if (g1 - g0) <= self.gap_max_s \
                else "unattributed"
            self._settled[key] += g1 - g0
        n = bisect.bisect_right(self._pending, point, key=_end)
        self._pending = [(max(t0, point), t1, prio)
                         for t0, t1, prio in self._pending[n:]]
        self._settled_until = point

    # -- reads ----------------------------------------------------------
    def totals(self, now: Optional[float] = None) -> Dict[str, float]:
        """The reconciled table: per-bucket seconds + host_gap +
        unattributed, summing exactly to elapsed."""
        with self._mu:
            return self._totals_locked(now)

    def _totals_locked(self, now: Optional[float] = None
                       ) -> Dict[str, float]:
        if self._armed_t is None:
            return {b: 0.0 for b in BUCKETS + DERIVED}
        now = self._clock() if now is None else float(now)
        now = max(now, self._clip_floor)
        covered, gaps = _sweep(self._pending, self._settled_until, now)
        out = dict(self._settled)
        for i, b in enumerate(BUCKETS):
            out[b] += covered[i]
        for g0, g1 in gaps:
            # the trailing open gap uses the same rule: a short tail
            # is dispatch overhead in flight, a long one is idle
            key = "host_gap" if (g1 - g0) <= self.gap_max_s \
                else "unattributed"
            out[key] += g1 - g0
        return out

    def elapsed(self) -> float:
        with self._mu:
            if self._armed_t is None:
                return 0.0
            return max(0.0, self._clock() - self._armed_t)

    @property
    def armed(self) -> bool:
        return self._armed_t is not None

    def goodput_fraction(self) -> Optional[float]:
        """productive / elapsed, or None before arming (a hole, not a
        zero — an unarmed process has no denominator)."""
        with self._mu:
            if self._armed_t is None:
                return None
            now = self._clock()
            el = now - self._armed_t
            if el <= 0:
                return None
            return self._totals_locked(now)["productive"] / el

    @staticmethod
    def top_badput(totals: Dict[str, float]) -> Optional[dict]:
        cause = max(BADPUT_CAUSES, key=lambda c: totals.get(c, 0.0))
        s = totals.get(cause, 0.0)
        if s <= 0:
            return None
        return {"cause": cause, "seconds": round(s, 6)}

    # -- watermarks + trip forensics ------------------------------------
    def snapshot_watermark(self, tag: str = "") -> dict:
        """Advance the watermark: record the current totals as the
        baseline the next trip's delta reads against. Returns the
        delta since the PREVIOUS watermark (or since arming)."""
        with self._mu:
            self._arm_locked()
            now = self._clock()
            totals = self._totals_locked(now)
            prev = self._watermark
            base = prev["buckets"] if prev else \
                {b: 0.0 for b in BUCKETS + DERIVED}
            delta = {b: round(totals[b] - base.get(b, 0.0), 6)
                     for b in BUCKETS + DERIVED}
            self._watermark = {
                "ts": time.time(),
                "t": now,
                "span": tag or _active_phase(),
                "buckets": totals,
            }
            return delta

    def note_trip(self, tag: str) -> Optional[dict]:
        """Forensic hook for the SLO breach latch: snapshot the
        per-bucket delta since the last watermark — "which bucket
        grew" is the first question a burn-rate page asks — then
        advance the watermark so consecutive trips don't re-blame the
        same seconds."""
        delta = self.snapshot_watermark(tag=tag)
        grown = {b: s for b, s in delta.items()
                 if b != "productive" and s > 0}
        top = max(grown, key=grown.get) if grown else None
        trip = {
            "tag": tag,
            "ts": time.time(),
            "span": _active_phase(),
            "delta": delta,
            "top_grown": top,
        }
        with self._mu:
            self._trips.append(trip)
        return trip

    # -- export ---------------------------------------------------------
    def _reg(self):
        return self._registry or default_registry()

    def update_gauges(self) -> Optional[dict]:
        """Refresh ``goodput_fraction`` + ``badput_seconds_total`` at a
        read boundary (the /metrics prescrape). A never-armed ledger
        mints NOTHING: the federation hole. Counters are monotone
        projections of the reconciled table — a transient
        reclassification (a host_gap tail growing into unattributed)
        shows on /goodputz immediately and the counter catches up."""
        with self._mu:
            if self._armed_t is None:
                return None
            now = self._clock()
            totals = self._totals_locked(now)
            el = max(now - self._armed_t, 0.0)
            frac = (totals["productive"] / el) if el > 0 else 0.0
            if self._g_fraction is None:
                reg = self._reg()
                self._g_fraction = reg.gauge(
                    "goodput_fraction",
                    "productive wall-clock seconds / elapsed since the "
                    "time ledger armed — absent entirely until the "
                    "first attributed interval (federation reads the "
                    "absence as a hole, never a zero)")
                self._c_badput = reg.counter(
                    "badput_seconds_total",
                    "non-productive wall-clock seconds by cause "
                    "(monotone projection of the /goodputz table)",
                    label_names=("cause",))
            self._g_fraction.set(frac)
            for cause in BADPUT_CAUSES:
                d = totals[cause] - self._exported[cause]
                if d > 0:
                    self._c_badput.labels(cause).inc(d)
                    self._exported[cause] = totals[cause]
            return totals

    def status_summary(self) -> dict:
        """Cheap /statusz row."""
        with self._mu:
            if self._armed_t is None:
                return {"enabled": enabled(), "armed": False}
            now = self._clock()
            totals = self._totals_locked(now)
            el = max(now - self._armed_t, 0.0)
        return {
            "enabled": enabled(),
            "armed": True,
            "elapsed_s": round(el, 3),
            "goodput_fraction": round(
                totals["productive"] / el, 4) if el > 0 else 0.0,
            "top_badput": self.top_badput(totals),
        }

    def payload(self) -> dict:
        """The GET /goodputz body: the reconciled bucket table with
        its explicit closing line, the goodput fraction, the top
        badput cause, and the watermark/trip forensics."""
        with self._mu:
            armed = self._armed_t is not None
            now = self._clock() if armed else 0.0
            totals = self._totals_locked(now) if armed else \
                {b: 0.0 for b in BUCKETS + DERIVED}
            el = max(now - self._armed_t, 0.0) if armed else 0.0
            attributed = sum(totals[b] for b in BUCKETS)
            wm = dict(self._watermark) if self._watermark else None
            trips = list(self._trips)
            pending = len(self._pending)
            clipped = self._clipped_s
            split = self._split_gaps
            armed_wall = self._armed_wall
        if wm:
            wm["buckets"] = {b: round(s, 6)
                             for b, s in wm["buckets"].items()}
        body = {
            "enabled": enabled(),
            "armed": armed,
            "armed_at": armed_wall,
            "elapsed_s": round(el, 6),
            "buckets": {b: round(totals[b], 6) for b in BUCKETS},
            "unattributed_s": round(totals["unattributed"], 6),
            "reconciliation": {
                "attributed_s": round(attributed, 6),
                "unattributed_s": round(totals["unattributed"], 6),
                "elapsed_s": round(el, 6),
                "residual_s": round(
                    el - attributed - totals["unattributed"], 9),
            },
            "goodput_fraction": round(totals["productive"] / el, 6)
            if el > 0 else None,
            "top_badput": self.top_badput(totals),
            "precedence": list(BUCKETS),
            "gap_max_s": self.gap_max_s,
            "watermark": wm,
            "trips": trips,
            "intervals_pending": pending,
            "clipped_s": round(clipped, 6),
            "forced_gap_splits": split,
        }
        if armed:
            delta = None
            if wm:
                delta = {b: round(totals[b] - wm["buckets"]
                                  .get(b, 0.0), 6)
                         for b in BUCKETS + DERIVED}
            body["delta_since_watermark"] = delta
        return body


_instance: Optional[TimeLedger] = None
_instance_mu = threading.Lock()


def instance() -> TimeLedger:
    global _instance
    with _instance_mu:
        if _instance is None:
            _instance = TimeLedger()
        return _instance


def reset() -> None:
    """Drop the process-wide ledger (test isolation). Does NOT drop
    already-minted metric families — tests use private registries."""
    global _instance
    with _instance_mu:
        _instance = None


# -- module-level conveniences (what the hot paths call) -------------------

def note(bucket: str, seconds: float) -> None:
    """One attributed interval ending now. The call sites guard with
    :func:`enabled` themselves (one module-flag check, the
    tracing/perf/mem discipline); this re-checks for safety."""
    if not _ENABLED:
        return
    instance().note(bucket, seconds)


def note_trip(tag: str) -> Optional[dict]:
    if not _ENABLED:
        return None
    return instance().note_trip(tag)


def goodputz_payload() -> dict:
    return instance().payload()


def status_summary() -> dict:
    return instance().status_summary()
