"""Overload brownout controller: deadline-aware admission, adaptive
per-replica concurrency, and a reversible fleet degradation ladder.

Under sustained overload the fleet's only pre-PR-20 defense was the
engine's blunt ``max_pending`` queue-full shed: the router happily
dispatched requests that were already hopeless, every SLO class
degraded at once, and the autoscaler's WARMING gap (spawn → READY is
tens of seconds) was exactly the window where gold traffic burned its
error budget. This module makes overload a MANAGED mode — three
cooperating mechanisms behind one :class:`OverloadController`:

HOPELESS SHEDDING (:class:`ServiceTimeEstimator`). Before any prefill
work is done, predict the request's service time from the perf
registry (realized prefill/decode token rates) plus current queue
residency, and shed requests whose deadline cannot be met with a
typed :class:`~paddle_tpu_torch.inference.llm.OverloadShed` carrying the
prediction — shedding a doomed request in 0.1 ms is strictly better
than failing it after 2 s of stolen compute. The estimator is
CONSERVATIVE: it sheds only when ``predicted > deadline ×
safety_factor`` (default 3×), a cold start with no perf history never
sheds, and its own accuracy is a metric
(``overload_estimate_error_ratio`` histogram of realized/predicted).
Protected classes (gold) are never hopeless-shed: their failure mode
is a deadline miss the SLO tracker burns honestly, never a shed the
operator didn't choose.

ADAPTIVE CONCURRENCY (:class:`AIMDLimiter`). An AIMD limiter bounds
the router's in-flight dispatches per replica: additive raise on
clean completions, multiplicative cut on deadline misses and shed
verdicts, floor/ceiling bounds, injectable clock. A slow replica
self-throttles instead of accumulating a doomed backlog; the realized
limit is the ``overload_limit{replica}`` gauge.

BROWNOUT LADDER (:class:`BrownoutLadder`). Ordered, REVERSIBLE
degradation levels latched off the LIVE SLO burn windows
(``SLOTracker.window_status()`` — never the sticky breach latch) with ElasticManager-style hysteresis/dwell so a
square-wave burn signal cannot flap the fleet:

    L0 normal
    L1 shed optional work: audit shadows off, migration detours off
    L2 clamp bronze ``max_new_tokens`` + tighten bronze deadlines
    L3 bronze shed — gold-only admission

Gold (any class in ``protected_classes``) is NEVER degraded below its
SLO by any level. Every transition logs its inputs (burn rates,
limiter state, warming count) and output (level + reason) to a
bounded log on ``GET /overloadz``; the ladder coordinates with the
autoscaler (brownout engages while replicas are WARMING; it steps
down as ``mark_ready`` capacity lands and the live windows decay) and
federates as ``fleet_brownout_level`` (max over UP replicas,
hole-not-zero).

Seeded chaos hooks: ``overload.estimate`` forces a wildly-wrong
service-time prediction; ``overload.step`` forces a spurious (but
reversible) ladder transition. Both replay from seed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from ..inference.llm import OverloadShed
from ..observability import metrics as _obs
from ..observability import perf as _perf
from ..observability import server as _dbgsrv
from ..reliability import faults as _faults
from ..reliability.retry import backoff_delay

# ladder levels, in escalation order; the names are the /overloadz and
# docs vocabulary (docs/RELIABILITY.md "Overload failure model")
LEVELS = ("normal", "shed_optional", "clamp_bronze", "gold_only")
MAX_LEVEL = len(LEVELS) - 1

TRANSITION_LOG_CAP = 64


class AIMDLimiter:
    """Additive-increase / multiplicative-decrease concurrency bound,
    one limit per replica name.

    Clean completions raise the limit by ``raise_step`` (additive);
    deadline misses and shed verdicts cut it by ``cut_factor``
    (multiplicative), at most once per ``cut_interval_s`` per replica
    — a burst of misses from ONE overload event is one congestion
    signal, not N (the TCP discipline). Limits are clamped to
    [floor, ceiling]; a fresh replica starts at ``initial``
    (default: the ceiling — optimistic, the first misses pull it
    down). ``clock`` is injectable for tests."""

    def __init__(self, floor: int = 1, ceiling: int = 32,
                 initial: Optional[float] = None,
                 raise_step: float = 1.0, cut_factor: float = 0.5,
                 cut_interval_s: float = 0.25,
                 clock=time.monotonic):
        if not (0 < floor <= ceiling):
            raise ValueError(f"need 0 < floor <= ceiling, got "
                             f"{floor}/{ceiling}")
        if not (0.0 < cut_factor < 1.0):
            raise ValueError(f"cut_factor must be in (0, 1), got "
                             f"{cut_factor}")
        self.floor = int(floor)
        self.ceiling = int(ceiling)
        self.initial = float(ceiling if initial is None else initial)
        self.raise_step = float(raise_step)
        self.cut_factor = float(cut_factor)
        self.cut_interval_s = float(cut_interval_s)
        self._clock = clock
        self._mu = threading.Lock()
        self._limits: Dict[str, float] = {}
        self._last_cut: Dict[str, float] = {}
        self.n_cuts = 0

    def _clamp(self, v: float) -> float:
        return max(float(self.floor), min(float(self.ceiling), v))

    def limit(self, name: str) -> int:
        """The integer in-flight bound for ``name`` right now."""
        with self._mu:
            return int(self._limits.get(name, self.initial))

    def has_room(self, name: str, inflight: int) -> bool:
        return int(inflight) < self.limit(name)

    def on_success(self, name: str) -> None:
        """Additive raise on a clean completion."""
        with self._mu:
            cur = self._limits.get(name, self.initial)
            self._limits[name] = self._clamp(cur + self.raise_step)

    def on_miss(self, name: str) -> bool:
        """Multiplicative cut on a deadline miss / shed verdict.
        Returns True when a cut was applied (False inside the
        ``cut_interval_s`` cooldown — that miss rode an
        already-priced congestion event)."""
        now = self._clock()
        with self._mu:
            if now - self._last_cut.get(name, -1e18) \
                    < self.cut_interval_s:
                return False
            cur = self._limits.get(name, self.initial)
            self._limits[name] = self._clamp(cur * self.cut_factor)
            self._last_cut[name] = now
            self.n_cuts += 1
            return True

    def forget(self, name: str) -> None:
        """Drop a detached replica's state (a re-attached same name
        re-earns its limit from ``initial``)."""
        with self._mu:
            self._limits.pop(name, None)
            self._last_cut.pop(name, None)

    def state(self) -> Dict[str, int]:
        """Snapshot for /overloadz and the transition log."""
        with self._mu:
            return {n: int(v) for n, v in sorted(self._limits.items())}


class ServiceTimeEstimator:
    """Deadline-aware admission: predicted service seconds from the
    perf registry's realized token rates.

    ``predict`` returns None on a COLD START (perf disabled, or no
    llm prefill/decode program has accumulated ``min_busy_s`` of
    wall time yet) — a request is never shed on a guess the registry
    can't back. ``hopeless`` applies the conservative factor: shed
    only when ``predicted > deadline × safety_factor``. ``source`` is
    injectable for tests: a zero-arg callable returning
    ``(prefill_tokens_per_s, decode_tokens_per_s)`` or None."""

    def __init__(self, safety_factor: float = 3.0,
                 min_busy_s: float = 0.05, source=None):
        if safety_factor < 1.0:
            raise ValueError("safety_factor < 1 would shed requests "
                             "the estimator itself predicts feasible")
        self.safety_factor = float(safety_factor)
        self.min_busy_s = float(min_busy_s)
        self._source = source

    def rates(self):
        """(prefill_tok/s, decode_tok/s) from the perf registry, or
        None before enough history exists. Prefill falls back to the
        decode rate when only decode programs have run (shorter
        prompts than history — still conservative: prefill is the
        faster phase per token)."""
        if self._source is not None:
            return self._source()
        if not _perf.enabled():
            return None
        pre_s = pre_t = dec_s = dec_t = 0.0
        for h in _perf.instance().programs():
            if h.component != "llm":
                continue
            if h.kind.startswith("prefill"):
                pre_s += h.seconds
                pre_t += h.tokens
            elif h.kind.startswith("decode") or \
                    h.kind.startswith("spec"):
                dec_s += h.seconds
                dec_t += h.tokens
        if dec_s < self.min_busy_s or dec_t <= 0:
            return None                      # cold start: never shed
        dec_rate = dec_t / dec_s
        pre_rate = (pre_t / pre_s) \
            if (pre_s >= self.min_busy_s and pre_t > 0) else dec_rate
        return pre_rate, dec_rate

    def predict(self, prompt_len: int, max_new_tokens: int,
                queue_s: float = 0.0) -> Optional[float]:
        """Predicted wall seconds for this request: prefill + decode
        at realized rates, plus the caller's queue-residency estimate.
        None = no history (cold start). The ``overload.estimate``
        fault site distorts the prediction 1000× — chaos proof that a
        wildly-wrong estimator degrades to visible shed/miss verdicts,
        never to hangs or silent corruption."""
        r = self.rates()
        if r is None:
            return None
        pre_rate, dec_rate = r
        if pre_rate <= 0 or dec_rate <= 0:
            return None
        p = (prompt_len / pre_rate) + (max_new_tokens / dec_rate) \
            + max(0.0, float(queue_s))
        if _faults.enabled():
            try:
                _faults.check("overload.estimate")
            except _faults.FaultInjected:
                p *= 1000.0
        return p

    def hopeless(self, predicted: Optional[float],
                 deadline_s: Optional[float]) -> bool:
        if predicted is None or deadline_s is None:
            return False
        return predicted > float(deadline_s) * self.safety_factor


class BrownoutLadder:
    """The reversible degradation ladder with ElasticManager-style
    damping: one level per step, a dwell before any move, and an
    exponential backoff curve on direction FLIPS so a square-wave
    pressure signal converges instead of flapping.

    ``step(pressure, ...)`` moves at most one level toward the signal:
    up when ``pressure`` (some class's live windows all burn above
    threshold), down when clear. A move in the SAME direction as the
    last one waits its dwell (``up_dwell_s`` / ``down_dwell_s``,
    asymmetric — escalate fast, recover deliberately); a FLIP
    additionally waits ``backoff_delay(flips-1, backoff_base_s)``
    capped at ``backoff_cap_s``, so each reversal doubles the quiet
    time and the flap count under a square wave is logarithmic. The
    flip streak resets after ``healthy_dwell_s`` without any
    transition. ``clock`` is injectable."""

    def __init__(self, up_dwell_s: float = 0.5,
                 down_dwell_s: float = 2.0,
                 backoff_base_s: float = 1.0,
                 backoff_cap_s: float = 30.0,
                 healthy_dwell_s: Optional[float] = None,
                 max_level: int = MAX_LEVEL,
                 clock=time.monotonic):
        self.up_dwell_s = float(up_dwell_s)
        self.down_dwell_s = float(down_dwell_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.healthy_dwell_s = float(
            2.0 * down_dwell_s if healthy_dwell_s is None
            else healthy_dwell_s)
        self.max_level = int(max_level)
        self._clock = clock
        self._mu = threading.Lock()
        self.level = 0
        self._last_change: Optional[float] = None
        self._last_dir = 0           # +1 up, -1 down, 0 never moved
        self._flips = 0              # direction reversals in a row
        self.n_transitions = 0
        self.log = deque(maxlen=TRANSITION_LOG_CAP)

    def _curve(self) -> float:
        return backoff_delay(max(self._flips - 1, 0),
                             self.backoff_base_s,
                             cap=self.backoff_cap_s)

    def _record(self, now, frm, to, reason, inputs) -> None:
        self.n_transitions += 1
        self.log.append({
            "t": round(now, 4), "from": frm, "to": to,
            "from_level": LEVELS[frm], "to_level": LEVELS[to],
            "reason": reason, "inputs": dict(inputs or {})})

    def step(self, pressure: bool, inputs: Optional[dict] = None,
             reason: str = "") -> int:
        """Advance the ladder one tick against the live signal;
        returns the (possibly unchanged) level."""
        now = self._clock()
        with self._mu:
            want = 0
            if pressure and self.level < self.max_level:
                want = 1
            elif not pressure and self.level > 0:
                want = -1
            since = (now - self._last_change) \
                if self._last_change is not None else None
            # a long quiet stretch forgives the flip history — the
            # next storm is a NEW story, not a continuation
            if since is not None and since >= self.healthy_dwell_s:
                self._flips = 0
            if want == 0:
                return self.level
            dwell = self.up_dwell_s if want > 0 else self.down_dwell_s
            if since is not None:
                need = dwell
                if want != self._last_dir and self._last_dir != 0:
                    need = max(dwell, self._curve())
                if since < need:
                    return self.level
            if want != self._last_dir and self._last_dir != 0:
                self._flips += 1
            frm = self.level
            self.level = frm + want
            self._last_dir = want
            self._last_change = now
            self._record(now, frm, self.level,
                         reason or ("burn_tripped" if want > 0
                                    else "burn_clear"), inputs)
            return self.level

    def force(self, level: int, reason: str,
              inputs: Optional[dict] = None) -> int:
        """Jump to ``level`` unconditionally (the ``overload.step``
        chaos hook and operator overrides). The jump is logged and
        REVERSIBLE — it updates the dwell clock like any transition,
        so the normal :meth:`step` hysteresis walks it back when the
        live signal disagrees."""
        level = max(0, min(self.max_level, int(level)))
        now = self._clock()
        with self._mu:
            if level == self.level:
                return self.level
            frm = self.level
            want = 1 if level > frm else -1
            if want != self._last_dir and self._last_dir != 0:
                self._flips += 1
            self.level = level
            self._last_dir = want
            self._last_change = now
            self._record(now, frm, level, reason, inputs)
            return self.level

    def transitions(self) -> list:
        with self._mu:
            return list(self.log)


def _controller_metrics(reg):
    return {
        "shed": reg.counter(
            "overload_shed_total",
            "requests shed by the overload controller, by verdict "
            "('hopeless': predicted service time cannot meet the "
            "deadline; 'brownout': ladder level admits protected "
            "classes only)",
            label_names=("reason",)),
        "limit": reg.gauge(
            "overload_limit",
            "AIMD per-replica concurrency limit the router enforces "
            "(additive raise on clean completions, multiplicative "
            "cut on deadline misses/sheds)",
            label_names=("replica",)),
        "level": reg.gauge(
            "brownout_level",
            "current degradation-ladder level: 0 normal, 1 shed "
            "optional work, 2 clamp bronze, 3 gold-only admission"),
        "err": reg.histogram(
            "overload_estimate_error_ratio",
            "realized / predicted service time for admitted requests "
            "that carried a prediction (1.0 = perfect; the hopeless-"
            "shed estimator's own accuracy)"),
    }


class OverloadController:
    """The one object the router talks to: ties the estimator, the
    limiter, and the ladder behind an ``admit()`` /
    ``on_outcome()`` / ``tick()`` surface.

    ``protected_classes`` (default ``("gold",)``) are NEVER degraded:
    no ladder level sheds or clamps them and the hopeless-shed
    estimator does not apply (their failure mode is an honest
    deadline miss, never a shed the operator didn't choose).
    ``bronze_max_new_tokens`` / ``bronze_deadline_factor`` are the L2
    clamp knobs for everything else. Constructed standalone and
    passed to :class:`~paddle_tpu_torch.serving.Router` via ``overload=``;
    the router binds it, runs :meth:`tick` on the health-poll cadence
    and consults :meth:`admit` per submission. Disabled-path cost on
    a router WITHOUT a controller is one ``is None`` check."""

    def __init__(self, protected_classes=("gold",),
                 estimator: Optional[ServiceTimeEstimator] = None,
                 limiter: Optional[AIMDLimiter] = None,
                 ladder: Optional[BrownoutLadder] = None,
                 bronze_max_new_tokens: int = 16,
                 bronze_deadline_factor: float = 0.5,
                 max_queue_wait_s: float = 30.0,
                 retry_after_base_s: float = 0.1,
                 service_ewma_alpha: float = 0.2,
                 registry=None, clock=time.monotonic,
                 name: str = "overload"):
        self.protected = frozenset(protected_classes or ())
        self.estimator = estimator or ServiceTimeEstimator()
        self.limiter = limiter or AIMDLimiter()
        self.ladder = ladder or BrownoutLadder(clock=clock)
        self.bronze_max_new_tokens = int(bronze_max_new_tokens)
        self.bronze_deadline_factor = float(bronze_deadline_factor)
        self.max_queue_wait_s = float(max_queue_wait_s)
        self.retry_after_base_s = float(retry_after_base_s)
        self._alpha = float(service_ewma_alpha)
        self._clock = clock
        self.name = name
        self._mu = threading.Lock()
        self._router = None
        self._provider_name: Optional[str] = None
        self._m = _controller_metrics(
            registry if registry is not None
            else _obs.default_registry())
        self._ewma_service: Optional[float] = None
        self.n_shed: Dict[str, int] = {}
        self.n_ticks = 0

    # -- wiring --------------------------------------------------------------
    @property
    def level(self) -> int:
        return self.ladder.level

    def bind(self, router) -> None:
        """Attach to a router: /overloadz provider + the brownout
        gauge arm here (level 0 is a real, exported verdict from a
        BOUND controller — an unbound one exports nothing, the
        hole-not-zero discipline)."""
        self._router = router
        self._provider_name = f"{router.name}_{id(router):x}"
        _dbgsrv.register_overload_provider(self._provider_name,
                                           self._overloadz)
        self._m["level"].set(self.ladder.level)

    def unbind(self) -> None:
        if self._provider_name is not None:
            _dbgsrv.unregister_overload_provider(self._provider_name)
            self._provider_name = None
        self._router = None

    # -- the control loop (health-poll cadence) ------------------------------
    def tick(self) -> int:
        """One controller step: read the LIVE burn windows + fleet
        load, walk the ladder one level toward the signal, refresh
        gauges. Runs as a router poll hook; also callable directly
        (tests drive it with an injected clock)."""
        r = self._router
        if r is None:
            return self.ladder.level
        self.n_ticks += 1
        status = r.slo.window_status()
        load = r.fleet_load()
        tripped = sorted(c for c, s in status.items()
                         if s.get("tripped"))
        burns = {c: {w: v["burn_rate"]
                     for w, v in s["windows"].items()}
                 for c, s in status.items()}
        inputs = {"burn": burns, "tripped": tripped,
                  "warming": load.get("warming", 0),
                  "ready": load.get("ready", 0),
                  "inflight": load.get("inflight", 0),
                  "limiter": self.limiter.state()}
        if _faults.enabled():
            try:
                _faults.check("overload.step")
            except _faults.FaultInjected as e:
                # a spurious, seeded transition: one level up, logged
                # with the fault as its reason. Reversible by design —
                # the live windows disagree, so the normal hysteresis
                # walks it back down (chaos pins exactly that).
                self.ladder.force(self.ladder.level + 1,
                                  reason=f"fault_injected:{e}",
                                  inputs=inputs)
        level = self.ladder.step(bool(tripped), inputs=inputs)
        self._m["level"].set(level)
        for rname, lim in self.limiter.state().items():
            self._m["limit"].labels(rname).set(lim)
        return level

    # -- admission (router submit path) --------------------------------------
    def _count_shed(self, reason: str) -> None:
        with self._mu:
            self.n_shed[reason] = self.n_shed.get(reason, 0) + 1
        self._m["shed"].labels(reason).inc()

    def queue_estimate(self) -> float:
        """Expected queue residency: mean in-flight per ready replica
        × the EWMA of realized service time (0 before either signal
        exists — conservative, the estimator under-predicts)."""
        r = self._router
        with self._mu:
            svc = self._ewma_service
        if r is None or svc is None:
            return 0.0
        load = r.fleet_load()
        ready = load.get("ready") or 0
        if not ready:
            return 0.0
        return (load.get("inflight", 0) / ready) * svc

    def admit(self, slo: Optional[str], prompt_len: int,
              max_new_tokens: int,
              deadline_s: Optional[float]) -> dict:
        """The per-request verdict, pre-dispatch. Returns a dict:
        ``{"shed": OverloadShed}`` to refuse, else optionally
        ``max_new_tokens`` (L2 clamp), ``deadline_factor`` (L2
        tightening) and ``predicted_s`` (for the accuracy histogram).
        Protected classes pass through untouched at every level."""
        level = self.ladder.level
        out: dict = {}
        if slo in self.protected:
            return out
        if level >= 3:
            self._count_shed("brownout")
            out["shed"] = OverloadShed(
                f"brownout level {level} ({LEVELS[level]}): only "
                f"protected classes admitted "
                f"(request class {slo or 'unclassified'!r})",
                reason="brownout",
                retry_after_s=self.retry_after_s("brownout"))
            return out
        if level >= 2:
            if max_new_tokens > self.bronze_max_new_tokens:
                max_new_tokens = self.bronze_max_new_tokens
                out["max_new_tokens"] = max_new_tokens
            if deadline_s is not None:
                deadline_s = deadline_s * self.bronze_deadline_factor
                out["deadline_factor"] = self.bronze_deadline_factor
        predicted = self.estimator.predict(
            prompt_len, max_new_tokens, queue_s=self.queue_estimate())
        if predicted is not None:
            out["predicted_s"] = predicted
            if self.estimator.hopeless(predicted, deadline_s):
                self._count_shed("hopeless")
                out["shed"] = OverloadShed(
                    f"hopeless: predicted {predicted:.3f}s cannot "
                    f"meet the {deadline_s:.3f}s deadline "
                    f"(safety_factor "
                    f"{self.estimator.safety_factor:g})",
                    reason="hopeless", predicted_s=predicted,
                    deadline_s=deadline_s,
                    retry_after_s=self.retry_after_s("hopeless"))
        return out

    def allow_optional_work(self) -> bool:
        """L1 gate: audit shadows and migration detours run only at
        level 0 (cut optional work FIRST — before any client-visible
        degradation)."""
        return self.ladder.level < 1

    def retry_after_s(self, reason: str = "queue_full") -> float:
        """The Retry-After a shed response should carry: the base
        backoff doubled per ladder level — a fleet deep in brownout
        tells clients to stay away longer, which is the actual
        anti-thundering-herd mechanism (serve_llm forwards this as
        the HTTP header; HTTPReplica/router honor it)."""
        return round(self.retry_after_base_s
                     * (2.0 ** self.ladder.level), 3)

    # -- outcome feedback (router resolution path) ---------------------------
    def on_outcome(self, replica: Optional[str], outcome: str,
                   predicted_s: Optional[float],
                   latency_s: float) -> None:
        """Feedback from a resolved dispatch: AIMD raise/cut, the
        estimate-accuracy histogram, and the service-time EWMA the
        queue-residency estimate rides."""
        if replica is not None:
            if outcome == "ok":
                self.limiter.on_success(replica)
            elif outcome in ("deadline", "shed"):
                self.limiter.on_miss(replica)
        if outcome == "ok":
            with self._mu:
                if self._ewma_service is None:
                    self._ewma_service = float(latency_s)
                else:
                    self._ewma_service += self._alpha * (
                        float(latency_s) - self._ewma_service)
        if predicted_s and predicted_s > 0 \
                and outcome in ("ok", "deadline"):
            self._m["err"].observe(latency_s / predicted_s)

    def forget(self, replica: str) -> None:
        self.limiter.forget(replica)

    # -- observability -------------------------------------------------------
    def _overloadz(self) -> Optional[dict]:
        if self._router is None:
            return None
        with self._mu:
            shed = dict(self.n_shed)
            svc = self._ewma_service
        return {
            "level": self.ladder.level,
            "level_name": LEVELS[self.ladder.level],
            "levels": list(LEVELS),
            "protected_classes": sorted(self.protected),
            "ticks": self.n_ticks,
            "transitions": self.ladder.transitions(),
            "limiter": {
                "limits": self.limiter.state(),
                "floor": self.limiter.floor,
                "ceiling": self.limiter.ceiling,
                "cuts": self.limiter.n_cuts,
            },
            "estimator": {
                "safety_factor": self.estimator.safety_factor,
                "rates": (lambda r: None if r is None else
                          {"prefill_tokens_per_s": round(r[0], 2),
                           "decode_tokens_per_s": round(r[1], 2)})(
                    self._rates_safe()),
                "service_ewma_s": (round(svc, 4)
                                   if svc is not None else None),
            },
            "shed": shed,
            "retry_after_s": self.retry_after_s(),
        }

    def _rates_safe(self):
        try:
            return self.estimator.rates()
        except Exception:  # noqa: BLE001 — a status page never raises
            return None
