"""SLO-driven autoscaler: the closed loop from /sloz to the fleet.

Every sensor and actuator this loop needs already exists — per-class
burn-rate windows (:class:`~paddle_tpu_torch.observability.slo.SLOTracker`),
spawnable replicas (``spawn_replica``), draining-aware routing,
TCPStore membership, the elastic backoff curve — but without it a
human reads ``/sloz`` and acted. :class:`Autoscaler` closes the
loop, riding the router's existing health-poll cadence (one poll, one
health verdict, one scrape, one scaling decision):

SCALE OUT when a watched SLO class's short AND long burn windows both
trip (the same multi-window rule the breach latch fires on, read from
the LIVE windows via ``SLOTracker.window_status`` — an acknowledged
latch does not re-trigger anything; only windows that re-trip do), or
optionally when fleet occupancy crosses a high-water mark. A spawned
replica is attached WARMING — a capacity hole that absorbs no
dispatches and no occupancy weight — and is only counted (and routed
to) after the spawner's READY handshake plus the first successful
health probe. A failed or wedged spawn retries with backoff and never
double-counts capacity (``autoscale.spawn`` fault site).

SCALE IN when occupancy sags under the low-water mark, through a
strict drain → verify-empty → kill sequence: the victim is marked
admin-draining (the router admits nothing new from that instant — in
particular within one poll interval), the loop waits for the router's
in-flight count to that replica to reach ZERO under a bounded drain
deadline, then terminates gracefully (SIGTERM → the replica leaves
the TCPStore roster, closes its engine) and detaches. A scale-in
loses ZERO requests: the verified-empty path kills an idle process;
stragglers past the drain deadline (``autoscale.drain`` fault site
forces this) die mid-request and fail over through the router's nonce
pinning — the client sees latency, and a token-identical stream.

DAMPING is the ElasticManager backoff curve: consecutive actions in
the same direction wait ``backoff_base · 2^(n-1)`` (capped) between
actions; a direction FLIP must wait out a configurable healthy dwell,
and a dwell with no trigger active resets the curve. Replica counts
are clamped to [min_replicas, max_replicas]. A replica that DIES
under management is respawned as a REPLACEMENT — capacity-neutral,
damping-neutral, logged as ``replace`` not ``scale_out``.

Every decision is recorded in a bounded log (inputs: burn rates,
occupancy, replica counts; output: action + reason) surfaced on
``GET /scalez``, alongside ``autoscaler_replicas{state}``,
``autoscaler_actions_total{action,reason}``,
``autoscaler_drain_seconds`` and ``autoscale.*`` spans.

    router = Router(store_endpoint=endpoint, ...)
    scaler = Autoscaler(router,
                        make_subprocess_spawner(replica_spec),
                        min_replicas=1, max_replicas=8,
                        replica_slots=4)
    scaler.start()          # rides the router's health-poll cadence

The decision loop is held to the JAX package's, action for action,
under a fake clock (``tests/test_torch_fleet_control.py``); the JAX
package's storm gates are ``tools/chaos_soak.py --ci --autoscale`` and
``tools/llm_bench.py --storm``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ..observability import metrics as _obs
from ..observability import server as _dbgsrv
from ..observability import tracing as _trace
from ..reliability import faults as _faults
from ..reliability.retry import backoff_delay


def _autoscaler_metrics():
    reg = _obs.default_registry()
    return {
        "replicas": reg.gauge(
            "autoscaler_replicas",
            "fleet replicas by lifecycle state as the autoscaler "
            "sees them (ready serve; warming are uncounted holes; "
            "draining are being verified empty before the kill)",
            label_names=("state",)),
        "actions": reg.counter(
            "autoscaler_actions_total",
            "scaling decisions that produced an action (scale_out / "
            "scale_in / replace / scale_out_failed), by reason",
            label_names=("action", "reason")),
        "drain": reg.histogram(
            "autoscaler_drain_seconds",
            "scale-in drain wall time: mark-draining -> verified "
            "empty (or the bounded drain deadline when stragglers "
            "remained and failed over)"),
    }


class SubprocessReplica:
    """Lifecycle handle over a spawned replica subprocess: liveness,
    graceful terminate, and roster withdrawal as the backstop for a
    process that died without running its own ``leave()``."""

    def __init__(self, proc, info: dict,
                 store_endpoint: Optional[str] = None):
        self.proc = proc
        self.info = dict(info)
        self.store_endpoint = store_endpoint

    def alive(self) -> bool:
        return self.proc.poll() is None

    def terminate(self, grace_s: float = 15.0) -> None:
        from .replica import terminate_replica
        terminate_replica(self.proc, timeout=grace_s)
        self._withdraw()

    def kill(self) -> None:
        """Hard kill — the straggler path: a drain deadline that
        expired with requests still in flight must NOT grant a second
        grace period (a graceful SIGTERM would quietly finish the
        work the deadline said we stop waiting for). The reset
        connections turn the stragglers into nonce-pinned failovers
        on a sibling, deterministically."""
        if self.proc.poll() is None:
            self.proc.kill()
            try:
                self.proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 — unreaped zombie
                pass
        self._withdraw()

    def _withdraw(self) -> None:
        if not self.store_endpoint:
            return
        # the graceful SIGTERM path already left the roster; this is
        # the SIGKILL/crash backstop (deleting an absent key is a
        # no-op)
        try:
            from ..distributed.tcp_store import (TCPMembership,
                                                 TCPStoreClient)
            TCPMembership.withdraw(
                TCPStoreClient(self.store_endpoint),
                self.info.get("name", ""))
        except Exception:  # noqa: BLE001 — roster cleanup is
            pass           # best-effort; stale_after still ages it


def make_subprocess_spawner(spec_template: dict,
                            timeout: float = 180.0
                            ) -> Callable[[str], tuple]:
    """The production spawner: ``spawn_replica`` a subprocess from
    ``spec_template`` (name overridden per spawn — each scale-out and
    each replacement gets a FRESH name, so breaker history and
    membership records never leak across incarnations) and return
    ``(HTTPReplica, SubprocessReplica)``."""
    def spawn(name: str):
        from .replica import HTTPReplica, spawn_replica
        spec = dict(spec_template, name=name)
        proc, info = spawn_replica(spec, timeout=timeout)
        client = HTTPReplica(info["generate"], info["healthz"],
                             metrics_url=info.get("metrics"))
        return client, SubprocessReplica(
            proc, info, store_endpoint=spec.get("store"))
    return spawn


class _Managed:
    __slots__ = ("name", "client", "handle", "state", "spawned_at")

    def __init__(self, name, client, handle, now):
        self.name = name
        self.client = client
        self.handle = handle
        self.state = "warming"   # warming → ready → draining → gone
        self.spawned_at = now


class Autoscaler:
    """The control loop. Call :meth:`tick` on a cadence (or
    :meth:`start` to ride ``router.add_poll_hook``); each tick reads
    the sensors, applies the damping gate, and runs at most one
    action (on a worker thread unless ``synchronous=True``).

    Sensors are injectable for tests: ``burn_fn`` defaults to
    ``router.slo.window_status`` and ``occupancy_fn`` to
    ``router.fleet_load(replica_slots)``; ``clock`` drives every
    damping/drain timing decision.

    The autoscaler can only scale IN replicas it spawned (it holds
    their lifecycle handles); externally attached replicas count
    toward the fleet size and bounds but are never chosen as scale-in
    victims.
    """

    def __init__(self, router, spawner: Callable[[str], tuple], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 replica_slots: int = 4,
                 watch_classes=None,
                 high_water: Optional[float] = None,
                 low_water: float = 0.2,
                 drain_deadline_s: float = 30.0,
                 drain_poll_s: float = 0.05,
                 terminate_grace_s: float = 15.0,
                 spawn_attempts: int = 3,
                 spawn_backoff_s: float = 0.5,
                 ready_timeout_s: float = 120.0,
                 backoff_base_s: float = 2.0,
                 backoff_cap_s: float = 60.0,
                 dwell_s: float = 10.0,
                 decision_log_cap: int = 256,
                 role: Optional[str] = None,
                 name_prefix: str = "auto",
                 name: str = "autoscaler",
                 synchronous: bool = False,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 burn_fn: Optional[Callable[[], dict]] = None,
                 occupancy_fn: Optional[Callable[[], dict]] = None):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        self.router = router
        self.spawner = spawner
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.replica_slots = int(replica_slots)
        self.watch_classes = (None if watch_classes is None
                              else frozenset(watch_classes))
        self.high_water = high_water
        self.low_water = float(low_water)
        self.drain_deadline_s = float(drain_deadline_s)
        self.drain_poll_s = float(drain_poll_s)
        self.terminate_grace_s = float(terminate_grace_s)
        self.spawn_attempts = int(spawn_attempts)
        self.spawn_backoff_s = float(spawn_backoff_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.dwell_s = float(dwell_s)
        # pool role in a disaggregated fleet: this controller sizes
        # ONLY its own pool (role-filtered fleet_load) and tags its
        # spawns/attaches with the role. One Autoscaler per pool,
        # each off its pool's own burn signal.
        self.role = role
        if role is not None:
            if name_prefix == "auto":
                name_prefix = f"auto-{role}"
            if name == "autoscaler":
                name = f"autoscaler-{role}"
        self.name_prefix = name_prefix
        self.name = name
        self.synchronous = bool(synchronous)
        self._clock = clock
        self._sleep = sleep
        self._burn_fn = burn_fn
        self._occupancy_fn = occupancy_fn
        self._mu = threading.Lock()
        # serializes whole ticks: the router poll hook and any direct
        # tick() caller (bench thread, tests) must never interleave —
        # two concurrent ticks could both pass the busy check and
        # double-launch the same decision. Non-blocking: a tick that
        # finds one in progress is simply skipped.
        self._tick_mu = threading.Lock()
        self._managed: Dict[str, _Managed] = {}
        self._seq = itertools.count()
        self._log: deque = deque(maxlen=int(decision_log_cap))
        self._m = _autoscaler_metrics()
        # damping state: consecutive same-direction action streak +
        # the curve bookkeeping (docs/RELIABILITY.md "Damping math")
        self._streak = 0
        self._last_dir: Optional[str] = None
        self._last_action_t: Optional[float] = None
        self._last_hold: Optional[str] = None
        # replica-seconds integral (the bench's cost axis) + counters
        self._replica_seconds = 0.0
        self._last_tick_t: Optional[float] = None
        self.n_scale_out = 0
        self.n_scale_in = 0
        self.n_replaced = 0
        self._action_thread: Optional[threading.Thread] = None
        self._started = False
        self._closed = False
        self._status_name = f"{name}_{id(self):x}"

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Autoscaler":
        """Ride the router's health-poll cadence and register the
        /scalez surface. Idempotent."""
        if self._started:
            return self
        self._started = True
        self.router.add_poll_hook(self.tick)
        _dbgsrv.register_scale_provider(self._status_name,
                                        self._scalez)
        _dbgsrv.register_status_provider(self._status_name,
                                         self._scalez)
        return self

    def close(self, terminate_managed: bool = False) -> None:
        """Stop deciding. ``terminate_managed=True`` also drains
        nothing — it terminates every managed replica outright (the
        bench/soak teardown path; production owners usually keep the
        fleet and just stop the controller)."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            self.router.remove_poll_hook(self.tick)
            _dbgsrv.unregister_scale_provider(self._status_name)
            _dbgsrv.unregister_status_provider(self._status_name)
        t = self._action_thread
        if t is not None and t.is_alive():
            # the longest legitimate action is a spawn waiting out
            # ready_timeout_s (or a drain waiting out its deadline
            # plus the terminate grace) — join past the worst case so
            # an in-flight spawn can observe _closed and tear itself
            # down instead of leaking a live replica subprocess
            t.join(timeout=max(self.drain_deadline_s
                               + self.terminate_grace_s,
                               self.ready_timeout_s, 1.0) + 30.0)
        if terminate_managed:
            with self._mu:
                managed = list(self._managed.values())
                self._managed.clear()
            for m in managed:
                try:
                    m.handle.terminate(self.terminate_grace_s)
                except Exception:  # noqa: BLE001 — teardown
                    pass
                self.router.detach(m.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- sensors ------------------------------------------------------------
    def _burn_status(self) -> dict:
        if self._burn_fn is not None:
            return self._burn_fn()
        return self.router.slo.window_status()

    def _load(self) -> dict:
        if self._occupancy_fn is not None:
            return self._occupancy_fn()
        if self.role is not None:
            return self.router.fleet_load(self.replica_slots,
                                          role=self.role)
        return self.router.fleet_load(self.replica_slots)

    # -- damping ------------------------------------------------------------
    def _may_act(self, direction: str, now: float) -> bool:
        """The flap gate: same-direction repeats wait out the
        exponential curve (backoff_base · 2^(streak-1), capped);
        direction flips wait out the LARGER of the healthy dwell and
        that same curve — the streak survives flips, so a strictly
        alternating signal cannot sidestep the climb by flipping at
        dwell cadence forever."""
        if self._last_action_t is None:
            return True
        since = now - self._last_action_t
        curve = backoff_delay(max(self._streak - 1, 0),
                              self.backoff_base_s,
                              cap=self.backoff_cap_s)
        if direction == self._last_dir:
            return since >= curve
        return since >= max(self.dwell_s, curve)

    def _note_action(self, direction: str, now: float) -> None:
        # the streak survives direction flips ON PURPOSE: a flapping
        # signal (out, in, out, in …) must climb the same curve as a
        # repeating one — only a healthy dwell (no trigger at all)
        # resets it, via _maybe_reset_curve
        self._streak += 1
        self._last_dir = direction
        self._last_action_t = now

    def _maybe_reset_curve(self, now: float) -> None:
        """A healthy dwell (no trigger wanting anything) resets the
        backoff curve, so the next real episode starts fresh."""
        if self._last_action_t is not None \
                and now - self._last_action_t >= self.dwell_s:
            self._streak = 0
            self._last_dir = None

    # -- the decision log ----------------------------------------------------
    def _decide(self, action: str, reason: str, inputs: dict,
                replica: Optional[str] = None, **extra) -> dict:
        rec = {"t": round(self._clock(), 3), "wall": time.time(),
               "action": action, "reason": reason, "inputs": inputs}
        if replica is not None:
            rec["replica"] = replica
        rec.update(extra)
        with self._mu:
            self._log.append(rec)
        if action in ("scale_out", "scale_in", "replace",
                      "scale_out_failed"):
            self._m["actions"].labels(action, reason.split(":")[0]).inc()
            self._last_hold = None
        return rec

    def _hold(self, why: str, inputs: dict) -> None:
        """A trigger fired but the gate (bounds/backoff) held it.
        Logged once per episode — a bounded log must not fill with
        one identical hold per tick."""
        if self._last_hold == why:
            return
        self._last_hold = why
        self._decide("hold", why, inputs)

    def decisions(self) -> list:
        with self._mu:
            return list(self._log)

    def replica_seconds(self) -> float:
        """∫ live replicas dt since the first tick (ready + warming +
        draining — a warming replica costs compute even before it
        serves). The storm bench's cost axis."""
        return self._replica_seconds

    # -- the tick -----------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One control cycle: integrate replica-seconds, publish
        gauges, then at most one decision. Returns the action started
        ("scale_out"/"scale_in"/"replace") or None. Concurrent calls
        serialize — a tick arriving while one runs is skipped."""
        if self._closed:
            return None
        if not self._tick_mu.acquire(blocking=False):
            return None
        try:
            return self._tick_locked()
        finally:
            self._tick_mu.release()

    def _tick_locked(self) -> Optional[str]:
        now = self._clock()
        load = self._load()
        if self._last_tick_t is not None and now > self._last_tick_t:
            self._replica_seconds += (now - self._last_tick_t) * (
                load.get("ready", 0) + load.get("warming", 0)
                + load.get("draining", 0))
        self._last_tick_t = now
        for state in ("ready", "warming", "draining"):
            self._m["replicas"].labels(state).set(load.get(state, 0))
        if self._busy():
            return None

        # 1. replacements: a managed replica that died (SIGKILL,
        # crash) is respawned capacity-neutral — elastic respawn, not
        # a scaling decision, so the damping curve is untouched
        dead = None
        with self._mu:
            for m in self._managed.values():
                if m.state in ("warming", "ready") \
                        and not m.handle.alive():
                    dead = m
                    break
            if dead is not None:
                self._managed.pop(dead.name, None)
        if dead is not None:
            # reap + withdraw the corpse BEFORE detach so the
            # membership sync cannot re-attach its stale record
            try:
                dead.handle.terminate(0.1)
            except Exception:  # noqa: BLE001 — corpse cleanup
                pass
            self.router.detach(dead.name)
            inputs = self._inputs(load, {})
            self._launch(self._do_spawn, "replace",
                         "replica_died", inputs)
            return "replace"

        # 2. triggers
        burn = self._burn_status()
        tripped = sorted(
            cls for cls, st in burn.items()
            if st.get("tripped") and (self.watch_classes is None
                                      or cls in self.watch_classes))
        occ = load.get("occupancy")
        inputs = self._inputs(load, burn, tripped)
        live = load.get("ready", 0) + load.get("warming", 0)

        # min-replicas floor (bootstrap / unmanaged attrition)
        if live < self.min_replicas:
            if self._may_act("out", now):
                self._note_action("out", now)
                self._launch(self._do_spawn, "scale_out",
                             "min_replicas", inputs)
                return "scale_out"
            self._hold("backoff", inputs)
            return None

        want_out = bool(tripped) or (
            self.high_water is not None and occ is not None
            and occ >= self.high_water)
        want_in = (not want_out) and occ is not None \
            and occ <= self.low_water \
            and load.get("ready", 0) > self.min_replicas
        if want_out:
            if live >= self.max_replicas:
                self._hold("at_max", inputs)
                return None
            if not self._may_act("out", now):
                self._hold("backoff", inputs)
                return None
            reason = ("slo_burn:" + ",".join(tripped)) if tripped \
                else "occupancy_high"
            self._note_action("out", now)
            self._launch(self._do_spawn, "scale_out", reason, inputs)
            return "scale_out"
        if want_in:
            victim = self._pick_victim()
            if victim is None:
                self._hold("no_managed_victim", inputs)
                return None
            if not self._may_act("in", now):
                self._hold("backoff", inputs)
                return None
            self._note_action("in", now)
            self._launch(self._do_scale_in, victim, "occupancy_low",
                         inputs)
            return "scale_in"
        self._maybe_reset_curve(now)
        return None

    def _inputs(self, load: dict, burn: dict, tripped=()) -> dict:
        ov = getattr(self.router, "overload", None)
        return {
            "burn": {cls: {w: st["windows"][w]["burn_rate"]
                           for w in st.get("windows", {})}
                     for cls, st in burn.items()},
            "tripped": list(tripped),
            "occupancy": load.get("occupancy"),
            "ready": load.get("ready", 0),
            "warming": load.get("warming", 0),
            "draining": load.get("draining", 0),
            # what the brownout controller was doing when this
            # decision fired — the /scalez ↔ /overloadz join column
            # (None: no controller bound; the ladder ENGAGES while
            # replicas warm, it does not wait for capacity)
            "brownout": None if ov is None else ov.level,
        }

    def _busy(self) -> bool:
        t = self._action_thread
        return t is not None and t.is_alive()

    def _launch(self, fn, *args) -> None:
        if self.synchronous:
            fn(*args)
            return
        t = threading.Thread(target=fn, args=args,
                             name=f"{self.name}-action", daemon=True)
        self._action_thread = t
        t.start()

    # -- scale out / replace -------------------------------------------------
    def _do_spawn(self, action: str, reason: str, inputs: dict) -> bool:
        span = _trace.start_span(
            f"autoscale.{action}",
            attrs={"reason": reason,
                   "occupancy": inputs.get("occupancy") or 0.0,
                   "ready": inputs.get("ready", 0)}) \
            if _trace.enabled() else None
        name = f"{self.name_prefix}-{next(self._seq)}"
        # warming is declared BEFORE the process exists: a membership
        # attach racing this spawn lands the replica in warming, not
        # rotation
        self.router.expect_warming(name)
        client = handle = None
        err: Optional[BaseException] = None
        attempts = 0
        while attempts < self.spawn_attempts:
            attempts += 1
            try:
                if _faults.enabled():
                    _faults.check("autoscale.spawn")
                client, handle = self.spawner(name)
                break
            except Exception as e:  # noqa: BLE001 — retried, typed
                err = e             # in the decision log
                client = handle = None
                if attempts < self.spawn_attempts:
                    self._sleep(backoff_delay(attempts - 1,
                                              self.spawn_backoff_s,
                                              cap=self.backoff_cap_s))
        if handle is None:
            # NEVER count a replica that never existed: clear the
            # warming expectation so the name cannot linger as a hole
            self.router.detach(name)
            self._decide("scale_out_failed", reason, inputs,
                         replica=name, attempts=attempts,
                         error=str(err))
            if span is not None:
                span.set_status("error").set_attr(
                    "error", str(err)).end()
            return False
        if self._closed:
            # the controller shut down while this spawn was in
            # flight: the new process belongs to nobody — end it now
            # rather than leak a live replica past close()
            try:
                handle.terminate(self.terminate_grace_s)
            except Exception:  # noqa: BLE001 — teardown
                pass
            self.router.detach(name)
            if span is not None:
                span.set_status("error").set_attr(
                    "error", "autoscaler closed mid-spawn").end()
            return False
        m = _Managed(name, client, handle, self._clock())
        with self._mu:
            self._managed[name] = m
        if self.role is not None:
            self.router.attach(name, client, warming=True,
                               role=self.role)
        else:
            self.router.attach(name, client, warming=True)
        if not self._wait_healthy(client, handle):
            # spawned but never became healthy: tear it down and keep
            # it uncounted — a half-up replica must not hold capacity
            with self._mu:
                self._managed.pop(name, None)
            try:
                handle.terminate(self.terminate_grace_s)
            except Exception:  # noqa: BLE001 — teardown of a wreck
                pass
            self.router.detach(name)
            self._decide("scale_out_failed", reason, inputs,
                         replica=name, attempts=attempts,
                         error="never became healthy")
            if span is not None:
                span.set_status("error").set_attr(
                    "error", "never became healthy").end()
            return False
        self.router.mark_ready(name)
        m.state = "ready"
        if action == "replace":
            self.n_replaced += 1
        else:
            self.n_scale_out += 1
        self._decide(action, reason, inputs, replica=name,
                     attempts=attempts)
        if span is not None:
            span.set_attr("replica", name).set_attr(
                "attempts", attempts).end()
        return True

    def _wait_healthy(self, client, handle) -> bool:
        """READY came from the spawner; capacity additionally waits
        for the FIRST successful health probe — the replica must
        answer for itself before it counts."""
        deadline = self._clock() + self.ready_timeout_s
        while self._clock() < deadline:
            if self._closed or not handle.alive():
                return False
            try:
                h = client.health()
            except Exception:  # noqa: BLE001 — booting
                h = None
            if h == "healthy":
                return True
            self._sleep(min(self.drain_poll_s * 2, 0.2))
        return False

    # -- scale in -----------------------------------------------------------
    def _pick_victim(self) -> Optional[_Managed]:
        """Least-loaded managed ready replica, newest first on ties
        (LIFO scale-in keeps the longest-lived — and warmest-cached —
        replicas serving)."""
        with self._mu:
            ready = [m for m in self._managed.values()
                     if m.state == "ready"]
        if not ready:
            return None
        return min(ready, key=lambda m: (
            self.router.inflight_of(m.name) or 0, -m.spawned_at))

    def _do_scale_in(self, m: _Managed, reason: str,
                     inputs: dict) -> bool:
        span = _trace.start_span(
            "autoscale.scale_in",
            attrs={"reason": reason, "replica": m.name,
                   "occupancy": inputs.get("occupancy") or 0.0}) \
            if _trace.enabled() else None
        m.state = "draining"
        self.router.drain(m.name)
        t0 = self._clock()
        # one poll interval of settle time: a dispatch that routed an
        # instant before drain() may not have incremented inflight
        # yet; after one interval every pre-drain dispatch is visible
        # (and anything later was never admitted)
        self._sleep(max(getattr(self.router, "health_poll_interval",
                                0.0), self.drain_poll_s))
        stragglers = 0
        deadline = t0 + self.drain_deadline_s
        while True:
            try:
                if _faults.enabled():
                    _faults.check("autoscale.drain")
            except _faults.FaultInjected:
                # the seeded drain wedge: the deadline expires NOW —
                # kill with stragglers, which MUST fail over
                # nonce-pinned (the chaos gate's token-identity check)
                stragglers = self.router.inflight_of(m.name) or 0
                break
            n = self.router.inflight_of(m.name)
            if not n:
                stragglers = 0
                break
            if self._clock() >= deadline:
                stragglers = n
                break
            self._sleep(self.drain_poll_s)
        drain_s = self._clock() - t0
        self._m["drain"].observe(max(drain_s, 0.0))
        try:
            if stragglers and hasattr(m.handle, "kill"):
                # the deadline already expired: a graceful terminate
                # would grant the stragglers a SECOND grace window.
                # Hard-kill instead — the broken connections fail the
                # stragglers over nonce-pinned (token-identical), the
                # contract the chaos gate pins end to end
                m.handle.kill()
            else:
                m.handle.terminate(self.terminate_grace_s)
        except Exception:  # noqa: BLE001 — the detach below still
            pass           # pulls it from rotation
        self.router.detach(m.name)
        with self._mu:
            self._managed.pop(m.name, None)
        m.state = "gone"
        self.n_scale_in += 1
        self._decide("scale_in", reason, inputs, replica=m.name,
                     drain_s=round(drain_s, 3), stragglers=stragglers)
        if span is not None:
            span.set_attr("drain_s", round(drain_s, 3))
            span.set_attr("stragglers", stragglers)
            span.end()
        return True

    # -- /scalez ------------------------------------------------------------
    def _scalez(self) -> Optional[dict]:
        if self._closed:
            return None
        now = self._clock()
        with self._mu:
            managed = {m.name: m.state
                       for m in self._managed.values()}
            log = list(self._log)
        return {
            "config": {
                "role": self.role,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "replica_slots": self.replica_slots,
                "watch_classes": (sorted(self.watch_classes)
                                  if self.watch_classes is not None
                                  else None),
                "high_water": self.high_water,
                "low_water": self.low_water,
                "drain_deadline_s": self.drain_deadline_s,
                "backoff_base_s": self.backoff_base_s,
                "backoff_cap_s": self.backoff_cap_s,
                "dwell_s": self.dwell_s,
            },
            "state": {
                "streak": self._streak,
                "last_direction": self._last_dir,
                "since_last_action_s": (
                    round(now - self._last_action_t, 3)
                    if self._last_action_t is not None else None),
                "busy": self._busy(),
                "managed": managed,
                "scale_out": self.n_scale_out,
                "scale_in": self.n_scale_in,
                "replaced": self.n_replaced,
                "replica_seconds": round(self._replica_seconds, 3),
            },
            "load": self._load(),
            "decisions": log,
        }
