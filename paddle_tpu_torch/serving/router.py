"""Fleet router: prefix-affinity load balancing over engine replicas
with per-replica circuit breakers and in-budget failover.

The horizontally-scaled serving tier: everything a
single :class:`LLMEngine` does — prefix caching,
deadlines, priorities, shed/cancel verdicts, the health state machine
— composed ACROSS processes. One router fronts K replicas (in-process
engines, spawned subprocesses, or attached multi-host endpoints;
membership via the rendezvous TCPStore) and gives clients the same
``submit(...) -> Future`` surface the engine has, with three fleet
properties layered on top:

PREFIX AFFINITY. Requests are routed by a rendezvous hash of the
prompt's first KV-page digests (the same rolling BLAKE2b chain
``prefix_cache.page_digests`` computes), so requests sharing a prefix
land on the replica most likely to already hold those pages — the
cache hit rate multiplies under scale-out instead of diluting by 1/K.
Rendezvous hashing keeps the mapping stable under membership churn: a
replica leaving only remaps ITS keys.

HEALTH AS ROUTING INPUT. A background poll of each replica's
``/healthz`` plus in-band error verdicts drive a per-replica
:class:`CircuitBreaker` (closed → open → half-open): connection
failures and crashes trip it OPEN (quiet time, no retry storm),
half-open probes re-close it when the replica returns. A replica
reporting DRAINING (its own sticky health latch, HTTP 503) receives no
new admissions within one poll interval; its requests rebalance to
siblings without consuming failover budget.

FAILOVER INSIDE THE RETRY BUDGET. The router pins each request's
sampling nonce at admission, so a request lost to a replica crash
mid-decode is re-submitted to a sibling and — all replicas being
identically seeded — regenerates the IDENTICAL token stream (the engine's
device-retry semantics, now across processes). The client sees
latency, never an error, while ``failover_budget`` lasts.

Per-tenant quotas and SLO classes map onto the engine's existing
priority/deadline machinery: an :class:`SLOClass` is a named
(deadline, priority) default, a :class:`TenantQuota` bounds a tenant's
in-flight requests (overflow sheds at the ROUTER — the byte-lean
control plane never even wakes a replica for it).
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

from ..inference.llm import (AdmissionShed, EngineClosed,
                             OverloadShed, RequestCancelled)
from ..inference.prefix_cache import page_digests
from ..observability import audit as _audit
from ..observability import goodput as _goodput
from ..observability import metrics as _obs
from ..observability import propagation as _propagation
from ..observability import server as _dbgsrv
from ..observability import tracing as _trace
from ..observability.slo import DEFAULT_WINDOWS, SLOTracker
from ..reliability import faults as _faults
from ..reliability.retry import DeadlineExceeded, as_deadline
from .breaker import STATE_CODE, CircuitBreaker
from .fleet import FleetScraper
from .replica import HTTPReplica, ReplicaUnavailable

_HEALTH_CODE = {"healthy": 0, "degraded": 1, "draining": 2,
                "unreachable": 3, "unknown": 3}


def affinity_key(prompt, page_size: int, affinity_pages: int) -> bytes:
    """The routing key: the rolling digest of the prompt's first
    ``min(affinity_pages, full pages)`` KV pages. Prompts sharing
    their first ``affinity_pages`` pages co-locate (their tails,
    wherever they diverge beyond that, don't matter); prompts shorter
    than one page hash their tokens, so identical short prompts still
    co-locate. Small ``affinity_pages`` = coarse families (better
    sharing), large = finer spread."""
    digs = page_digests(prompt, page_size)
    if digs:
        # digest i commits to the whole history through page i — one
        # key per prefix family
        return digs[:affinity_pages][-1]
    return hashlib.blake2b(
        ",".join(map(str, prompt)).encode(), digest_size=16).digest()


def rendezvous_pick(key: bytes, names) -> Optional[str]:
    """Highest-random-weight (rendezvous) hash: the max-scoring name
    for ``key``. Stable under membership churn — removing a name only
    remaps the keys that preferred it."""
    best, best_score = None, -1
    for n in names:
        h = hashlib.blake2b(key + n.encode(), digest_size=8)
        score = int.from_bytes(h.digest(), "big")
        if score > best_score:
            best, best_score = n, score
    return best


class SLOClass:
    """A named latency tier: requests submitted under it inherit its
    deadline/priority unless they bring their own. ``target`` is the
    class's SLO success objective (fed to the router's
    :class:`~paddle_tpu_torch.observability.slo.SLOTracker`; None uses the
    tracker's default)."""

    def __init__(self, name: str, deadline_s: Optional[float] = None,
                 priority: int = 0,
                 target: Optional[float] = None):
        self.name = name
        self.deadline_s = deadline_s
        self.priority = int(priority)
        self.target = target


class TenantQuota:
    """Per-tenant admission bound: at most ``max_inflight`` of the
    tenant's requests live in the fleet at once (None: unbounded);
    ``slo`` names the tenant's default SLO class."""

    def __init__(self, max_inflight: Optional[int] = None,
                 slo: Optional[str] = None):
        self.max_inflight = max_inflight
        self.slo = slo


def _router_metrics():
    reg = _obs.default_registry()
    return {
        "dispatches": reg.counter(
            "router_dispatches_total",
            "request dispatch attempts per replica",
            label_names=("replica",)),
        "failovers": reg.counter(
            "router_failover_total",
            "re-dispatches after a replica became unavailable "
            "mid-request (same nonce — token-identical resubmission)"),
        "rebalanced": reg.counter(
            "router_rebalanced_total",
            "dispatches rerouted off a shedding/draining replica "
            "(no failover budget consumed)"),
        "shed": reg.counter(
            "router_shed_total",
            "requests shed at the router (tenant quota, or no "
            "routable replica)"),
        "affinity_routed": reg.counter(
            "router_affinity_routed_total",
            "dispatches that landed on the prefix-affinity-preferred "
            "replica"),
        "affinity_total": reg.counter(
            "router_affinity_eligible_total",
            "dispatches that had an affinity preference (denominator "
            "of the hit rate)"),
        "affinity_rate": reg.gauge(
            "router_affinity_hit_rate",
            "cumulative affinity-preferred / eligible dispatches"),
        "breaker": reg.gauge(
            "router_breaker_state",
            "per-replica breaker: 0 closed, 1 half-open, 2 open",
            label_names=("replica",)),
        "inflight": reg.gauge(
            "router_replica_inflight",
            "requests currently dispatched to each replica (the "
            "router-side queue depth)",
            label_names=("replica",)),
        "rhealth": reg.gauge(
            "router_replica_health",
            "last polled replica health: 0 healthy, 1 degraded, "
            "2 draining, 3 unreachable",
            label_names=("replica",)),
        "latency": reg.histogram(
            "router_request_seconds",
            "router submit → resolution (failover latency included)"),
        "role_dispatches": reg.counter(
            "router_role_dispatches_total",
            "dispatch attempts by replica pool role (disaggregated "
            "fleets run 'prefill' and 'decode' pools; replicas with "
            "no declared role count as 'unified')",
            label_names=("role",)),
        "migrate_seconds": reg.histogram(
            "kv_migrate_seconds",
            "end-to-end KV-page migration wall time as the router "
            "sees it: prefill fill + page export + verified import"),
        "migrate_failed": reg.counter(
            "router_migrate_failed_total",
            "migrations abandoned mid-flight; the request fell back "
            "to nonce-pinned local recompute on its decode replica"),
    }


class _ReplicaState:
    __slots__ = ("name", "client", "breaker", "health", "inflight",
                 "dispatched", "from_membership", "info", "warming",
                 "admin_draining", "role")

    def __init__(self, name, client, breaker):
        self.name = name
        self.client = client
        self.breaker = breaker
        self.health = "unknown"   # last poll verdict (or in-band 503)
        self.inflight = 0
        self.dispatched = 0
        self.from_membership = False
        self.info: dict = {}
        # pool role in a disaggregated fleet: "prefill" replicas fill
        # KV pages and hand them off; "decode" (or None = unified)
        # replicas serve the requests themselves
        self.role = None
        # WARMING: spawned but not yet counted toward capacity (no
        # READY + healthy probe yet). A warming replica is a HOLE —
        # it absorbs no dispatches AND stays out of the occupancy
        # denominator, the same semantics fleet_mfu has (a
        # replica that isn't serving must neither take traffic nor
        # drag the fleet average toward a spurious scale-in).
        self.warming = False
        # ADMIN DRAINING: the autoscaler marked this replica for
        # scale-in. Routing excludes it immediately; the health poll
        # must NOT overwrite the verdict back to "healthy" while the
        # drain is in progress.
        self.admin_draining = False


class _FleetRequest:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "deadline",
                 "priority", "tenant", "nonce", "future", "cancelled",
                 "span", "excluded", "t_submit", "failovers",
                 "affinity_key", "quota_held", "rr_slot", "slo_name",
                 "had_deadline", "last_dispatch", "digests", "migrate",
                 "prior_knobs", "predicted_s")

    def __init__(self, prompt, max_new_tokens, temperature):
        self.prompt = list(map(int, prompt))
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.deadline = None
        self.priority = 0
        self.tenant = None
        self.nonce = 0
        self.future: Future = Future()
        self.cancelled = False
        self.span = None
        self.excluded = set()    # replicas that shed/died THIS request
        self.t_submit = time.monotonic()
        self.failovers = 0
        self.affinity_key = b""
        self.quota_held = False   # holds one tenant-inflight slot
        self.rr_slot = 0          # round-robin seat, fixed at submit
        self.slo_name = None      # SLO class for burn-rate accounting
        self.had_deadline = False
        # (SpanContext, replica) of the previous dispatch attempt —
        # the next attempt links back to it so a failover reads as
        # one story on the merged timeline
        self.last_dispatch = None
        # full-page digest chain of the prompt (computed once at
        # submit); drives both affinity and KV-page migration
        self.digests = []
        # result of a completed migration for this request, attached
        # to the final result dict ({"seconds", "pages", "prefill"},
        # plus the fill's token-0 witness for chain verification)
        self.migrate = None
        # knob fingerprint of the replica a failed attempt ran on
        # (last known) — a failover sibling serving under DIFFERENT
        # knobs is a detected drift, not a documented hazard
        self.prior_knobs = None
        # the overload controller's admission-time service estimate —
        # the resolution latency is judged against it (the
        # overload_estimate_error_ratio histogram)
        self.predicted_s = None


class Router:
    """Load-balancing front over K engine replicas.

    ``replicas``: mapping name → replica client (:class:`LocalReplica`
    / :class:`HTTPReplica` / any object with their surface); more join
    later via :meth:`attach` or TCPStore membership
    (``store_endpoint=``, records published by
    ``distributed.tcp_store.TCPMembership`` — replicas that re-register
    under the same name keep their breaker history, so a restarted
    replica must walk open → half-open → closed like any recovering
    one).

    ``policy``: ``"affinity"`` (prefix rendezvous, the default) or
    ``"round_robin"`` (the baseline ``llm_bench --fleet`` compares
    against). Both fall back to least-loaded when no preference
    applies.
    """

    def __init__(self, replicas: Optional[Dict[str, object]] = None, *,
                 page_size: int = 16, affinity_pages: int = 2,
                 failover_budget: int = 2,
                 health_poll_interval: float = 0.25,
                 breaker_fail_threshold: int = 3,
                 breaker_open_for: float = 1.0,
                 breaker_half_open_probes: int = 1,
                 slo_classes: Optional[Dict[str, SLOClass]] = None,
                 tenants: Optional[Dict[str, TenantQuota]] = None,
                 store_endpoint: Optional[str] = None,
                 membership_stale_after: float = 2.0,
                 policy: str = "affinity",
                 max_workers: int = 32,
                 scrape_metrics: bool = True,
                 federate_prefixes=("llm_", "perf_", "mem_",
                                    "badput_", "kv_migrate_", "drift_",
                                    "brownout_", "overload_"),
                 disagg_threshold_tokens: Optional[int] = None,
                 slo_windows=DEFAULT_WINDOWS,
                 slo_default_target: float = 0.99,
                 slo_breach_threshold: float = 10.0,
                 slo_min_samples: int = 10,
                 overload=None,
                 name: str = "router"):
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self.page_size = int(page_size)
        self.affinity_pages = int(affinity_pages)
        self.failover_budget = int(failover_budget)
        self.health_poll_interval = float(health_poll_interval)
        self.policy = policy
        self.name = name
        self._breaker_kw = dict(
            fail_threshold=breaker_fail_threshold,
            open_for=breaker_open_for,
            half_open_probes=breaker_half_open_probes)
        self.slo_classes = dict(slo_classes or {})
        self.tenants = dict(tenants or {})
        self._mu = threading.Lock()
        self._replicas: Dict[str, _ReplicaState] = {}
        # names pre-declared warming (Autoscaler.expect_warming): a
        # membership attach racing the spawner's explicit attach must
        # not slip a half-booted replica into rotation
        self._expect_warm: set = set()
        # detach tombstones: name -> detach time. A membership sync
        # whose roster SNAPSHOT predates a scale-in's withdraw+detach
        # must not resurrect the killed replica from the stale
        # snapshot (a ghost that would sit breaker-open forever —
        # roster records going stale never detaches). Entries expire
        # after membership_stale_after: by then any lingering record
        # has aged out, and a legitimately re-registered same name
        # (fresh heartbeats) attaches normally.
        self._detached_at: Dict[str, float] = {}
        # zero-arg callables run at the tail of every health-poll
        # cycle (the Autoscaler's tick rides this cadence)
        self._poll_hooks: list = []
        self._tenant_inflight: Dict[str, int] = {}
        self._by_id: Dict[int, _FleetRequest] = {}
        self._nonce_seq = itertools.count()
        self._rr_seq = itertools.count()
        self._closed = False
        self._m = _router_metrics()
        self.n_submitted = 0
        self.n_failovers = 0
        self.n_rebalanced = 0
        self.n_shed = 0
        # -- disaggregated prefill/decode fleet state --
        # migrate when the decode target would have to prefill more
        # than this many uncached tokens locally (None: 2 pages — one
        # page of savings is not worth a network round trip)
        self.disagg_threshold_tokens = disagg_threshold_tokens
        self.n_migrations = 0
        self.n_migrate_failed = 0
        self.n_pages_migrated = 0
        self.n_pages_rejected = 0
        # -- stream-integrity auditor state --
        # last-known engine knob fingerprint per replica (updated on
        # every verified completion): failover verification compares
        # the recovering sibling's knobs against the failed one's
        self._knobs: Dict[str, dict] = {}
        self.n_shadows = 0
        # optimistic per-replica digest residency: updated on every
        # completion/migration, dropped when the replica goes
        # unreachable (it may restart blank). Wrong-in-either-
        # direction is safe — a stale "resident" only re-migrates or
        # recomputes; verification on import keeps it exact.
        self._resident: Dict[str, set] = {}
        # per-replica Retry-After cooldowns: a shed response carrying
        # the header moves that replica to the back of the line until
        # the cooldown lapses (only skipped while OTHER candidates
        # exist — a cooldown must never make a fleet unroutable)
        self._retry_until: Dict[str, float] = {}
        # overload brownout controller (serving/overload.py): admission
        # verdicts pre-dispatch, AIMD concurrency bounds in _route, the
        # degradation ladder ticking on the health-poll cadence (bound
        # below, after the debug surface exists)
        self.overload = overload
        for rname, client in (replicas or {}).items():
            self.attach(rname, client)
        # TCPStore membership: poll the roster alongside health
        self._store_client = None
        self._membership_stale_after = float(membership_stale_after)
        if store_endpoint is not None:
            from ..distributed.tcp_store import TCPStoreClient
            self._store_client = TCPStoreClient(store_endpoint)
        # fleet observability: the FleetScraper federates replica
        # /metrics on the health-poll cadence; the SLOTracker turns
        # request outcomes into burn-rate gauges. Both are wired into
        # the debug surface below.
        self.scraper = FleetScraper(
            federate_prefixes=tuple(federate_prefixes)) \
            if scrape_metrics else None
        self.slo = SLOTracker(
            targets={n: c.target for n, c in self.slo_classes.items()
                     if c.target is not None},
            default_target=slo_default_target,
            windows=tuple(slo_windows),
            breach_threshold=slo_breach_threshold,
            min_samples=slo_min_samples)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix=f"{name}-dispatch")
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name=f"{name}-health", daemon=True)
        self._poller.start()
        # live-debug surface: /statusz fleet view, /fleetz federation,
        # /sloz burn rates, /healthz aggregate (+ SLO breach latch),
        # POST /reset_health → breaker + breach-latch reset (the
        # router-side half of the operator escape hatch)
        self._status_name = f"{name}_{id(self):x}"
        _dbgsrv.register_status_provider(self._status_name,
                                         self._status)
        _dbgsrv.register_health_provider(self._status_name,
                                         self._aggregate_health)
        _dbgsrv.register_reset_handler(self._status_name,
                                       self._reset_all)
        _dbgsrv.register_fleet_provider(self._status_name,
                                        self._fleetz)
        _dbgsrv.register_slo_provider(self._status_name,
                                      self._sloz)
        _dbgsrv.register_health_provider(self._status_name + "_slo",
                                         self._slo_health)
        if self.scraper is not None:
            _dbgsrv.register_scrape_provider(
                self._status_name, self._render_federated)
        if overload is not None:
            overload.bind(self)
            self.add_poll_hook(overload.tick)

    # -- membership ---------------------------------------------------------
    def attach(self, name: str, client, warming: bool = False,
               role: Optional[str] = None) -> None:
        """Add (or re-point) a replica. Re-attaching an existing name
        keeps its breaker — a restarted replica re-earns trust through
        half-open probes instead of resetting its history.
        ``warming=True`` (or a prior :meth:`expect_warming`) attaches
        it as a capacity HOLE: no dispatches, no occupancy weight,
        until :meth:`mark_ready`. ``role`` declares the replica's pool
        in a disaggregated fleet ("prefill" / "decode"; None on
        re-attach preserves the existing role)."""
        with self._mu:
            # an explicit attach overrides a detach tombstone — the
            # caller knows the replica exists
            self._detached_at.pop(name, None)
            st = self._replicas.get(name)
            if st is None:
                st = _ReplicaState(name, client,
                                   CircuitBreaker(**self._breaker_kw))
                st.warming = warming or name in self._expect_warm
                st.role = role
                self._replicas[name] = st
            else:
                st.client = client
                if warming:
                    st.warming = True
                if role is not None:
                    st.role = role

    def expect_warming(self, name: str) -> None:
        """Pre-declare ``name`` as warming BEFORE its process exists:
        whichever attach path lands first (the spawner's explicit
        :meth:`attach` or the TCPStore membership sync — a booting
        replica announces membership before it prints READY) the
        replica enters warming, never rotation. Cleared by
        :meth:`mark_ready` or :meth:`detach`."""
        with self._mu:
            self._expect_warm.add(name)
            st = self._replicas.get(name)
            if st is not None:
                st.warming = True

    def mark_ready(self, name: str) -> bool:
        """Promote a warming replica into rotation (the autoscaler
        calls this after READY + the first successful health probe).
        Returns False when the name is unknown."""
        with self._mu:
            self._expect_warm.discard(name)
            st = self._replicas.get(name)
            if st is None:
                return False
            st.warming = False
            return True

    def drain(self, name: str) -> bool:
        """Mark a replica ADMIN-DRAINING for scale-in: routing
        excludes it from the next :meth:`submit` on (nothing new is
        admitted within one poll interval — in fact immediately), and
        the health poll stops overwriting the verdict. The caller
        then waits for :meth:`inflight_of` to reach zero before
        terminating (docs/RELIABILITY.md "Autoscaling failure
        model")."""
        with self._mu:
            st = self._replicas.get(name)
            if st is None:
                return False
            st.admin_draining = True
            st.health = "draining"
            return True

    def inflight_of(self, name: str) -> Optional[int]:
        """Router-side in-flight dispatches to ``name`` (None when
        unknown) — the scale-in verify-empty check. The router is the
        replica's only admission path, so zero here means the replica
        holds no request this fleet could lose."""
        with self._mu:
            st = self._replicas.get(name)
            return None if st is None else st.inflight

    def fleet_load(self, slots_per_replica: Optional[int] = None,
                   role: Optional[str] = None) -> dict:
        """Capacity/occupancy accounting over the attached fleet.
        READY replicas (not warming, not draining, breaker not open,
        reachable) define the capacity; warming and draining replicas
        are counted but are HOLES in the occupancy denominator.
        ``occupancy`` is total ready in-flight / (slots × ready), or
        None when no ready capacity exists (a hole, not a zero — the
        autoscaler must not read an all-warming fleet as idle).
        ``role`` restricts the accounting to one pool of a
        disaggregated fleet ("unified" matches undeclared roles) —
        each pool's autoscaler sizes off its OWN burn signal."""
        with self._mu:
            states = list(self._replicas.values())
        if role is not None:
            states = [st for st in states
                      if (st.role or "unified") == role]
        ready = [st for st in states
                 if not st.warming and not st.admin_draining
                 and st.breaker.state != "open"
                 and st.health not in ("draining", "unreachable")]
        warming = sum(1 for st in states if st.warming)
        draining = sum(1 for st in states if not st.warming
                       and (st.admin_draining
                            or st.health == "draining"))
        inflight = sum(st.inflight for st in ready)
        out = {"attached": len(states), "ready": len(ready),
               "warming": warming, "draining": draining,
               "inflight": inflight,
               "ready_names": sorted(st.name for st in ready)}
        if slots_per_replica:
            cap = int(slots_per_replica) * len(ready)
            out["capacity"] = cap
            out["occupancy"] = (inflight / cap) if cap else None
        return out

    def detach(self, name: str) -> None:
        with self._mu:
            self._replicas.pop(name, None)
            self._expect_warm.discard(name)
            self._resident.pop(name, None)
            self._retry_until.pop(name, None)
            self._detached_at[name] = time.monotonic()
        if self.scraper is not None:
            self.scraper.forget(name)
        if self.overload is not None:
            self.overload.forget(name)

    # -- poll hooks ---------------------------------------------------------
    def add_poll_hook(self, fn) -> None:
        """Run ``fn()`` at the tail of every health-poll cycle — the
        cadence the Autoscaler's control loop rides (one poll, one
        health verdict, one scrape, one scaling decision)."""
        with self._mu:
            self._poll_hooks.append(fn)

    def remove_poll_hook(self, fn) -> None:
        with self._mu:
            if fn in self._poll_hooks:
                self._poll_hooks.remove(fn)

    def replica_names(self):
        with self._mu:
            return sorted(self._replicas)

    def _sync_membership(self) -> None:
        from ..distributed.tcp_store import (StoreUnavailable,
                                             TCPMembership)
        try:
            members = TCPMembership.list_members(
                self._store_client,
                stale_after=self._membership_stale_after)
        except StoreUnavailable:
            return
        now = time.monotonic()
        with self._mu:
            # tombstones expire unconditionally — most detached names
            # (fresh auto-N incarnations) never reappear in a roster,
            # so sweeping only on reappearance would grow the dict by
            # one entry per scale-in forever
            for n in [n for n, ts in self._detached_at.items()
                      if now - ts >= self._membership_stale_after]:
                del self._detached_at[n]
        for mname, info in members.items():
            with self._mu:
                if mname in self._detached_at:
                    # this roster snapshot may predate the detach
                    # (scale-in withdraw): do not resurrect a replica
                    # that was just removed
                    continue
                st = self._replicas.get(mname)
                same = st is not None and st.info == info
            if same:
                continue
            client = HTTPReplica(info["generate"], info["healthz"],
                                 metrics_url=info.get("metrics"))
            self.attach(mname, client, role=info.get("role"))
            with self._mu:
                st = self._replicas[mname]
                st.from_membership = True
                st.info = dict(info)

    # -- health / breaker maintenance ---------------------------------------
    def _poll_once(self) -> None:
        if self._store_client is not None:
            self._sync_membership()
        with self._mu:
            states = list(self._replicas.values())
        for st in states:
            if st.breaker.state != "closed":
                # open: skip (quiet time). half-open: a poll IS the
                # probe — consume a probe slot so traffic and polls
                # share one budget
                if not st.breaker.allow():
                    self._m["breaker"].labels(st.name).set(
                        STATE_CODE[st.breaker.state])
                    if self.scraper is not None:   # open = down
                        self.scraper.mark_unreachable(st.name,
                                                      st.client)
                    continue
            h = None
            try:
                if _faults.enabled():
                    _faults.check("router.healthz")
                h = st.client.health()
            except Exception:  # noqa: BLE001 — a poll failure is data
                h = None
            if not st.admin_draining:
                # an admin drain (scale-in in progress) pins the
                # verdict: the replica itself still answers "healthy"
                # right up to the kill, and one optimistic poll
                # re-admitting traffic mid-drain would break the
                # verify-empty contract
                st.health = h if h is not None else "unreachable"
            if h is None:
                st.breaker.record_failure()
                with self._mu:
                    # an unreachable replica may come back blank —
                    # drop the optimistic digest-residency view
                    self._resident.pop(st.name, None)
            else:
                # ANY answer settles as success — the breaker judges
                # reachability only; a draining verdict keeps the
                # replica out of rotation through the HEALTH filter,
                # not by re-tripping the breaker every probe cycle
                st.breaker.record_success()
            self._m["breaker"].labels(st.name).set(
                STATE_CODE[st.breaker.state])
            self._m["rhealth"].labels(st.name).set(
                _HEALTH_CODE.get(st.health, 3))
            # metrics federation rides the SAME cycle: one poll, one
            # health verdict, one scrape — an unreachable replica is
            # recorded down without a second timeout
            if self.scraper is not None:
                if h is None:
                    self.scraper.mark_unreachable(st.name, st.client)
                else:
                    self.scraper.scrape(st.name, st.client)

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.health_poll_interval):
            try:
                self._poll_once()
                # windowed SLO gauges decay on the same cadence —
                # burn rates on /metrics must fall back to 0 when a
                # storm ends, not freeze at their last recorded value
                self.slo.refresh()
            except Exception:  # noqa: BLE001 — the poller must survive
                pass
            with self._mu:
                hooks = list(self._poll_hooks)
            for fn in hooks:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — a broken hook must
                    pass           # not stop health polling

    def reset_breakers(self) -> None:
        """Operator escape hatch: force every breaker closed (e.g.
        after a known-good fleet restart). Reachable over HTTP via
        POST /reset_health."""
        with self._mu:
            states = list(self._replicas.values())
        for st in states:
            st.breaker.reset()
            if st.health == "draining" and not st.admin_draining:
                # an ADMIN drain is the autoscaler's scale-in in
                # progress, not sticky failure state — the operator
                # reset must not re-admit a replica mid-drain
                st.health = "unknown"   # re-polled next interval
            self._m["breaker"].labels(st.name).set(0)

    def _reset_all(self) -> None:
        """POST /reset_health verb for the router: breakers closed AND
        SLO breach latches acknowledged — one curl recovers the whole
        router-side sticky state."""
        self.reset_breakers()
        self.slo.reset_breach()

    # -- routing ------------------------------------------------------------
    _rendezvous = staticmethod(rendezvous_pick)

    def _affinity_key(self, prompt) -> bytes:
        return affinity_key(prompt, self.page_size,
                            self.affinity_pages)

    def _route(self, req: _FleetRequest):
        """(state, affinity_hit) — or (None, verdict) where verdict is
        True (every replica draining), False (none routable), or
        ``"limited"`` (routable replicas exist but all sit at their
        AIMD concurrency limit: wait, don't shed)."""
        with self._mu:
            states = dict(self._replicas)
            retry_until = dict(self._retry_until)
        # role awareness: requests DECODE on non-prefill replicas.
        # Prefill-pool replicas only enter the candidate set when no
        # non-prefill replica could possibly serve (a degraded fleet
        # must never lose a request to pool purity — the prefill
        # replica is a full engine and can decode, just wastefully).
        serving = {n: st for n, st in states.items()
                   if st.role != "prefill"}
        if any(n not in req.excluded
               and st.health != "draining"
               and not st.warming and not st.admin_draining
               and st.breaker.state != "open"
               for n, st in serving.items()):
            states = serving
        eligible = {n: st for n, st in states.items()
                    if n not in req.excluded
                    and st.health != "draining"
                    and not st.warming and not st.admin_draining}
        # Retry-After cooldowns: a replica that shed with the header
        # goes to the back of the line — but only while OTHER
        # candidates exist (a cooldown never makes a fleet unroutable)
        if retry_until:
            now = time.monotonic()
            cooling = {n for n in eligible
                       if retry_until.get(n, 0.0) > now}
            if cooling and len(cooling) < len(eligible):
                for n in cooling:
                    eligible.pop(n)
        # AIMD concurrency bound: replicas at their learned in-flight
        # limit drop out; when that empties the candidate set the
        # caller WAITS for a slot instead of shedding (the limiter
        # bounds concurrency, not admission)
        limited = False
        if self.overload is not None and eligible:
            lim = self.overload.limiter
            with_room = {n: st for n, st in eligible.items()
                         if lim.has_room(n, st.inflight)}
            if with_room:
                eligible = with_room
            else:
                limited = True
                eligible = {}
        preferred_all = self._rendezvous(req.affinity_key, states) \
            if self.policy == "affinity" else None
        while eligible:
            names = {n for n, st in eligible.items()
                     if st.breaker.state != "open"}
            if not names:
                break
            if self.policy == "affinity":
                pick = self._rendezvous(req.affinity_key, names)
            else:
                # the seat was assigned at submit time, so placement
                # is a function of ARRIVAL order, not of which pool
                # thread won the race to dispatch
                order = sorted(names)
                pick = order[req.rr_slot % len(order)]
            st = eligible[pick]
            if st.breaker.allow():
                return st, pick == preferred_all
            eligible.pop(pick)   # half-open probe budget spent
        if limited:
            return None, "limited"
        all_draining = bool(states) and all(
            st.health == "draining" for st in states.values())
        return None, all_draining

    # -- disaggregated prefill/decode migration -----------------------------
    def _migrate_threshold(self) -> int:
        if self.disagg_threshold_tokens is not None:
            return int(self.disagg_threshold_tokens)
        return 2 * self.page_size

    def _uncached_estimate(self, req: _FleetRequest, name: str) -> int:
        """Tokens ``name`` would have to prefill locally, per the
        router's optimistic residency view (the true answer lives on
        the replica; over-estimating only migrates pages that turn
        out to be duplicates, which import_pages dedups)."""
        cap = (len(req.prompt) - 1) // self.page_size
        seen = self._resident.get(name)
        n = 0
        if seen:
            for d in req.digests[:cap]:
                if d not in seen:
                    break
                n += 1
        return len(req.prompt) - n * self.page_size

    def _pick_prefill(self, req: _FleetRequest):
        """Rendezvous-choose a ready prefill-pool replica for this
        request's prefix family (same key as decode affinity: one
        family keeps hitting one prefill replica's cache). None when
        the fleet has no usable prefill pool."""
        with self._mu:
            pool = {n: st for n, st in self._replicas.items()
                    if st.role == "prefill"
                    and n not in req.excluded
                    and st.health not in ("draining", "unreachable")
                    and not st.warming and not st.admin_draining
                    and st.breaker.state != "open"}
        if not pool:
            return None
        pick = self._rendezvous(req.affinity_key, pool)
        st = pool[pick]
        return st if st.breaker.allow() else None

    def _maybe_migrate(self, req: _FleetRequest, dst: _ReplicaState,
                       dspan) -> None:
        """The disaggregation hot path: when the decode target would
        have to prefill a long uncached prompt locally, have a
        prefill-pool replica fill the pages instead (one-token
        generate, SAME nonce), pull the page run by digest, and
        install it on the decode replica via the digest-verified
        import. Every failure mode — prefill shed, replica lost
        mid-transfer, pages rejected on verify — degrades to the
        decode replica recomputing locally under the same pinned
        nonce: slower, never wrong, never a lost request."""
        if dst.role == "prefill":
            return                     # already landing on a prefill
        cap = (len(req.prompt) - 1) // self.page_size
        if cap <= 0:
            return
        if self._uncached_estimate(req, dst.name) \
                <= self._migrate_threshold():
            return
        pst = self._pick_prefill(req)
        if pst is None:
            return
        t0 = time.monotonic()
        mspan = None
        if dspan is not None:
            mspan = _trace.start_span(
                "llm.migrate", parent=dspan,
                attrs={"prefill_replica": pst.name,
                       "decode_replica": dst.name,
                       "pages_wanted": cap})
        mctx = mspan.context if mspan is not None else None
        self._m["dispatches"].labels(pst.name).inc()
        self._m["role_dispatches"].labels("prefill").inc()
        with self._mu:
            pst.dispatched += 1
            pst.inflight += 1
        self._m["inflight"].labels(pst.name).set(pst.inflight)
        try:
            if _faults.enabled():
                _faults.check("router.migrate")
            # 1. fill: one-token generate on the prefill replica
            # under the request's own nonce — its pages are the exact
            # pages the decode replica would have computed
            fill = pst.client.submit(
                req.prompt, max_new_tokens=1,
                temperature=req.temperature,
                deadline_s=(req.deadline.remaining()
                            if req.deadline is not None else None),
                nonce=req.nonce, trace_context=mctx)
            digs = req.digests[:cap]
            # 2. pull the page run from the source by digest list
            payload = pst.client.export_pages(
                [d.hex() for d in digs], trace_context=mctx)
            # 3. verified install on the decode target
            res = dst.client.import_pages(payload, trace_context=mctx)
            pst.breaker.record_success()
            dt = time.monotonic() - t0
            imported = int(res.get("imported", 0))
            dups = int(res.get("duplicates", 0))
            rejected = res.get("rejected") or []
            self._m["migrate_seconds"].observe(dt)
            with self._mu:
                self.n_migrations += 1
                self.n_pages_migrated += imported
                self.n_pages_rejected += len(rejected)
                self._resident.setdefault(pst.name, set()).update(digs)
                # the accepted run is a chain prefix; dups were
                # already resident
                self._resident.setdefault(dst.name, set()).update(
                    digs[:imported + dups])
            if _goodput.enabled():
                # migration wall time is time this request spent
                # waiting to start decoding — its own badput bucket
                # (not folded into queue_wait: a fleet drowning in
                # page transfers must not masquerade as queueing)
                _goodput.note("migration", dt)
            req.migrate = {"seconds": dt, "pages": imported,
                           "duplicates": dups,
                           "rejected": len(rejected),
                           "prefill": pst.name}
            # the fill's token-0 witness: the prefill replica decoded
            # one token under the request's own nonce, so its digest
            # must be the exact chain the decode replica's stream
            # starts with — checked in _verify_stream at resolution
            if isinstance(fill, dict) and fill.get("output_ids"):
                req.migrate["fill_token"] = int(fill["output_ids"][0])
                req.migrate["fill_digest"] = fill.get("stream_digest")
                req.migrate["fill_knobs"] = fill.get("knobs")
            if mspan is not None:
                mspan.set_attr("pages", imported)
                mspan.set_attr("duplicates", dups)
                mspan.set_attr("rejected", len(rejected))
                mspan.set_attr("seconds", round(dt, 6))
                mspan.end()
        except Exception as e:  # noqa: BLE001 — fallback, never fatal
            if isinstance(e, ReplicaUnavailable):
                # transport-level loss: charge the breaker and drop
                # the residency view (the replica may restart blank)
                pst.breaker.record_failure()
                pst.health = "unreachable"
                with self._mu:
                    self._resident.pop(pst.name, None)
            with self._mu:
                self.n_migrate_failed += 1
            self._m["migrate_failed"].inc()
            if _goodput.enabled():
                _goodput.note("migration", time.monotonic() - t0)
            if mspan is not None:
                mspan.set_attr("fallback", "local_recompute")
                mspan.set_status("error") \
                     .set_attr("error", str(e)).end()
        finally:
            with self._mu:
                pst.inflight -= 1
            self._m["inflight"].labels(pst.name).set(pst.inflight)

    # -- submission ---------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, deadline=None,
               priority: int = 0, tenant: Optional[str] = None,
               slo: Optional[str] = None,
               trace_context=None) -> Future:
        if self._closed:
            # typed like the engine's verdict: through serve_llm this
            # is a 503 (out of rotation), never a client-error 400
            raise EngineClosed("router closed")
        if not prompt_ids:
            raise ValueError("empty prompt")
        req = _FleetRequest(prompt_ids, max_new_tokens, temperature)
        req.tenant = tenant
        quota = self.tenants.get(tenant) if tenant else None
        if slo is None and quota is not None:
            slo = quota.slo
        cls = self.slo_classes.get(slo) if slo else None
        if cls is not None:
            if deadline is None:
                deadline = cls.deadline_s
            if priority == 0:
                priority = cls.priority
        req.deadline = as_deadline(deadline)
        req.priority = int(priority)
        req.had_deadline = req.deadline is not None
        req.slo_name = slo
        req.nonce = next(self._nonce_seq) & 0x7FFFFFFF
        req.future.request_id = req.nonce
        # one digest-chain walk serves both the affinity key and the
        # migration page list
        req.digests = page_digests(req.prompt, self.page_size)
        if req.digests:
            req.affinity_key = req.digests[:self.affinity_pages][-1]
        else:
            req.affinity_key = hashlib.blake2b(
                ",".join(map(str, req.prompt)).encode(),
                digest_size=16).digest()
        req.rr_slot = next(self._rr_seq)
        self.n_submitted += 1
        if _trace.enabled():
            # router.request roots here — or under a REMOTE parent
            # when the client itself propagated a traceparent (a
            # router fronted by serve_llm extends the caller's trace)
            req.span = _trace.start_span(
                "router.request",
                parent=_propagation.context_from(trace_context),
                attrs={
                    "prompt_tokens": len(req.prompt),
                    "nonce": req.nonce, "tenant": tenant or "",
                    "slo": slo or ""})
        # tenant quota: shed at the router — terminal, byte-lean (no
        # replica is woken for a request its tenant can't run)
        if quota is not None and quota.max_inflight is not None:
            with self._mu:
                cur = self._tenant_inflight.get(tenant, 0)
                over = cur >= quota.max_inflight
                if not over:
                    self._tenant_inflight[tenant] = cur + 1
                    req.quota_held = True
            if over:
                self._resolve_shed(
                    req, f"tenant {tenant!r} quota exhausted "
                    f"({cur}/{quota.max_inflight} in flight)",
                    reason="queue_full")
                return req.future
        # overload admission: the brownout controller may shed outright
        # (hopeless prediction, gold-only floor) or clamp the request
        # (bronze under L2) before any replica is woken. Gold never
        # reaches either branch — admit() passes protected classes
        # through untouched.
        if self.overload is not None:
            verdict = self.overload.admit(
                slo, len(req.prompt), req.max_new_tokens,
                req.deadline.remaining()
                if req.deadline is not None else None)
            shed = verdict.get("shed")
            if shed is not None:
                self._resolve_shed(req, str(shed), shed.reason,
                                   exc=shed)
                return req.future
            req.predicted_s = verdict.get("predicted_s")
            if "max_new_tokens" in verdict:
                req.max_new_tokens = int(verdict["max_new_tokens"])
            if req.deadline is not None \
                    and "deadline_factor" in verdict:
                req.deadline = as_deadline(
                    req.deadline.remaining()
                    * float(verdict["deadline_factor"]))
        with self._mu:
            self._by_id[req.nonce] = req
        self._pool.submit(self._run, req)
        return req.future

    def generate(self, prompts, max_new_tokens: int = 32,
                 temperature: float = 0.0, **kw):
        """Blocking batch convenience (mirrors ``LLMEngine.generate``)."""
        futs = [self.submit(p, max_new_tokens, temperature, **kw)
                for p in prompts]
        return [f.result() for f in futs]

    def cancel(self, request_id: int) -> bool:
        """Best-effort cancel: takes effect at the next routing
        boundary (pre-dispatch, or between failover attempts). Work
        already in flight on a replica runs to completion there; its
        result is discarded and the client still sees
        :class:`RequestCancelled`."""
        with self._mu:
            req = self._by_id.get(request_id)
        if req is None or req.future.done():
            return False
        req.cancelled = True
        return True

    # -- the dispatch loop (runs on the pool) -------------------------------
    def _resolve(self, req: _FleetRequest, result=None, exc=None,
                 outcome: str = "ok") -> None:
        with self._mu:
            self._by_id.pop(req.nonce, None)
            if req.quota_held:
                req.quota_held = False
                n = self._tenant_inflight.get(req.tenant, 1) - 1
                if n <= 0:
                    self._tenant_inflight.pop(req.tenant, None)
                else:
                    self._tenant_inflight[req.tenant] = n
        latency = time.monotonic() - req.t_submit
        self._m["latency"].observe(latency)
        # SLO accounting: every resolution is a burn-rate sample for
        # its class (cancelled requests are a client choice and burn
        # no budget — slo.py owns that policy)
        self.slo.record(req.slo_name, req.tenant, latency, outcome,
                        had_deadline=req.had_deadline)
        if req.span is not None:
            req.span.set_attr("outcome", outcome)
            req.span.set_attr("failovers", req.failovers)
            if exc is not None:
                req.span.set_status("error").set_attr("error", str(exc))
            req.span.end()
            req.span = None
        if req.future.done():
            return
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(result)

    def _resolve_shed(self, req: _FleetRequest, why: str,
                      reason: str, exc=None) -> None:
        self.n_shed += 1
        self._m["shed"].inc()
        if _goodput.enabled():
            # a shed request's whole router residency was wasted wall
            # — the ledger names it (precedence over the queue_wait it
            # overlaps), so brownout cost is visible, not hidden
            _goodput.note("shed", time.monotonic() - req.t_submit)
        self._resolve(req,
                      exc=exc or AdmissionShed(why, reason=reason),
                      outcome="shed")

    def _check_boundaries(self, req: _FleetRequest) -> bool:
        """Typed early outs at every routing boundary; True = resolved."""
        if req.cancelled:
            self._resolve(req, exc=RequestCancelled(
                f"request {req.nonce} cancelled at the router"),
                outcome="cancelled")
            return True
        if req.deadline is not None and req.deadline.expired:
            self._resolve(req, exc=DeadlineExceeded(
                f"request {req.nonce} deadline expired after "
                f"{req.failovers} failover(s)"), outcome="deadline")
            return True
        return False

    def _run(self, req: _FleetRequest) -> None:
        try:
            self._run_inner(req)
        except Exception as e:  # noqa: BLE001 — never lose a future
            self._resolve(req, exc=e, outcome="error")

    def _run_inner(self, req: _FleetRequest) -> None:
        while True:
            if self._check_boundaries(req):
                return
            st, flag = self._route(req)
            if st is None:
                if flag == "limited":
                    # routable replicas exist but every one sits at
                    # its AIMD limit: hold the request (this pool
                    # thread IS the queue slot) until a dispatch
                    # completes — bounded by the deadline boundary
                    # check above and the controller's max queue wait
                    waited = time.monotonic() - req.t_submit
                    if waited < self.overload.max_queue_wait_s:
                        time.sleep(0.01)
                        continue
                    self._resolve_shed(
                        req, f"concurrency-limited for {waited:.1f}s "
                        f"(AIMD limits {self.overload.limiter.state()})",
                        reason="limited",
                        exc=OverloadShed(
                            f"concurrency-limited for {waited:.1f}s: "
                            "no replica slot freed within "
                            f"{self.overload.max_queue_wait_s:.0f}s",
                            reason="limited",
                            retry_after_s=self.overload.retry_after_s(
                                "limited")))
                    return
                self._resolve_shed(
                    req, "no routable replica "
                    f"(tried {sorted(req.excluded)}, "
                    f"{len(self._replicas)} attached)",
                    reason="draining" if flag else "queue_full")
                return
            dspan = None
            if req.span is not None:
                dspan = _trace.start_span(
                    "router.dispatch", parent=req.span,
                    attrs={"replica": st.name,
                           "failovers": req.failovers})
                if req.last_dispatch is not None:
                    # a re-dispatch (failover or rebalance) links back
                    # to the attempt it replaces: the cross-replica
                    # retry reads as one story on a merged timeline
                    prev_ctx, prev_name = req.last_dispatch
                    dspan.add_link(prev_ctx, {
                        "relation": "retry_of",
                        "replica": prev_name})
                req.last_dispatch = (dspan.context, st.name)
            # disaggregated fleets: long-uncached prompts detour
            # through the prefill pool before this dispatch. Only the
            # first attempt migrates — a failover retry goes straight
            # to recompute (the fallback that cannot fail). Brownout
            # L1+ pauses the detour: a migration is optional latency
            # work, the first thing an overloaded fleet stops buying.
            if req.failovers == 0 and req.migrate is None \
                    and not req.excluded \
                    and (self.overload is None
                         or self.overload.allow_optional_work()):
                self._maybe_migrate(req, st, dspan)
            if self.policy == "affinity":
                self._m["affinity_total"].inc()
                if flag:
                    self._m["affinity_routed"].inc()
                fam = self._m["affinity_total"]
                self._m["affinity_rate"].set(
                    self._m["affinity_routed"].value
                    / max(1.0, fam.value))
            self._m["dispatches"].labels(st.name).inc()
            self._m["role_dispatches"].labels(
                st.role or "unified").inc()
            with self._mu:
                st.dispatched += 1
                st.inflight += 1
            self._m["inflight"].labels(st.name).set(st.inflight)
            try:
                if _faults.enabled():
                    _faults.check("router.dispatch")
                kw = {}
                if req.tenant is not None:
                    # tenant rides to the replica engine so
                    # llm_served_flops_total{tenant} attributes the
                    # request's cost where the FLOPs actually ran
                    kw["tenant"] = req.tenant
                out = st.client.submit(
                    req.prompt, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature,
                    deadline_s=(req.deadline.remaining()
                                if req.deadline is not None else None),
                    priority=req.priority, nonce=req.nonce, **kw,
                    # the dispatch span rides to the replica (HTTP
                    # header / direct SpanContext) so its llm.request
                    # tree shares this request's trace_id end to end
                    trace_context=(dspan.context
                                   if dspan is not None else None))
            except (AdmissionShed, EngineClosed) as e:
                # the replica refused — rebalance WITHOUT consuming
                # failover budget (nothing was lost). 503/draining
                # also updates the health view immediately instead of
                # waiting out a poll interval. A refusal is still a
                # RESPONSE: settle the breaker (a half-open probe that
                # drew a shed must not wedge the breaker half-open —
                # the breaker judges reachability, health judges load)
                st.breaker.record_success()
                if isinstance(e, EngineClosed) or \
                        getattr(e, "reason", "") == "draining":
                    st.health = "draining"
                # a shed response carrying Retry-After cools this
                # replica: _route prefers siblings until it lapses
                ra = getattr(e, "retry_after_s", None)
                if ra:
                    with self._mu:
                        self._retry_until[st.name] = \
                            time.monotonic() + float(ra)
                if self.overload is not None:
                    self.overload.on_outcome(st.name, "shed",
                                             None, 0.0)
                req.excluded.add(st.name)
                self.n_rebalanced += 1
                self._m["rebalanced"].inc()
                if dspan is not None:
                    dspan.set_attr("verdict", "shed")
                    dspan.set_status("error").end()
                continue
            except (ReplicaUnavailable, _faults.FaultInjected) as e:
                # the crash path: charge the breaker, fail over with
                # the SAME nonce while budget remains. Remember the
                # failed replica's last-known knob fingerprint — the
                # recovering sibling must be serving under the SAME
                # engine configuration or the retried stream cannot
                # be the stream the failed attempt was emitting
                if _audit.enabled():
                    req.prior_knobs = self._knobs.get(st.name)
                st.breaker.record_failure()
                st.health = "unreachable"
                req.excluded.add(st.name)
                with self._mu:
                    # a lost replica may restart with a blank pool
                    self._resident.pop(st.name, None)
                if dspan is not None:
                    dspan.set_attr("verdict", "unavailable")
                    dspan.set_status("error").end()
                if req.failovers >= self.failover_budget:
                    self._resolve(req, exc=ReplicaUnavailable(
                        f"request {req.nonce} lost replica {st.name} "
                        f"and exhausted its failover budget "
                        f"({self.failover_budget})"),
                        outcome="unavailable")
                    return
                req.failovers += 1
                self.n_failovers += 1
                self._m["failovers"].inc()
                continue
            except Exception as e:  # noqa: BLE001 — typed + terminal
                # the replica answered (504/499/400 are verdicts, not
                # crashes): settle the breaker like any response
                st.breaker.record_success()
                if dspan is not None:
                    dspan.set_attr("verdict", type(e).__name__)
                    dspan.set_status("error").end()
                outcome = ("deadline"
                           if isinstance(e, DeadlineExceeded)
                           else "cancelled"
                           if isinstance(e, RequestCancelled)
                           else "error")
                if self.overload is not None \
                        and outcome == "deadline":
                    self.overload.on_outcome(
                        st.name, "deadline", req.predicted_s,
                        time.monotonic() - req.t_submit)
                self._resolve(req, exc=e, outcome=outcome)
                return
            finally:
                with self._mu:
                    st.inflight -= 1
                self._m["inflight"].labels(st.name).set(st.inflight)
            st.breaker.record_success()
            if self.overload is not None:
                self.overload.on_outcome(
                    st.name, "ok", req.predicted_s,
                    time.monotonic() - req.t_submit)
            if dspan is not None:
                dspan.set_attr("verdict", "ok").end()
            if req.cancelled:
                # cancelled while the replica was generating: the
                # tokens are discarded, the promise is kept
                self._resolve(req, exc=RequestCancelled(
                    f"request {req.nonce} cancelled at the router"),
                    outcome="cancelled")
                return
            out["replica"] = st.name
            out["failovers"] = req.failovers
            out["request_id"] = req.nonce
            if req.migrate is not None:
                out["migrate_s"] = req.migrate["seconds"]
                out["migrated_pages"] = req.migrate["pages"]
                out["prefill_replica"] = req.migrate["prefill"]
            cap = (len(req.prompt) - 1) // self.page_size
            if cap > 0:
                with self._mu:
                    # the completed request computed (or re-used)
                    # every full prompt page on this replica
                    self._resident.setdefault(st.name, set()).update(
                        req.digests[:cap])
            if req.span is not None:
                # hand the client its trace id: one GET
                # /tracez?trace_id= on any fleet process pulls this
                # request's spans
                out["trace_id"] = req.span.trace_id
            if _audit.enabled():
                self._verify_stream(req, st, out)
            self._resolve(req, result=out)
            return

    # -- stream-integrity verification --------------------------------------
    def _verify_stream(self, req: _FleetRequest, st, out: dict) -> None:
        """Check every identity claim this resolution makes. The chain
        (``out["stream_digest"]``, folded over (nonce, position, token)
        by the replica's engine) is the witness:

        - ALWAYS: recompute the chain from the returned tokens under
          the request's pinned nonce; a mismatch means the stream and
          its digest disagree (corruption between engine and router).
          Counted under the claim being made (failover / migration) —
          or silently trusted when no claim is in play, because an
          unclaimed stream has no reference to diverge FROM; shadows
          provide that reference at ``audit_shadow_rate``.
        - failover (``req.failovers > 0``): the recovering sibling
          must also serve under the SAME engine-knob fingerprint as
          the replica that failed — a mismatched kv_dtype / draft
          sibling is a DETECTED divergence, not a doc caveat.
        - migration (``req.migrate`` carries a fill witness): the
          prefill's one-token fill ran under this request's nonce, so
          its digest IS the expected chain at position 0; the decode
          stream must extend it exactly.
        - shadow: at the sampled rate, re-execute OFF-PATH on the
          same replica under the same nonce and diff link by link.

        Never raises — a verification failure is a recorded verdict,
        not a request failure (the tokens already resolved)."""
        try:
            tokens = out.get("output_ids") or []
            digest_hex = out.get("stream_digest")
            knobs = out.get("knobs")
            if digest_hex is None:
                return              # replica predates the auditor
            claimed = bytes.fromhex(digest_hex)
            expected = _audit.chain_of(req.nonce, tokens)
            intact = claimed == expected
            with self._mu:
                if knobs is not None:
                    self._knobs[st.name] = knobs
            if req.failovers > 0:
                knob_ok = (req.prior_knobs is None
                           or req.prior_knobs == knobs)
                _audit.record(
                    self.name, "failover", intact and knob_ok,
                    position=None if intact else len(tokens),
                    chain_ours=expected, chain_theirs=claimed,
                    request_id=req.nonce, nonce=req.nonce,
                    knobs_ours=knobs, knobs_theirs=req.prior_knobs,
                    detail=(f"nonce-pinned failover to {st.name} "
                            f"after {req.failovers} failover(s): "
                            + ("chain intact" if intact else
                               "returned digest does not match the "
                               "returned tokens")
                            + ("" if knob_ok else
                               "; engine knob fingerprint differs "
                               "from the failed sibling's")))
            mig = req.migrate
            if mig is not None and mig.get("fill_digest") and tokens:
                fill_chain = bytes.fromhex(mig["fill_digest"])
                ok = _audit.verify_prefix(req.nonce, tokens,
                                          fill_chain, 1)
                _audit.record(
                    self.name, "migration", ok,
                    position=None if ok else 0,
                    chain_ours=_audit.chain_of(req.nonce, tokens[:1]),
                    chain_theirs=fill_chain,
                    request_id=req.nonce, nonce=req.nonce,
                    knobs_ours=knobs,
                    knobs_theirs=mig.get("fill_knobs"),
                    detail=(f"migrated-pages decode on {st.name} vs "
                            f"prefill fill on {mig['prefill']}: "
                            "the decode stream must extend the "
                            "fill's position-0 chain"))
            if _audit.sampled(req.nonce, _audit.shadow_rate()) \
                    and (self.overload is None
                         or self.overload.allow_optional_work()):
                # off-path: the caller's future resolves regardless;
                # the shadow rides the dispatch pool. Brownout L1+
                # sheds the sample — determinism proof is optional
                # work an overloaded fleet stops buying first.
                self.n_shadows += 1
                self._pool.submit(self._shadow, req, st, dict(out))
        except Exception:  # noqa: BLE001 — auditing must never
            pass           # turn a served request into a failure

    def _shadow(self, req: _FleetRequest, st, out: dict) -> None:
        """Sampled shadow re-execution: re-run the request on the SAME
        replica under the SAME nonce, directly against its client (not
        :meth:`submit` — a shadow must not be re-shadowed, shed, or
        failed over), and diff the chains link by link. The wall time
        lands in the ``audit`` badput bucket — determinism proof is a
        cost the goodput ledger must own, not hide."""
        t0 = time.monotonic()
        try:
            ref = st.client.submit(
                req.prompt, max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, nonce=req.nonce)
            tokens = out.get("output_ids") or []
            ref_tokens = ref.get("output_ids") or []
            pos = _audit.first_divergence(tokens, ref_tokens)
            ours = out.get("stream_digest")
            theirs = ref.get("stream_digest")
            _audit.record(
                self.name, "shadow", pos is None and ours == theirs,
                position=pos,
                chain_ours=(bytes.fromhex(ours) if ours else None),
                chain_theirs=(bytes.fromhex(theirs) if theirs
                              else None),
                request_id=req.nonce, nonce=req.nonce,
                knobs_ours=out.get("knobs"),
                knobs_theirs=ref.get("knobs"),
                detail=(f"shadow re-execution on {st.name}: same "
                        f"replica, same nonce, chain-vs-chain"))
        except Exception:  # noqa: BLE001 — a failed shadow is a
            pass           # missed sample, never an incident
        finally:
            if _goodput.enabled():
                _goodput.note("audit", time.monotonic() - t0)

    # -- observability surfaces ---------------------------------------------
    def _status(self) -> Optional[dict]:
        if self._closed:
            return None
        with self._mu:
            states = list(self._replicas.values())
            tenants = dict(self._tenant_inflight)
        return {
            "policy": self.policy,
            "submitted": self.n_submitted,
            "failovers": self.n_failovers,
            "rebalanced": self.n_rebalanced,
            "shed": self.n_shed,
            "tenant_inflight": tenants,
            "migrations": {
                "completed": self.n_migrations,
                "failed": self.n_migrate_failed,
                "pages": self.n_pages_migrated,
                "pages_rejected": self.n_pages_rejected,
            },
            "drift": dict(_audit.instance().counts(),
                          shadows=self.n_shadows),
            "replicas": {st.name: {
                "health": st.health,
                "breaker": st.breaker.state,
                "breaker_opens": st.breaker.n_opens,
                "inflight": st.inflight,
                "dispatched": st.dispatched,
                "from_membership": st.from_membership,
                "warming": st.warming,
                "admin_draining": st.admin_draining,
                "role": st.role or "unified",
            } for st in states},
        }

    def _aggregate_health(self) -> Optional[str]:
        if self._closed:
            return None
        with self._mu:
            states = list(self._replicas.values())
        # warming replicas are expected capacity-in-progress, not
        # sickness: they neither count as routable nor drag the
        # aggregate toward degraded
        considered = [st for st in states if not st.warming]
        routable = [st for st in considered
                    if st.health != "draining"
                    and not st.admin_draining
                    and st.breaker.state != "open"]
        if not routable:
            return "draining"
        if len(routable) < len(considered):
            return "degraded"
        return "healthy"

    def _slo_health(self) -> Optional[str]:
        """The /healthz breach-latch component: a latched SLO breach
        shows as degraded until an operator acknowledges it."""
        if self._closed:
            return None
        return self.slo.health()

    def _sloz(self) -> Optional[dict]:
        if self._closed:
            return None
        return self.slo.report()

    def _render_federated(self) -> Optional[str]:
        if self._closed or self.scraper is None:
            return None
        return self.scraper.render_prometheus()

    def _fleetz(self) -> Optional[dict]:
        """The /fleetz payload: the router's per-replica view (health,
        breaker, dispatch counts) joined with the scraper's per-replica
        metrics digest, plus the computed fleet aggregates."""
        if self._closed:
            return None
        with self._mu:
            states = list(self._replicas.values())
        scraped = self.scraper.replica_report() \
            if self.scraper is not None else {}
        replicas = {}
        roles: Dict[str, dict] = {}
        for st in states:
            entry = {
                "health": st.health,
                "breaker": st.breaker.state,
                "breaker_opens": st.breaker.n_opens,
                "inflight": st.inflight,
                "dispatched": st.dispatched,
                "from_membership": st.from_membership,
                "warming": st.warming,
                "admin_draining": st.admin_draining,
                "role": st.role or "unified",
            }
            entry["metrics"] = scraped.pop(st.name, None)
            replicas[st.name] = entry
            # per-role pool state: a down replica is a DOWN count, a
            # hole in ready capacity — never a ready entry of zero
            r = roles.setdefault(st.role or "unified", {
                "attached": 0, "ready": 0, "warming": 0,
                "draining": 0, "down": 0})
            r["attached"] += 1
            if st.warming:
                r["warming"] += 1
            elif st.admin_draining or st.health == "draining":
                r["draining"] += 1
            elif st.breaker.state == "open" or \
                    st.health in ("unreachable", "unknown"):
                r["down"] += 1
            else:
                r["ready"] += 1
        # scrapes for since-detached replicas, if any, still show
        for name, digest in scraped.items():
            replicas[name] = {"health": "detached", "metrics": digest}
        out = {
            "policy": self.policy,
            "replicas": replicas,
            "roles": roles,
            "submitted": self.n_submitted,
            "failovers": self.n_failovers,
            "rebalanced": self.n_rebalanced,
            "shed": self.n_shed,
            "migrations": {
                "completed": self.n_migrations,
                "failed": self.n_migrate_failed,
                "pages": self.n_pages_migrated,
                "pages_rejected": self.n_pages_rejected,
            },
            "drift": dict(_audit.instance().counts(),
                          shadows=self.n_shadows),
        }
        if self.scraper is not None:
            out["aggregates"] = self.scraper.aggregates()
        return out

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.overload is not None:
            self.remove_poll_hook(self.overload.tick)
            self.overload.unbind()
        _dbgsrv.unregister_status_provider(self._status_name)
        _dbgsrv.unregister_health_provider(self._status_name)
        _dbgsrv.unregister_health_provider(self._status_name + "_slo")
        _dbgsrv.unregister_reset_handler(self._status_name)
        _dbgsrv.unregister_fleet_provider(self._status_name)
        _dbgsrv.unregister_slo_provider(self._status_name)
        _dbgsrv.unregister_scrape_provider(self._status_name)
        self._stop.set()
        self._poller.join(timeout=10)
        # in-flight dispatches run to completion and resolve their
        # futures; new submits are already refused
        self._pool.shutdown(wait=True)
        with self._mu:
            leftovers = list(self._by_id.values())
        for req in leftovers:
            self._resolve(req, exc=EngineClosed("router closed"),
                          outcome="closed")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
