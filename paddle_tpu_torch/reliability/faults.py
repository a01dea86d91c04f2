"""Deterministic fault injection: named sites, seeded schedules.

The failure paths this repo grew (engine device-error recovery,
checkpoint commit, rendezvous-store retries, DataLoader workers) were
only ever exercised when real hardware happened to misbehave. This
module makes failure a first-class, REPLAYABLE input: production code
declares *injection sites* — one ``check(site)`` call on the failure
boundary — and a chaos harness (tools/chaos_soak.py) arms *rules*
describing when each site should throw.

Discipline (same as observability.tracing): off by default, and the
only cost of disabled injection is the ``enabled()`` module-flag check
at the site; hot paths guard with ``if faults.enabled(): ...`` so a
serving engine pays one attribute read per tick.

Determinism: probability rules do NOT consume a shared RNG stream —
each (seed, site, rule, call-number) decision is a pure hash, so the
set of faulting call numbers depends only on the seed and the
schedule, never on thread timing or on how many other sites fired in
between. ``preview(site, n)`` recomputes the schedule without touching
any state, which is what the chaos gate's same-seed → same-fault-
sequence assertion checks.

Named sites (the catalog; see docs/RELIABILITY.md):

========================  ==================================================
``device.dispatch``       engine jit dispatch (decode step / prefill chunk /
                          speculative round) — a PJRT/compile failure
``engine.slab``           fused decode slab dispatch (one lax.scan
                          program over decode_ticks_per_dispatch
                          ticks) — fires alongside device.dispatch so
                          chaos schedules can target slabs without
                          perturbing per-tick call numbering
``device.transfer``       device→host fetch of sampled tokens
``ckpt.write``            checkpoint save dispatch (pre-write)
``ckpt.rename``           checkpoint commit/rename stage (post-write)
``ckpt.snapshot``         device→host state snapshot (the only part of
                          an async save the train loop waits on)
``ckpt.async_commit``     background writer thread, one queued commit
                          (write+manifest) about to run
``loader.state``          DataLoader cursor capture/restore
                          (state_dict / load_state_dict)
``store.socket``          one TCP rendezvous-store request attempt
``io.worker``             DataLoader host-batch production
``router.dispatch``       fleet router: one request dispatch to a replica
``router.healthz``        fleet router: one replica health poll
``router.migrate``        fleet router: one KV-page migration attempt
                          (prefill fill + export + import) — injection
                          abandons the transfer; the request MUST fall
                          back to nonce-pinned local recompute on its
                          decode replica, token-identical
``kv.export``             engine: one export_pages call about to read
                          resident prefix pages off the device
``kv.import``             engine: one import_pages call about to verify
                          and install a migrated page run
``autoscale.spawn``       serving autoscaler: one spawn attempt during a
                          scale-out/replacement — injection makes the
                          spawn fail; the autoscaler must retry with
                          backoff and never count the failed replica
                          toward capacity
``autoscale.drain``       serving autoscaler: one iteration of the
                          scale-in drain wait — injection reads as the
                          drain deadline expiring NOW, so the replica
                          is killed with stragglers in flight (which
                          must fail over nonce-pinned, token-identical)
``replica.crash``         serving replica process: hard-crash trigger
                          (the replica main loop exits the process on
                          injection — a SIGKILL the schedule controls)
``data.poison``           trainer: one host batch about to dispatch —
                          injection NaN-poisons its float inputs
                          instead of raising (the trainer catches the
                          FaultInjected and corrupts the batch)
``grad.nonfinite``        trainer: one optimizer step inside the
                          guarded jitted program — injection feeds a
                          NaN loss multiplier, making that step's
                          loss AND grads non-finite on schedule
                          without retracing (requires the numeric
                          guard armed; see reliability/guard.py)
``audit.flip``            engine: one token about to be delivered —
                          injection XOR-flips its low bit BEFORE the
                          stream's digest chain extends over it, so
                          the corrupted stream is SELF-consistent
                          (its own chain matches its own tokens) and
                          only a chain-vs-chain check — device-retry
                          prefix, migration parity, or a shadow
                          re-execution — can catch it: the model of
                          a silently divergent replica (requires the
                          stream auditor armed; see
                          observability/audit.py)
``overload.estimate``     overload controller: one hopeless-shed
                          service-time prediction — injection
                          distorts the prediction 1000× (wildly
                          wrong) instead of raising; the controller
                          must degrade to visible shed/miss verdicts,
                          never hangs (serving/overload.py)
``overload.step``         overload controller: one brownout-ladder
                          tick — injection forces a SPURIOUS one-level
                          escalation, logged with the fault as its
                          reason; the normal hysteresis must walk it
                          back down once the live windows disagree
========================  ==================================================

Stdlib-only by design: any module may import this without cycles.
"""

from __future__ import annotations

import hashlib
import math
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

SITES = (
    "device.dispatch",
    "engine.slab",
    "device.transfer",
    "ckpt.write",
    "ckpt.rename",
    "ckpt.snapshot",
    "ckpt.async_commit",
    "loader.state",
    "store.socket",
    "io.worker",
    "router.dispatch",
    "router.healthz",
    "router.migrate",
    "kv.export",
    "kv.import",
    "autoscale.spawn",
    "autoscale.drain",
    "replica.crash",
    "data.poison",
    "grad.nonfinite",
    "audit.flip",
    "overload.estimate",
    "overload.step",
)


class FaultInjected(RuntimeError):
    """Default injected failure. Carries the site and the 1-based call
    number so assertions (and flight dumps) can pin exactly which
    dispatch died."""

    def __init__(self, site: str, call_index: int, note: str = ""):
        msg = f"injected fault at {site} (call #{call_index})"
        if note:
            msg += f": {note}"
        super().__init__(msg)
        self.site = site
        self.call_index = call_index


_enabled = False
_mu = threading.Lock()
_seed = 0
_t0 = 0.0
_rules: Dict[str, List["FaultRule"]] = {}
_calls: Dict[str, int] = {}
_log: List[Tuple[str, int]] = []
_log_dropped = 0
_LOG_CAP = 4096


def _bernoulli(seed: int, site: str, rule_idx: int, call_n: int,
               p: float) -> bool:
    """Pure, process-independent coin flip for one (rule, call): a
    blake2b of the identifying tuple, not a stateful RNG — immune to
    PYTHONHASHSEED and to interleaving with other sites' calls."""
    h = hashlib.blake2b(
        f"{seed}:{site}:{rule_idx}:{call_n}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64 < p


class FaultRule:
    """One trigger at one site. Composable conditions (all must hold):

    - ``nth``: fire on these 1-based call numbers (int or iterable);
    - ``p``: fire with this per-call probability (deterministic per
      seed — see :func:`_bernoulli`);
    - ``after_s``/``until_s``: only inside this window relative to
      :func:`enable` (time-window rules are inherently timing-
      dependent and are excluded from :func:`preview`);
    - ``times``: total injection budget for the rule.

    ``exc``: exception class or zero-arg factory; default
    :class:`FaultInjected`.
    """

    __slots__ = ("site", "nth", "p", "after_s", "until_s", "times",
                 "exc", "fired")

    def __init__(self, site: str,
                 nth: Union[int, Iterable[int], None] = None,
                 p: Optional[float] = None,
                 after_s: Optional[float] = None,
                 until_s: Optional[float] = None,
                 times: Optional[int] = None,
                 exc: Optional[Callable[[], BaseException]] = None):
        if nth is None and p is None and after_s is None \
                and until_s is None:
            raise ValueError(
                "a FaultRule needs a trigger: nth=, p=, or a time "
                "window (after_s/until_s)")
        self.site = site
        if nth is None:
            self.nth = None
        elif isinstance(nth, int):
            self.nth = frozenset((nth,))
        else:
            self.nth = frozenset(int(x) for x in nth)
        self.p = None if p is None else float(p)
        self.after_s = after_s
        self.until_s = until_s
        self.times = math.inf if times is None else int(times)
        self.exc = exc
        self.fired = 0

    def decides(self, seed: int, rule_idx: int, call_n: int) -> bool:
        """The pure (timing-independent) part of the trigger."""
        if self.nth is not None and call_n not in self.nth:
            return False
        if self.p is not None and not _bernoulli(
                seed, self.site, rule_idx, call_n, self.p):
            return False
        return True

    def matches(self, seed: int, rule_idx: int, call_n: int,
                now_rel: float) -> bool:
        if self.fired >= self.times:
            return False
        if self.after_s is not None and now_rel < self.after_s:
            return False
        if self.until_s is not None and now_rel >= self.until_s:
            return False
        return self.decides(seed, rule_idx, call_n)

    def make_exc(self, call_n: int) -> BaseException:
        if self.exc is None:
            return FaultInjected(self.site, call_n)
        e = self.exc()
        if isinstance(e, BaseException):
            return e
        raise TypeError(f"exc factory for {self.site} returned {e!r}")


# ---------------------------------------------------------------------------
# module controls
# ---------------------------------------------------------------------------


def enable(seed: int = 0) -> None:
    """Arm injection. Resets call counters, the injection log, AND
    every registered rule's ``times`` budget, so a run is replayable:
    same seed + same schedule + same per-site call ordering → same
    injected faults (re-arming without re-registering rules replays
    too)."""
    global _enabled, _seed, _t0, _log_dropped
    with _mu:
        _seed = int(seed)
        _t0 = time.monotonic()
        _calls.clear()
        del _log[:]
        _log_dropped = 0
        for rules in _rules.values():
            for rule in rules:
                rule.fired = 0
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Disable AND drop every rule/counter (test isolation)."""
    global _enabled, _log_dropped
    with _mu:
        _enabled = False
        _rules.clear()
        _calls.clear()
        del _log[:]
        _log_dropped = 0


def enabled() -> bool:
    return _enabled


def seed() -> int:
    return _seed


def inject(site: str,
           nth: Union[int, Iterable[int], None] = None,
           p: Optional[float] = None,
           after_s: Optional[float] = None,
           until_s: Optional[float] = None,
           times: Optional[int] = None,
           exc: Optional[Callable[[], BaseException]] = None
           ) -> FaultRule:
    """Register a rule at a named site (see :data:`SITES`; unknown
    sites are allowed so downstream code can declare its own, but the
    catalog is the contract chaos schedules are written against)."""
    rule = FaultRule(site, nth=nth, p=p, after_s=after_s,
                     until_s=until_s, times=times, exc=exc)
    with _mu:
        _rules.setdefault(site, []).append(rule)
    return rule


def clear(site: Optional[str] = None) -> None:
    with _mu:
        if site is None:
            _rules.clear()
        else:
            _rules.pop(site, None)


# ---------------------------------------------------------------------------
# the hot-path hook
# ---------------------------------------------------------------------------


def check(site: str) -> None:
    """The injection site. No-op unless :func:`enable` ran (callers on
    hot paths additionally guard with ``if faults.enabled():`` so the
    disabled cost is one module-flag read). When armed: counts the
    call, evaluates the site's rules, and raises the first match."""
    if not _enabled:
        return
    hit = None
    with _mu:
        n = _calls.get(site, 0) + 1
        _calls[site] = n
        rules = _rules.get(site)
        if rules:
            now_rel = time.monotonic() - _t0
            for idx, rule in enumerate(rules):
                if rule.matches(_seed, idx, n, now_rel):
                    rule.fired += 1
                    if len(_log) < _LOG_CAP:
                        _log.append((site, n))
                    else:
                        global _log_dropped
                        _log_dropped += 1
                    hit = rule
                    break
    if hit is not None:
        # the exc factory is USER code — run it outside _mu so a
        # factory that reads faults state (call_count, injected_log)
        # cannot deadlock the injecting thread
        _count_injection(site)
        raise hit.make_exc(n)


def _count_injection(site: str) -> None:
    try:
        from ..observability import metrics as _obs
        _obs.default_registry().counter(
            "fault_injected_total", "faults raised by the injection "
            "registry", label_names=("site",)).labels(site).inc()
    except Exception:  # noqa: BLE001 — accounting must not mask chaos
        pass


# ---------------------------------------------------------------------------
# introspection (what the chaos gate asserts on)
# ---------------------------------------------------------------------------


def call_count(site: str) -> int:
    with _mu:
        return _calls.get(site, 0)


def injected_log() -> List[Tuple[str, int]]:
    """(site, call-number) of every fault raised since :func:`enable`,
    in raise order — bounded at ``_LOG_CAP`` entries; check
    :func:`injected_log_dropped` before asserting exact equality
    against a schedule."""
    with _mu:
        return list(_log)


def injected_log_dropped() -> int:
    """Injections NOT recorded in :func:`injected_log` because the
    bounded log filled (still raised and counted in the metric)."""
    with _mu:
        return _log_dropped


def preview(site: str, n_calls: int,
            seed: Optional[int] = None) -> List[int]:
    """The call numbers in 1..n_calls at which the site WOULD fault,
    computed purely from the seed and the registered nth/p rules
    (time-window rules are skipped — they depend on the wall clock,
    not the seed). This is the determinism witness: two runs with the
    same seed and schedule must inject exactly at a prefix-consistent
    subset of ``preview(site, N)``."""
    s = _seed if seed is None else int(seed)
    with _mu:
        rules = [(idx, r, r.times)
                 for idx, r in enumerate(_rules.get(site, ()))
                 if r.after_s is None and r.until_s is None]
    out = []
    budgets = {idx: t for idx, _, t in rules}
    for n in range(1, int(n_calls) + 1):
        for idx, r, _ in rules:
            if budgets[idx] <= 0:
                continue
            if r.decides(s, idx, n):
                budgets[idx] -= 1
                out.append(n)
                break
    return out
