"""HBM attribution ledger — per-owner device-memory accounting.

The fleet can see how fast it runs (/perfz, observability/perf.py) and
whether it meets SLOs (/sloz), but until this module it could not see
WHERE device memory goes: ``sample_device_memory()`` exports raw
``torch.cuda.memory_stats()`` totals with zero attribution, so the two
biggest capacity bets — int8 KV pages ("~2x page capacity at fixed
HBM", ROADMAP item 1) and KV-page migration routed by per-replica
headroom (item 3) — had no measured accounting to verify against and
no surface to route on. This module is that accounting:

- OWNERS register attributed reservations once, at allocation
  boundaries — never per tick. ``hapi.Model`` registers
  params / opt-state / buffers (bytes from the abstract tree,
  per-dtype) when its device trees are built; the engine's paged KV
  pool registers a LIVE provider whose rows split the pool into
  free / private / prefix-cache-shared pages (refcounted shared pages
  counted once) computed at read time from the same host counters the
  allocator mutates; ``DecodeCarry`` slabs register their scratch
  arrays; the checkpoint snapshot path registers its host-side
  staging buffers (``placement="host"`` — host rows are reported but
  excluded from the device reconciliation).
- Every read RECONCILES against ``torch.cuda.memory_stats()``: the
  residual (``bytes_in_use`` minus the attributed sum) is an explicit
  "unattributed" line — allocator blocks and cuBLAS workspace — never
  silently folded into an owner. A process without a card (CPU)
  reports the residual as ``None`` with a note, not as a fake zero.
- HIGH-WATERMARKS are kept per phase, tagged by the span active when
  the watermark advanced (``train.dispatch``, ``llm.decode``, ...),
  so an OOM post-mortem can say WHICH phase grew.
- FORENSICS: a near-OOM threshold (``FLAGS.mem_near_oom_fraction``)
  arms a ONE-SHOT flight-recorder snapshot, and
  :func:`maybe_dump_oom` — called from the engine loop's error
  handler and the train dispatch paths — turns any
  ``torch.cuda.OutOfMemoryError`` into a flight dump carrying the per-owner
  table plus the delta since the last watermark: a diffable
  accounting instead of a bare stack trace.

Surfaces: ``GET /memz`` (observability/server.py renders
:func:`memz_payload`), ``mem_bytes{owner,kind}`` /
``mem_watermark_bytes`` / ``mem_headroom_pages`` on ``/metrics``, a
``/statusz`` row, and fleet federation
(``fleet_mem_headroom_pages`` via ``serving.fleet.FleetScraper`` —
down/warming replicas are HOLES, per the fleet_mfu convention) so the
router and autoscaler can read real per-replica headroom.

Disabled cost is ONE module-flag check at every call site, pinned the
same way tracing and perf are (``FLAGS.mem_observability`` sets the
initial state; :func:`enable`/:func:`disable` flip it at runtime).
Enabled cost on hot paths is zero: registration happens at allocation
boundaries, the KV split is computed by the read, not the tick.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..core import flags as _flags
from ._gclock import GcSafeLock
from .metrics import default_registry

# -- enable flag (pinned: one module-bool check at every call site) --------

_ENABLED = bool(_flags.get_flag("mem_observability"))


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


UNATTRIBUTED_NOTE = ("CUDA caching-allocator blocks + cuBLAS workspace "
                     "+ any owner not registered with the ledger")
NO_STATS_NOTE = ("this process has no CUDA device (CPU): the residual "
                 "is unknowable; host_rss_bytes is the fallback signal")

# substrings that identify an allocator-exhaustion failure: PyTorch's
# CUDA allocator raises torch.cuda.OutOfMemoryError ("CUDA out of
# memory. Tried to allocate ..."); host-side allocators say "out of
# memory" in several capitalizations.
_OOM_MARKERS = ("OutOfMemoryError", "CUDA out of memory",
                "RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OUT_OF_MEMORY", "Resource exhausted")


def is_oom(exc: BaseException) -> bool:
    """Does this exception smell like device/allocator exhaustion?
    ``torch.cuda.OutOfMemoryError`` by its type name, anything else by
    its message: the engine loop and train step catch broad Exception
    classes."""
    text = f"{type(exc).__name__}: {exc}"
    return any(m in text for m in _OOM_MARKERS)


# process-unique owner scope tokens (NOT id(): CPython reuses addresses
# after GC — same discipline as observability/perf.py)
_scope_counter = itertools.count()


def next_scope() -> str:
    """A process-unique scope token for ledger registrations."""
    return f"m{next(_scope_counter)}"


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
    """Attach a GC finalizer releasing ``scope``'s ledger entries when
    ``owner`` is collected — the backstop for owners discarded without
    their explicit cleanup path (engine close, Model re-prepare).
    Returns the ``weakref.finalize`` handle."""
    import weakref
    return weakref.finalize(owner, _cleanup_scope, scope)


def tree_bytes_by_dtype(tree) -> Dict[str, int]:
    """Per-dtype byte totals of the tensors in ``tree`` (a tensor, a
    ``state_dict``, a Module, or nested dicts/lists/tuples of them),
    from shapes and element sizes only — no device sync, no tensor
    retained. Non-tensor leaves contribute nothing."""
    import torch
    out: Dict[str, int] = {}
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            key = str(x.dtype).replace("torch.", "")
            out[key] = out.get(key, 0) + x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def _collect_device_stats() -> Optional[dict]:
    """The one card's ``torch.cuda.memory_stats()`` as the reconcile
    target: ``{"bytes_in_use", "bytes_limit", "peak_bytes_in_use",
    "devices"}`` (the caching allocator's allocated bytes, the card's
    total memory, the allocator's peak). Returns None on a process
    without a CUDA device — an explicit hole, never zeros.
    Module-level so tests can monkeypatch a synthetic device total."""
    import torch
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0)),
            "bytes_limit": float(
                torch.cuda.get_device_properties(0).total_memory),
            "peak_bytes_in_use": float(
                stats.get("allocated_bytes.all.peak", 0)) or None,
            "devices": 1}


def host_rss_bytes() -> Optional[float]:
    """Current resident set size of this process — the documented
    fallback gauge on backends without device memory stats. Linux
    /proc/self/statm (current RSS); falls back to getrusage ru_maxrss
    (PEAK rss — close enough for the trend) elsewhere; None when
    neither source exists."""
    try:
        import os
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:  # noqa: BLE001
        pass
    try:
        import resource
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return float(rss * 1024)     # ru_maxrss is KiB on Linux
    except Exception:  # noqa: BLE001
        return None


def _active_phase() -> str:
    """The span to tag a watermark with: the caller thread's current
    span if one is open, else the newest live span anywhere in the
    process (a read from the HTTP thread should still say what the
    job is doing), else "(untraced)"."""
    from . import tracing
    sp = tracing.current_span()
    if sp is not None:
        return sp.name
    if tracing.enabled():
        live = tracing.live_spans()
        if live:
            return live[-1]["name"]
    return "(untraced)"


class MemoryLedger:
    """Process-wide attribution ledger (singleton via
    :func:`instance`; tests build private ones).

    Two registration styles:

    - :meth:`set_entry` — a STATIC reservation: (scope, owner, kind)
      -> bytes, overwritten in place when the owner re-registers
      (Model re-prepare, a second async snapshot). Placement
      "device" rows reconcile against ``memory_stats()``; "host"
      rows (checkpoint staging) are reported but excluded.
    - :meth:`register_provider` — a LIVE source: a zero-arg callable
      returning ``{"rows": [...], "headroom_pages": n,
      "page_bytes": b}`` computed at read time (the engine's KV-pool
      split: free/private/shared move every tick, so the READ does
      the math, the tick pays nothing). A provider returning None is
      dead and self-unregisters (the weakref-closure convention).
    """

    def __init__(self):
        # the scope finalizers' removals queue here while it is held
        self._mu = GcSafeLock()
        # (scope, owner, kind) -> {"owner","kind","bytes","placement",
        #                          "scope","detail"}
        self._entries: Dict[Tuple[str, str, str], dict] = {}
        self._providers: Dict[str, Callable[[], Optional[dict]]] = {}
        # phase -> {"bytes", "ts"}: high-watermark of attributed
        # DEVICE bytes, tagged by the span active when it advanced
        self._watermarks: Dict[str, dict] = {}
        self._peak_bytes = 0.0
        # per-owner rows captured when the global watermark last
        # advanced — the baseline the OOM dump diffs against
        self._peak_rows: Dict[Tuple[str, str], float] = {}
        self._near_oom_fired = False
        self._oom_dumped = False
        self._stats_cache: Tuple[float, Optional[dict]] = (0.0, None)
        self._gauge_keys: set = set()
        self._headroom_exported = False
        self.t_start = time.time()

    # -- registration (allocation boundaries, never per tick) -----------
    def set_entry(self, scope: str, owner: str, kind: str,
                  nbytes: float, placement: str = "device",
                  detail: Optional[dict] = None) -> None:
        row = {"owner": owner, "kind": kind, "bytes": float(nbytes),
               "placement": placement, "scope": scope,
               "detail": detail or {}}
        with self._mu:
            self._entries[(scope, owner, kind)] = row
        self._refresh_watermark()

    def clear_entry(self, scope: str, owner: str, kind: str) -> None:
        with self._mu:
            self._entries.pop((scope, owner, kind), None)

    def register_provider(self, scope: str,
                          fn: Callable[[], Optional[dict]]) -> None:
        with self._mu:
            self._providers[scope] = fn
        self._refresh_watermark()

    def remove_scope(self, scope: str) -> int:
        """Drop every entry and provider registered under ``scope`` —
        called by owners on teardown (engine close, Model re-prepare)
        so long-lived processes creating owners in a loop can't grow
        the table with dead rows. Returns the number removed."""
        with self._mu:
            return self._drop_scope_locked(scope)

    def _drop_scope_locked(self, scope: str) -> int:
        dead = [k for k in self._entries if k[0] == scope]
        for k in dead:
            self._entries.pop(k, None)
        had = self._providers.pop(scope, None) is not None
        return len(dead) + (1 if had else 0)

    # -- readout ---------------------------------------------------------
    def _collect(self) -> Tuple[List[dict], Optional[dict]]:
        """ONE pass over static entries + live providers →
        (rows, headroom). Every read path goes through here so a
        /memz request runs each provider exactly once and its gauges,
        payload, and watermark all describe the same snapshot.
        Providers run OUTSIDE the ledger lock; a None return
        unregisters the provider — its owner is gone."""
        with self._mu:
            out = [dict(r) for r in self._entries.values()]
            provs = list(self._providers.items())
        pages = bytes_addable = 0.0
        page_bytes: Optional[float] = 0.0
        found = False
        dead = []
        for scope, fn in provs:
            try:
                d = fn()
            except Exception as e:  # noqa: BLE001 — one bad provider
                out.append({"owner": "provider_error", "kind": scope,
                            "bytes": 0.0, "placement": "device",
                            "scope": scope, "detail": {"error": str(e)}})
                continue
            if d is None:
                dead.append(scope)
                continue
            for r in d.get("rows", ()):
                r = dict(r)
                r.setdefault("placement", "device")
                r.setdefault("scope", scope)
                r.setdefault("detail", {})
                out.append(r)
            if d.get("headroom_pages") is not None:
                hp = float(d["headroom_pages"])
                pb = float(d.get("page_bytes", 0))
                pages += hp
                bytes_addable += hp * pb
                # one shared page size keeps the page-denominated
                # estimates meaningful; mixed pools (two engines with
                # different page_bytes in one process) report None —
                # bytes_addable stays exact either way
                page_bytes = pb if not found or page_bytes == pb \
                    else None
                found = True
        if dead:
            with self._mu:
                for scope in dead:
                    self._providers.pop(scope, None)
        headroom = None
        if found:
            headroom = {
                "kv_pages_addable": pages, "page_bytes": page_bytes,
                "bytes_addable": bytes_addable,
                "source": "pool free + evictable prefix-cache pages"}
        return out, headroom

    def rows(self) -> List[dict]:
        """Every attributed row (static entries + live provider
        rows)."""
        return self._collect()[0]

    def headroom(self) -> Optional[dict]:
        """KV pages addable RIGHT NOW, summed over live pool
        providers — each reports the same quantity its engine's
        admission path uses (``LLMEngine._avail_pages``: free +
        evictable prefix-cache residents), so the ledger can never
        drift from what the allocator would actually hand out. None
        when no pool provider reports it (a trainer process, a
        closed engine): a HOLE, not a zero."""
        return self._collect()[1]

    def _active(self) -> bool:
        """Only query the card once some owner registered device
        rows: a router-only process answering /memz must not
        initialize a CUDA context (the perf registry's discipline)."""
        with self._mu:
            if self._providers:
                return True
            return any(r["placement"] == "device"
                       for r in self._entries.values())

    def device_stats(self, ttl: float = 1.0) -> Optional[dict]:
        """Cached ``memory_stats()`` aggregate (a scrape storm must
        not hammer the allocator on every request). None when the
        backend exports no stats or no owner has registered device
        rows yet."""
        if not self._active():
            return None
        now = time.monotonic()
        with self._mu:
            ts, cached = self._stats_cache
            if now - ts < ttl:
                return dict(cached) if cached else None
        stats = _collect_device_stats()
        with self._mu:
            self._stats_cache = (now, stats)
        return dict(stats) if stats else None

    @staticmethod
    def _attributed(rows: List[dict], placement: str) -> float:
        return sum(r["bytes"] for r in rows
                   if r["placement"] == placement)

    def _note_watermark(self, rows: List[dict],
                        device_total: float) -> None:
        """Advance the per-phase high-watermarks; when the GLOBAL peak
        advances, snapshot the per-owner rows as the baseline the OOM
        dump diffs against ("delta since the last watermark")."""
        phase = _active_phase()
        with self._mu:
            wm = self._watermarks.get(phase)
            if wm is None or device_total > wm["bytes"]:
                self._watermarks[phase] = {
                    "bytes": device_total, "ts": round(time.time(), 3)}
            if device_total > self._peak_bytes:
                self._peak_bytes = device_total
                self._peak_rows = {
                    (r["owner"], r["kind"]): r["bytes"]
                    for r in rows if r["placement"] == "device"}

    def _delta_since_watermark(self, rows: List[dict]) -> List[dict]:
        with self._mu:
            base = dict(self._peak_rows)
        out = []
        for r in rows:
            if r["placement"] != "device":
                continue
            prev = base.pop((r["owner"], r["kind"]), 0.0)
            if r["bytes"] != prev:
                out.append({"owner": r["owner"], "kind": r["kind"],
                            "bytes": r["bytes"],
                            "delta_bytes": r["bytes"] - prev})
        for (owner, kind), prev in base.items():
            out.append({"owner": owner, "kind": kind, "bytes": 0.0,
                        "delta_bytes": -prev})
        return out

    def _refresh_watermark(self) -> None:
        """Advance the watermarks at a registration boundary: reads
        advance them too, but a bench/batch process may never READ
        while its owners are alive — the allocation boundary itself
        must leave the peak behind (it's what ``peak_mem_bytes``
        ledger rows carry after the owners close). Cold path only:
        registrations happen once per allocation, never per tick."""
        try:
            rows, _ = self._collect()
            self._note_watermark(rows,
                                 self._attributed(rows, "device"))
        except Exception:  # noqa: BLE001 — accounting must not raise
            pass

    def watermark_bytes(self) -> float:
        """Global high-watermark of attributed device bytes — what
        bench ledger rows carry as ``peak_mem_bytes``."""
        with self._mu:
            return self._peak_bytes

    # -- the payload (one read = ONE provider pass + reconcile) ---------
    def payload(self) -> dict:
        """The GET /memz body. Reconciliation invariant (test-pinned):
        ``sum(owner device bytes) + unattributed_bytes ==
        device.bytes_in_use`` whenever the backend reports stats —
        the residual is COMPUTED as the closing line, never folded
        into an owner. Gauges refresh from the SAME snapshot, so
        /memz and /metrics cannot disagree within one read."""
        rows, headroom = self._collect()
        return self._build_payload(rows, headroom)

    def _build_payload(self, rows: List[dict],
                       headroom: Optional[dict]) -> dict:
        dev = self.device_stats()
        attributed_dev = self._attributed(rows, "device")
        attributed_host = self._attributed(rows, "host")
        self._note_watermark(rows, attributed_dev)
        self._set_gauges(rows, headroom)
        if dev is not None:
            residual = dev["bytes_in_use"] - attributed_dev
            note = UNATTRIBUTED_NOTE
        else:
            residual = None
            note = NO_STATS_NOTE
        if dev is not None and headroom is not None and \
                dev.get("bytes_limit") and headroom["page_bytes"]:
            # second estimate: pages a GROWN pool could add before the
            # allocator limit (the int8-KV sizing question)
            free_hbm = max(0.0, dev["bytes_limit"] - dev["bytes_in_use"])
            headroom["hbm_pages_addable"] = int(
                free_hbm // headroom["page_bytes"])
        with self._mu:
            watermarks = {p: dict(w)
                          for p, w in self._watermarks.items()}
        out = {
            "enabled": enabled(),
            "uptime_s": round(time.time() - self.t_start, 3),
            "attributed_device_bytes": attributed_dev,
            "attributed_host_bytes": attributed_host,
            "owners": sorted(rows, key=lambda r: -r["bytes"]),
            "device": dev,
            "unattributed_bytes": residual,
            "unattributed_note": note,
            "headroom": headroom,
            "watermarks": watermarks,
            "peak_attributed_bytes": self.watermark_bytes(),
            "host_rss_bytes": host_rss_bytes(),
        }
        self._check_near_oom(dev, rows, headroom)
        return out

    # -- gauges ----------------------------------------------------------
    def update_gauges(self) -> None:
        """Refresh ``mem_bytes{owner,kind}`` / ``mem_watermark_bytes``
        / ``mem_headroom_pages`` in the default registry (read
        boundaries only: /metrics prescrape, /statusz, bench
        snapshots; /memz refreshes them through its own payload
        snapshot). An owner whose rows vanished (engine closed) is
        zeroed; a process with NO live pool exports no headroom gauge
        at all — a warming replica must read as a HOLE in
        ``fleet_mem_headroom_pages``, not a zero."""
        rows, headroom = self._collect()
        self._note_watermark(rows, self._attributed(rows, "device"))
        self._set_gauges(rows, headroom)
        # near-OOM arming happens at ANY ledger read (documented: the
        # /metrics prescrape is usually the first reader to see the
        # threshold crossed), not just /memz
        self._check_near_oom(self.device_stats(), rows, headroom)

    def _set_gauges(self, rows: List[dict],
                    headroom: Optional[dict]) -> None:
        reg = default_registry()
        g = reg.gauge(
            "mem_bytes",
            "attributed memory reservation by owner and kind "
            "(device + host rows; docs/OBSERVABILITY.md "
            "\"Memory surfaces\")",
            label_names=("owner", "kind"))
        seen = set()
        totals: Dict[Tuple[str, str], float] = {}
        for r in rows:
            totals[(r["owner"], r["kind"])] = \
                totals.get((r["owner"], r["kind"]), 0.0) + r["bytes"]
        for (owner, kind), nb in totals.items():
            g.labels(owner=owner, kind=kind).set(nb)
            seen.add((owner, kind))
        with self._mu:
            stale = self._gauge_keys - seen
            self._gauge_keys = seen
        for owner, kind in stale:
            g.labels(owner=owner, kind=kind).set(0)
        reg.gauge(
            "mem_watermark_bytes",
            "high-watermark of attributed device bytes since process "
            "start (per-phase watermarks on /memz)"
        ).set(self.watermark_bytes())
        if headroom is not None:
            reg.gauge(
                "mem_headroom_pages",
                "KV pages the paged pools could still hand out (free "
                "+ evictable prefix-cache pages) — the per-replica "
                "headroom the fleet router federates; absent (a hole, "
                "not 0) when no pool lives in this process"
            ).set(headroom["kv_pages_addable"])
            self._headroom_exported = True
        elif self._headroom_exported:
            # the last pool closed: remove the family so federation
            # reads a hole, not a stale last value
            reg.unregister("mem_headroom_pages")
            self._headroom_exported = False

    def status_summary(self) -> dict:
        """Cheap /statusz row (no device query beyond the 1s cache)."""
        rows, headroom = self._collect()
        return {
            "enabled": enabled(),
            "owners": len({(r["owner"], r["kind"]) for r in rows}),
            "attributed_device_bytes": self._attributed(rows, "device"),
            "attributed_host_bytes": self._attributed(rows, "host"),
            "peak_attributed_bytes": self.watermark_bytes(),
            "kv_pages_addable": (headroom["kv_pages_addable"]
                                 if headroom else None),
        }

    # -- forensics -------------------------------------------------------
    def _check_near_oom(self, dev: Optional[dict], rows: List[dict],
                        headroom: Optional[dict]) -> None:
        """One-shot near-OOM snapshot: when device usage crosses
        ``FLAGS.mem_near_oom_fraction`` of the limit at ANY ledger
        read (/memz, /metrics prescrape, /statusz), dump the
        attribution table through the flight recorder BEFORE the OOM
        lands — the pre-crash baseline the post-crash dump diffs
        against. 0 disables."""
        frac = float(_flags.get_flag("mem_near_oom_fraction") or 0.0)
        if frac <= 0 or dev is None or not dev.get("bytes_limit"):
            return
        used = dev["bytes_in_use"] / dev["bytes_limit"]
        if used < frac:
            return
        from .flight import dump_flight_record, get_flight_recorder
        with self._mu:
            # the one-shot latch must not be consumed by a process
            # that has no recorder installed YET (dumping would be a
            # silent no-op and the forensic baseline would be lost
            # forever once one IS installed)
            if self._near_oom_fired or get_flight_recorder() is None:
                return
            self._near_oom_fired = True
        path = dump_flight_record("near_oom", extra={
            "used_fraction": round(used, 4),
            "threshold": frac,
            "memz": {
                "attributed_device_bytes":
                    self._attributed(rows, "device"),
                "owners": sorted(rows, key=lambda r: -r["bytes"]),
                "device": dev,
                "unattributed_bytes":
                    dev["bytes_in_use"]
                    - self._attributed(rows, "device"),
                "headroom": headroom,
            },
        })
        if path is None:        # recorder failed: stay armed
            with self._mu:
                self._near_oom_fired = False

    def maybe_dump_oom(self, exc: BaseException,
                       component: str = "") -> Optional[str]:
        """RESOURCE_EXHAUSTED anywhere in the engine loop or train
        step lands here (callers pass every caught error; non-OOMs
        return None untouched). One dump per process — the FIRST OOM
        is the forensic one; later cascades would only overwrite it
        with post-mortem noise. The dump's ``extra`` row carries the
        full per-owner table plus the delta since the last watermark,
        so the accounting of what GREW is one diff away."""
        if not is_oom(exc):
            return None
        from .flight import dump_flight_record, get_flight_recorder
        with self._mu:
            # don't consume the one-shot without a recorder to dump
            # through: the process may install one and OOM again
            if self._oom_dumped or get_flight_recorder() is None:
                return None
            self._oom_dumped = True
        try:
            # ONE snapshot: the delta is taken against the watermark
            # baseline BEFORE _build_payload can advance it, and the
            # dumped table is the same rows the delta was diffed from
            rows, headroom = self._collect()
            delta = self._delta_since_watermark(rows)
            payload = self._build_payload(rows, headroom)
        except Exception:  # noqa: BLE001 — forensics must not mask
            delta, payload = [], {"error": "ledger read failed"}
        path = dump_flight_record("oom", extra={
            "component": component,
            "error": str(exc)[:500],
            "memz": payload,
            "delta_since_watermark": delta,
        })
        if path is None:        # recorder failed: stay armed
            with self._mu:
                self._oom_dumped = False
        return path

    def reset_one_shots(self) -> None:
        """Re-arm the near-OOM and OOM one-shot dumps (tests; an
        operator who recovered a replica via /reset_health)."""
        with self._mu:
            self._near_oom_fired = False
            self._oom_dumped = False


_instance: Optional[MemoryLedger] = None
_instance_mu = threading.Lock()


def instance() -> MemoryLedger:
    global _instance
    with _instance_mu:
        if _instance is None:
            _instance = MemoryLedger()
        return _instance


def reset() -> None:
    """Drop the process-wide ledger (test isolation)."""
    global _instance
    with _instance_mu:
        _instance = None


# -- module-level conveniences (what the owners call) ----------------------

def set_entry(scope: str, owner: str, kind: str, nbytes: float,
              placement: str = "device",
              detail: Optional[dict] = None) -> None:
    instance().set_entry(scope, owner, kind, nbytes,
                         placement=placement, detail=detail)


def register_provider(scope: str,
                      fn: Callable[[], Optional[dict]]) -> None:
    instance().register_provider(scope, fn)


def remove_scope(scope: str) -> int:
    return instance().remove_scope(scope)


def memz_payload() -> dict:
    return instance().payload()


def status_summary() -> dict:
    return instance().status_summary()


def maybe_dump_oom(exc: BaseException,
                   component: str = "") -> Optional[str]:
    """The error-path hook hot loops call on every caught exception:
    one flag check when disabled, a string match when enabled, a
    flight dump when the error is an OOM."""
    if not _ENABLED:
        return None
    return instance().maybe_dump_oom(exc, component=component)
