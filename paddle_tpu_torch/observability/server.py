"""Live debug server: scrape + inspect a running job over HTTP.

The reference's PS-mode jobs were scraped ad hoc (monitor.h stats read
out-of-band); serving/training jobs here get a first-class surface — a
stdlib ``http.server`` on a daemon thread, safe to leave on in
production (read-mostly; the mutating endpoints arm a bounded
profiler window and reset health):

- ``GET /metrics``  — Prometheus text exposition 0.0.4 (the scrape).
- ``GET /healthz``  — liveness: ``{"status": "ok", "uptime_s": ...}``.
- ``GET /statusz``  — JSON job state: every registered status
  provider (LLM engines report occupancy/prefix-cache/queue state,
  ``hapi.Model`` reports train-loop state), plus device memory via
  ``sample_device_memory()``.
- ``GET /tracez``   — recent finished spans + currently-live spans
  from the tracing table (``?limit=N`` newest first, 0 = uncapped;
  ``?trace_id=`` filters to one request's spans — the cross-process
  query the fleet trace merge and operators use). Spans carry
  ``ts_wall`` so snapshots from different processes align.
- ``GET /perfz``    — live roofline view (observability.perf): MFU /
  HBM-bandwidth-utilization / FLOPs-rate over a sliding window, the
  per-program cost table (analytic FLOPs + bytes per program signature),
  and the step-time breakdown per component (train dispatch vs
  compile vs drain; llm decode vs prefill).
- ``GET /memz``     — the HBM attribution ledger
  (observability.memory): per-owner table (model trees, KV pool split
  free/private/prefix-shared, checkpoint staging), reconciled against
  ``torch.cuda.memory_stats()`` with an explicit unattributed residual,
  per-phase high-watermarks, and the "KV pages addable" headroom
  estimate.
- ``GET /goodputz`` — the wall-clock time ledger
  (observability.goodput): every second since arming attributed to
  one bucket (productive / compile / input_wait / ckpt_stall /
  recovery / shed / queue_wait / host_gap) with an explicit
  unattributed closing line, the goodput fraction, the top badput
  cause, and SLO-trip watermark forensics.
- ``GET /fleetz``   — fleet view (registered by a serving Router):
  per-replica health/breaker/scrape digest + computed aggregates;
  404 when this process fronts no fleet.
- ``GET /sloz``     — SLO report (registered SLOTracker): per-class
  burn rates, deadline hit ratios, breach latches; 404 when none.
- ``GET /scalez``   — autoscaler view (registered by a serving
  Autoscaler): config, damping state, live fleet load, and the
  bounded decision log (inputs → action + reason); 404 when none.
- ``GET /overloadz`` — overload brownout controller view (registered
  by a Router constructed with ``overload=``): ladder level + bounded
  transition log, AIMD per-replica limits, estimator state, shed
  counts by reason; 404 when none.
- ``POST /profilez`` — arm an on-demand profiler window:
  ``{"duration_s": 5, "log_dir": "/tmp/prof"}`` starts a
  ``profiler.Profiler`` on a thread of its own (the card's kernels of
  the whole process in one torch.profiler trace under ``log_dir``) and
  stops it after the window; 409 while one is armed or while the job's
  own Profiler records. ``GET /profilez`` shows the armed window.
- ``POST /reset_health`` — invoke registered reset handlers (an
  engine's ``reset_health()``, the fleet router's breaker reset);
  body ``{"name": ...}`` targets one, empty body resets all; 404
  when no engine/router is registered in this process.

Components self-register status providers (weakly — a dead engine
disappears from /statusz instead of raising)::

    from paddle_tpu_torch.observability import server as debug
    debug.register_status_provider("my_component", lambda: {...})
    srv = debug.start_debug_server(port=0)   # ephemeral port
    srv.port
"""

from __future__ import annotations

import json
import threading
import time
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from . import goodput as _goodput
from . import memory as _mem
from . import perf as _perf
from . import tracing
from .exporters import prometheus_text, sample_device_memory
from .metrics import MetricRegistry, default_registry

# name → callable returning a JSON-able dict (or None to be skipped —
# the convention weakref-closures use once their referent dies)
_providers: Dict[str, Callable[[], Optional[dict]]] = {}
_providers_mu = threading.Lock()

# name → callable returning a health STATE string ("healthy"/"ok",
# "degraded", "draining") or None once the component is gone. /healthz
# aggregates these: any draining component flips the endpoint to 503
# so a load balancer stops routing to this process (the LLM engine's
# health state machine registers here — docs/RELIABILITY.md).
_health_providers: Dict[str, Callable[[], Optional[str]]] = {}
_HEALTH_RANK = {"ok": 0, "healthy": 0, "degraded": 1, "draining": 2}

# name → zero-arg reset callable (LLMEngine.reset_health, the fleet
# router's breaker reset). POST /reset_health invokes them — the
# operator escape hatch reachable without a Python shell: a drained
# engine (sticky health latch) or a stuck-open breaker is recovered
# with one curl instead of an attach-and-poke.
_reset_handlers: Dict[str, Callable[[], None]] = {}

# name → callable returning extra Prometheus exposition text appended
# to /metrics (or None once the component is gone). The fleet router's
# FleetScraper re-exports replica series through this — federation
# rides the same scrape operators already have pointed at /metrics.
_scrape_providers: Dict[str, Callable[[], Optional[str]]] = {}

# name → callable returning the /fleetz JSON payload (per-replica
# state + aggregates); registered by a fleet router. 404 when empty —
# this process fronts no fleet.
_fleet_providers: Dict[str, Callable[[], Optional[dict]]] = {}

# name → callable returning the /sloz JSON payload (SLOTracker.report)
_slo_providers: Dict[str, Callable[[], Optional[dict]]] = {}

# name → callable returning the /scalez JSON payload (the serving
# Autoscaler's decision log + config + live load view). 404 when empty
# — no autoscaler runs in this process.
_scale_providers: Dict[str, Callable[[], Optional[dict]]] = {}

# name → callable returning the /overloadz JSON payload (the overload
# controller's ladder level, bounded transition log, AIMD limits,
# estimator state, shed counts). 404 when empty — no controller is
# bound in this process.
_overload_providers: Dict[str, Callable[[], Optional[dict]]] = {}

# name → callable returning the /driftz JSON payload (stream-integrity
# chain tables: verified/diverged counts + last divergence per scope).
# The audit module self-registers at first record; 404 when empty —
# nothing in this process has audited a stream yet (hole, not zero).
_drift_providers: Dict[str, Callable[[], Optional[dict]]] = {}

_server: Optional["DebugServer"] = None
_server_mu = threading.Lock()


def register_status_provider(name: str,
                             fn: Callable[[], Optional[dict]]) -> None:
    with _providers_mu:
        _providers[name] = fn


def unregister_status_provider(name: str) -> None:
    with _providers_mu:
        _providers.pop(name, None)


def register_health_provider(name: str,
                             fn: Callable[[], Optional[str]]) -> None:
    with _providers_mu:
        _health_providers[name] = fn


def unregister_health_provider(name: str) -> None:
    with _providers_mu:
        _health_providers.pop(name, None)


def register_reset_handler(name: str,
                           fn: Callable[[], None]) -> None:
    with _providers_mu:
        _reset_handlers[name] = fn


def unregister_reset_handler(name: str) -> None:
    with _providers_mu:
        _reset_handlers.pop(name, None)


def register_scrape_provider(name: str,
                             fn: Callable[[], Optional[str]]) -> None:
    with _providers_mu:
        _scrape_providers[name] = fn


def unregister_scrape_provider(name: str) -> None:
    with _providers_mu:
        _scrape_providers.pop(name, None)


def register_fleet_provider(name: str,
                            fn: Callable[[], Optional[dict]]) -> None:
    with _providers_mu:
        _fleet_providers[name] = fn


def unregister_fleet_provider(name: str) -> None:
    with _providers_mu:
        _fleet_providers.pop(name, None)


def register_slo_provider(name: str,
                          fn: Callable[[], Optional[dict]]) -> None:
    with _providers_mu:
        _slo_providers[name] = fn


def unregister_slo_provider(name: str) -> None:
    with _providers_mu:
        _slo_providers.pop(name, None)


def register_scale_provider(name: str,
                            fn: Callable[[], Optional[dict]]) -> None:
    with _providers_mu:
        _scale_providers[name] = fn


def unregister_scale_provider(name: str) -> None:
    with _providers_mu:
        _scale_providers.pop(name, None)


def register_overload_provider(name: str,
                               fn: Callable[[], Optional[dict]]
                               ) -> None:
    with _providers_mu:
        _overload_providers[name] = fn


def unregister_overload_provider(name: str) -> None:
    with _providers_mu:
        _overload_providers.pop(name, None)


def register_drift_provider(name: str,
                            fn: Callable[[], Optional[dict]]) -> None:
    with _providers_mu:
        _drift_providers[name] = fn


def unregister_drift_provider(name: str) -> None:
    with _providers_mu:
        _drift_providers.pop(name, None)


def _collect_dict_providers(table: Dict[str, Callable[[], Optional[dict]]]
                            ) -> Dict[str, dict]:
    """Shared collection discipline for dict-returning provider
    registries: a raising provider reports its error, a None return
    self-unregisters (the weakref-closure convention)."""
    with _providers_mu:
        items = list(table.items())
    out: Dict[str, dict] = {}
    dead = []
    for name, fn in items:
        try:
            d = fn()
        except Exception as e:  # noqa: BLE001 — one bad provider
            out[name] = {"error": str(e)}
            continue
        if d is None:
            dead.append(name)
        else:
            out[name] = d
    if dead:
        with _providers_mu:
            for name in dead:
                table.pop(name, None)
    return out


def _collect_health() -> Dict[str, str]:
    with _providers_mu:
        items = list(_health_providers.items())
    out: Dict[str, str] = {}
    dead = []
    for name, fn in items:
        try:
            st = fn()
        except Exception as e:  # noqa: BLE001 — a broken provider is
            out[name] = f"error: {e}"      # itself a degraded signal
            continue
        if st is None:
            dead.append(name)
        else:
            out[name] = str(st)
    if dead:
        with _providers_mu:
            for name in dead:
                _health_providers.pop(name, None)
    return out


def _collect_status() -> Dict[str, dict]:
    with _providers_mu:
        items = list(_providers.items())
    out: Dict[str, dict] = {}
    dead = []
    for name, fn in items:
        try:
            d = fn()
        except Exception as e:  # noqa: BLE001 — one bad provider
            out[name] = {"error": str(e)}   # must not kill /statusz
            continue
        if d is None:
            dead.append(name)
        else:
            out[name] = d
    for name in dead:
        unregister_status_provider(name)
    return out


class _ProfilerArm:
    """One on-demand profiler window at a time. A torch.profiler session
    must stop on the thread that started it, so each window runs on a
    thread of its own: start, wait out the window, stop."""

    def __init__(self):
        self._mu = threading.Lock()
        self._active: Optional[dict] = None

    def arm(self, duration_s: float, log_dir: str) -> Optional[dict]:
        from .. import profiler as prof_mod
        with self._mu:
            if self._active is not None:
                return None
            if prof_mod._events.active:
                # the job already has its own Profiler recording;
                # starting another would CLEAR the process-wide event
                # tables (Profiler.start) and then disable them on the
                # window's stop — silently emptying the user's trace
                return None
            prof = prof_mod.Profiler(log_dir=log_dir)
            started = threading.Event()
            ok = []

            def window():
                try:
                    prof.start()
                except RuntimeError:
                    # another torch.profiler session holds the
                    # process's one kineto slot: refuse like an armed
                    # window
                    prof.stop()
                    started.set()
                    return
                ok.append(True)
                started.set()
                time.sleep(max(float(duration_s), 0.01))
                try:
                    prof.stop()
                finally:
                    with self._mu:
                        self._active = None

            threading.Thread(target=window, name="profilez-window",
                             daemon=True).start()
            started.wait()
            if not ok:
                return None
            info = {"armed_at": time.time(),
                    "duration_s": float(duration_s),
                    "log_dir": os.path.abspath(log_dir)}
            self._active = info
            return dict(info)

    def status(self) -> Optional[dict]:
        with self._mu:
            return dict(self._active) if self._active else None


class DebugServer:
    """The HTTP front. ``port=0`` binds an ephemeral port (tests and
    multi-job hosts); ``.port`` reads the bound one."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 registry: Optional[MetricRegistry] = None):
        self.registry = registry or default_registry()
        self.t_start = time.time()
        self._arm = _ProfilerArm()
        # /statusz device-memory sample cache: a scrape storm must not
        # hammer memory_stats() on every request (1s TTL; errors are
        # cached too — a raising backend hurts just as much).
        # Deliberately separate from MemoryLedger's 1s stats cache:
        # this row is the RAW per-device dict (and sets the
        # device_memory_bytes gauges), the ledger's is the summed
        # reconcile aggregate — two shapes, each bounded to one
        # memory_stats() sweep per second
        self._devmem_cache: tuple = (0.0, None)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes,
                       ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, payload) -> None:
                self._reply(code, json.dumps(
                    payload, default=str).encode())

            def do_GET(self):
                try:
                    outer._get(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    try:
                        self._reply_json(500, {"error": str(e)})
                    except Exception:  # noqa: BLE001
                        pass

            def do_POST(self):
                try:
                    outer._post(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001
                    try:
                        self._reply_json(500, {"error": str(e)})
                    except Exception:  # noqa: BLE001
                        pass

            def log_message(self, *a):   # debug surface: stay quiet
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    # -- endpoint logic (kept on the server object for testability) -----
    def _get(self, h) -> None:
        url = urlparse(h.path)
        if url.path == "/metrics":
            # refresh the live roofline gauges so a bare /metrics
            # scrape (the fleet federation path) carries current
            # perf_mfu/bw values without needing a /perfz hit first;
            # resolved costs only — a scrape never lowers a program
            if _perf.enabled():
                try:
                    _perf.instance().update_gauges()
                except Exception:  # noqa: BLE001 — scrape must answer
                    pass
            # same discipline for the memory ledger: mem_bytes /
            # mem_watermark_bytes / mem_headroom_pages refresh at the
            # read boundary so the fleet federation scrape carries
            # current attribution without a /memz hit first
            if _mem.enabled():
                try:
                    _mem.instance().update_gauges()
                except Exception:  # noqa: BLE001 — scrape must answer
                    pass
            # and the time ledger: goodput_fraction / badput counters
            # refresh at the read boundary (a never-armed ledger mints
            # nothing — the federation hole)
            if _goodput.enabled():
                try:
                    _goodput.instance().update_gauges()
                except Exception:  # noqa: BLE001 — scrape must answer
                    pass
            text = prometheus_text(self.registry)
            # registered scrape providers (fleet federation) append
            # their blocks; a broken provider must not kill the scrape
            with _providers_mu:
                extras = list(_scrape_providers.items())
            dead = []
            for name, fn in extras:
                try:
                    block = fn()
                except Exception:  # noqa: BLE001
                    continue
                if block is None:
                    dead.append(name)
                elif block:
                    text = text.rstrip("\n") + "\n" + block
            for name in dead:
                unregister_scrape_provider(name)
            h._reply(200, text.encode(),
                     ctype="text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/healthz":
            comp = _collect_health()
            worst = 0
            for st in comp.values():
                # unknown strings (incl. provider errors) read as
                # degraded: visibly unhealthy, still routable
                worst = max(worst, _HEALTH_RANK.get(st, 1))
            status = ("ok", "degraded", "draining")[worst]
            body = {
                "status": status,
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self.t_start, 3)}
            if comp:
                body["components"] = comp
            # draining → 503: tells the balancer to pull this process
            # out of rotation while in-flight work finishes
            h._reply_json(503 if worst >= 2 else 200, body)
        elif url.path == "/statusz":
            now = time.monotonic()
            ts, cached = self._devmem_cache
            if cached is not None and now - ts < 1.0:
                devmem = cached
            else:
                try:
                    devmem = sample_device_memory(self.registry)
                except Exception as e:  # noqa: BLE001 — no backend yet
                    devmem = {"error": str(e)}
                if not devmem:
                    # backends without memory_stats (CPU) used to show
                    # a misleading empty dict here: report the hole
                    # explicitly, with the documented host-RSS fallback
                    rss = _mem.host_rss_bytes()
                    devmem = {
                        "note": "no device exports memory_stats() on "
                                "this backend; host_rss_bytes is the "
                                "fallback gauge",
                        "host_rss_bytes": rss}
                self._devmem_cache = (now, devmem)
            try:
                perf_row = _perf.status_summary()
            except Exception as e:  # noqa: BLE001 — one bad row
                perf_row = {"error": str(e)}
            try:
                mem_row = _mem.status_summary()
            except Exception as e:  # noqa: BLE001 — one bad row
                mem_row = {"error": str(e)}
            try:
                goodput_row = _goodput.status_summary()
            except Exception as e:  # noqa: BLE001 — one bad row
                goodput_row = {"error": str(e)}
            h._reply_json(200, {
                "pid": os.getpid(),
                "uptime_s": round(time.time() - self.t_start, 3),
                "tracing_enabled": tracing.enabled(),
                "providers": _collect_status(),
                "device_memory": devmem,
                "perf": perf_row,
                "memory": mem_row,
                "goodput": goodput_row,
                "profilez": self._arm.status()})
        elif url.path == "/tracez":
            # ?limit=N caps the finished spans returned (0 = no cap);
            # ?trace_id= pulls ONE request's spans out of a busy
            # replica's 16384-span ring instead of shipping all of it.
            # Spans gain ts_wall so tools/trace_merge.py can align
            # snapshots from different processes on one timeline.
            q = parse_qs(url.query)
            limit = int(q.get("limit", ["256"])[0])
            trace_id = q.get("trace_id", [None])[0]
            live = tracing.live_spans()
            fin = tracing.finished_spans()
            total = len(fin)
            if trace_id:
                live = [s for s in live if s["trace_id"] == trace_id]
                fin = [s for s in fin if s["trace_id"] == trace_id]
            matched = len(fin)
            fin = list(reversed(fin))
            if limit > 0:
                fin = fin[:limit]
            wall = tracing.perf_to_wall
            h._reply_json(200, {
                "enabled": tracing.enabled(),
                "trace_id": trace_id,
                "live": [dict(s, ts_wall=wall(s["ts"])) for s in live],
                "finished": [dict(s, ts_wall=wall(s["ts"]))
                             for s in fin],
                "finished_matched": matched,
                "finished_total": total})
        elif url.path == "/perfz":
            # live roofline view: program cost registry (FLOPs/bytes
            # per compiled signature, resolved at most once each —
            # cost_model.ProgramCostCache), MFU / HBM-bw / FLOPs-rate
            # gauges over the sliding window, and the step-time
            # breakdown per component (docs/OBSERVABILITY.md "Perf
            # surfaces")
            h._reply_json(200, _perf.perfz_payload())
        elif url.path == "/goodputz":
            # the wall-clock attribution ledger: bucket table with its
            # explicit unattributed closing line, goodput fraction,
            # top badput cause, watermark/trip forensics
            # (docs/OBSERVABILITY.md "Goodput surfaces")
            h._reply_json(200, _goodput.goodputz_payload())
        elif url.path == "/memz":
            # the HBM attribution ledger: per-owner table + the
            # device reconciliation with its explicit unattributed
            # residual (docs/OBSERVABILITY.md "Memory surfaces").
            # The payload refreshes the mem_* gauges from its own
            # snapshot (ONE provider pass), so /memz and /metrics
            # never disagree within a read.
            h._reply_json(200, _mem.memz_payload())
        elif url.path == "/fleetz":
            fleets = _collect_dict_providers(_fleet_providers)
            if not fleets:
                h._reply_json(404, {
                    "error": "no fleet registered in this process "
                             "(the router registers one)"})
            else:
                h._reply_json(200, {"fleets": fleets})
        elif url.path == "/sloz":
            slos = _collect_dict_providers(_slo_providers)
            if not slos:
                h._reply_json(404, {
                    "error": "no SLO tracker registered in this "
                             "process (the router registers one)"})
            else:
                h._reply_json(200, {"slo": slos})
        elif url.path == "/scalez":
            scalers = _collect_dict_providers(_scale_providers)
            if not scalers:
                h._reply_json(404, {
                    "error": "no autoscaler registered in this "
                             "process (the serving Autoscaler "
                             "registers one)"})
            else:
                h._reply_json(200, {"autoscalers": scalers})
        elif url.path == "/overloadz":
            ctrls = _collect_dict_providers(_overload_providers)
            if not ctrls:
                h._reply_json(404, {
                    "error": "no overload controller bound in this "
                             "process (a Router with overload= "
                             "registers one)"})
            else:
                h._reply_json(200, {"overload": ctrls})
        elif url.path == "/driftz":
            drift = _collect_dict_providers(_drift_providers)
            if not drift:
                h._reply_json(404, {
                    "error": "no stream auditor armed in this "
                             "process (observability.audit "
                             "registers at first record)"})
            else:
                h._reply_json(200, {"drift": drift})
        elif url.path == "/profilez":
            h._reply_json(200, {"armed": self._arm.status()})
        else:
            h._reply_json(404, {
                "error": f"unknown path {url.path}",
                "endpoints": ["/metrics", "/healthz", "/statusz",
                              "/tracez", "/perfz", "/memz",
                              "/goodputz", "/fleetz", "/sloz",
                              "/scalez", "/overloadz", "/driftz",
                              "POST /profilez",
                              "POST /reset_health"]})

    def _post(self, h) -> None:
        url = urlparse(h.path)
        if url.path == "/reset_health":
            self._post_reset_health(h)
            return
        if url.path != "/profilez":
            h._reply_json(404, {"error": f"unknown path {url.path}"})
            return
        n = int(h.headers.get("Content-Length", 0))
        try:
            body = json.loads(h.rfile.read(n) or b"{}")
        except ValueError:
            h._reply_json(400, {"error": "malformed JSON body"})
            return
        duration = float(body.get("duration_s", 5.0))
        log_dir = body.get("log_dir") or os.path.join(
            ".", "paddle_tpu_profile_ondemand")
        info = self._arm.arm(duration, log_dir)
        if info is None:
            h._reply_json(409, {"error": "a profiler is already "
                                "recording (on-demand window or the "
                                "job's own Profiler)",
                                "armed": self._arm.status()})
        else:
            h._reply_json(200, {"armed": info})

    def _post_reset_health(self, h) -> None:
        """Operator escape hatch over HTTP: invoke the registered
        reset handlers (engine ``reset_health``, router breaker
        reset). Body ``{"name": ...}`` targets one handler; no body
        (or ``{}``) resets all. 404 when nothing is registered — the
        process has no engine/router to reset."""
        n = int(h.headers.get("Content-Length", 0))
        try:
            body = json.loads(h.rfile.read(n) or b"{}")
        except ValueError:
            h._reply_json(400, {"error": "malformed JSON body"})
            return
        with _providers_mu:
            handlers = dict(_reset_handlers)
        if not handlers:
            h._reply_json(404, {"error": "no engine registered"})
            return
        target = body.get("name")
        if target is not None:
            if target not in handlers:
                h._reply_json(404, {
                    "error": f"no reset handler named {target!r}",
                    "registered": sorted(handlers)})
                return
            handlers = {target: handlers[target]}
        done, errors = [], {}
        for name, fn in handlers.items():
            try:
                fn()
                done.append(name)
            except Exception as e:  # noqa: BLE001 — report, don't die
                errors[name] = str(e)
        out = {"reset": done}
        if errors:
            out["errors"] = errors
        h._reply_json(500 if errors and not done else 200, out)

    # -- lifecycle ------------------------------------------------------
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "DebugServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="pt-debug-server", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=10)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def start_debug_server(host: str = "127.0.0.1", port: int = 0,
                       registry: Optional[MetricRegistry] = None
                       ) -> DebugServer:
    """Process-wide singleton start (idempotent: returns the running
    server if one exists)."""
    global _server
    with _server_mu:
        if _server is None:
            _server = DebugServer(host=host, port=port,
                                  registry=registry).start()
        return _server


def get_debug_server() -> Optional[DebugServer]:
    return _server


def stop_debug_server() -> None:
    global _server
    with _server_mu:
        if _server is not None:
            _server.stop()
            _server = None
