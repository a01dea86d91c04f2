"""Engine replicas: the router's uniform view of one serving engine.

A replica is anything with the small ``submit/health/cancel`` surface
below — the router neither knows nor cares whether the engine runs in
this process or behind an HTTP endpoint three hosts away:

- :class:`LocalReplica` — wraps an in-process :class:`LLMEngine`
  (tests, benches, single-host multi-engine layouts).
- :class:`HTTPReplica` — wraps a remote ``serve_llm`` endpoint plus
  its debug server's ``/healthz``; maps the pinned HTTP error contract
  (429/503/504/499) back to the typed exceptions, and maps transport
  failures (connection refused/reset — the crashed-replica signature)
  to :class:`ReplicaUnavailable`, the one error the router treats as
  "fail over and charge the breaker".
- :func:`spawn_replica` / ``python -m paddle_tpu_torch.serving.replica`` —
  a self-contained replica subprocess for the fleet chaos soak and
  local scale-out: builds a model from a JSON spec, serves it, exposes
  the debug surface, registers TCPStore membership, and honors an
  injected ``replica.crash`` fault by dying hard (``os._exit``), the
  way a SIGKILL would take it.

All replicas in a fleet must be built from the same model weights and
engine ``seed`` for failover to be token-identical (the router pins
each request's sampling nonce; see ``LLMEngine.submit(nonce=)``).
"""

from __future__ import annotations

import collections
import hashlib
import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

import torch

from ..inference.llm import (AdmissionShed, AdmissionTimeout,
                             RequestCancelled)
from ..reliability.retry import DeadlineExceeded


class ReplicaUnavailable(RuntimeError):
    """The replica could not be reached or died mid-request
    (connection refused/reset, empty response, unexpected 5xx). The
    router's verdict for this error: charge the circuit breaker and
    fail the request over to a sibling."""


class LocalReplica:
    """In-process replica over an ``LLMEngine`` (or anything with its
    submit/cancel/health surface)."""

    def __init__(self, engine):
        self.engine = engine

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               deadline_s: Optional[float] = None, priority: int = 0,
               nonce: Optional[int] = None, trace_context=None,
               tenant: Optional[str] = None) -> dict:
        kw = {}
        if tenant is not None:
            # passed only when set so bare submit/cancel stubs (and
            # older engines) keep working tenant-less
            kw["tenant"] = tenant
        fut = self.engine.submit(
            prompt_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, deadline=deadline_s,
            priority=priority, nonce=nonce,
            trace_context=trace_context, **kw)
        out = fut.result(timeout=600)
        out["request_id"] = fut.request_id
        return out

    def health(self) -> Optional[str]:
        if getattr(self.engine, "_closed", False):
            return None
        return self.engine.health

    # an in-process engine's metrics already live in this process's
    # registry — federating them again would double every series in
    # the same /metrics scrape, so local replicas OPT OUT of the
    # FleetScraper (absent from federation, never marked down; they
    # still appear in /fleetz via the router's own per-replica state)
    metrics_opt_out = True

    def metrics_text(self) -> Optional[str]:
        return None

    def cancel(self, request_id: int) -> bool:
        return self.engine.cancel(request_id)

    # KV-page migration (disaggregated fleet): direct handoff to the
    # engine's export/import surface — the same payload the HTTP
    # /kv_pages endpoint carries, minus the serialization hop
    def export_pages(self, digests, trace_context=None) -> dict:
        return self.engine.export_pages(digests)

    def import_pages(self, payload: dict, trace_context=None) -> dict:
        return self.engine.import_pages(payload)

    def close(self) -> None:
        pass   # the engine's owner closes it


class HTTPReplica:
    """Remote replica behind ``serve_llm`` + debug-server endpoints.

    ``generate_url`` is the ``serve_llm`` base (POST /generate,
    POST /cancel); ``healthz_url`` the debug server's /healthz;
    ``metrics_url`` its /metrics (derived from ``healthz_url`` when
    not given — both live on the same debug server)."""

    def __init__(self, generate_url: str, healthz_url: str,
                 timeout: float = 600.0,
                 metrics_url: Optional[str] = None):
        self.generate_url = generate_url.rstrip("/")
        self.healthz_url = healthz_url
        self.metrics_url = metrics_url or (
            healthz_url.rsplit("/healthz", 1)[0] + "/metrics")
        self.timeout = float(timeout)

    def _post(self, path: str, body: dict, timeout: float,
              trace_context=None):
        from urllib.error import HTTPError, URLError
        from urllib.request import Request, urlopen
        headers = {"Content-Type": "application/json"}
        if trace_context is not None:
            # cross-process propagation: the caller's span identity
            # rides the W3C header; a disabled-tracing caller's noop
            # context formats to None and no header is sent
            from ..observability import propagation as _prop
            tp = _prop.format_traceparent(trace_context)
            if tp is not None:
                headers[_prop.TRACEPARENT_HEADER] = tp
        req = Request(self.generate_url + path,
                      data=json.dumps(body).encode(),
                      headers=headers)
        try:
            with urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read() or b"{}")
        except HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except ValueError:
                payload = {}
            # backpressure contract: a shedding replica's
            # Retry-After header names its cooldown. Captured into
            # the payload (headers win over any body field — the
            # header is the standard surface) so submit() can attach
            # it to the typed verdict and the router can honor it
            # instead of blind-retrying into the same shed.
            ra = e.headers.get("Retry-After") if e.headers else None
            if ra is not None:
                try:
                    payload["retry_after_s"] = float(ra)
                except ValueError:
                    pass      # a malformed header is no header
            return e.code, payload
        except (URLError, OSError, ValueError) as e:
            # connection refused/reset, truncated response: the
            # crashed-or-vanished replica signature
            raise ReplicaUnavailable(
                f"replica at {self.generate_url} unreachable: "
                f"{e}") from e

    def submit(self, prompt_ids, max_new_tokens=32, temperature=0.0,
               deadline_s: Optional[float] = None, priority: int = 0,
               nonce: Optional[int] = None, trace_context=None,
               tenant: Optional[str] = None) -> dict:
        body = {"prompt_ids": list(map(int, prompt_ids)),
                "max_new_tokens": int(max_new_tokens),
                "temperature": float(temperature),
                "priority": int(priority)}
        if deadline_s is not None:
            body["deadline_s"] = float(deadline_s)
        if nonce is not None:
            body["nonce"] = int(nonce)
        if tenant is not None:
            # served-FLOPs attribution label on the replica engine
            body["tenant"] = str(tenant)
        # the HTTP wait must outlive the request's own deadline so the
        # typed 504 arrives instead of a transport timeout
        timeout = self.timeout if deadline_s is None \
            else min(self.timeout, float(deadline_s) + 30.0)
        code, out = self._post("/generate", body, max(timeout, 1.0),
                               trace_context=trace_context)
        if code == 200:
            return out
        err = out.get("error", f"HTTP {code}")
        if code == 429:
            exc = AdmissionShed(err,
                                reason=out.get("reason") or "queue_full")
            # the replica's cooldown rides the verdict: the router's
            # dispatch loop reads it off the exception and keeps the
            # replica out of _route until it expires
            exc.retry_after_s = out.get("retry_after_s")
            raise exc
        if code == 503:
            exc = AdmissionShed(err, reason="draining")
            exc.retry_after_s = out.get("retry_after_s")
            raise exc
        if code == 504:
            raise DeadlineExceeded(err)
        if code == 499:
            raise RequestCancelled(err)
        if code == 400:
            raise ValueError(err)
        raise ReplicaUnavailable(
            f"replica at {self.generate_url} returned HTTP {code}: "
            f"{err}")

    def health(self, timeout: float = 2.0) -> Optional[str]:
        """"healthy"/"degraded"/"draining", or None when unreachable
        (the caller decides what unreachable means — the router
        charges the breaker)."""
        from urllib.error import HTTPError, URLError
        from urllib.request import urlopen
        try:
            with urlopen(self.healthz_url, timeout=timeout) as r:
                body = json.loads(r.read() or b"{}")
        except HTTPError as e:
            if e.code == 503:   # draining flips /healthz to 503
                try:
                    body = json.loads(e.read() or b"{}")
                except ValueError:
                    body = {}
                return body.get("status", "draining")
            return None
        except (URLError, OSError, ValueError):
            return None
        status = body.get("status", "healthy")
        return "healthy" if status == "ok" else status

    def metrics_text(self, timeout: float = 2.0) -> Optional[str]:
        """Scrape the replica's Prometheus text exposition, or None
        when unreachable (the FleetScraper marks the replica down and
        keeps its last-known series out of the federated view)."""
        from urllib.error import HTTPError, URLError
        from urllib.request import urlopen
        try:
            with urlopen(self.metrics_url, timeout=timeout) as r:
                return r.read().decode("utf-8", "replace")
        except (HTTPError, URLError, OSError, ValueError):
            return None

    def cancel(self, request_id: int, trace_context=None) -> bool:
        try:
            code, out = self._post("/cancel",
                                   {"request_id": int(request_id)}, 10.0,
                                   trace_context=trace_context)
        except ReplicaUnavailable:
            return False
        return bool(out.get("cancelled")) if code == 200 else False

    def _kv_pages(self, body: dict, trace_context=None) -> dict:
        code, out = self._post("/kv_pages", body, 60.0,
                               trace_context=trace_context)
        if code == 200:
            return out
        err = out.get("error", f"HTTP {code}")
        if code == 503:
            raise AdmissionShed(err, reason="draining")
        if code == 400:
            raise ValueError(err)
        # 404 (no KV surface), 500 (injected transfer fault), and any
        # other 5xx: the migrate step's fallback-to-recompute signal
        raise ReplicaUnavailable(
            f"replica at {self.generate_url} /kv_pages failed "
            f"(HTTP {code}): {err}")

    def export_pages(self, digests, trace_context=None) -> dict:
        hexes = [d if isinstance(d, str) else d.hex() for d in digests]
        return self._kv_pages({"digests": hexes},
                              trace_context=trace_context)

    def import_pages(self, payload: dict, trace_context=None) -> dict:
        return self._kv_pages({"payload": payload},
                              trace_context=trace_context)

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# spawnable replica subprocess (fleet chaos soak / local scale-out)
# ---------------------------------------------------------------------------

READY_MARK = "REPLICA_READY "


def build_net_from_spec(spec: dict):
    """A small GPT from a JSON-able spec — the one model constructor
    the replica subprocess, the fleet's parent process and the tests
    share, so "same weights on every replica" is true by construction:
    parameters are drawn on the CPU from ``paddle_tpu_torch.seed``
    (``model_seed``) and then moved to the spec's ``device`` (the GPU
    unless it says ``"cpu"``), so two builds agree bit for bit in two
    processes and on the CPU and the card alike."""
    from ..core.rng import seed
    from ..models.gpt import GPTForCausalLM, gpt_config
    seed(int(spec.get("model_seed", 0)))
    cfg = gpt_config(
        "gpt2-small",
        num_layers=int(spec.get("layers", 2)),
        hidden_size=int(spec.get("hidden", 64)),
        num_heads=int(spec.get("heads", 4)),
        vocab_size=int(spec.get("vocab", 97)),
        max_position_embeddings=int(spec.get("max_pos", 96)),
        hidden_dropout=0.0, attention_dropout=0.0)
    return GPTForCausalLM(cfg, device=spec.get("device"))


def make_engine_from_spec(spec: dict):
    from ..inference.llm import LLMEngine
    net = build_net_from_spec(spec)
    ekw = dict(spec.get("engine", {}))
    ekw.setdefault("max_seqs", 4)
    ekw.setdefault("page_size", 4)
    ekw.setdefault("num_pages", 96)
    ekw.setdefault("prefill_buckets", (16,))
    ekw.setdefault("seed", 0)
    return LLMEngine(net, device=spec.get("device"), **ekw)


def state_digest(net) -> str:
    """BLAKE2b over the model's state dict (names, dtypes, shapes and
    bytes, in order): two replicas with one digest hold the same
    weights, whatever process or device they run on."""
    h = hashlib.blake2b(digest_size=16)
    for k, v in net.state_dict().items():
        t = v.detach().cpu().contiguous()
        h.update(f"{k}:{t.dtype}:{tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def device_name(eng) -> str:
    """The card's name (``torch.cuda.get_device_name``) of the engine's
    device, or ``"cpu"``."""
    if eng.device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(eng.device)


def kernel_status(eng) -> dict:
    """The ``kernels`` status provider of a replica process: its device,
    kernel B4's launches in this process and the engine's paged forward
    passes. B4 launches once a layer per pass, so a replica that served
    on the kernel shows ``paged_attention_launches == layers x
    dispatched_ticks + draft_layers x draft_passes``."""
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    draft = getattr(eng, "draft_net", None)
    return {"device": device_name(eng),
            "paged_attention_launches": pa.launches,
            "layers": eng.net.cfg.num_layers,
            "dispatched_ticks": eng.n_dispatched_ticks,
            "draft_layers": draft.cfg.num_layers if draft else 0,
            "draft_passes": eng.n_draft_passes}


def _arm_faults(spec: dict) -> None:
    if not spec.get("faults"):
        return
    from ..reliability import faults
    faults.reset()
    faults.enable(seed=int(spec["faults"].get("seed", 0)))
    for rule in spec["faults"].get("rules", ()):
        faults.inject(rule["site"],
                      nth=rule.get("nth"), p=rule.get("p"),
                      times=rule.get("times"))


def replica_main(spec: dict) -> int:
    """Subprocess body: engine + serve_llm + debug server + optional
    TCPStore membership, announced on stdout as one READY line.

    Observability knobs in the spec:

    - ``tracing``: truthy → enable the span table (off by default,
      same one-flag-check discipline as everywhere else) so the
      router's traceparent headers land in a real tree and
      ``/tracez?trace_id=`` answers cross-process queries.
    - ``obs_dir``: base directory for this replica's observability
      artifacts — the flight recorder dumps to
      ``<obs_dir>/<name>/`` and a JSONL metrics reporter appends to
      ``<obs_dir>/<name>/metrics.jsonl``. Without it, K spawned
      replicas sharing a cwd scatter (and with unlucky pids, collide)
      their dumps where no soak can collect them; with it, the fleet
      chaos soak collects every replica's dumps from one tree.

    The engine runs on the spec's ``device`` (the GPU unless it says
    ``"cpu"``); with no card a GPU replica raises before READY. The
    READY record names the device, and the debug server's ``/statusz``
    carries a ``kernels`` provider (:func:`kernel_status`).
    """
    from ..inference.llm import serve_llm
    from ..observability import server as debug
    from ..observability import tracing
    from ..reliability import faults
    from ..reliability.faults import FaultInjected

    name = spec.get("name", f"replica-{os.getpid()}")
    if spec.get("tracing"):
        tracing.enable()
    # GRACEFUL TERMINATE — the planned-departure path beside the
    # ``replica.crash`` site: SIGTERM/SIGINT set a stop event and the
    # main loop runs the same orderly teardown a clean exit would
    # (membership LEAVES the roster, engine closes, server stops).
    # Registered BEFORE the flight recorder installs its own SIGTERM
    # hook so a dump-then-chain still lands here: a preempted replica
    # dumps its flight record AND departs cleanly.
    stop_evt = threading.Event()

    def _graceful(signum, frame):  # noqa: ARG001 — signal signature
        stop_evt.set()

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:
        pass   # not the main thread (embedded use): kill paths only
    reporter = None
    if spec.get("obs_dir"):
        from ..observability import flight
        from ..observability.exporters import JSONLReporter
        my_dir = os.path.join(spec["obs_dir"], name)
        os.makedirs(my_dir, exist_ok=True)
        flight.install_flight_recorder(my_dir)
        reporter = JSONLReporter(
            os.path.join(my_dir, "metrics.jsonl"),
            interval=float(spec.get("jsonl_interval", 2.0)))
    _arm_faults(spec)
    eng = make_engine_from_spec(spec)
    # drift verdicts this engine records (device-retry prefix checks)
    # key the /driftz table by the replica's fleet name, not "engine"
    eng.audit_scope = name
    srv = serve_llm(eng)
    host, port = srv.server_address[:2]
    dbg = debug.start_debug_server()
    # the proof that this process serves on the kernel: B4's launch
    # counter lives here, so the parent reads it from /statusz
    debug.register_status_provider("kernels",
                                   lambda: kernel_status(eng))
    info = {"name": name,
            "generate": f"http://{host}:{port}",
            "healthz": f"{dbg.address}/healthz",
            "metrics": f"{dbg.address}/metrics",
            "tracez": f"{dbg.address}/tracez",
            "driftz": f"{dbg.address}/driftz",
            "pid": os.getpid(),
            "device": device_name(eng),
            "state_digest": state_digest(eng.net)}
    if spec.get("role"):
        # disaggregated pool membership ("prefill" / "decode"): rides
        # the roster record so the router's membership sync attaches
        # this replica to the right pool
        info["role"] = str(spec["role"])
    member = None
    if spec.get("store"):
        from ..distributed.tcp_store import TCPMembership
        member = TCPMembership(spec["store"], name, info,
                               beat_interval=float(
                                   spec.get("beat_interval", 0.2)))
    print(READY_MARK + json.dumps(info), flush=True)
    try:
        while not stop_evt.is_set():
            time.sleep(0.05)
            if faults.enabled():
                try:
                    faults.check("replica.crash")
                except FaultInjected:
                    # die the way a SIGKILL would: no cleanup, no
                    # goodbye — the fleet must absorb exactly this
                    os._exit(137)
    except KeyboardInterrupt:
        pass
    finally:
        if member is not None:
            # planned departure: LEAVE the roster (delete the record)
            # so the router's membership sync sees this replica gone
            # on its next poll, not after stale_after — a scale-in
            # must not race a re-attach of the replica it just ended
            member.leave()
        if reporter is not None:
            reporter.stop()
        eng.close()
        srv.shutdown()
    return 0


def terminate_replica(proc, timeout: float = 15.0) -> Optional[int]:
    """Graceful terminate for a spawned replica — the scale-in path
    beside the crash site: SIGTERM (the replica leaves membership,
    closes its engine, stops serving), a bounded wait, then SIGKILL
    escalation for a wedged child. Returns the exit code (None only
    if even the SIGKILL wait timed out)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
    return proc.poll()


def spawn_replica(spec: dict, timeout: float = 120.0,
                  env: Optional[dict] = None):
    """Spawn ``python -m paddle_tpu_torch.serving.replica`` and wait for
    its READY line. Returns ``(Popen, info_dict)``; the caller owns the
    process (SIGKILL it, wait() it). The child inherits the
    environment (``CUDA_VISIBLE_DEVICES`` included); a child that exits
    before READY raises :class:`ReplicaUnavailable` with the tail of its
    stderr."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    child_env = dict(os.environ, PYTHONPATH=repo)
    if env:
        child_env.update(env)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
         json.dumps(spec)],
        env=child_env, cwd=repo, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    err_tail = collections.deque(maxlen=20)

    def _pump_stderr():
        for line in proc.stderr:
            err_tail.append(line.rstrip())

    pump = threading.Thread(target=_pump_stderr, daemon=True)
    pump.start()
    # the READY wait must hold its deadline even while BLOCKED in
    # readline (a child wedged mid-start writes nothing): a daemon
    # reader thread signals through an Event the caller waits on with
    # the real budget
    found = {}
    ready = threading.Event()

    def _read_stdout():
        for line in proc.stdout:
            if line.startswith(READY_MARK):
                found["info"] = json.loads(line[len(READY_MARK):])
                ready.set()
                break
        ready.set()          # EOF: child exited before READY
        for _ in proc.stdout:
            pass             # keep draining so the child never blocks

    threading.Thread(target=_read_stdout, daemon=True).start()
    if not ready.wait(timeout):
        proc.kill()
        proc.wait(timeout=30)
        raise TimeoutError(
            f"replica {spec.get('name')} not READY in {timeout}s")
    if "info" not in found:
        rc = proc.wait(timeout=30)
        pump.join(timeout=5)
        raise ReplicaUnavailable(
            f"replica {spec.get('name')} exited before READY "
            f"(rc={rc}): " + " | ".join(err_tail))
    return proc, found["info"]


if __name__ == "__main__":
    sys.exit(replica_main(json.loads(sys.argv[1])))
