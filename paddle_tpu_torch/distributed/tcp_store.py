"""Socket-backed key-value store: the serving fleet's membership.

- ``TCPStoreServer``: a tiny threaded key-value server. Values are
  JSON; every SET is stamped with SERVER receive time, so liveness
  ("age of this key") is judged on one clock: no cross-process clock
  skew in the heartbeat protocol.
- ``TCPStoreClient``: one request per connection. Transient failures
  are retried through the shared ``reliability.retry`` policy
  (exponential backoff + jitter), then raise ``StoreUnavailable``: the
  process hosting the store is gone. The legacy
  ``retries``/``retry_delay`` constructor kwargs are kept as aliases
  into the policy.
- ``TCPMembership``: a named, heartbeated info record per member; the
  fleet router lists the roster with server-judged ages.

Wire format: one JSON line request, one JSON line response, per
connection. Ops: set k v | get k | del k | ages prefix | list prefix.
"""

from __future__ import annotations

import json
import math
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Tuple

from ..reliability import faults as _faults
from ..reliability.faults import FaultInjected
from ..reliability.retry import (Deadline, DeadlineExceeded,
                                 RetryExhausted, RetryPolicy,
                                 as_deadline)


class StoreUnavailable(RuntimeError):
    """The store endpoint is gone (leader dead / never started)."""


class TCPStoreServer:
    """Threaded key-value server with server-side age stamping."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        self._data: Dict[str, Tuple[str, float]] = {}
        self._mu = threading.Lock()
        store = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    line = self.rfile.readline(1 << 20)
                    req = json.loads(line)
                    resp = store._dispatch(req)
                except Exception as e:  # noqa: BLE001 — protocol error
                    resp = {"ok": False, "error": str(e)[:200]}
                try:
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                except OSError:
                    pass  # client went away; its retry will re-ask

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = Server((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        now = time.monotonic()
        with self._mu:
            if op == "set":
                self._data[req["k"]] = (req["v"], now)
                return {"ok": True}
            if op == "get":
                ent = self._data.get(req["k"])
                if ent is None:
                    return {"ok": True, "v": None, "age": None}
                return {"ok": True, "v": ent[0], "age": now - ent[1]}
            if op == "del":
                # planned departure (serving scale-in): the key is
                # removed NOW instead of aging out at the observer's
                # stale_after — deleting an absent key is a no-op, so
                # withdraw races with crash-cleanup harmlessly
                return {"ok": True,
                        "existed": self._data.pop(req["k"], None)
                        is not None}
            if op == "ages":
                pref = req.get("prefix", "")
                return {"ok": True, "ages": {
                    k: now - t for k, (v, t) in self._data.items()
                    if k.startswith(pref)}}
            if op == "list":
                pref = req.get("prefix", "")
                return {"ok": True, "items": {
                    k: v for k, (v, t) in self._data.items()
                    if k.startswith(pref)}}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class TCPStoreClient:
    """``retries``/``retry_delay`` are kept as constructor aliases for
    the shared policy's attempt budget / base delay (callers predate
    ``reliability.retry``); pass ``policy=`` to override wholesale."""

    def __init__(self, endpoint: str, timeout: float = 5.0,
                 retries: int = 3, retry_delay: float = 0.3,
                 policy: Optional[RetryPolicy] = None):
        host, port = endpoint.rsplit(":", 1)
        self.addr = (host, int(port))
        self.timeout = timeout
        self.retries = retries
        self.retry_delay = retry_delay
        # ValueError is retryable here: a half-written response line
        # (server died mid-reply) surfaces as a json decode error.
        # FaultInjected too, so a default-exception chaos schedule at
        # store.socket exercises the same retry path an OSError would
        self.policy = policy or RetryPolicy(
            max_attempts=retries, base_delay=retry_delay,
            max_delay=max(8 * retry_delay, 2.0), jitter=0.5,
            retry_on=(OSError, ValueError, FaultInjected),
            scope="tcp_store")

    def _attempt(self, req: dict, deadline: Optional[Deadline]) -> dict:
        if _faults.enabled():
            _faults.check("store.socket")
        timeout = self.timeout if deadline is None \
            else max(deadline.clamp(self.timeout), 0.01)
        with socket.create_connection(self.addr, timeout=timeout) as s:
            s.sendall(json.dumps(req).encode() + b"\n")
            f = s.makefile("rb")
            resp = json.loads(f.readline(1 << 20))
        if not resp.get("ok"):
            # a protocol-level refusal is not a flaky socket: surface
            # it without burning the retry budget
            raise StoreUnavailable(resp.get("error", "store error"))
        return resp

    def request(self, req: dict, deadline=None) -> dict:
        dl = as_deadline(deadline)
        try:
            return self.policy.call(self._attempt, req, dl, deadline=dl,
                                    describe=f"store {req.get('op')}")
        except RetryExhausted as e:
            raise StoreUnavailable(
                f"rendezvous store at {self.addr} unreachable: "
                f"{e.last!r}") from e.last
        except DeadlineExceeded as e:
            # StoreUnavailable is THE documented failure contract —
            # every consumer (heartbeat loop, NodeAgent rendezvous-
            # lost mapping) catches exactly it; a caller deadline
            # expiring mid-retry must not escape as a different type
            raise StoreUnavailable(
                f"rendezvous store at {self.addr} unreachable before "
                f"deadline: {e}") from e


class TCPMembership:
    """Elastic membership over the rendezvous store: a member PUBLISHES
    a named info record (JSON) and re-SETs it on a heartbeat cadence;
    observers read the roster with server-judged ages, so "alive" is
    decided on the one clock the store already stamps. The serving
    fleet (``paddle_tpu_torch.serving``) uses this for replica discovery: a
    replica registers ``member.<name>`` → {endpoints...}, the router
    lists members and treats entries older than ``stale_after`` as
    departed — a SIGKILLed replica leaves the roster within one
    timeout, a restarted one re-registers under the same name with its
    new endpoints (last write wins)."""

    PREFIX = "member."

    def __init__(self, endpoint: str, name: str, info: dict,
                 beat_interval: float = 0.5,
                 client: Optional[TCPStoreClient] = None):
        self.name = name
        self.info = dict(info)
        self.client = client or TCPStoreClient(endpoint)
        self._beat_interval = beat_interval
        self._stop = threading.Event()
        self.announce()
        self._thread = threading.Thread(target=self._beat_loop,
                                        name=f"membership-{name}",
                                        daemon=True)
        self._thread.start()

    def announce(self) -> None:
        self.client.request({"op": "set", "k": self.PREFIX + self.name,
                             "v": json.dumps(self.info)})

    def _beat_loop(self) -> None:
        while not self._stop.wait(self._beat_interval):
            try:
                self.announce()
            except StoreUnavailable:
                # the store (router) being gone is the OBSERVER's
                # verdict to make; a member just keeps trying
                pass

    def stop(self) -> None:
        """Stop heartbeating (the entry ages out at the observer's
        ``stale_after`` — the path a crashed member takes too, since
        it couldn't deregister either). A PLANNED departure that must
        leave the roster immediately — a scale-in, where a lingering
        record would let the router re-attach a replica the autoscaler
        just killed — uses :meth:`leave` instead."""
        self._stop.set()
        self._thread.join(timeout=5)

    def leave(self) -> None:
        """Planned-departure deregistration: stop heartbeating AND
        delete the roster record, so observers see the member gone on
        their next poll instead of after ``stale_after``. Best-effort
        — a store that is already gone means nobody is watching the
        roster anyway."""
        self.stop()
        try:
            self.client.request({"op": "del",
                                 "k": self.PREFIX + self.name})
        except StoreUnavailable:
            pass

    @classmethod
    def withdraw(cls, client: TCPStoreClient, name: str) -> bool:
        """Remove ``name`` from the roster on the member's behalf —
        the autoscaler's backstop for a replica that died (or was
        killed) without running its own :meth:`leave`. Returns True
        when a record was actually deleted."""
        resp = client.request({"op": "del", "k": cls.PREFIX + name})
        return bool(resp.get("existed"))

    @classmethod
    def list_members(cls, client: TCPStoreClient,
                     stale_after: Optional[float] = None
                     ) -> Dict[str, dict]:
        """name → info for every member whose record is younger than
        ``stale_after`` (None: everyone ever registered)."""
        items = client.request(
            {"op": "list", "prefix": cls.PREFIX})["items"]
        if stale_after is not None:
            ages = client.request(
                {"op": "ages", "prefix": cls.PREFIX})["ages"]
            items = {k: v for k, v in items.items()
                     if ages.get(k, math.inf) <= stale_after}
        return {k[len(cls.PREFIX):]: json.loads(v)
                for k, v in items.items()}
