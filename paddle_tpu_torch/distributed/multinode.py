"""Multi-node job control: per-node agents over a shared rendezvous (the
port's counterpart of ``paddle_tpu/distributed/multinode.py``, the same
protocol: generations, hold-until-rejoin, the shared failure budget and
the budget-free exit 67).

Reference being replaced: the launch controllers' Pod/Container model
(python/paddle/distributed/launch/controllers/collective.py — one
controller per node builds a Pod of rank Containers from
PADDLE_TRAINERS_NUM / node rank, watches them, and participates in
job-level restart) and the etcd-backed cross-node elastic watcher
(fleet/elastic/manager.py:131 — TTL-leased node registrations; the
watcher maps live-node-count changes to HOLD/RESTART decisions).

Design: the platform scheduler owns node membership and reschedules
lost machines; what the framework must supply is
(a) a rendezvous that every node agrees on per generation, (b) whole-
node failure detection, and (c) HOLD-until-rejoin + restart-from-
checkpoint semantics. There is no etcd in the loop; the rendezvous
store is a shared directory (NFS/GCS-fuse on real pods, tmpdir in
tests) written with atomic renames — the same file-based decision the
single-host elastic manager records (elastic.py).

Layout of the rendezvous directory::

    rdzv.json          leader-published {generation, master, nnodes, …}
    agent.{n}          per-node-agent heartbeat (mtime = last beat)
    restart.g{G}.n{n}  node n requests a restart of generation G
                       (content: {"reason": "failure"|"preempt"|
                        "peer-lost", "code": rc})
    done.g{G}.n{n}     node n's ranks all completed generation G

Protocol per generation G (every agent runs the same loop):

1. G is derived, not negotiated: start at rdzv.json's generation (0 if
   absent) and step past every G that has a restart flag. Flags are
   monotone — all agents converge on the same G with no election.
2. The leader (node 0) publishes rdzv.json for G — with a FRESH master
   port (rendezvous rotation) — only once every agent heartbeat is
   fresh, which makes the whole job HOLD while a lost node is being
   rescheduled. Followers wait for rdzv.json@G.
3. Each agent spawns its local ranks with GLOBAL ranks
   (node_rank*nproc_per_node + local) and the shared master, then
   watches: a non-zero local exit or a stale peer agent writes a
   restart flag and tears down; a peer's flag tears down too; all
   ranks of all nodes exiting 0 completes the job.
4. Budget: a generation burns the shared failure budget iff any of its
   restart flags has reason "failure". "preempt" (exit 67 = graceful
   preemption) and "peer-lost" (a whole node vanished — the platform's
   fault, it will reschedule the VM) are budget-free, mirroring the
   reference's mapping of etcd scale-down events to free RESTARTs
   (manager.py:248-252). The burned count is derived from the flag
   files, so every agent accounts identically without messaging.

A rank crashing with a collective error is AMBIGUOUS: it is the
symptom both of its own bug and of a peer node dying mid-collective.
On a non-preemption rank death the agent therefore holds the
classification for up to node_timeout — if a peer agent goes stale (or
flags first) in that window the generation is "peer-lost"/peer-owned,
otherwise it is a genuine "failure".
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .elastic import RESTART_COUNT_ENV, RESTART_EXIT_CODE, HB_DIR_ENV
from .launch import find_free_port, rank_argv, trainer_env

AGENT_BEAT_INTERVAL = 0.5


def _atomic_write(path: str, payload: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # mid-replace read or missing: caller retries


class FileRendezvous:
    """The shared-store half of the protocol (etcd analog)."""

    def __init__(self, directory: str, node_rank: int, nnodes: int):
        self.dir = directory
        self.node_rank = node_rank
        self.nnodes = nnodes
        os.makedirs(directory, exist_ok=True)
        self._stop = threading.Event()
        self.beat()
        self._thread = threading.Thread(target=self._beat_loop,
                                        daemon=True)
        self._thread.start()

    # -- agent heartbeats ---------------------------------------------
    def _agent_path(self, n: int) -> str:
        return os.path.join(self.dir, f"agent.{n}")

    def beat(self) -> None:
        with open(self._agent_path(self.node_rank), "w") as f:
            f.write(str(time.time()))

    def _beat_loop(self) -> None:
        while not self._stop.wait(AGENT_BEAT_INTERVAL):
            self.beat()

    def stop(self) -> None:
        self._stop.set()

    def stale_peers(self, timeout: float) -> List[int]:
        """Node ranks whose agent heartbeat is older than ``timeout``
        (or missing) — the expired-lease signal for a whole node."""
        now = time.time()
        out = []
        for n in range(self.nnodes):
            if n == self.node_rank:
                continue
            try:
                m = os.path.getmtime(self._agent_path(n))
            except OSError:
                out.append(n)
                continue
            if now - m > timeout:
                out.append(n)
        return out

    def peers_all_fresh(self, timeout: float) -> bool:
        return not self.stale_peers(timeout)

    # -- generation state ---------------------------------------------
    def _rdzv_path(self) -> str:
        return os.path.join(self.dir, "rdzv.json")

    def read(self) -> Optional[dict]:
        return _read_json(self._rdzv_path())

    def publish(self, generation: int, master: str, nproc: int) -> None:
        _atomic_write(self._rdzv_path(), {
            "generation": generation, "master": master,
            "nnodes": self.nnodes, "nproc_per_node": nproc})

    def _flags(self, generation: int) -> List[str]:
        pref = f"restart.g{generation}.n"
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        return [os.path.join(self.dir, f) for f in names
                if f.startswith(pref)]

    def restart_requested(self, generation: int) -> bool:
        return bool(self._flags(generation))

    def request_restart(self, generation: int, reason: str,
                        code: int = 0) -> None:
        _atomic_write(
            os.path.join(self.dir,
                         f"restart.g{generation}.n{self.node_rank}"),
            {"reason": reason, "code": code, "node": self.node_rank,
             "ts": time.time()})

    def next_generation(self) -> int:
        """Derive the current generation from the store: rdzv.json's
        generation, stepped past every flagged one. Monotone flags →
        every agent converges without coordination."""
        state = self.read()
        g = int(state["generation"]) if state else 0
        while self.restart_requested(g):
            g += 1
        return g

    def burned_restarts(self, upto_generation: int) -> int:
        """Generations < upto that burned the failure budget (any flag
        with reason "failure"; preempt and peer-lost are free).
        Derived, hence identical on every agent."""
        burned = 0
        for g in range(upto_generation):
            reasons = [(_read_json(p) or {}).get("reason", "failure")
                       for p in self._flags(g)]
            if any(r == "failure" for r in reasons):
                burned += 1
        return burned

    def mark_done(self, generation: int) -> None:
        _atomic_write(
            os.path.join(self.dir,
                         f"done.g{generation}.n{self.node_rank}"),
            {"node": self.node_rank, "ts": time.time()})

    def all_done(self, generation: int) -> bool:
        return all(
            os.path.exists(os.path.join(self.dir, f"done.g{generation}.n{n}"))
            for n in range(self.nnodes))


class NodeAgent:
    """One per node: the Pod controller + elastic watcher for the
    node's ranks (ref: launch/controllers/collective.py Pod build +
    watch; fleet/elastic/manager.py cross-node decisions)."""

    def __init__(self, node_rank: int, nnodes: int, nproc_per_node: int,
                 training_script: str, script_args: List[str],
                 rdzv_dir: Optional[str] = None, max_restarts: int = 0,
                 node_timeout: float = 10.0,
                 rdzv_timeout: float = 300.0,
                 log_dir: Optional[str] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 poll_interval: float = 0.1,
                 rdzv_backend: str = "file",
                 rdzv_endpoint: Optional[str] = None):
        self.node_rank = node_rank
        self.nnodes = nnodes
        self.nproc = nproc_per_node
        self.script = training_script
        self.script_args = script_args
        self.max_restarts = max_restarts
        self.node_timeout = node_timeout
        self.rdzv_timeout = rdzv_timeout
        self.log_dir = log_dir
        self.env_extra = env_extra or {}
        self.poll_interval = poll_interval
        if rdzv_backend == "tcp":
            # clusters without a shared filesystem: rank 0 hosts the
            # socket store (ref: distributed/store/tcp_store.h)
            if not rdzv_endpoint:
                raise ValueError(
                    "rdzv_backend='tcp' requires rdzv_endpoint "
                    "host:port (the leader binds it; peers connect)")
            from .tcp_store import TCPRendezvous
            self.rdzv = TCPRendezvous(rdzv_endpoint, node_rank, nnodes,
                                      startup_timeout=rdzv_timeout)
        elif rdzv_backend == "file":
            if not rdzv_dir:
                raise ValueError("rdzv_backend='file' requires rdzv_dir")
            self.rdzv = FileRendezvous(rdzv_dir, node_rank, nnodes)
        else:
            raise ValueError(f"unknown rdzv_backend {rdzv_backend!r}")
        self._procs: List[subprocess.Popen] = []
        self._logs = []

    @property
    def is_leader(self) -> bool:
        return self.node_rank == 0

    def _host(self) -> str:
        """Address the leader advertises as the coordination master —
        must be reachable from PEER nodes, so loopback only when the
        whole job shares one host. Override with PADDLE_MASTER_HOST
        (multi-NIC pods); auto-detect otherwise."""
        import socket
        host = os.environ.get("PADDLE_MASTER_HOST")
        if host:
            return host
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"

    # -- local pod ----------------------------------------------------
    def _spawn(self, generation: int, master: str) -> None:
        self._procs, self._logs = [], []
        world = self.nnodes * self.nproc
        for local in range(self.nproc):
            rank = self.node_rank * self.nproc + local
            env = dict(os.environ)
            env.update(self.env_extra)
            env.update(trainer_env(rank, world, master))
            env[RESTART_COUNT_ENV] = str(generation)
            env["PADDLE_NNODES"] = str(self.nnodes)
            env["PADDLE_NODE_RANK"] = str(self.node_rank)
            env.pop(HB_DIR_ENV, None)  # node-level watch owns liveness
            stdout = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                f = open(os.path.join(self.log_dir,
                                      f"worker.{rank}.log"), "a")
                self._logs.append(f)
                stdout = f
            self._procs.append(subprocess.Popen(
                rank_argv(self.script, self.script_args),
                env=env, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None))

    def _teardown(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 30
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for f in self._logs:
            f.close()
        self._procs, self._logs = [], []

    # -- protocol steps -----------------------------------------------
    def _await_rendezvous(self, generation: int) -> Optional[str]:
        """Leader publishes once all agents are fresh; everyone waits
        for rdzv.json@generation. Returns the master, or None on
        timeout (a lost peer never rescheduled)."""
        deadline = time.time() + self.rdzv_timeout
        while time.time() < deadline:
            if self.is_leader:
                state = self.rdzv.read()
                if (state is None or int(state["generation"]) < generation) \
                        and self.rdzv.peers_all_fresh(self.node_timeout):
                    master = f"{self._host()}:{find_free_port()}"
                    self.rdzv.publish(generation, master, self.nproc)
                    return master
                if state and int(state["generation"]) == generation:
                    return state["master"]
            else:
                state = self.rdzv.read()
                if state and int(state["generation"]) == generation:
                    return state["master"]
                if state and int(state["generation"]) > generation:
                    return None  # stale view; caller re-derives
            time.sleep(self.poll_interval)
        return None

    def _watch(self, generation: int) -> str:
        """Watch one generation; returns 'completed' | 'restart' |
        'error'. Writes this node's restart flag when it is the one
        that observed the failure."""
        local_done = False
        pending = None  # (rc, classify-by deadline) of a dead rank
        while True:
            for p in list(self._procs):
                rc = p.poll()
                if rc is None:
                    continue
                if rc == 0:
                    self._procs.remove(p)
                    continue
                if rc == RESTART_EXIT_CODE:
                    self.rdzv.request_restart(generation, "preempt", rc)
                    self._teardown()
                    return "restart"
                # ambiguous: own bug, or collateral of a dying peer —
                # hold the verdict until a peer goes stale/flags or the
                # window closes (see module docstring)
                if pending is None:
                    pending = (rc,
                               time.time() + self.node_timeout + 2.0)
                self._procs.remove(p)
            if not self._procs and pending is None and not local_done:
                local_done = True
                self.rdzv.mark_done(generation)
            if local_done and self.rdzv.all_done(generation):
                return "completed"
            if self.rdzv.restart_requested(generation):
                self._teardown()  # peer already owns the classification
                return "restart"
            stale = self.rdzv.stale_peers(self.node_timeout)
            if stale:
                self.rdzv.request_restart(generation, "peer-lost",
                                          -stale[0])
                self._teardown()
                return "restart"
            if pending is not None and time.time() > pending[1]:
                self.rdzv.request_restart(generation, "failure",
                                          pending[0])
                self._teardown()
                return "restart"
            time.sleep(self.poll_interval)

    def run(self, max_generations: int = 128) -> int:
        """Drive generations until the job completes or the shared
        failure budget is exhausted. Exit code 0 on success.
        ``max_generations`` backstops runaway budget-free restart loops
        (a node flapping forever), like the single-host manager's
        ``max_preemptions``."""
        from .tcp_store import StoreUnavailable
        try:
            while True:
                generation = self.rdzv.next_generation()
                if generation > max_generations:
                    print(f"[multinode {self.node_rank}] generation "
                          f"backstop hit ({generation})",
                          file=sys.stderr)
                    return 1
                burned = self.rdzv.burned_restarts(generation)
                if burned > self.max_restarts:
                    print(f"[multinode {self.node_rank}] failure budget "
                          f"exhausted ({burned}/{self.max_restarts})",
                          file=sys.stderr)
                    return 1
                master = self._await_rendezvous(generation)
                if master is None:
                    if self.rdzv.next_generation() != generation:
                        continue  # generation moved on under us
                    print(f"[multinode {self.node_rank}] rendezvous "
                          f"timeout at generation {generation}",
                          file=sys.stderr)
                    return 2
                self._spawn(generation, master)
                outcome = self._watch(generation)
                if outcome == "completed":
                    return 0
                print(f"[multinode {self.node_rank}] generation "
                      f"{generation} -> restart", file=sys.stderr)
        except StoreUnavailable as e:
            # tcp backend: the leader hosting the store is gone — on a
            # platform-scheduled pod that means the job is gone; exit
            # like a rendezvous timeout and let the platform restart us
            print(f"[multinode {self.node_rank}] rendezvous store "
                  f"lost: {e}", file=sys.stderr)
            return 2
        finally:
            self.rdzv.stop()
            self._teardown()
