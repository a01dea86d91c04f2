"""Elastic training: failure detection, restart decisions, resume (the
port's counterpart of ``paddle_tpu/distributed/elastic.py``).

Reference being replaced: the etcd-backed ``ElasticManager``
(python/paddle/distributed/fleet/elastic/manager.py:131) — workers
register TTL-leased nodes under a job prefix, a watcher maps the
live-node count to ``ElasticStatus`` HOLD/RESTART/COMPLETED/EXIT, and
the launcher tears down / respawns ranks accordingly; paired with
epoch-level auto-checkpoint resume
(fluid/incubate/checkpoint/auto_checkpoint.py).

There is no etcd in the loop. Failures surface two ways: a rank process
DIES (observable by the parent launcher — the analog of an expired
lease), or a rank WEDGES while its process stays alive (a hung device:
only visible as lack of training progress). So the manager watches
both signals locally:

- process liveness — ``Popen.poll`` per rank, the lease expiry analog;
- progress heartbeats — each rank touches a per-rank file, either from
  a daemon thread (process-liveness semantics) or from the training
  loop via ``beat()`` (progress semantics — catches hangs the thread
  mode cannot).

A failed generation is torn down (SIGTERM all ranks), the rendezvous
port is rotated, and a new generation starts with
``PADDLE_ELASTIC_RESTART_COUNT`` incremented and, when the manager
knows the checkpoint directory, ``PADDLE_ELASTIC_RESUME_STEP`` set to
the newest verified step, which ``Model.fit(resume="auto")`` reads.
Restart budget, exit codes and statuses are the JAX package's.
"""

from __future__ import annotations

import enum
import os
import signal
import subprocess
import sys
import threading
import time

from ..core.monitor import stat_add
from ..observability import goodput as _goodput
from ..reliability.retry import backoff_delay
from .launch import find_free_port, rank_argv, trainer_env
from typing import Dict, List, Optional

HB_DIR_ENV = "PADDLE_ELASTIC_HB_DIR"
RESTART_COUNT_ENV = "PADDLE_ELASTIC_RESTART_COUNT"
# Newest VERIFIED checkpoint step, threaded into each respawned
# generation's env when the manager knows the checkpoint directory —
# Model.fit(resume="auto") reads it, so a respawned rank picks up the
# right step with no script changes (and falls back to the newest
# verified step if the pinned one has rotted since).
RESUME_STEP_ENV = "PADDLE_ELASTIC_RESUME_STEP"

# A rank exiting with this code means "I was preempted, my state is
# checkpointed, restart me" — the launcher restarts WITHOUT burning the
# failure budget (the reference maps etcd scale-down events to
# ElasticStatus.RESTART the same way, manager.py:248-252).
RESTART_EXIT_CODE = 67


class ElasticStatus(enum.Enum):
    """ref: elastic/manager.py ElasticStatus."""
    HOLD = "hold"            # generation healthy, keep watching
    COMPLETED = "completed"  # every rank exited 0
    RESTART = "restart"      # a rank died or stalled; respawn
    ERROR = "error"          # restart budget exhausted


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------

class Heartbeat:
    """Rank-side progress signal (the reference's TTL lease keepalive,
    manager.py lease refresh thread).

    mode="thread": a daemon thread touches ``hb.{rank}`` every
    ``interval`` — equivalent to the reference's semantics (proves the
    process is alive). mode="manual": the training loop calls
    :meth:`beat` each step, writing ``progress.{rank}`` — stronger,
    proves actual progress. The two write DIFFERENT files, and the
    manager judges staleness on progress files whenever any exist, so
    the auto-started liveness thread can never mask a wedged device
    that has stopped making progress."""

    def __init__(self, directory: Optional[str] = None,
                 rank: Optional[int] = None, interval: float = 1.0,
                 mode: str = "thread"):
        directory = directory or os.environ.get(HB_DIR_ENV)
        if directory is None:
            raise ValueError(
                f"no heartbeat directory (arg or ${HB_DIR_ENV})")
        rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", 0))
        os.makedirs(directory, exist_ok=True)
        prefix = "hb" if mode == "thread" else "progress"
        self.path = os.path.join(directory, f"{prefix}.{rank}")
        self.interval = interval
        self.mode = mode
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beat()
        if mode == "thread":
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def beat(self) -> None:
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.beat()

    def stop(self) -> None:
        self._stop.set()


def restart_count() -> int:
    """How many times the elastic manager has restarted this job (0 on
    the first incarnation) — scripts branch on this to decide resume."""
    return int(os.environ.get(RESTART_COUNT_ENV, 0))


class PreemptionGuard:
    """Graceful-preemption handler: the platform delivers SIGTERM
    with a grace period before evicting a machine; the rank must reach a
    step boundary, checkpoint, and exit asking to be restarted
    (:data:`RESTART_EXIT_CODE`).

    ref: the reference handles the analogous etcd scale-down signal in
    fleet/elastic/manager.py:131 (watcher → ElasticStatus.RESTART) and
    relies on auto_checkpoint for state; here the signal is POSIX and
    the checkpoint hook runs in the training loop's own thread (a
    signal handler must not serialize device state itself — it only
    sets a flag, so a mid-step signal never corrupts a save).

    Usage::

        guard = PreemptionGuard()
        acp = AutoCheckpoint(dir, model, ...)
        for step in acp.epochs(total_steps):     # any granularity
            model.train_batch(...)
            guard.check(save=lambda: acp.commit(step))  # exits 67 if hit
    """

    def __init__(self, signals=(signal.SIGTERM,), install: bool = True):
        self._triggered = threading.Event()
        self._prev = {}
        if install:
            for s in signals:
                self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._triggered.set()

    def trigger(self) -> None:
        """Programmatic preemption (tests; cloud notice pollers)."""
        self._triggered.set()

    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def check(self, save=None, exit: bool = True) -> bool:
        """At a step boundary: if preemption was signalled, run ``save``
        (the final checkpoint), then exit with RESTART_EXIT_CODE. With
        ``exit=False`` returns True instead (caller drains and exits)."""
        if not self._triggered.is_set():
            return False
        stat_add("elastic.preempt_exit")
        # flight-recorder hook: a preempted rank dumps its in-flight
        # span window BEFORE checkpoint-and-exit, so "what was this
        # rank doing when the platform evicted it" survives the VM
        # (no-op unless observability.flight is installed)
        try:
            from ..observability.flight import dump_flight_record
            dump_flight_record("preemption")
        except Exception:  # noqa: BLE001 — never block the checkpoint
            pass
        if save is not None:
            save()
        if exit:
            sys.exit(RESTART_EXIT_CODE)
        return True


# ---------------------------------------------------------------------------
# launcher side
# ---------------------------------------------------------------------------

class ElasticManager:
    """Spawns ranks, watches liveness + heartbeats, decides
    HOLD/RESTART/COMPLETED/ERROR per generation, and re-runs up to
    ``max_restarts`` times (ref: manager.py watch loop + launcher
    restart in launch/controllers/collective.py)."""

    def __init__(self, nproc: int, training_script: str,
                 script_args: List[str],
                 master: Optional[str] = None,
                 log_dir: Optional[str] = None,
                 max_restarts: int = 0,
                 heartbeat_timeout: Optional[float] = None,
                 env_extra: Optional[Dict[str, str]] = None,
                 poll_interval: float = 0.2,
                 restart_backoff: float = 0.5,
                 restart_backoff_cap: float = 30.0,
                 backoff_reset_s: float = 60.0,
                 checkpoint_dir: Optional[str] = None):
        self.nproc = nproc
        self.script = training_script
        self.script_args = script_args
        self.master = master or f"127.0.0.1:{find_free_port()}"
        self.log_dir = log_dir
        self.max_restarts = max_restarts
        self.heartbeat_timeout = heartbeat_timeout
        self.env_extra = env_extra or {}
        self.poll_interval = poll_interval
        self.restarts = 0      # failure-budget consumption only
        self.generation = 0    # every respawn (failures AND preemptions)
        # elastic auto-resume: when the manager knows where checkpoints
        # live, every generation gets $PADDLE_ELASTIC_RESUME_STEP (the
        # newest verified step) and the respawn path watches whether
        # that step ADVANCES between generations — a crash loop that
        # never moves the checkpoint (e.g. the newest checkpoint keeps
        # failing verification on restore) damps like any other
        # restart storm instead of hot-looping into the same corruption
        self.checkpoint_dir = checkpoint_dir
        self._spawn_resume_step: Optional[int] = None
        self._resume_stalls = 0
        # restart-storm damping (reliability.retry backoff curve): a
        # deterministic child crash used to hot-loop max_preemptions
        # times in seconds; now consecutive short-lived generations
        # back off exponentially (restart_backoff · 2^n, capped), and
        # a generation that survives backoff_reset_s resets the curve.
        # jitter=0: one launcher per job — reproducible pacing beats
        # thundering-herd protection here.
        self.restart_backoff = float(restart_backoff)
        self.restart_backoff_cap = float(restart_backoff_cap)
        self.backoff_reset_s = float(backoff_reset_s)
        self._backoff_level = 0

    # -- one generation ------------------------------------------------
    def _spawn(self) -> None:
        self._procs: List[subprocess.Popen] = []
        self._logs = []
        self._gen_start = time.time()
        if self.heartbeat_timeout is not None:
            if self.log_dir:
                self._hb_dir = os.path.join(
                    self.log_dir, f"elastic_hb_gen{self.generation}")
            else:
                import tempfile
                self._hb_dir = os.path.join(
                    tempfile.gettempdir(),
                    f"pt_elastic_hb_{os.getpid()}_{self.generation}")
            os.makedirs(self._hb_dir, exist_ok=True)
            # leftover beats from a previous run sharing this dir would
            # read as instantly-stale and restart a healthy generation
            for f in os.listdir(self._hb_dir):
                try:
                    os.unlink(os.path.join(self._hb_dir, f))
                except OSError:
                    pass
        resume_step = self._spawn_resume_step = self._latest_verified()
        for rank in range(self.nproc):
            env = dict(os.environ)
            env.update(self.env_extra)
            env.update(trainer_env(rank, self.nproc, self.master))
            env[RESTART_COUNT_ENV] = str(self.generation)
            if resume_step is not None:
                env[RESUME_STEP_ENV] = str(resume_step)
            if self.heartbeat_timeout is not None:
                env[HB_DIR_ENV] = self._hb_dir
            stdout = None
            if self.log_dir:
                os.makedirs(self.log_dir, exist_ok=True)
                f = open(os.path.join(
                    self.log_dir, f"worker.{rank}.log"), "a")
                self._logs.append(f)
                stdout = f
            self._procs.append(subprocess.Popen(
                rank_argv(self.script, self.script_args),
                env=env, stdout=stdout,
                stderr=subprocess.STDOUT if stdout else None))

    def _latest_verified(self) -> Optional[int]:
        """Newest verified (manifested) checkpoint step, or None — a
        manifest scan, cheap enough for every respawn."""
        if self.checkpoint_dir is None:
            return None
        from ..io.checkpoint import latest_manifest_step
        return latest_manifest_step(self.checkpoint_dir)

    def _note_resume_progress(self) -> bool:
        """After a generation dies: did the resumable step advance past
        what that generation was HANDED at spawn? Returns True when the
        restart is STALLED on the same checkpoint — the signal that
        feeds the respawn backoff, so a newest checkpoint that keeps
        failing verification on restore can't drive a hot-loop of
        doomed respawns into the same corruption."""
        if self.checkpoint_dir is None:
            return False
        stalled = self._latest_verified() == self._spawn_resume_step
        if stalled:
            self._resume_stalls += 1
            stat_add("elastic.resume_stalls")
        else:
            self._resume_stalls = 0
        return stalled

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
                p.wait(timeout=30)
        for f in self._logs:
            f.close()
        self._logs = []

    def _newest(self, prefix: str) -> Optional[float]:
        newest = None
        for rank in range(self.nproc):
            path = os.path.join(self._hb_dir, f"{prefix}.{rank}")
            try:
                m = os.path.getmtime(path)
            except OSError:
                continue
            newest = m if newest is None else max(newest, m)
        return newest

    def _heartbeats_stale(self) -> bool:
        if self.heartbeat_timeout is None:
            return False
        # spawn grace before the FIRST beat: rank boot includes the
        # torch/framework import (many seconds on a loaded host) — a
        # short grace here misreads slow boot as a stall and burns the
        # restart budget on healthy generations
        grace = max(3 * self.heartbeat_timeout, 30.0)
        now = time.time()
        # progress beats (manual, from the training loop) outrank the
        # liveness thread: a wedged device keeps the thread beating but
        # stalls progress — judge on progress whenever any rank sent one
        newest = self._newest("progress")
        if newest is None:
            newest = self._newest("hb")
        if newest is None:  # nothing beat yet: allow spawn grace
            return now - self._gen_start > grace
        return now - newest > self.heartbeat_timeout

    def _watch_generation(self) -> "tuple[ElasticStatus, Optional[int]]":
        """code None = heartbeat stall (no exit code exists); a signal
        kill surfaces as the usual negative code — -1 would collide
        with SIGHUP, so the stall sentinel must not be an int."""
        live = list(self._procs)
        try:
            while live:
                for p in list(live):
                    rc = p.poll()
                    if rc is None:
                        continue
                    live.remove(p)
                    if rc != 0:
                        return ElasticStatus.RESTART, rc
                if self._heartbeats_stale():
                    return ElasticStatus.RESTART, None
                time.sleep(self.poll_interval)
            return ElasticStatus.COMPLETED, 0
        finally:
            self._teardown()

    # -- the job -------------------------------------------------------
    def run(self, max_preemptions: int = 64) -> int:
        """Run to completion with restarts; return the exit code.

        A rank exiting :data:`RESTART_EXIT_CODE` (graceful preemption:
        checkpoint written, asking to be rescheduled) restarts WITHOUT
        consuming the failure budget, bounded only by
        ``max_preemptions`` as a runaway backstop."""
        preemptions = 0
        while True:
            # STAT_ADD wiring (launcher process): a train-with-restart
            # run leaves a non-empty StatRegistry.snapshot() and these
            # ride the Prometheus/JSONL exports: a job silently
            # restarting for hours becomes one counter read
            stat_add("elastic.generations")
            self._spawn()
            status, code = self._watch_generation()
            if status is ElasticStatus.COMPLETED:
                return 0
            self.generation += 1
            # -SIGTERM: the platform's preemption signal killed the rank
            # before PreemptionGuard installed (interpreter start, torch
            # import) — no checkpoint from THIS incarnation, but the
            # last committed one restores losslessly, and the kill was
            # the scheduler's doing, not the trainer's: budget-free
            if code == RESTART_EXIT_CODE or code == -signal.SIGTERM:
                preemptions += 1
                stat_add("elastic.preemptions")
                if preemptions > max_preemptions:
                    # NOT 67: exiting 67 here would tell any outer
                    # supervisor "restart me for free", defeating the
                    # runaway backstop the moment it fires
                    return 1
                kind = ("checkpointed" if code == RESTART_EXIT_CODE
                        else "killed pre-guard")
                print(f"[elastic] preempted rank {kind}; restart "
                      f"{preemptions} (budget-free)", file=sys.stderr)
            else:
                self.restarts += 1
                stat_add("elastic.restarts")
                stat_add("elastic.stalls" if code is None
                         else "elastic.rank_failures")
                if self.restarts > self.max_restarts:
                    return code if code else 1
                print(f"[elastic] restart "
                      f"{self.restarts}/{self.max_restarts} after "
                      f"{'stall' if code is None else f'exit {code}'}",
                      file=sys.stderr)
            # restart-storm damping before the respawn; a CHECKPOINTED
            # preemption exit is evidence of health, not of a crash
            # loop — it restarts immediately and resets the curve.
            # Unless the checkpoint is STALLED: a "graceful" exit that
            # never advances the verified step (emergency flush timing
            # out every time, or resume dying into a corrupt newest
            # checkpoint) is a crash loop wearing a 67 — damp it, and
            # let consecutive stalls escalate the curve.
            stalled = self._note_resume_progress()
            if stalled and self._resume_stalls > 1:
                self._backoff_level = max(self._backoff_level,
                                          self._resume_stalls - 1)
            self._respawn_backoff(
                healthy=(code == RESTART_EXIT_CODE and not stalled))
            # fresh rendezvous for the new generation (the reference
            # re-registers under a new etcd index the same way)
            self.master = f"127.0.0.1:{find_free_port()}"

    def _respawn_backoff(self, healthy: bool) -> float:
        """Restart-storm damping (reliability.retry backoff curve):
        consecutive short-lived generations wait restart_backoff · 2^n
        (capped) before the respawn, so a deterministic child crash
        can't hot-loop the budget away in seconds. Two signals reset
        the curve: a generation that survived ``backoff_reset_s``, and
        a ``healthy`` exit (graceful checkpointed preemption — the
        platform's doing, not the trainer's; it respawns immediately).
        Returns the delay slept."""
        if healthy:
            self._backoff_level = 0
            return 0.0
        if time.time() - self._gen_start >= self.backoff_reset_s:
            self._backoff_level = 0
        delay = backoff_delay(self._backoff_level,
                              self.restart_backoff,
                              cap=self.restart_backoff_cap)
        self._backoff_level += 1
        if delay > 0:
            print(f"[elastic] backing off {delay:.1f}s before "
                  f"respawn (consecutive restart "
                  f"{self._backoff_level})", file=sys.stderr)
            stat_add("elastic.backoff_seconds", delay)
            time.sleep(delay)
            if _goodput.enabled():
                # restart damping is wall clock nobody trains through:
                # recovery badput on the time ledger
                _goodput.note("recovery", delay)
        return delay

    def install_signal_forwarding(self) -> None:
        """Launcher-level grace: when the LAUNCHER receives SIGTERM (the
        platform preempting the whole VM), forward it to every rank and
        wait for their graceful exits before leaving (ref: the launch
        controller's signal trap, launch/controllers/controller.py)."""

        def handler(signum, frame):
            if getattr(self, "_procs", None):  # may fire before _spawn
                self._teardown()  # SIGTERM ranks, 30s grace, then kill
            sys.exit(RESTART_EXIT_CODE)

        signal.signal(signal.SIGTERM, handler)
