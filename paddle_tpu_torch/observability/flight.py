"""Crash flight recorder: dump the recent span/event window on death.

The tracing table (``observability.tracing``) is already a fixed-size
ring of recent spans; this module is the part that gets them OUT of a
dying process. Install once near the top of a job::

    from paddle_tpu_torch.observability import flight
    flight.install_flight_recorder("./flight")

and three exits produce a JSONL dump automatically:

- an unhandled exception (``sys.excepthook`` — and
  ``threading.excepthook``, so the LLM engine loop or a DataLoader
  prefetch thread dying is captured too);
- SIGTERM (a cluster scheduler's preemption signal — the dump runs
  before the previous handler / default death, so the in-flight spans
  of the preempted step survive);
- elastic preemption (``distributed.elastic.PreemptionGuard.check``
  calls :func:`dump_flight_record` before the checkpoint-and-exit).

Dump format (one JSON object per line):

    {"kind": "header", "reason": ..., "ts": ..., "pid": ...,
     "argv": [...], "metrics": {flattened registry snapshot}}
    {"kind": "span", "live": true,  ...span dict...}   # in flight
    {"kind": "span", "live": false, ...span dict...}   # ring, newest last
    {"kind": "event", ...}                             # profiler tail

Span dicts carry perf_counter timestamps plus ``ts_wall`` (unix) so
dumps from different processes can be lined up.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Optional

from . import tracing
from .metrics import MetricRegistry, default_registry

# how many trailing profiler RecordEvent rows ride along in a dump
_EVENT_TAIL = 256

_installed: Optional["FlightRecorder"] = None
# RLock: install_flight_recorder holds it across its check-then-install
# (two concurrent callers must not both observe "none installed" and
# stack hooks twice) while FlightRecorder.install() re-acquires it to
# register itself as the process-wide recorder
_mu = threading.RLock()


class FlightRecorder:
    """Owns the dump path + the process death hooks. ``install()`` is
    separate from construction so tests can exercise ``dump()`` without
    touching global hooks."""

    def __init__(self, directory: str,
                 registry: Optional[MetricRegistry] = None,
                 signals=(signal.SIGTERM,)):
        self.directory = os.path.abspath(directory)
        self.registry = registry or default_registry()
        self.signals = tuple(signals)
        self._prev_signal: dict = {}
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._dumped: set = set()     # one dump per reason per process
        self._dump_mu = threading.Lock()

    # -- the dump -------------------------------------------------------
    def dump(self, reason: str, dedupe: bool = False,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write ``flight_<pid>_<reason>.jsonl``; returns the path.
        Never raises — a recorder failure must not mask the original
        crash. ``dedupe=True`` (the hook paths) writes at most one dump
        per reason: a SIGTERM handler racing an excepthook must not
        interleave. ``extra`` (a JSON-serializable dict) lands as one
        ``kind="extra"`` row right after the header — how a failed
        checkpoint-restore verification attaches its manifest digest
        diff."""
        try:
            with self._dump_mu:
                if dedupe and reason in self._dumped:
                    return None
                self._dumped.add(reason)
                return self._dump_locked(reason, extra=extra)
        except Exception:  # noqa: BLE001 — never mask the real death
            return None

    def _dump_locked(self, reason: str,
                     extra: Optional[dict] = None) -> str:
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"flight_{os.getpid()}_{reason}.jsonl")
        live = tracing.live_spans()
        finished = tracing.finished_spans()
        events = []
        prof = sys.modules.get("paddle_tpu_torch.profiler")
        if prof is not None:
            with prof._events.lock:
                events = list(prof._events.trace)[-_EVENT_TAIL:]
        try:
            metrics = self.registry.snapshot()
        except Exception:  # noqa: BLE001
            metrics = {}
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "header", "reason": reason, "ts": time.time(),
                "pid": os.getpid(), "argv": list(sys.argv),
                "live_spans": len(live), "finished_spans": len(finished),
                "metrics": metrics,
            }, default=str) + "\n")
            if extra is not None:
                f.write(json.dumps({"kind": "extra", **extra},
                                   default=str) + "\n")
            for sp in live:
                sp = dict(sp, live=True, kind="span",
                          ts_wall=tracing.perf_to_wall(sp["ts"]))
                f.write(json.dumps(sp, default=str) + "\n")
            for sp in finished:
                sp = dict(sp, live=False, kind="span",
                          ts_wall=tracing.perf_to_wall(sp["ts"]))
                f.write(json.dumps(sp, default=str) + "\n")
            for ev in events:
                f.write(json.dumps({
                    "kind": "event",
                    "ts_wall": tracing.perf_to_wall(ev["ts"]), **ev,
                }, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return path

    # -- hooks ----------------------------------------------------------
    def install(self) -> "FlightRecorder":
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        self._prev_threading_hook = threading.excepthook
        threading.excepthook = self._on_thread_exception
        for s in self.signals:
            try:
                self._prev_signal[s] = signal.signal(
                    s, self._on_signal)
            except (ValueError, OSError):
                # not the main thread / unsupported signal: the
                # exception hooks still cover us
                pass
        # the most recently installed recorder IS the process-wide one
        # (mirrors uninstall(), which already clears this slot):
        # dump_flight_record() callers — e.g. checkpoint verify
        # failures — must reach a recorder installed either way
        global _installed
        with _mu:
            _installed = self
        return self

    def uninstall(self) -> None:
        if self._prev_excepthook is not None:
            sys.excepthook = self._prev_excepthook
            self._prev_excepthook = None
        if self._prev_threading_hook is not None:
            threading.excepthook = self._prev_threading_hook
            self._prev_threading_hook = None
        for s, prev in self._prev_signal.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev_signal = {}
        global _installed
        with _mu:
            if _installed is self:
                _installed = None

    def _on_exception(self, exc_type, exc, tb):
        self.dump("exception", dedupe=True)
        (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

    def _on_thread_exception(self, args):
        # SystemExit in a worker thread is a normal shutdown, not a
        # crash (threading.excepthook itself ignores it too)
        if args.exc_type is not SystemExit:
            self.dump("thread_exception", dedupe=True)
        if self._prev_threading_hook is not None:
            self._prev_threading_hook(args)

    def _dump_bounded(self, reason: str, timeout: float = 10.0) -> None:
        """Dump from a helper thread with a bounded join. A signal
        handler runs between bytecodes of the MAIN thread — if that
        interrupted frame holds tracing._lock / _events.lock /
        registry locks (non-reentrant), dumping inline would deadlock
        the handler and the process would hang instead of dying. The
        helper thread blocks on the lock instead; if it can't finish
        in time we give up the dump and let the death proceed."""
        t = threading.Thread(target=self.dump, args=(reason,),
                             kwargs={"dedupe": True}, daemon=True,
                             name="flight-recorder-dump")
        t.start()
        t.join(timeout)

    def _on_signal(self, signum, frame):
        name = signal.Signals(signum).name.lower()
        self._dump_bounded(name)
        prev = self._prev_signal.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore the default disposition and re-deliver so the
            # exit status still says "killed by SIGTERM" (supervisors
            # key off it — e.g. elastic's budget-free preemption path)
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        # SIG_IGN / None: swallow, matching the prior disposition


def install_flight_recorder(directory: str = "./flight_recorder",
                            registry: Optional[MetricRegistry] = None,
                            signals=(signal.SIGTERM,)) -> FlightRecorder:
    """Create + install the process-wide recorder (idempotent per
    process: a second call re-points the existing recorder's
    directory rather than stacking hooks)."""
    with _mu:  # held across check+install: concurrent first callers
        if _installed is not None:  # must not both stack hooks
            _installed.directory = os.path.abspath(directory)
            if registry is not None:
                _installed.registry = registry
            return _installed
        return FlightRecorder(directory, registry=registry,
                              signals=signals).install()


def get_flight_recorder() -> Optional[FlightRecorder]:
    return _installed


def dump_flight_record(reason: str,
                       extra: Optional[dict] = None,
                       dedupe: bool = False) -> Optional[str]:
    """Dump through the installed recorder; harmless no-op when none
    is installed (the elastic hook calls this unconditionally).
    ``dedupe=True`` makes the dump one-shot per reason per process —
    the near-OOM / stream-divergence forensics discipline (the first
    incident is the interesting one; a divergence storm must not
    grind the process writing dumps)."""
    rec = _installed
    if rec is None:
        return None
    return rec.dump(reason, extra=extra, dedupe=dedupe)
