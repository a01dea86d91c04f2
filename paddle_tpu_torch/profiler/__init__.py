"""paddle_tpu_torch.profiler — the profiling facade (the port's
counterpart of ``paddle_tpu/profiler/__init__.py``).

Reference being replaced (SURVEY.md §5):
- ``paddle.profiler.Profiler`` with scheduler states
  (python/paddle/profiler/profiler.py:271, ProfilerState :34);
- C++ Profiler composing HostTracer + CudaTracer into an event tree
  exported by ChromeTracingLogger (paddle/fluid/platform/profiler/*);
- ``RecordEvent`` host annotations (platform/profiler/event_tracing.h);
- runtime counters StatRegistry/STAT_ADD (platform/monitor.h:80/133).

Design: the device side is ``torch.profiler`` (kineto: CPU ops and the
card's kernels on one timeline). Each RECORD window of a ``Profiler``
is one ``torch.profiler.profile`` session whose chrome trace lands in
``log_dir`` (``trace_<pid>_<n>.json``, one file per window; a window
stops on the thread that started it, as kineto requires); a READY
phase is the session's warmup, so the window records from its first
kernel;
``RecordEvent`` enters ``torch.profiler.record_function``, so the host
annotation sits on the same timeline as the kernels it launched. What
the facade adds, as in the JAX package: Paddle-shaped scheduling
(closed/ready/record cycles), host-side wall-clock aggregation for a
``summary()`` table, and the process-wide host event stream that
``observability.export_chrome_tracing`` renders.

Only one kineto session can run in a process at a time (a second one
silently corrupts the first), so starting a window while any profiler
session records raises, as the JAX package's trace slot does. A window
that asked for the card's activity and recorded no device event (kineto
on some hosts delivers none) is reported in ``trace_files`` and in
``summary()``, not hidden.
"""

from __future__ import annotations

import collections
import contextlib
import enum
import itertools
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch


class ProfilerTarget(enum.Enum):
    """ref: profiler/profiler.py ProfilerTarget.CPU/GPU. The JAX names
    are kept: ``HOST`` is the host's activity (CPU ops) and ``TPU`` the
    accelerator's, which in the port is the CUDA card's kernels and
    copies (the host's activity is recorded with it)."""
    HOST = 0
    TPU = 1


class SortedKeys(enum.Enum):
    """Sort keys for summary tables (ref: profiler_statistic.py
    SortedKeys — the CPU* family; device time lives in the trace)."""
    CPUTotal = "total"
    CPUAvg = "avg"
    CPUMax = "max"
    Calls = "calls"


class ProfilerState(enum.Enum):
    """ref: profiler/profiler.py:34 ProfilerState."""
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int,
                   repeat: int = 0, skip_first: int = 0
                   ) -> Callable[[int], ProfilerState]:
    """ref: paddle.profiler.make_scheduler — step-phase cycling."""
    period = closed + ready + record

    def sched(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        phase = s % period
        if phase < closed:
            return ProfilerState.CLOSED
        if phase < closed + ready:
            return ProfilerState.READY
        if phase == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return sched


# ---------------------------------------------------------------------------
# host event aggregation (the summary() table)
# ---------------------------------------------------------------------------

class _HostEvents:
    """Process-wide so events from worker threads (data loading, async
    checkpointing) land in the same summary() table.

    Two views of the same stream: ``stats`` (per-name durations, feeds
    summary()) and ``trace`` (timestamped complete events, feeds
    observability.export_chrome_tracing). The trace is bounded so a long
    profiled run can't grow host memory without limit; the per-name
    aggregates keep counting past the cap."""

    TRACE_CAP = 200_000

    def __init__(self):
        self.stats: Dict[str, list] = collections.defaultdict(list)
        self.trace: collections.deque = collections.deque(
            maxlen=self.TRACE_CAP)
        self.active = False
        self.lock = threading.Lock()

    def record(self, name: str, t0: float, dt: float) -> None:
        t = threading.current_thread()
        with self.lock:
            self.stats[name].append(dt)
            self.trace.append({"name": name, "ts": t0, "dur": dt,
                               "tid": t.ident, "tname": t.name})

    def record_stat(self, name: str, dt: float) -> None:
        """Aggregate-only record (no trace row): observability spans
        feed summary() through this — their timeline rendering comes
        from the span table, so a trace append here would render each
        span twice in export_chrome_tracing."""
        with self.lock:
            self.stats[name].append(dt)


_events = _HostEvents()

# which Profiler instance last start()ed: stop() only deactivates the
# shared event stream if it still owns it, so a stale stop (e.g. the
# debug server's timed /profilez disarm racing a job profiler started
# after it) can't silently kill the newer profiler's recording
_active_owner: Optional["Profiler"] = None

# the Profiler whose torch.profiler session is open (one per process)
_trace_slot: Optional["Profiler"] = None
_trace_mu = threading.Lock()
# numbers the trace files of every window this process writes
_trace_seq = itertools.count()


class RecordEvent:
    """Host-side annotation (ref: paddle.profiler.RecordEvent /
    platform RecordEvent). Shows up on the torch.profiler timeline via
    ``record_function`` AND in profiler.summary()."""

    def __init__(self, name: str):
        self.name = name
        self._ann = None
        self._t0 = 0.0

    def begin(self):
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        self._t0 = time.perf_counter()

    def end(self):
        dt = time.perf_counter() - self._t0
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if _events.active:
            _events.record(self.name, self._t0, dt)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def _activities(targets):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if ProfilerTarget.TPU in targets and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _device_event_count(prof) -> int:
    """Events of the card's own activity in a stopped session."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)


class Profiler:
    """ref: python/paddle/profiler/profiler.py:271.

    Usage::
        prof = Profiler(targets=[ProfilerTarget.TPU],
                        scheduler=make_scheduler(closed=1, ready=1,
                                                 record=3),
                        log_dir="./prof")
        prof.start()
        for step in ...:
            ...
            prof.step()
        prof.stop()
        print(prof.summary())

    ``trace_files`` lists one ``{"path", "device_events"}`` row per
    closed RECORD window (``device_events`` None where the card's
    activity was not recorded: no card, or ``targets`` without TPU)."""

    def __init__(self, targets: Optional[Iterable] = None,
                 scheduler: Optional[Callable] = None,
                 log_dir: str = "./paddle_tpu_profile",
                 on_trace_ready: Optional[Callable] = None):
        self.targets = list(targets or [ProfilerTarget.TPU])
        self.scheduler = scheduler or (lambda step: ProfilerState.RECORD)
        self.log_dir = log_dir
        self.on_trace_ready = on_trace_ready
        self.step_num = 0
        self._state = ProfilerState.CLOSED
        self._tracing = False
        self._session = None
        self._thread = None
        self.trace_files: list = []
        # [start, end] perf_counter pairs, one per RECORD window (end
        # None while the window is open) — export_chrome_tracing's
        # per-profiler filter renders only events inside these
        self._windows: list = []

    def recording_windows(self):
        """(start, end) perf_counter pairs of this profiler's RECORD
        phases; an open window reads as end=+inf."""
        import math
        return [(s, e if e is not None else math.inf)
                for s, e in self._windows]

    # -- device trace control -------------------------------------------
    def _open_session(self):
        """Take the process's one torch.profiler session and run kineto's
        warmup: the card's activity tracing is set up and nothing is
        kept. A READY phase does this a step ahead of its RECORD window,
        so the window's first kernels are not lost to the set-up."""
        global _trace_slot
        if self._session is not None:
            return
        from torch.profiler import profile as _torch_profile
        with _trace_mu:
            if _trace_slot is not None or \
                    torch._C._autograd._profiler_enabled():
                raise RuntimeError(
                    "a profiler trace is already running in this process "
                    "(one torch.profiler session at a time)")
            os.makedirs(self.log_dir, exist_ok=True)
            session = _torch_profile(activities=_activities(self.targets))
            session.prepare_trace()
            _trace_slot = self
        self._session = session
        self._thread = threading.get_ident()

    def _close_session(self):
        global _trace_slot
        if threading.get_ident() != self._thread:
            raise RuntimeError(
                "a profiler window must stop on the thread that started "
                "it (torch.profiler's session is thread-bound)")
        session, self._session = self._session, None
        try:
            if not self._tracing:       # warmed up, never recorded
                session.start_trace()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            session.stop_trace()
        finally:
            with _trace_mu:
                if _trace_slot is self:
                    _trace_slot = None
        return session

    def _start_trace(self):
        if self._tracing:
            return
        self._open_session()
        if torch.cuda.is_available():
            # the card finishes what was launched before the window, so
            # the window holds the kernels launched inside it
            torch.cuda.synchronize()
        self._session.start_trace()
        self._tracing = True
        self._windows.append([time.perf_counter(), None])

    def _stop_trace(self):
        if not self._tracing:
            return
        try:
            session = self._close_session()
        finally:
            self._tracing = False
            if self._windows and self._windows[-1][1] is None:
                self._windows[-1][1] = time.perf_counter()
        path = os.path.join(self.log_dir, f"trace_{os.getpid()}_"
                            f"{next(_trace_seq)}.json")
        session.export_chrome_trace(path)
        from torch.profiler import ProfilerActivity
        device = _device_event_count(session) \
            if ProfilerActivity.CUDA in session.activities else None
        self.trace_files.append({"path": path, "device_events": device})
        if self.on_trace_ready:
            self.on_trace_ready(self)

    # -- lifecycle ------------------------------------------------------
    def start(self):
        # clear UNDER the lock: worker threads may be inside
        # RecordEvent.end() → _events.record() concurrently
        with _events.lock:
            _events.stats.clear()
            _events.trace.clear()
        self._windows = []
        _events.active = True
        global _active_owner
        _active_owner = self
        self._transition(self.scheduler(self.step_num))

    def step(self):
        self.step_num += 1
        self._transition(self.scheduler(self.step_num))

    def stop(self):
        global _active_owner
        self._stop_trace()
        if self._session is not None:     # stopped while READY
            self._close_session()
        self._state = ProfilerState.CLOSED
        if _active_owner is self or _active_owner is None:
            _events.active = False
            _active_owner = None

    def _transition(self, new_state: ProfilerState):
        # RECORD_AND_RETURN marks a cycle boundary: the trace closes (and
        # on_trace_ready fires) even if the next state records again
        if self._state == ProfilerState.RECORD_AND_RETURN:
            self._stop_trace()
        if new_state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN):
            self._start_trace()
        elif self._state == ProfilerState.RECORD:
            self._stop_trace()
        if new_state == ProfilerState.READY:
            self._open_session()
        elif new_state == ProfilerState.CLOSED and \
                self._session is not None and not self._tracing:
            self._close_session()
        self._state = new_state

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- host-side stats (ref: profiler/profiler_statistic.py tables) ----
    def summary(self, sorted_by="total") -> str:
        """Statistic report (ref: profiler_statistic.py SummaryView):
        a model-perspective table (Dataloader / TrainStep / Callbacks /
        Eval buckets, recorded by ``Model.fit`` while profiling, with
        time ratios) followed by the full host-event table. Kernel
        timelines live in the chrome traces under ``log_dir``; a window
        that recorded no device event is named under the tables."""
        if isinstance(sorted_by, SortedKeys):
            sorted_by = sorted_by.value
        with _events.lock:
            snapshot = {k: list(v) for k, v in _events.stats.items()}
        rows = [(name, len(t), sum(t), sum(t) / len(t), max(t))
                for name, t in snapshot.items()]
        key = {"total": 2, "avg": 3, "max": 4, "calls": 1}[sorted_by]
        rows.sort(key=lambda r: -r[key])

        def table(title, rs, extra_ratio_of=None):
            lines = [title,
                     f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}"
                     f"{'Avg(s)':>12}{'Max(s)':>12}" +
                     (f"{'Ratio':>9}" if extra_ratio_of else "")]
            for name, calls, total, avg, mx in rs:
                line = (f"{name[:39]:<40}{calls:>8}{total:>12.6f}"
                        f"{avg:>12.6f}{mx:>12.6f}")
                if extra_ratio_of:
                    line += f"{100.0 * total / extra_ratio_of:>8.1f}%"
                lines.append(line)
            return lines

        out = []
        perspective = [r for r in rows
                       if r[0] in ("Dataloader", "TrainStep",
                                   "Callbacks", "Eval")]
        if perspective:
            wall = sum(r[2] for r in perspective)
            out += table("---- Model Perspective "
                         "(ref: model summary table) ----",
                         perspective, extra_ratio_of=wall)
            out.append("")
        out += table("---- Host Events ----", rows)
        empty = [t["path"] for t in self.trace_files
                 if t["device_events"] == 0]
        if empty:
            out.append("")
            out.append(f"no device events recorded in {len(empty)} "
                       f"window(s): {', '.join(empty)}")
        return "\n".join(out)


@contextlib.contextmanager
def profile(log_dir: str = "./paddle_tpu_profile"):
    """One-shot trace context with the Paddle name."""
    p = Profiler(log_dir=log_dir)
    p.start()
    try:
        yield p
    finally:
        p.stop()


# Host-annotation chrome://tracing export (ref: ChromeTracingLogger);
# the card's timelines are the torch.profiler traces under log_dir.
from ..observability.exporters import export_chrome_tracing  # noqa: E402,F401
