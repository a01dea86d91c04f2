"""A registry lock that the registry's own GC finalizers may need.

The perf and memory registries drop an owner's entries from a
``weakref.finalize`` callback when the owner is collected. A collection
can start inside any allocation, on a thread that already holds the
registry's (non-reentrant) lock, so a finalizer that blocked on that
lock would deadlock its own thread. :class:`GcSafeLock` is that lock
with a queue beside it: :meth:`GcSafeLock.call_or_defer` runs a
callback under the lock when the lock is free and otherwise queues it,
and every ``with`` block runs the queued callbacks first.
"""

from __future__ import annotations

import threading
from collections import deque


class GcSafeLock:
    """``with lock:`` as a ``threading.Lock``, plus
    :meth:`call_or_defer` for finalizers."""

    def __init__(self):
        self._mu = threading.Lock()
        self._deferred: deque = deque()

    def __enter__(self):
        self._mu.acquire()
        try:
            self._run_deferred()
        except BaseException:
            self._mu.release()
            raise
        return self

    def __exit__(self, *exc):
        self._mu.release()

    def _run_deferred(self) -> None:
        while self._deferred:
            fn, args = self._deferred.popleft()
            fn(*args)

    def call_or_defer(self, fn, *args) -> None:
        """``fn(*args)`` under the lock now if it is free, else at the
        start of the lock's next ``with`` block. Never blocks."""
        if not self._mu.acquire(blocking=False):
            self._deferred.append((fn, args))
            return
        try:
            self._run_deferred()
            fn(*args)
        finally:
            self._mu.release()
