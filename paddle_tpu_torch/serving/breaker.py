"""Per-replica circuit breaker: closed → open → half-open → closed.

The router's view of one replica's recent behavior, separate from the
replica's own health state machine (``LLMEngine`` walks healthy →
degraded → draining from INSIDE; the breaker judges from OUTSIDE — a
crashed process can't report draining, but its connection refusals
trip the breaker just the same). Semantics are the classic ones
(Nygard's "Release It!" / Hystrix lineage):

- CLOSED: traffic flows; ``fail_threshold`` consecutive failures trip
  the breaker OPEN.
- OPEN: no traffic for ``open_for`` seconds — the replica gets quiet
  time to restart instead of a retry storm (EQuARX's byte-lean control
  plane argument applies here too: a dead replica must not eat the
  fleet's dispatch budget).
- HALF-OPEN: after the cooldown, up to ``half_open_probes`` trial
  requests are admitted. Any success closes the breaker (counters
  reset); any failure re-opens it and restarts the cooldown.

Thread-safe; time injectable (``clock=``) so tests drive transitions
without sleeping. Stdlib-only.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

#: gauge encoding (docs/OBSERVABILITY.md router rows)
STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    def __init__(self, fail_threshold: int = 3, open_for: float = 2.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.fail_threshold = int(fail_threshold)
        self.open_for = float(open_for)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        self._mu = threading.Lock()
        self._state = "closed"
        self._consec_failures = 0
        self._opened_at = 0.0
        self._probes_out = 0
        self.n_opens = 0          # cumulative trips (status surface)

    @property
    def state(self) -> str:
        with self._mu:
            return self._state_locked()

    def _state_locked(self) -> str:
        # the open→half_open edge is time-driven; materialize it on
        # read so observers and allow() agree on one transition point
        if self._state == "open" and \
                self._clock() - self._opened_at >= self.open_for:
            self._state = "half_open"
            self._probes_out = 0
        return self._state

    def allow(self) -> bool:
        """May a request (or health probe) be sent now? Half-open
        admits at most ``half_open_probes`` outstanding trials; their
        verdicts arrive via record_success/record_failure."""
        with self._mu:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "open":
                return False
            if self._probes_out >= self.half_open_probes:
                return False
            self._probes_out += 1
            return True

    def record_success(self) -> None:
        with self._mu:
            st = self._state_locked()
            self._consec_failures = 0
            if st == "half_open":
                self._state = "closed"
                self._probes_out = 0

    def record_failure(self) -> None:
        with self._mu:
            st = self._state_locked()
            self._consec_failures += 1
            if st == "half_open" or (
                    st == "closed"
                    and self._consec_failures >= self.fail_threshold):
                # a failed half-open probe re-opens immediately — the
                # replica gets another full cooldown, not a hammering
                self._state = "open"
                self._opened_at = self._clock()
                self._probes_out = 0
                self.n_opens += 1

    def reset(self) -> None:
        """Operator escape hatch (POST /reset_health routes here via
        the router): force closed, clear counters."""
        with self._mu:
            self._state = "closed"
            self._consec_failures = 0
            self._probes_out = 0

    def __repr__(self):
        return (f"CircuitBreaker(state={self.state!r}, "
                f"consec_failures={self._consec_failures}, "
                f"opens={self.n_opens})")
