"""One retry policy for the whole stack: backoff + jitter + deadlines.

Before this module the repo had three divergent retry loops — the
rendezvous store's fixed-delay ``for _ in range(retries)``, the engine
admission path's unbounded ``"retry"`` requeue, and checkpoint IO's
none-at-all. Each invented its own budget semantics (or had none).
This is the shared vocabulary they now compose from:

- :class:`Deadline` — an absolute time budget that COMPOSES: pass it
  down a call tree, ``min`` it with a narrower one, clamp per-attempt
  IO timeouts against it. Built on ``time.monotonic``.
- :func:`backoff_delay` — the exponential-backoff-with-jitter curve as
  one pure function (the elastic launcher uses it directly for its
  restart storm damping).
- :class:`RetryPolicy` — attempts budget + backoff curve + retryable
  exception set + optional per-attempt timeout. ``call(fn)`` runs the
  loop; exhaustion raises :class:`RetryExhausted` chained to the last
  error; an expired deadline raises :class:`DeadlineExceeded` instead
  of sleeping toward a budget nobody is waiting for.

Every retry sleep lands in the ``retry_attempts{scope=...}`` counter
and its duration in ``retry_backoff_seconds_total{scope=...}`` (plus
the time ledger's ``recovery`` bucket), so "how often are we limping"
AND "how much wall clock it costs" are one scrape away
(docs/OBSERVABILITY.md).

Stdlib-only by design (imported by distributed/io/inference alike).
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Optional, Tuple, Type, Union


class DeadlineExceeded(TimeoutError):
    """The composed time budget ran out (distinct from an attempt
    budget running out — see :class:`RetryExhausted`)."""


class RetryExhausted(RuntimeError):
    """Attempt budget spent without success. ``last`` holds the final
    attempt's exception (also chained as ``__cause__``)."""

    def __init__(self, what: str, attempts: int,
                 last: Optional[BaseException]):
        super().__init__(
            f"{what or 'operation'} failed after {attempts} "
            f"attempt(s): {last!r}")
        self.attempts = attempts
        self.last = last


class Deadline:
    """An absolute point on the monotonic clock. Immutable; cheap to
    pass through call trees and to combine::

        dl = Deadline.after(30.0)
        inner = dl.min(Deadline.after(5.0))   # the tighter one wins
        sock.settimeout(inner.clamp(1.0))     # per-attempt cap
    """

    __slots__ = ("t_end",)

    def __init__(self, t_end: float):
        self.t_end = float(t_end)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    @classmethod
    def never(cls) -> "Deadline":
        return cls(math.inf)

    def remaining(self) -> float:
        return self.t_end - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def min(self, other: Optional["Deadline"]) -> "Deadline":
        if other is None or other.t_end >= self.t_end:
            return self
        return other

    def clamp(self, timeout: Optional[float]) -> float:
        """A per-attempt timeout that can never overshoot the
        deadline (floored at 0)."""
        rem = max(0.0, self.remaining())
        if timeout is None:
            return rem
        return min(float(timeout), rem)

    def raise_if_expired(self, what: str = "") -> None:
        if self.expired:
            raise DeadlineExceeded(
                f"deadline exceeded{f' in {what}' if what else ''} "
                f"(over by {-self.remaining():.3f}s)")

    def __repr__(self):
        return f"Deadline(remaining={self.remaining():.3f}s)"


def as_deadline(value: Union[None, float, int, Deadline]
                ) -> Optional[Deadline]:
    """Coerce an API-surface deadline argument: None passes through,
    a number means 'seconds from now', a Deadline is used as-is."""
    if value is None or isinstance(value, Deadline):
        return value
    return Deadline.after(float(value))


def backoff_delay(attempt: int, base: float, cap: float = 30.0,
                  multiplier: float = 2.0, jitter: float = 0.0,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry number ``attempt`` (0-based): exponential
    growth capped at ``cap``, with symmetric fractional ``jitter``
    (0.5 → uniform in [0.5d, 1.5d]). ``jitter=0`` is fully
    deterministic — the elastic launcher's restart damping uses that
    so its pacing is reproducible in tests."""
    d = min(float(cap), float(base) * float(multiplier) ** int(attempt))
    if jitter:
        u = (rng or random).random()
        d *= 1.0 + float(jitter) * (2.0 * u - 1.0)
    return max(0.0, d)


def _retry_metric(scope: str, exhausted: bool = False) -> None:
    try:
        from ..observability import metrics as _obs
        reg = _obs.default_registry()
        if exhausted:
            reg.counter("retry_exhausted_total",
                        "retry budgets spent without success",
                        label_names=("scope",)).labels(scope).inc()
        else:
            reg.counter("retry_attempts",
                        "failed attempts that will be retried",
                        label_names=("scope",)).labels(scope).inc()
    except Exception:  # noqa: BLE001 — accounting must not mask errors
        pass


def _backoff_metric(scope: str, seconds: float) -> None:
    """Seconds slept between attempts, independently scrapeable: the
    series the time ledger's ``recovery`` bucket reconciles against
    (and the /sloz reader's "slow vs retrying" discriminator)."""
    try:
        from ..observability import metrics as _obs
        _obs.default_registry().counter(
            "retry_backoff_seconds_total",
            "cumulative backoff sleep between retry attempts",
            label_names=("scope",)).labels(scope).inc(seconds)
    except Exception:  # noqa: BLE001 — accounting must not mask errors
        pass
    try:
        from ..observability import goodput as _goodput
        if _goodput.enabled():
            # a backoff sleep is time spent limping: recovery badput
            _goodput.note("recovery", seconds)
    except Exception:  # noqa: BLE001
        pass


class RetryPolicy:
    """Budgeted exponential-backoff-with-jitter retry.

    ``max_attempts`` counts TOTAL tries (1 = no retry). ``retry_on``
    is the retryable exception tuple — anything else propagates
    immediately (a protocol error is not a flaky socket).
    ``per_attempt_timeout`` is advisory: IO callers read it through
    :meth:`attempt_timeout` and apply it to their own blocking calls
    (Python can't preempt an attempt from outside).

    ``seed`` pins the jitter stream (chaos runs want replayable
    pacing); unseeded policies share the module RNG.
    """

    def __init__(self, max_attempts: int = 3, base_delay: float = 0.1,
                 max_delay: float = 30.0, multiplier: float = 2.0,
                 jitter: float = 0.5,
                 retry_on: Tuple[Type[BaseException], ...] = (OSError,),
                 per_attempt_timeout: Optional[float] = None,
                 scope: str = "default",
                 seed: Optional[int] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self.per_attempt_timeout = per_attempt_timeout
        self.scope = scope
        self._rng = random.Random(seed) if seed is not None else None

    def delay(self, attempt: int) -> float:
        return backoff_delay(attempt, self.base_delay, self.max_delay,
                             self.multiplier, self.jitter, self._rng)

    def attempt_timeout(self, deadline: Optional[Deadline] = None
                        ) -> Optional[float]:
        """The timeout one blocking attempt should use: the policy's
        per-attempt cap clamped by the remaining deadline."""
        if deadline is None:
            return self.per_attempt_timeout
        return deadline.clamp(self.per_attempt_timeout)

    def call(self, fn: Callable, *args,
             deadline: Union[None, float, Deadline] = None,
             retry_on: Optional[Tuple[Type[BaseException], ...]] = None,
             on_retry: Optional[Callable[[int, BaseException],
                                         None]] = None,
             describe: str = "", **kw):
        """Run ``fn`` under the budget. Raises the first non-retryable
        exception as-is; :class:`DeadlineExceeded` when the composed
        deadline expires; :class:`RetryExhausted` (chained to the last
        error) when the attempt budget runs out."""
        dl = as_deadline(deadline)
        catch = retry_on if retry_on is not None else self.retry_on
        what = describe or getattr(fn, "__name__", "operation")
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            if dl is not None and dl.expired:
                raise DeadlineExceeded(
                    f"deadline exceeded before attempt "
                    f"{attempt + 1} of {what}") from last
            try:
                return fn(*args, **kw)
            except catch as e:  # noqa: PERF203 — the whole point
                last = e
                if on_retry is not None:
                    on_retry(attempt + 1, e)
                if attempt + 1 >= self.max_attempts:
                    break
                _retry_metric(self.scope)
                d = self.delay(attempt)
                if dl is not None and d >= dl.remaining():
                    # the backoff would outlive the deadline: no
                    # further attempt is possible, so surface the
                    # verdict NOW instead of sleeping out a budget
                    # nobody is waiting for
                    raise DeadlineExceeded(
                        f"deadline exceeded retrying {what} (backoff "
                        f"{d:.3f}s exceeds remaining budget)") from e
                if d > 0:
                    time.sleep(d)
                    _backoff_metric(self.scope, d)
        _retry_metric(self.scope, exhausted=True)
        raise RetryExhausted(what, self.max_attempts, last) from last
