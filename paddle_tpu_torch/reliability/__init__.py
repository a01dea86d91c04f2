"""Reliability layer: deterministic fault injection + shared failure
semantics (deadlines, retry budgets, backoff); copies of the JAX
package's stdlib-only modules of the same names.

- :mod:`~paddle_tpu_torch.reliability.faults` — seeded, replayable
  fault injection behind named sites threaded through the engine loop
  (zero overhead while disabled — same discipline as
  observability.tracing). Site names and schedules are the JAX
  package's, so one seeded rule fires on the same dispatch in both
  engines.
- :mod:`~paddle_tpu_torch.reliability.retry` — ONE exponential-
  backoff-with-jitter policy (attempt budgets, per-attempt timeouts,
  composable :class:`~paddle_tpu_torch.reliability.retry.Deadline`
  objects).
- :mod:`~paddle_tpu_torch.reliability.guard` — the numeric guard:
  on-device verdicts over each train step's loss and gradients (torch
  ops, no host read) and the skip / rollback / abort policy applied at
  the metric drain.
"""

from . import faults  # noqa: F401
from . import guard  # noqa: F401
from . import retry  # noqa: F401
from .faults import FaultInjected  # noqa: F401
from .retry import (Deadline, DeadlineExceeded, RetryExhausted,  # noqa: F401
                    RetryPolicy, as_deadline, backoff_delay)
from .guard import GuardAbort, GuardPolicy, GuardRollback  # noqa: F401,E402
