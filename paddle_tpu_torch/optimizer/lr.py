"""Learning-rate schedulers (the port's counterpart of
``paddle_tpu/optimizer/lr.py``).

Each scheduler is both stateful Paddle-style (``sched.step()``
advances, ``sched.get_lr()`` reads) and a pure function of the step
index (``sched(step)``, ``sched.lr_at(step)``). In the port the function
runs on the host and returns a Python float: the optimizer's update is
eager, so the rate is a scalar argument of its kernels, never a device
value that would need a sync.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Optional, Sequence


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = None
        self.step()

    def lr_at(self, step: int) -> float:
        """The rate at ``step``, a pure function. Subclasses override."""
        raise NotImplementedError

    def __call__(self, step: int) -> float:
        return self.lr_at(step)

    def get_lr(self) -> float:
        return float(self.last_lr)

    def step(self, epoch: Optional[int] = None) -> None:
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        self.last_lr = float(self.lr_at(self.last_epoch))

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]


class ConstantLR(LRScheduler):
    def lr_at(self, step):
        return self.base_lr


class NoamDecay(LRScheduler):
    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1,
                 verbose: bool = False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = float(max(step, 1))
        return self.base_lr * self.d_model ** -0.5 * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** float(step)


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * math.exp(-self.gamma * float(step))


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose: bool = False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr / (1 + self.gamma * float(step))


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False, last_epoch: int = -1,
                 verbose: bool = False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = float(step)
        if self.cycle:
            decay_steps = max(self.decay_steps * math.ceil(
                max(step, 1e-9) / self.decay_steps), self.decay_steps)
        else:
            decay_steps = self.decay_steps
            step = min(step, self.decay_steps)
        frac = (1 - step / decay_steps) ** self.power
        return (self.base_lr - self.end_lr) * frac + self.end_lr


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch: int = -1, verbose: bool = False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def lr_at(self, step):
        return float(self.values[bisect.bisect_right(self.boundaries,
                                                     step)])


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int,
                 eta_min: float = 0.0, last_epoch: int = -1,
                 verbose: bool = False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        cos = math.cos(math.pi * min(float(step), self.T_max) / self.T_max)
        return self.eta_min + (self.base_lr - self.eta_min) * (1 + cos) / 2


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1, verbose: bool = False):
        self.inner = learning_rate if isinstance(learning_rate, LRScheduler)\
            else None
        self.peak = None if self.inner is not None else float(learning_rate)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr, last_epoch, verbose)

    def lr_at(self, step):
        if step < self.warmup_steps:
            return self.start_lr + (self.end_lr - self.start_lr) * \
                float(step) / self.warmup_steps
        if self.inner is not None:
            return float(self.inner.lr_at(max(step - self.warmup_steps, 0)))
        return self.peak


class StepDecay(LRScheduler):
    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self.gamma ** float(step // self.step_size)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        n = bisect.bisect_right(self.milestones, step)
        return self.base_lr * self.gamma ** float(n)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda: Callable,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * float(self.lr_lambda(step))


class MultiplicativeDecay(LRScheduler):
    """Stateful only: ``lr_at`` returns the rate the steps so far
    reached, whatever ``step`` it is asked about (as in the JAX
    package)."""

    def __init__(self, learning_rate: float, lr_lambda: Callable,
                 last_epoch: int = -1, verbose: bool = False):
        self.lr_lambda = lr_lambda
        self._factor = 1.0
        super().__init__(learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        return self.base_lr * self._factor

    def step(self, epoch=None):
        self.last_epoch = epoch if epoch is not None else self.last_epoch + 1
        if self.last_epoch > 0:
            self._factor *= self.lr_lambda(self.last_epoch)
        self.last_lr = self.base_lr * self._factor


class ReduceOnPlateau(LRScheduler):
    """Metric-driven; stateful only (host decisions)."""

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0.0,
                 epsilon: float = 1e-8, verbose: bool = False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self._lr = float(learning_rate)
        super().__init__(learning_rate, -1, verbose)

    def lr_at(self, step):
        return self._lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            self.last_lr = self._lr
            return
        m = float(metrics)
        if self.best is None or self._is_better(m):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            new_lr = max(self._lr * self.factor, self.min_lr)
            if self._lr - new_lr > self.epsilon:
                self._lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        self.last_lr = self._lr

    def _is_better(self, m):
        t = self.threshold
        if self.mode == "min":
            ref = self.best * (1 - t) if self.threshold_mode == "rel" \
                else self.best - t
            return m < ref
        ref = self.best * (1 + t) if self.threshold_mode == "rel" \
            else self.best + t
        return m > ref


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int,
                 divide_factor: float = 25.0,
                 end_learning_rate: float = 0.0001,
                 phase_pct: float = 0.3, anneal_strategy: str = "cos",
                 last_epoch: int = -1, verbose: bool = False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _interp(self, a, b, pct):
        if self.anneal == "cos":
            return b + (a - b) * (1 + math.cos(math.pi * pct)) / 2
        return a + (b - a) * pct

    def lr_at(self, step):
        step = float(step)
        up = self.phase_pct * self.total_steps
        if step < up:
            return self._interp(self.initial_lr, self.max_lr,
                                min(max(step / max(up, 1), 0.0), 1.0))
        down = (step - up) / max(self.total_steps - up, 1)
        return self._interp(self.max_lr, self.end_lr,
                            min(max(down, 0.0), 1.0))


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate: float, max_learning_rate: float,
                 step_size_up: int, step_size_down: Optional[int] = None,
                 mode: str = "triangular", gamma: float = 1.0,
                 last_epoch: int = -1, verbose: bool = False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = step_size_down or step_size_up
        self.mode = mode
        self.gamma = gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def lr_at(self, step):
        step = float(step)
        cycle_len = self.up + self.down
        cycle = math.floor(1 + step / cycle_len)
        x = step - (cycle - 1) * cycle_len
        pct = x / self.up if x <= self.up else \
            1 - (x - self.up) / self.down
        amp = self.max_lr - self.base_lr_
        if self.mode == "triangular2":
            amp = amp / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * self.gamma ** step
        return self.base_lr_ + amp * pct


def make_schedule(lr) -> Callable[[int], float]:
    """float | LRScheduler -> a pure host function step -> rate."""
    if isinstance(lr, LRScheduler):
        return lr.lr_at
    val = float(lr)
    return lambda step: val
