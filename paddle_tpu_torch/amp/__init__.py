"""Automatic mixed precision (the port's counterpart of
``paddle_tpu/amp/__init__.py``).

Paddle's per-op casting, written out at the same call sites as in the
JAX package: under :func:`auto_cast`, ``nn.functional.linear``, the
attention entry point, the tied LM head and the fused loss cast their
matmul operands to the compute dtype through :func:`white_cast`;
``layer_norm`` and ``softmax`` keep float32 statistics unless the user
white-lists them (:func:`op_in_white`). ``torch.autocast`` is not used:
its op lists differ from Paddle's, and these call sites decide the
dtypes. The state is thread-local, as in the JAX package.

``GradScaler`` is the JAX package's dynamic loss scaler for float16:
the functional core (``init_state``, ``scale_loss``, ``unscale``,
``update_state``) as torch ops on 0-dim device tensors, and the eager
``scale``/``step``, which reads the host once a step (whether the
unscaled gradients are finite, and the new scale). ``amp.debugging``
holds the NaN/Inf tools.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Tuple

import torch

from ..core import dtype as dtype_mod
from ..core import flags


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white: frozenset = frozenset()
        self.black: frozenset = frozenset()


_state = _AmpState()


def is_enabled() -> bool:
    return _state.enabled


def compute_dtype():
    return _state.dtype if _state.enabled else None


@contextlib.contextmanager
def auto_cast(enable: bool = True, dtype=None, level: str = "O1",
              custom_white_list=None, custom_black_list=None):
    """``level``: O1 casts per op (matmul-like ops run in ``dtype``); O2
    also expects the caller to keep parameters in ``dtype``
    (:func:`decorate`). ``custom_white_list``: ops forced to the compute
    dtype beyond the matmul-like defaults (``"layer_norm"``,
    ``"softmax"`` skip their float32 statistics).
    ``custom_black_list``: matmul-like ops held in their input dtype."""
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.white, _state.black)
    _state.enabled = enable
    _state.dtype = dtype_mod.dtype(dtype if dtype is not None
                                   else flags.get_flag("amp_dtype"))
    _state.level = level
    _state.white = frozenset(custom_white_list or ())
    _state.black = frozenset(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.white, _state.black) = prev


amp_guard = auto_cast  # legacy alias, as in the JAX package


def _saved_state() -> tuple:
    """This thread's auto_cast state, for :func:`_restored`."""
    return (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)


def _restored(saved: tuple):
    """auto_cast as ``saved`` describes it, on whichever thread enters
    it (a rematerialized block recomputed by the autograd engine's
    device thread)."""
    enabled, dt, level, white, black = saved
    return auto_cast(enable=enabled, dtype=dt, level=level,
                     custom_white_list=white, custom_black_list=black)


def _cast_all(xs):
    dt = _state.dtype
    out = tuple(x.to(dt) if x is not None and x.is_floating_point() else x
                for x in xs)
    return out if len(out) > 1 else out[0]


def white_cast(*xs, op: str = "matmul"):
    """Cast matmul-like operands to the AMP compute dtype when enabled,
    unless ``op`` was custom_black_listed."""
    if not _state.enabled or op in _state.black:
        return xs if len(xs) > 1 else xs[0]
    return _cast_all(xs)


def op_in_white(op: str) -> bool:
    """True when the user custom_white_listed ``op``: float32-by-default
    ops (layer_norm, softmax) then run in the compute dtype."""
    return _state.enabled and op in _state.white


def decorate(model, optimizer=None, level: str = "O2", dtype=None):
    """O2 decoration: cast the model's parameters to the AMP dtype."""
    model.to(dtype_mod.dtype(dtype or flags.get_flag("amp_dtype")))
    if optimizer is not None:
        return model, optimizer
    return model


# ---------------------------------------------------------------------------
# Dynamic loss scaling (float16)
# ---------------------------------------------------------------------------

def _all_finite(grads) -> torch.Tensor:
    """A 0-dim bool device tensor: every gradient finite."""
    leaves = list(grads.values()) if isinstance(grads, dict) else \
        list(grads)
    return torch.stack([torch.isfinite(g).all() for g in leaves]).all()


def _scaler_metrics():
    """Loss-scaler instruments. The inf/nan skip feeds the numeric
    guard's families (``guard_trips_total{kind="scaler_inf",
    action="skip"}``, ``guard_skipped_steps_total``), so scaler skips and
    guard skips read on one dashboard, as in the JAX package."""
    from ..observability import metrics as _obs
    from ..reliability.guard import _guard_metrics
    reg = _obs.default_registry()
    g = _guard_metrics()
    return {
        "scale": reg.gauge(
            "amp_loss_scale", "current GradScaler loss scale"),
        "found_inf": reg.counter(
            "amp_found_inf_total",
            "optimizer steps the GradScaler skipped on inf/nan grads"),
        "trips": g["trips"],
        "skipped": g["skipped"],
    }


class GradScaler:
    """Dynamic loss scaler: the scale doubles after
    ``incr_every_n_steps`` finite steps in a row and halves after
    ``decr_every_n_nan_or_inf`` non-finite ones, clipped to [1, 2^31]; a
    non-finite step is skipped.

    Functional core (device tensors, no host read)::

        state = scaler.init_state()
        scaled_loss = scaler.scale_loss(loss, state)
        grads, ok = scaler.unscale(grads, state)
        state = scaler.update_state(state, ok)
    """

    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self.enable = enable
        self.init_scale = init_loss_scaling
        self.incr_ratio = incr_ratio
        self.decr_ratio = decr_ratio
        self.incr_every_n_steps = incr_every_n_steps
        self.decr_every_n = decr_every_n_nan_or_inf
        self.dynamic = use_dynamic_loss_scaling
        self._state = self.init_state()

    # functional core --------------------------------------------------------
    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device)}

    @staticmethod
    def _on(state, device):
        if state["scale"].device == device:
            return state
        return {k: v.to(device) for k, v in state.items()}

    def scale_loss(self, loss, state=None):
        if not self.enable:
            return loss
        state = self._on(state or self._state, loss.device)
        return loss * state["scale"].to(loss.dtype)

    def unscale(self, grads, state=None) -> Tuple[Any, torch.Tensor]:
        """Gradients divided by the scale (in float32, cast back to each
        gradient's dtype) and whether all of them are finite."""
        if not self.enable:
            return grads, torch.tensor(True)
        dev = next(iter(grads.values())).device
        inv = 1.0 / self._on(state or self._state, dev)["scale"]
        grads = {k: (g.float() * inv).to(g.dtype) for k, g in grads.items()}
        return grads, _all_finite(grads)

    def update_state(self, state, all_finite) -> Dict[str, torch.Tensor]:
        if not (self.enable and self.dynamic):
            return state
        state = self._on(state, all_finite.device)
        good = torch.where(all_finite, state["good"] + 1, 0).int()
        bad = torch.where(all_finite, 0, state["bad"] + 1).int()
        grow = good >= self.incr_every_n_steps
        shrink = bad >= self.decr_every_n
        scale = torch.where(grow, state["scale"] * self.incr_ratio,
                            state["scale"])
        scale = torch.where(shrink, scale * self.decr_ratio, scale)
        scale = torch.clamp(scale, 1.0, 2.0 ** 31)
        return {"scale": scale,
                "good": torch.where(grow, 0, good).int(),
                "bad": torch.where(shrink, 0, bad).int()}

    def observe_metrics(self, state, all_finite) -> None:
        """Publish the ``amp_loss_scale`` gauge and, for a skipped step,
        the skip counters shared with the numeric guard (reads ``state``
        and ``all_finite`` on the host)."""
        self._publish(float(state["scale"]), bool(all_finite))

    @staticmethod
    def _publish(scale: float, found_finite: bool) -> None:
        m = _scaler_metrics()
        m["scale"].set(scale)
        if not found_finite:
            m["found_inf"].inc()
            m["trips"].labels("scaler_inf", "skip").inc()
            m["skipped"].inc()

    # stateful wrappers (eager path) ----------------------------------------
    def scale(self, loss):
        return self.scale_loss(loss, self._state)

    def step(self, optimizer, grads) -> None:
        """Unscale ``grads`` ({name: grad}), step ``optimizer`` with them
        if they are finite, and update the scale. One host read a step:
        the finite bit and the new scale together."""
        grads, ok = self.unscale(grads, self._state)
        new_state = self.update_state(self._state, ok)
        finite, scale = torch.stack(
            [ok.float(), new_state["scale"].float()]).tolist() \
            if self.enable else (1.0, 1.0)
        if finite:
            optimizer.step(grads)
        self._state = new_state
        if self.enable:
            self._publish(scale, bool(finite))

    def is_enable(self):
        return self.enable

    def state_dict(self):
        return {k: float(v) for k, v in self._state.items()}

    def load_state_dict(self, sd):
        self._state = {
            "scale": torch.tensor(sd["scale"], dtype=torch.float32),
            "good": torch.tensor(int(sd["good"]), dtype=torch.int32),
            "bad": torch.tensor(int(sd["bad"]), dtype=torch.int32)}


from . import debugging  # noqa: E402,F401  (the NaN/Inf tools)
