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
``GradScaler`` is not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import contextlib
import threading

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
