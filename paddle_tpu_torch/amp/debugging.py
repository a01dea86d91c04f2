"""NaN/Inf detection with tensor-level attribution (the port's
counterpart of ``paddle_tpu/amp/debugging.py``).

- Per op, for debug runs: ``enable_tensor_checker`` turns on
  ``torch.autograd.set_detect_anomaly``, under which the backward raises
  at the first op whose gradient holds a NaN, naming it (the JAX
  package flips ``jax_debug_nans`` to the same end). The enable/disable
  pairs nest: each enable pushes the value it found, each disable pops
  it.
- Per tensor: :func:`finite_bits` reduces each named tensor to a
  finite-ness bit on the device; :func:`find_nonfinite` reads them and
  names the bad ones (the trainer's ``check_nan_inf`` report and the
  numeric guard's abort message); :func:`check_numerics` raises naming
  one tensor.
"""

from __future__ import annotations

import contextlib
import enum
from typing import Any, Dict, List, Optional

import torch


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    def __init__(self, enable: bool = True,
                 debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


# a stack, so nested enable/disable pairs each restore the value they
# found
_anomaly_stack: List[bool] = []


def enable_tensor_checker(config: Optional[TensorCheckerConfig] = None):
    """Turn on per-op NaN/Inf localization in the backward. Re-entrant:
    every enable pushes the prior value (a disabled config pushes without
    turning anything on, so the pairs stay balanced)."""
    _anomaly_stack.append(torch.is_anomaly_enabled())
    if config is not None and not config.enable:
        return
    torch.autograd.set_detect_anomaly(True)


def disable_tensor_checker():
    prev = _anomaly_stack.pop() if _anomaly_stack else False
    torch.autograd.set_detect_anomaly(prev)


@contextlib.contextmanager
def tensor_checker(config: Optional[TensorCheckerConfig] = None):
    """``with tensor_checker(): ...``: the exception-safe enable/disable
    pair."""
    enable_tensor_checker(config)
    try:
        yield
    finally:
        disable_tensor_checker()


def finite_bits(tree: Any) -> Dict[str, torch.Tensor]:
    """On the device: one bool per named floating tensor of ``tree``
    (nested dicts, lists, tuples), True when it is all finite."""
    return {name: torch.isfinite(v).all()
            for name, v in _flatten(tree).items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()}


def find_nonfinite(tree: Any) -> List[str]:
    """Names of the non-finite tensors of ``tree`` (a host read)."""
    bits = finite_bits(tree)
    if not bits:
        return []
    flags = torch.stack(list(bits.values())).tolist()
    return sorted(n for n, ok in zip(bits, flags) if not ok)


def check_numerics(x, name: str = "tensor", stack_height_limit: int = 0):
    """Raise FloatingPointError naming ``name`` when ``x`` holds a NaN
    or an Inf; return ``x`` otherwise (a host read)."""
    x = torch.as_tensor(x)
    if x.is_floating_point() and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            f"check_numerics: {name} contains NaN/Inf")
    return x


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves of nested dicts/lists/tuples under dotted path names, as
    the JAX package names its tree paths."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix or "leaf": tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
