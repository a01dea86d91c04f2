"""paddle_tpu_torch.device — the device API (the port's counterpart of
``paddle_tpu/device/``).

``set_device`` chooses where the flat tensor API creates tensors for
functions that take no tensor (``zeros``, ``arange``, ``randn``, ...);
functions that take tensors compute on their inputs' device. With no
choice made the card is the default, and a creation call on a machine
with no card raises: it never carries on on the CPU. ``Stream`` and
``Event`` are ``torch.cuda.Stream`` / ``torch.cuda.Event`` on the card;
on the CPU an event reads the host clock after a barrier and a stream is
an empty scope, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ..core import device as _dev


def get_all_device_type():
    return ["cpu", "gpu"] if torch.cuda.is_available() else ["cpu"]


def _canonical(device: torch.device) -> str:
    if device.type == "cuda":
        return f"gpu:{device.index or 0}"
    return "cpu"


def get_device() -> str:
    """The flat API's device: the one ``set_device`` chose, else
    ``"gpu:0"`` on a machine with a card and ``"cpu"`` without."""
    chosen = _dev.explicit_device()
    if chosen is not None:
        return _canonical(chosen)
    return "gpu:0" if torch.cuda.is_available() else "cpu"


def _parse(device) -> torch.device:
    if isinstance(device, torch.device):
        spec = f"{device.type}:{device.index or 0}"
    elif hasattr(device, "kind") and hasattr(device, "device_id"):
        spec = f"{device.kind}:{device.device_id}"    # a Place
    else:
        spec = str(device)
    name, _, index = spec.partition(":")
    if name not in ("cpu", "gpu", "cuda"):
        raise ValueError(
            f"device {spec!r} not available; have {get_all_device_type()}")
    if name == "cpu":
        return torch.device("cpu")
    i = int(index) if index else 0
    if not torch.cuda.is_available() or i >= torch.cuda.device_count():
        raise ValueError(
            f"device {spec!r} not available; have {get_all_device_type()}")
    return torch.device("cuda", i)


def set_device(device) -> str:
    """``paddle.device.set_device``: ``"cpu"``, ``"gpu"``, ``"gpu:N"``
    (or ``"cuda:N"``, a ``torch.device``, a Place). Validates the request
    against the machine and returns the canonical name."""
    _dev.set_current(_parse(device))
    return get_device()


def device_count() -> int:
    return torch.cuda.device_count()


def _on_card() -> bool:
    chosen = _dev.explicit_device()
    if chosen is not None:
        return chosen.type == "cuda"
    return torch.cuda.is_available()


def synchronize(device: Optional[str] = None) -> None:
    """Block until the card's queued work is done (nothing to wait for on
    the CPU)."""
    if device is not None:
        if _parse(device).type == "cuda":
            torch.cuda.synchronize(_parse(device))
    elif _on_card():
        torch.cuda.synchronize()


class Event:
    """``paddle.device.cuda.Event``: ``torch.cuda.Event(enable_timing=
    True)`` on the card; on the CPU a host timestamp."""

    def __init__(self):
        self._cuda = torch.cuda.Event(enable_timing=True) \
            if _on_card() else None
        self._t = None

    def record(self):
        if self._cuda is not None:
            self._cuda.record()
        else:
            self._t = time.perf_counter()

    def synchronize(self):
        if self._cuda is not None:
            self._cuda.synchronize()

    def elapsed_time(self, end: "Event") -> float:
        """Milliseconds between two recorded events."""
        if self._cuda is not None:
            return self._cuda.elapsed_time(end._cuda)
        if self._t is None or end._t is None:
            raise RuntimeError("record() both events first")
        return (end._t - self._t) * 1e3


class Stream:
    """``paddle.device.cuda.Stream``: a ``torch.cuda.Stream`` whose
    ``with`` scope makes it current; on the CPU an empty scope."""

    def __init__(self):
        self._stream = torch.cuda.Stream() if _on_card() else None
        self._ctx = None

    def __enter__(self):
        if self._stream is not None:
            self._ctx = torch.cuda.stream(self._stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        return False

    def synchronize(self):
        if self._stream is not None:
            self._stream.synchronize()


from .fill_r4 import (  # noqa: E402,F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, IPUPlace, MLUPlace, NPUPlace,
    TPUPlace, XPUPlace, get_all_custom_device_type,
    get_available_custom_device, get_available_device,
    get_cudnn_version, is_compiled_with_cinn, is_compiled_with_cuda,
    is_compiled_with_ipu, is_compiled_with_mlu, is_compiled_with_npu,
    is_compiled_with_rocm, is_compiled_with_xpu)
