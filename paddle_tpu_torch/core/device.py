"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
``device`` argument they take ``cuda`` and raise when no card is
present, so a run never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the GPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda")


_current = None   # the device set_device chose; None: the card


def set_current(device) -> None:
    """Make ``device`` (a ``torch.device``, or None for the card) the
    device of the flat tensor API's creation calls."""
    global _current
    _current = None if device is None else torch.device(device)


def current_device() -> torch.device:
    """The device on which a function that takes no tensor (``zeros``,
    ``arange``, ``randn``) creates its result: the one
    ``paddle_tpu_torch.set_device`` chose, else the card; with neither a
    choice nor a card it raises."""
    if _current is not None:
        return _current
    return resolve_device(None)


def explicit_device():
    """The device ``set_device`` chose, or None."""
    return _current
