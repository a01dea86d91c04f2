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
