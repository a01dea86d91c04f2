"""Seeded randomness for parameter initialization.

``seed(s)`` keeps the signature of ``paddle_tpu.seed``; behind it is one
CPU ``torch.Generator`` that the initializers draw from. Parameters are
always drawn on the CPU and moved to their device afterwards, so a seed
gives the same weights whatever the device. The generator's numbers
differ from ``jax.random``'s: to run both packages on the same weights,
carry them across with :func:`paddle_tpu_torch.interop.load_reference_state`.
"""

from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_generator: torch.Generator | None = None


def seed(s: int) -> None:
    """Set the global seed (analog of ``paddle.seed``)."""
    global _generator
    with _lock:
        _generator = torch.Generator(device="cpu").manual_seed(int(s))


def generator() -> torch.Generator:
    """The global CPU generator (seeded with 0 until :func:`seed`)."""
    global _generator
    with _lock:
        if _generator is None:
            _generator = torch.Generator(device="cpu").manual_seed(0)
        return _generator
