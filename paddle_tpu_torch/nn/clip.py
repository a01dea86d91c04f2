"""Gradient clipping (the port's counterpart of
``paddle_tpu/nn/clip.py``): ClipGradByValue, ClipGradByNorm and
ClipGradByGlobalNorm over a ``{name: grad}`` dict, applied by the
Optimizer before its update. Norms are float32; clipped gradients keep
their dtype. Pure: the input gradients are not modified."""

from __future__ import annotations

from typing import Dict

import torch


class GradClipBase:
    def __call__(self, grads: Dict[str, torch.Tensor]):
        raise NotImplementedError


class ClipGradByValue(GradClipBase):
    def __init__(self, max: float, min: float | None = None):
        self.max = float(max)
        self.min = float(-max if min is None else min)

    def __call__(self, grads):
        return {k: torch.clamp(g, self.min, self.max)
                for k, g in grads.items()}


class ClipGradByNorm(GradClipBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        def _clip(g):
            n = torch.sqrt(torch.sum(torch.square(g.float())))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            return (g * scale).to(g.dtype)
        return {k: _clip(g) for k, g in grads.items()}


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """float32 L2 norm over every gradient of the dict (a device
    scalar: reading it is the caller's sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


class ClipGradByGlobalNorm(GradClipBase):
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        scale = torch.clamp(
            self.clip_norm / torch.clamp(global_norm(grads), min=1e-12),
            max=1.0)
        return {k: (g * scale).to(g.dtype) for k, g in grads.items()}
