"""Gradient clipping (the port's counterpart of
``paddle_tpu/nn/clip.py``): ClipGradByValue, ClipGradByNorm and
ClipGradByGlobalNorm over a ``{name: grad}`` dict, applied by the
Optimizer before its update. Norms are float32; clipped gradients keep
their dtype. Pure: the input gradients are not modified.

Under fsdp (``parallel.reducer``) a gradient dict holds this rank's
shards of the sharded parameters: inside :func:`sharded_norms` the
global norm sums the shards' squares across the fsdp ranks (and the
replicated gradients' once), so every rank clips by the norm of the
whole gradient; :func:`all_finite` is decided across the ranks too."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

_SHARDED: Optional[tuple] = None   # (sharded names, fsdp process group)


@contextlib.contextmanager
def sharded_norms(names, group) -> Iterator[None]:
    """In scope, gradients named in ``names`` are fsdp shards over
    ``group``."""
    global _SHARDED
    prev, _SHARDED = _SHARDED, (frozenset(names), group)
    try:
        yield
    finally:
        _SHARDED = prev


def _across(x: torch.Tensor, op) -> torch.Tensor:
    from ..parallel.collective import all_reduce_
    return all_reduce_(x.reshape(1).clone(), _SHARDED[1], op).reshape(())


def sum_squares(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """float32 sum of every gradient's squares, across the fsdp shards
    inside :func:`sharded_norms` (a device scalar)."""
    import torch.distributed as dist
    names = _SHARDED[0]
    sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
    shard = [s for k, s in zip(grads, sq) if k in names]
    rest = [s for k, s in zip(grads, sq) if k not in names]
    dev = next(iter(grads.values())).device
    total = _across(torch.stack(shard).sum() if shard
                    else torch.zeros((), device=dev), dist.ReduceOp.SUM)
    return total + (torch.stack(rest).sum() if rest else 0.0)


def all_finite(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Whether every gradient is finite, on every fsdp rank inside
    :func:`sharded_norms` (a 0-dim bool)."""
    import torch.distributed as dist
    ok = torch.stack([torch.isfinite(g).all()
                      for g in grads.values()]).all()
    if _SHARDED is None:
        return ok
    return _across(ok.float(), dist.ReduceOp.MIN) > 0


def sharded() -> bool:
    return _SHARDED is not None


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
    scalar: reading it is the caller's sync); of the whole gradient
    inside :func:`sharded_norms`."""
    if _SHARDED is not None:
        return torch.sqrt(sum_squares(grads))
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
