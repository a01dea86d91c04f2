"""Gradient clipping (the port's counterpart of
``paddle_tpu/nn/clip.py``): ClipGradByValue, ClipGradByNorm and
ClipGradByGlobalNorm over a ``{name: grad}`` dict, applied by the
Optimizer before its update. Norms are float32; clipped gradients keep
their dtype. Pure: the input gradients are not modified.

On a mesh (``parallel.reducer``) a gradient dict holds this rank's
pieces of the sharded parameters: fsdp shards, tensor-parallel slices,
a pipeline rank's stages. Inside :func:`sharded_norms` every norm sums
the pieces' squares across the ranks that hold them (and a replicated
gradient's once): the global norm (``ClipGradByGlobalNorm``, the numeric
guard) and each tensor's own norm (``ClipGradByNorm``, and the
per-tensor norms and means of Lamb, LarsMomentum and Adafactor through
:func:`tensor_sum` and :func:`shard_of`), so every rank computes what one
process computes on the whole tensors. :func:`all_finite` is decided
across the ranks too."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

# (spec, group of every rank): spec maps a sharded name to (its axes,
# the process group over them, {dim: pieces along it})
_SHARDED: Optional[tuple] = None


@contextlib.contextmanager
def sharded_norms(spec: Dict[str, tuple], world) -> Iterator[None]:
    """In scope, the gradients named in ``spec`` are pieces:
    ``spec[name] = (axes, group, {dim: count})`` says they are split over
    the mesh ``axes`` (whose process ``group`` holds the other pieces),
    ``count`` pieces along each ``dim``. ``world``: a group of every
    rank, over which finiteness is decided."""
    global _SHARDED
    prev, _SHARDED = _SHARDED, (dict(spec), world)
    try:
        yield
    finally:
        _SHARDED = prev


def _allreduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    from ..parallel.collective import all_reduce_
    shape = x.shape
    return all_reduce_(x.reshape(-1).clone(), group,
                       op or dist.ReduceOp.SUM).reshape(shape)


def shard_of(name: str) -> Optional[tuple]:
    """``(axes, group, {dim: count})`` of a sharded name in scope."""
    return None if _SHARDED is None else _SHARDED[0].get(name)


def tensor_sum(name: str, s: torch.Tensor) -> torch.Tensor:
    """A sum over every element of ``name``'s tensor, from this rank's
    partial ``s``: summed across the ranks holding its other pieces."""
    sh = shard_of(name)
    return s if sh is None else _allreduce(s, sh[1])


def sum_squares(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """float32 sum of every gradient's squares, across the pieces of the
    sharded ones inside :func:`sharded_norms` (a device scalar)."""
    spec = _SHARDED[0]
    parts: Dict[tuple, list] = {}
    rest = []
    for k, g in grads.items():
        sq = torch.sum(torch.square(g.float()))
        if k in spec:
            parts.setdefault(spec[k][0], [spec[k][1]]).append(sq)
        else:
            rest.append(sq)
    dev = next(iter(grads.values())).device
    total = torch.stack(rest).sum() if rest else \
        torch.zeros((), device=dev)
    for axes in sorted(parts):   # one all-reduce a group, in one order
        group, *sq = parts[axes]
        total = total + _allreduce(torch.stack(sq).sum(), group)
    return total


def all_finite(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Whether every gradient is finite, on every rank inside
    :func:`sharded_norms` (a 0-dim bool)."""
    import torch.distributed as dist
    ok = torch.stack([torch.isfinite(g).all()
                      for g in grads.values()]).all()
    if _SHARDED is None or _SHARDED[1] is None:
        return ok
    return _allreduce(ok.float(), _SHARDED[1], dist.ReduceOp.MIN) > 0


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
        def _clip(k, g):
            n = torch.sqrt(tensor_sum(k, torch.sum(torch.square(
                g.float()))))
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-12),
                                max=1.0)
            return (g * scale).to(g.dtype)
        return {k: _clip(k, g) for k, g in grads.items()}


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
