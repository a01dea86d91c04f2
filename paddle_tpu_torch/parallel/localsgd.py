"""LocalSGD: k local steps per replica, then parameter averaging (the
port's counterpart of ``paddle_tpu/parallel/localsgd.py``).

Reference being replaced: the LocalSGD meta optimizer
(python/paddle/distributed/fleet/meta_optimizers/localsgd_optimizer.py —
a program rewrite inserting c_allreduce on params every k steps instead
of the per-step gradient allreduce).

The JAX package gives every dp rank its own parameter copy as a leading
replica dim sharded over ``dp`` and runs the step per shard with no
gradient collective. A port rank holds its own copy already (one process
a rank): :func:`replicate_params` makes the copies equal,
:func:`build_local_sgd_step`'s step updates this rank's copy from its
rows of the global batch with no gradient collective, and every
``sync_every`` steps one all-reduce a dtype averages the parameters —
one collective where dp would make k.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import collective as _coll
from .mesh import DeviceMesh, get_mesh


def _by_dtype(params: Dict[str, torch.Tensor]):
    out: Dict[torch.dtype, list] = {}
    for k, v in params.items():
        out.setdefault(v.dtype, []).append(k)
    return out


def _average(params: Dict[str, torch.Tensor], mesh: DeviceMesh,
             axis: str) -> Dict[str, torch.Tensor]:
    """The mean of every rank's copy over ``axis``: one flat all-reduce a
    dtype."""
    n = mesh.axis_size(axis)
    g = mesh.group(axis) if n > 1 else None
    out = dict(params)
    for names in _by_dtype(params).values():
        flat = torch.cat([params[k].reshape(-1) for k in names])
        if g is not None:
            _coll.all_reduce_(flat, g)
        flat = flat / n
        o = 0
        for k in names:
            m = params[k].numel()
            out[k] = flat[o:o + m].view(params[k].shape)
            o += m
    return out


def replicate_params(params, mesh: Optional[DeviceMesh] = None,
                     axis: str = "dp"):
    """Give every rank along ``axis`` its own copy: this rank's copy,
    equal to the axis's first rank's values."""
    mesh = mesh or get_mesh()
    return {k: _coll.broadcast(torch.as_tensor(v).detach(), axis, 0, mesh)
            for k, v in params.items()}


def unreplicate_params(params, mesh: Optional[DeviceMesh] = None,
                       axis: str = "dp"):
    """Average the replicas away (e.g. for evaluation/export): the mean
    of every rank's copy, on every rank."""
    return _average(params, mesh or get_mesh(), axis)


def _rows(x, mesh: DeviceMesh, axis: str):
    """This rank's rows of a global batch leaf (leading dim split evenly
    over ``axis``)."""
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    n = mesh.axis_size(axis)
    b = x.shape[0] // n
    i = mesh.local_rank(axis)
    return x[i * b:(i + 1) * b]


def build_local_sgd_step(grad_fn: Callable, update_fn: Callable,
                         sync_every: int,
                         mesh: Optional[DeviceMesh] = None,
                         axis: str = "dp", batch_spec=None):
    """Build the LocalSGD step.

    ``grad_fn(params, batch) -> (loss, grads)`` for ONE replica's params
    on its rows of the batch; ``update_fn(params, grads) -> new params``
    (replica-local). The returned ``step(params, batch, step_idx)`` takes
    this rank's copy and the GLOBAL batch (every leaf's leading dim split
    over ``axis``; ``batch_spec`` is accepted for the JAX signature),
    and averages the copies over ``axis`` only when ``step_idx %
    sync_every == sync_every - 1``. The returned loss is the mean over
    the replicas."""
    mesh = mesh or get_mesh()

    def step(params, batch, step_idx):
        from ..io import _tree_map
        local = _tree_map(lambda x: _rows(torch.as_tensor(x), mesh, axis),
                          batch)
        loss, grads = grad_fn(params, local)
        new = update_fn(params, grads)
        if int(step_idx) % sync_every == sync_every - 1:
            new = _average(new, mesh, axis)
        loss = _average({"loss": torch.as_tensor(loss).float()}, mesh,
                        axis)["loss"]
        return new, loss

    return step
