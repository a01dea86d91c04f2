"""paddle_tpu_torch.parallel user API — fleet/init_parallel_env analog
(the port's counterpart of ``paddle_tpu/parallel/api.py``).

Replaces the reference's distributed bring-up chain
(reference: python/paddle/distributed/parallel.py:94 ``init_parallel_env``
→ TCPStore rendezvous → ProcessGroupNCCL; fleet facade
fleet/base/fleet_base.py:211 ``init`` / :947 ``distributed_model``). The
JAX package is one SPMD program over every device; the port is one
process a rank: ``init_parallel_env`` joins the ``torch.distributed``
default process group, a :class:`~.mesh.DeviceMesh` names its axes, and
``distributed_model`` installs the hooks through which a ``Model`` on
the mesh takes its rows of every global batch, reduces its gradients
and shards its parameters (:mod:`~.reducer`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..nn.layer import Layer
from .mesh import DeviceMesh, get_mesh, init_mesh
from .sharding import (LogicalRules, check_runnable,
                       check_sequence_parallel, is_split, row_groups,
                       shard_batch, shard_params, shard_superbatch)
from .strategy import DistributedStrategy

_state = {"initialized": False, "device": None}


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _local_rank(rank: int, world: int) -> int:
    """This rank's index on its node: the launcher's node agent runs
    ``world / PADDLE_NNODES`` ranks a node."""
    nnodes = _env_int("PADDLE_NNODES", 1)
    node = _env_int("PADDLE_NODE_RANK", 0)
    return rank - node * max(world // max(nnodes, 1), 1)


def current_device() -> Optional[torch.device]:
    """The device ``init_parallel_env`` put this rank on (None before)."""
    return _state["device"]


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      backend: Optional[str] = None,
                      device=None) -> None:
    """Join the default process group (ref: distributed/parallel.py:94).

    The rendezvous comes from the arguments or from the launcher's
    environment, as in the JAX package: ``PADDLE_MASTER`` (else
    ``MASTER_ADDR`` / ``MASTER_PORT``), ``PADDLE_TRAINERS_NUM`` and
    ``PADDLE_TRAINER_ID``; ``coordinator_address`` is ``host:port`` or a
    ``file://`` / ``tcp://`` init method. One process without an address
    gets an in-process store.

    ``backend`` defaults to NCCL and ``device`` to ``cuda:{local rank}``.
    Two ranks that would land on one card under NCCL raise: ranks sharing
    a card, and ranks on the CPU, pass ``backend="gloo"`` and their
    ``device``. Under an elastic launcher the liveness heartbeat starts
    here, as in the JAX package."""
    if _state["initialized"]:
        return
    addr = coordinator_address or os.environ.get("PADDLE_MASTER")
    if not addr and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:" \
               f"{os.environ.get('MASTER_PORT', '29500')}"
    world = num_processes or _env_int("PADDLE_TRAINERS_NUM", 1)
    rank = process_id if process_id is not None else \
        _env_int("PADDLE_TRAINER_ID", 0)
    backend = backend or "nccl"
    if device is None:
        device = f"cuda:{_local_rank(rank, world)}"
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got "
                         f"{device}; CPU ranks pass backend='gloo'")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} asked for, but no CUDA card is visible; "
                f"CPU ranks pass backend='gloo', device='cpu'")
        torch.cuda.set_device(device)
        torch.empty(0, device=device)   # a context before the groups
    if not dist.is_initialized():
        if addr:
            method = addr if "://" in addr else f"tcp://{addr}"
            dist.init_process_group(backend, init_method=method,
                                    rank=rank, world_size=world)
        elif world == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise ValueError(
                f"{world} processes need a rendezvous address "
                f"(coordinator_address or PADDLE_MASTER)")
    if dist.get_backend() == "nccl":
        _check_one_rank_per_card(device)
    _state.update(initialized=True, device=device)
    from ..distributed import elastic as _elastic
    if os.environ.get(_elastic.HB_DIR_ENV):
        _elastic.Heartbeat()


def _check_one_rank_per_card(device: torch.device) -> None:
    """Raise when another rank of the job sits on this rank's card
    (compared by host and card UUID through the group's store: NCCL is
    not asked, as it would fail first)."""
    store = dist.distributed_c10d._get_default_store()
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = f"{socket.gethostname()}/" \
           f"{torch.cuda.get_device_properties(device).uuid}"
    store.set(f"paddle_tpu_torch/card/{rank}", mine)
    seen = {}
    for r in range(world):
        key = store.get(f"paddle_tpu_torch/card/{r}").decode()
        if key in seen:
            raise RuntimeError(
                f"ranks {seen[key]} and {r} would share one card under "
                f"NCCL; ranks that share a card pass backend='gloo' and "
                f"their device to init_parallel_env")
        seen[key] = r


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    """Host-level barrier over every rank (ref: barrier_op.cc)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# host-level collectives on the JAX package's stacked [group, ...] arrays
# (ref: python/paddle/distributed/collective.py all_reduce/all_gather/
# broadcast); the same pure functions in both packages
# ---------------------------------------------------------------------------

def all_reduce(stacked, op: str = "sum"):
    from . import collective
    return collective.host_all_reduce(stacked, op)


def all_gather(x, mesh: Optional[DeviceMesh] = None):
    """The full tensor of a sharded one (``DTensor.full_tensor()``); an
    ordinary tensor is already whole on every rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.full_tensor()
    return x


def broadcast(stacked, src: int = 0, mesh: Optional[DeviceMesh] = None):
    """ref: c_broadcast — on a stacked [group, ...] array, every slice
    takes src's value."""
    x = torch.as_tensor(np.asarray(stacked)
                        if not isinstance(stacked, torch.Tensor)
                        else stacked)
    return x[src].expand(x.shape).clone()


# ---------------------------------------------------------------------------
# model wrapping
# ---------------------------------------------------------------------------

class DataParallel(Layer):
    """Eager DP wrapper (ref: paddle.DataParallel
    fluid/dygraph/parallel.py:419). Forward takes the global batch and
    returns this rank's rows (``shard_batch``; dropout draws the rank's
    rows of the global mask); after the backward the gradients are
    averaged over the data ranks (the Reducer's bucketed all-reduce,
    imperative/reducer.h:129: one flat all-reduce a dtype, queued at the
    end of the backward). The replicas take the first data rank's
    parameters at wrap time."""

    def __init__(self, layers: Layer, mesh: Optional[DeviceMesh] = None):
        super().__init__()
        from .reducer import MeshSync
        self._layers = layers
        self._mesh = mesh or get_mesh()
        self._sync = MeshSync(self._mesh)
        self._sync.setup(dict(layers.named_parameters()))
        self._queued = False
        if self._sync.active:
            for p in layers.parameters():
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(self._on_grad)

    def _on_grad(self, _p) -> None:
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._reduce)

    def _reduce(self) -> None:
        self._queued = False
        params = [p for p in self._layers.parameters()
                  if p.requires_grad and p.grad is not None]
        grads, _ = self._sync.reduce(
            {str(i): p.grad for i, p in enumerate(params)},
            torch.zeros((), device=params[0].grad.device), weighted=False)
        for i, p in enumerate(params):
            p.grad = grads[str(i)]

    def forward(self, *args, **kwargs):
        split = any(is_split(a, 0, self._mesh) for a in args
                    if hasattr(a, "shape"))
        args = shard_batch(args, self._mesh)
        kwargs = shard_batch(kwargs, self._mesh)
        with self._sync.rows_context(split):
            return self._layers(*args, **kwargs)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)


def distributed_model(model, strategy: Optional[DistributedStrategy] = None,
                      mesh: Optional[DeviceMesh] = None,
                      rules: Optional[LogicalRules] = None,
                      global_batch: Optional[int] = None,
                      seq_len: Optional[int] = None,
                      act_dtype_bytes: Optional[int] = None):
    """Attach the mesh to a hapi ``Model`` (ref: fleet_base.py:947
    ``distributed_model``): one call installs the parameter, batch and
    superbatch hooks the Model's steps go through (the JAX package's
    ``_shard_params`` / ``_shard_batch`` / ``_shard_superbatch`` /
    ``_mesh``); the Model's first step splits its parameters over the
    mesh (``parallel.reducer``). With no mesh, one is built from
    ``strategy`` or, given ``global_batch``, by the auto-parallel planner
    (ref: auto_parallel/engine.py:53 Engine auto mode): the cost model
    picks (dp, fsdp, tp) for the world's ranks and the plan is recorded
    as ``model._plan``; else ``dp`` over every rank. ``seq_len``
    defaults to the model's ``max_position_embeddings`` hint. A live
    ``sp`` axis runs a sequence-parallel GPT (ring attention; every sp
    rank passes the same global batch); a live ``ep`` axis raises: it is
    not ported yet."""
    if strategy is not None and global_batch is not None:
        raise ValueError(
            "pass either strategy (manual layout) or global_batch "
            "(auto-planned layout), not both — the planner would be "
            "silently skipped")
    if mesh is None:
        mesh = get_mesh(required=False)
        if mesh is not None and global_batch is not None:
            import warnings
            warnings.warn(
                "distributed_model(global_batch=...) found a mesh already "
                "installed; the auto-parallel planner was skipped and the "
                "existing mesh is used as-is")
        if mesh is None:
            if strategy is None and global_batch is not None:
                from . import planner
                from .mesh import init_mesh_from_axes
                n = get_world_size()
                best = planner.plan(model.network, n,
                                    global_batch=global_batch,
                                    seq_len=seq_len, rules=rules,
                                    act_dtype_bytes=act_dtype_bytes)
                if not best.fits:
                    import warnings
                    warnings.warn(
                        "auto-parallel planner predicts an OOM on every "
                        f"layout; using the smallest footprint: "
                        f"{best.describe()}")
                mesh = init_mesh_from_axes(best.axes)
                model._plan = best
                # context for verify_plan's measured-memory re-plan loop
                model._planner_ctx = {
                    "n_devices": n, "global_batch": global_batch,
                    "seq_len": seq_len, "rules": rules, "chip": None,
                    "act_dtype_bytes": act_dtype_bytes}
            else:
                axes = strategy.mesh_axes() if strategy else {"dp": -1}
                mesh = init_mesh(**(axes or {"dp": -1}))
    check_runnable(mesh)
    check_sequence_parallel(model.network, mesh)
    rules = rules or LogicalRules()
    meta = model.network.param_meta()

    def _shard_params(tree):
        return shard_params(tree, meta, mesh, rules)

    groups = row_groups(model.network, mesh)

    def _shard_batch(tree):
        return shard_batch(tree, mesh, groups)

    def _shard_superbatch(tree):
        return shard_superbatch(tree, mesh, groups)

    model._shard_params = _shard_params
    model._shard_batch = _shard_batch
    model._shard_superbatch = _shard_superbatch
    model._mesh = mesh
    model._rules = rules
    model._sync = None   # built at the Model's first step
    return model
