"""``paddle.distributed`` eager communication (the port's counterpart of
``paddle_tpu/distributed/comm.py``; ref: python/paddle/distributed/
collective.py — ProcessGroup-backed eager collectives — and parallel.py
ParallelEnv).

The JAX package is one program over every device, so its "per-rank
tensor" is a stacked ``[group, ...]`` array and each collective is a
reduction or permutation of that leading axis. The port runs one process
a rank: rank ``r`` passes slice ``r`` of that array (its own tensor) and
gets slice ``r`` of the JAX package's result, over ``torch.distributed``
(the default group, or a :class:`Group` from :func:`new_group`). CUDA
tensors of a gloo group are staged through pinned host memory
(``parallel.collective.wire``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..parallel import collective as _coll


class ReduceOp:
    """ref: distributed/collective.py ReduceOp enum."""

    SUM, MAX, MIN, PROD, AVG = 0, 1, 2, 3, 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT,
              ReduceOp.AVG: dist.ReduceOp.SUM}


@dataclass
class Group:
    """Rank-subset communicator (ref: collective.py Group): the global
    ranks, an id, and the process group over them."""

    ranks: List[int]
    gid: int = 0
    pg: Any = field(default=None, repr=False, compare=False)

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank)


_groups: List[Group] = []
_world_group: Optional[Group] = None


def _world() -> Group:
    # a dedicated slot, NOT _groups[0]: a user calling new_group()
    # before any world access would otherwise become the world group
    global _world_group
    if _world_group is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        _world_group = Group(list(range(n)), gid=0)
    return _world_group


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              timeout=None) -> Group:
    """ref: collective.py new_group. Every rank of the world calls it
    (torch builds process groups collectively)."""
    members = list(ranks) if ranks is not None else _world().ranks
    pg = None
    if dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(sorted(members), backend=backend, **kw)
    g = Group(members, gid=len(_groups) + 1, pg=pg)
    _groups.append(g)
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _world()
    for g in _groups:
        if g.gid == gid:
            return g
    return _world()


def is_initialized() -> bool:
    """ref: collective.py is_initialized — true once the default process
    group exists."""
    return dist.is_initialized()


def _pg(group: Optional[Group]):
    return None if group is None else group.pg


def _me(group: Optional[Group]) -> int:
    """This rank's index in ``group`` (its slice of the stacked form)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    g = group or _world()
    return g.ranks.index(rank) if rank in g.ranks else -1


def _single(group: Optional[Group]) -> bool:
    return not dist.is_initialized() or (group or _world()).nranks == 1


def wait(tensor, group=None, use_calc_stream=True):
    """ref: collective.py wait (stream sync): the tensor once every
    queued kernel that writes it has run."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def _reduced(x, op, group):
    out = torch.as_tensor(x).clone()
    if not _single(group):
        _coll.all_reduce_(out, _pg(group) or dist.group.WORLD,
                          _TORCH_OPS[op])
    if op == ReduceOp.AVG:
        out = out / (group or _world()).nranks
    return out


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """``dst`` gets the reduction over the group; every other rank keeps
    its input (the JAX package's ``x.at[dst].set(red)``)."""
    red = _reduced(tensor, op, group)
    return red if _me(group) == dst else torch.as_tensor(tensor)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM,
                   group=None, sync_op=True):
    """Rank ``r`` passes ``[group, ...]`` (its slice for each rank, or
    ``tensor_list``) and gets the reduction over the ranks of slice
    ``r`` (ref: c_reducescatter)."""
    x = torch.stack([torch.as_tensor(t) for t in tensor_list]) \
        if tensor_list is not None else torch.as_tensor(tensor)
    return _reduced(x, op, group)[max(_me(group), 0)]


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``r`` gets slice ``r`` of ``src``'s list (``tensor_list``, or
    ``tensor`` stacked ``[group, ...]``) (ref: collective.py scatter)."""
    x = torch.stack([torch.as_tensor(t) for t in tensor_list]) \
        if tensor_list is not None else torch.as_tensor(tensor)
    if not _single(group):
        g = group or _world()
        h = _coll.wire(x.contiguous().clone(), _pg(group) or
                       dist.group.WORLD)
        dist.broadcast(h, g.ranks[src], group=_pg(group))
        x = _coll.back(h, x)
    return x[max(_me(group), 0)]


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """Rank ``r`` sends slice ``s`` of its list to rank ``s`` and gets
    ``[rank s's slice r for s]`` (the JAX package's transpose of the two
    leading axes; ref: AllToAll ProcessGroup.h:141)."""
    x = torch.stack([torch.as_tensor(t) for t in in_tensor_list]) \
        if isinstance(in_tensor_list, (list, tuple)) \
        else torch.as_tensor(in_tensor_list)
    if _single(group):
        return x
    parts = _coll.all_gather_list(x, _pg(group) or dist.group.WORLD)
    me = _me(group)
    return torch.stack([p[me] for p in parts])


def send(tensor, dst=0, group=None, sync_op=True):
    """Point-to-point send of ``tensor`` to group rank ``dst``; returns
    the payload (ref: send_v2)."""
    t = torch.as_tensor(tensor)
    if not _single(group):
        g = group or _world()
        h = _coll.wire(t.contiguous(), _pg(group) or dist.group.WORLD)
        dist.send(h, g.ranks[dst], group=_pg(group))
    return t


def recv(tensor, src=0, group=None, sync_op=True):
    """Receive into (a copy shaped like) ``tensor`` from group rank
    ``src``; returns what ``src`` sent (ref: recv_v2)."""
    t = torch.as_tensor(tensor)
    if _single(group):
        return t
    g = group or _world()
    out = torch.empty_like(t)
    h = _coll.wire(out, _pg(group) or dist.group.WORLD)
    dist.recv(h, g.ranks[src], group=_pg(group))
    return _coll.back(h, out) if h is not out else out


class _Task:
    def __init__(self, value, work=None, finish=None):
        self.value = value
        self._work = work
        self._finish = finish

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
            if self._finish is not None:
                self.value = self._finish()
        return self.value


def isend(tensor, dst=0, group=None):
    """Async send; the task's ``wait()`` returns the payload (ref:
    collective.py isend)."""
    t = torch.as_tensor(tensor)
    if _single(group):
        return _Task(t)
    g = group or _world()
    h = _coll.wire(t.contiguous(), _pg(group) or dist.group.WORLD)
    return _Task(t, dist.isend(h, g.ranks[dst], group=_pg(group)))


def irecv(tensor, src=0, group=None):
    """Async receive; the task's ``wait()`` returns what ``src`` sent."""
    t = torch.as_tensor(tensor)
    if _single(group):
        return _Task(t)
    g = group or _world()
    out = torch.empty_like(t)
    h = _coll.wire(out, _pg(group) or dist.group.WORLD)
    work = dist.irecv(h, g.ranks[src], group=_pg(group))
    return _Task(out, work, lambda: _coll.back(h, out))


def split(x, num_or_sections, axis=0, group=None):
    """Model-parallel split helper (ref: collective.py split): this
    rank's piece of ``x`` along ``axis``."""
    x = torch.as_tensor(x)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if isinstance(num_or_sections, int):
        parts = torch.chunk(x, num_or_sections, dim=axis)
    else:
        parts = torch.split(x, list(num_or_sections), dim=axis)
    return parts[rank % len(parts)]


class ParallelEnv:
    """ref: fluid/dygraph/parallel.py ParallelEnv — rank, world and
    device of this process."""

    @property
    def rank(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def local_rank(self) -> int:
        from ..parallel.api import _local_rank
        return _local_rank(self.rank, self.world_size)

    @property
    def world_size(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def device_id(self) -> int:
        from ..parallel.api import current_device
        dev = current_device()
        if dev is None or dev.type != "cuda":
            return 0
        return dev.index or 0

    @property
    def dev_id(self) -> int:
        return self.device_id

    @property
    def current_endpoint(self) -> str:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        r = self.rank
        return eps[r] if r < len(eps) and eps[r] else f"127.0.0.1:{r}"

    @property
    def trainer_endpoints(self) -> List[str]:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


class ParallelMode:
    """ref: fleet/base/topology.py ParallelMode enum."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


# -- gloo compatibility (ref: distributed/parallel.py gloo_* — CPU
# barrier/rendezvous helpers): a gloo process group on the CPU

def gloo_init_parallel_env(rank_id: int, rank_num: int,
                           server_endpoint: str) -> None:
    """ref: gloo_init_parallel_env — CPU-only bring-up over a gloo
    group at ``server_endpoint``."""
    from ..parallel import init_parallel_env
    init_parallel_env(server_endpoint, rank_num, rank_id, backend="gloo",
                      device="cpu")


def gloo_barrier() -> None:
    from ..parallel import barrier
    barrier()


def gloo_release() -> None:
    """ref: gloo_release — the group is released at process exit."""
