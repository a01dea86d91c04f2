"""Key-sharded tables beyond device memory (the port's counterpart of
``paddle_tpu/nn/layers/sharded_embedding.py``): table capacity scales
with the cluster, not one host.

The parameter server shards its sparse tables by key over server nodes
and routes pull / push RPCs to the owner (memory_sparse_table.h
``shard_num``; brpc_ps_client.cc). As in the JAX package there is no
RPC and no server: ownership is arithmetic over the mesh's ``dp`` axis.
Data rank d of W OWNS the ids with ``id % W == d``, and stores only
their rows, in one :class:`HostOffloadedEmbedding` pool.

- **Pull**: the rank's ids are all-gathered over the data ranks; each
  rank answers for the ids it owns (zeros elsewhere) and one all-reduce
  sum rebuilds every row on every rank (each row has exactly one owner,
  so the sum is the routed gather). These are host tensors, so gloo
  carries them without staging; the rank's rows then go to the card as
  ``HostOffloadedEmbedding``'s do (a pinned buffer, copied without
  blocking).
- **Push** (the lookup's backward): the ids and gradient blocks are
  all-gathered, and each owner applies the accessor rule to its ids
  once.
- **Restore** takes any set of ``shard{r}of{n}`` files and keeps the
  rows the current world size assigns to this rank: a job can come back
  at another size.

Where the axis is not live (no mesh, or one rank), the layer runs as a
local table.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..layer import Layer
from .host_embedding import HostOffloadedEmbedding, _host_ids, \
    pooled_combine

_GLOO_GROUPS: dict = {}


def _host_group(group):
    """A gloo group over ``group``'s ranks (``group`` itself where it is
    gloo): the host tensors of the pull and push travel over it."""
    if dist.get_backend(group) == "gloo":
        return group
    ranks = tuple(dist.get_process_group_ranks(group))
    if ranks not in _GLOO_GROUPS:
        _GLOO_GROUPS[ranks] = dist.new_group(list(ranks), backend="gloo")
    return _GLOO_GROUPS[ranks]


def _gather(x: torch.Tensor, group, w: int) -> torch.Tensor:
    outs = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(outs, x.contiguous(), group=group)
    return torch.stack(outs)


class _ShardedLookup(torch.autograd.Function):
    """The rank's rows of ``ids`` from their owners, on the anchor's
    device; the backward routes the gradients to the owners."""

    @staticmethod
    def forward(ctx, ids, anchor, layer, group, w, my):
        host = torch.from_numpy(_host_ids(ids))
        gids = _gather(host, group, w)                    # [W, b, k]
        part = torch.from_numpy(layer._pull_owned(w, gids.numpy(), my))
        dist.all_reduce(part, group=group)                # routed gather
        rows = part[my]
        dev = anchor.device
        if dev.type == "cuda":
            staged = torch.empty(rows.shape, dtype=torch.float32,
                                 pin_memory=True)
            staged.copy_(rows)
            rows = staged.to(dev, non_blocking=True)
        ctx.host, ctx.layer, ctx.group, ctx.w, ctx.my = \
            host, layer, group, w, my
        ctx.anchor = (anchor.device, anchor.dtype)
        return rows

    @staticmethod
    def backward(ctx, g):
        gids = _gather(ctx.host, ctx.group, ctx.w)
        gg = _gather(g.detach().to("cpu", torch.float32), ctx.group, ctx.w)
        ctx.layer._push_owned(ctx.w, gids.numpy(), gg.numpy(), ctx.my)
        dev, dtype = ctx.anchor
        return None, torch.zeros(1, device=dev, dtype=dtype), None, None, \
            None, None


class ShardedHostEmbedding(Layer):
    """Pooled sparse-slot embedding, key-sharded over the ``dp`` mesh
    axis (the pooled MultiSlot semantics and accessor rules of
    :class:`HostOffloadedEmbedding`).

    ``host_budget_rows``: a hard cap on the rows THIS process may hold,
    its host RAM budget. A table whose global row count exceeds any one
    budget still trains, since each rank stores only its ~1/W share.
    """

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 combiner: str = "sum", padding_idx: Optional[int] = 0,
                 hash_ids: bool = False, optimizer: str = "adagrad",
                 learning_rate: float = 0.05, init_scale: float = 1e-3,
                 initial_accumulator: float = 0.1, seed: int = 0,
                 axis: str = "dp",
                 host_budget_rows: Optional[int] = None,
                 async_push: bool = False, max_pending_push: int = 2,
                 spill_dir: Optional[str] = None):
        super().__init__()
        self.axis = axis
        self.host_budget_rows = host_budget_rows
        self.combiner = combiner
        self.padding_idx = padding_idx
        self.hash_ids = hash_ids
        self.embedding_dim = embedding_dim
        self.num_embeddings = num_embeddings
        # ownership keys on folded ids, so this layer folds; the local
        # pool never folds (it takes folded ids) but carries hash_ids so
        # its snapshots get the right fold tag
        self._local = HostOffloadedEmbedding(
            num_embeddings, embedding_dim, combiner=combiner,
            padding_idx=padding_idx, hash_ids=hash_ids,
            optimizer=optimizer, learning_rate=learning_rate,
            init_scale=init_scale,
            initial_accumulator=initial_accumulator, seed=seed,
            async_push=async_push, max_pending_push=max_pending_push,
            spill_dir=spill_dir)
        # its own anchor, so the lookup's backward runs (as
        # HostOffloadedEmbedding's)
        from .. import initializer as I
        self.push_anchor = self.create_parameter(
            [1], initializer=I.Constant(0.0))

    # -- host-side shard handlers ------------------------------------------
    def _check_budget(self) -> None:
        if (self.host_budget_rows is not None
                and self._local.touched_rows > self.host_budget_rows):
            raise RuntimeError(
                f"host shard holds {self._local.touched_rows} rows > "
                f"budget {self.host_budget_rows}; raise the budget or "
                f"add hosts (capacity scales with the cluster)")

    def _pull_owned(self, w: int, gids: np.ndarray,
                    my_idx) -> np.ndarray:
        """The rows of the ids rank ``my_idx`` of ``w`` owns; zeros
        elsewhere (the sum over the owners completes the gather)."""
        flat = np.asarray(gids, np.int64).reshape(-1)
        own = (flat % w) == int(my_idx)
        out = np.zeros((flat.size, self.embedding_dim), np.float32)
        if own.any():
            out[own] = self._local._pull(flat[own])
            self._check_budget()
        return out.reshape(np.shape(gids) + (self.embedding_dim,))

    def _push_owned(self, w: int, gids: np.ndarray, ggrads: np.ndarray,
                    my_idx) -> np.ndarray:
        flat = np.asarray(gids, np.int64).reshape(-1)
        g = np.asarray(ggrads, np.float32).reshape(
            -1, self.embedding_dim)
        own = (flat % w) == int(my_idx)
        if own.any():
            self._local._push(flat[own], g[own])
        return np.zeros((), np.float32)

    def _live_mesh(self, mesh=None):
        from ...parallel.mesh import get_mesh
        mesh = mesh or get_mesh(required=False)
        if mesh is None or not mesh.has_axis(self.axis):
            return None
        return mesh

    def forward(self, ids):
        ids = torch.as_tensor(ids)
        if self.hash_ids:
            from .sparse_embedding import fold_hash_ids
            ids = fold_hash_ids(ids, self.num_embeddings, self.padding_idx)
        mesh = self._live_mesh()
        if mesh is None:
            # a one-wide axis: the unsharded host-table path
            return pooled_combine(ids, self._local._lookup(ids),
                                  self.padding_idx, self.combiner)
        w = mesh.axis_size(self.axis)
        group = _host_group(mesh.group(self.axis))
        emb = _ShardedLookup.apply(ids, self.push_anchor, self, group, w,
                                   mesh.local_rank(self.axis))
        return pooled_combine(ids, emb, self.padding_idx, self.combiner)

    # -- sharded snapshot lifecycle ----------------------------------------
    @property
    def touched_rows_local(self) -> int:
        return self._local.touched_rows

    def snapshot_shard(self, path_prefix: str) -> str:
        """Write THIS process's shard (save_sparse_table per PS node)."""
        rank, n = (dist.get_rank(), dist.get_world_size()) \
            if dist.is_initialized() else (0, 1)
        path = f"{path_prefix}.shard{rank}of{n}.npz"
        self._local.snapshot(path)
        return path

    def restore_shards(self, paths: Sequence[str], mesh=None) -> None:
        """Load any set of shard files, keeping only the rows the CURRENT
        topology assigns to this rank (a restore at another world size
        re-keys). Without a live axis this process owns everything."""
        live = self._live_mesh(mesh)
        if live is None:
            w, mine = 1, [0]
        else:
            w, mine = live.axis_size(self.axis), [live.local_rank(self.axis)]
        all_ids, all_vals, all_aid, all_acc = [], [], [], []
        for p in paths:
            z = np.load(p if str(p).endswith(".npz") else p + ".npz")
            if tuple(z["meta"]) != (self.num_embeddings,
                                    self.embedding_dim):
                raise ValueError(f"shard {p} shape mismatch")
            self._local._check_fold(z, p)  # refuse fold-scheme mismatch
            ids = np.asarray(z["ids"], np.int64)
            keep = np.isin(ids % w, mine)
            all_ids.append(ids[keep])
            all_vals.append(np.asarray(z["values"], np.float32)[keep])
            aid = np.asarray(z["acc_ids"], np.int64)
            akeep = np.isin(aid % w, mine)
            all_aid.append(aid[akeep])
            all_acc.append(np.asarray(z["accs"], np.float32)[akeep])
        d = self.embedding_dim
        self._local._load_arrays(
            np.concatenate(all_ids) if all_ids else np.empty(0, np.int64),
            np.concatenate(all_vals) if all_vals
            else np.zeros((0, d), np.float32),
            np.concatenate(all_aid) if all_aid else np.empty(0, np.int64),
            np.concatenate(all_acc) if all_acc
            else np.zeros((0, d), np.float32))
