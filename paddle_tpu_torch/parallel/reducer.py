"""The data-parallel and fully sharded state of a ``Model`` on a mesh:
the gradient reduction, the global loss and the fsdp shards.

In the JAX package, ``distributed_model`` attaches shardings and XLA
compiles one SPMD program: each device computes on its rows, and the
gradient all-reduce (dp) or reduce-scatter (fsdp) is inserted where the
sharded and replicated parts of the step meet. The port runs one process
a rank and does that part of the program by hand (the reference's
EagerReducer, distributed/collective/reducer.h:88), after the backward
and before the update:

- **dp.** Every rank holds every parameter. Gradients of its rows are
  all-reduced over the data ranks in one flat bucket a dtype, the loss
  riding in the float32 bucket, and divided by the data ranks — or,
  where the loss names its count (``loss.count(*labels)``: the tokens a
  mean runs over, which a loss mask or ``ignore_index`` makes differ
  between ranks), each rank's loss is weighted by its count over the
  global count before the backward and the sum is the result. Every rank
  then holds the same bits, and the update keeps the replicas equal.
- **fsdp.** A parameter whose logical ``embed`` dim the rules map to the
  fsdp axis lives as this rank's shard (a plain tensor; the network's
  parameter holds no storage between steps). The shards are all-gathered
  into the parameters before a forward, the full gradients
  reduce-scattered back to shards after the backward (then all-reduced
  over dp where both axes are live), and the optimizer updates the shards,
  so its state is sharded like its parameter. Replicated parameters
  (biases, norms) take the dp path over all data ranks. Global norms
  (the numeric guard, ``ClipGradByGlobalNorm``) sum the shards' squares
  across the fsdp ranks (``nn.clip.sharded_norms``).

A mesh whose data axes have one rank leaves every tensor untouched, so a
``dp=1`` step equals the unsharded step bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..nn import clip as _clip
from . import collective as _coll
from .mesh import DeviceMesh
from .sharding import check_runnable

_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, likes: List[torch.Tensor]):
    out, o = [], 0
    for t in likes:
        n = t.numel()
        out.append(flat[o:o + n].view(t.shape))
        o += n
    return out


class MeshSync:
    """One per ``Model`` under ``distributed_model``."""

    def __init__(self, mesh: DeviceMesh, shard_params=None):
        check_runnable(mesh)
        self.mesh = mesh
        self.n = mesh.data_size
        self.active = self.n > 1
        self.data_group = mesh.group(mesh.data_axes) if self.active \
            else None
        self.data_index = mesh.index(mesh.data_axes)
        self.fsdp = mesh.axis_size("fsdp")
        self.fsdp_group = mesh.group("fsdp") if self.fsdp > 1 else None
        self.fsdp_index = mesh.local_rank("fsdp")
        self.dp_group = mesh.group("dp") if mesh.has_axis("dp") else None
        self._shard_params = shard_params
        # fsdp: name -> (dim, full shape); name -> this rank's shard
        self.sharded: Dict[str, Tuple[int, torch.Size]] = {}
        self.shards: Dict[str, torch.Tensor] = {}
        self._params: Dict[str, torch.nn.Parameter] = {}
        self._set_up = False
        self.reduce_seconds = 0.0

    @property
    def is_writer(self) -> bool:
        """The rank that writes checkpoints (global rank 0)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    # -- set-up ---------------------------------------------------------
    def setup(self, params: Dict[str, torch.nn.Parameter],
              optimizer=None) -> None:
        """Once, before the first step: the replicas take the data group's
        first rank's values; under fsdp each sharded parameter becomes this
        rank's shard."""
        if self._set_up:
            return
        self._set_up = True
        self._params = dict(params)
        if not self.active:
            return
        with torch.no_grad():
            by_dt: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in params.values():
                by_dt.setdefault(p.dtype, []).append(p)
            for ps in by_dt.values():   # one broadcast a dtype
                flat = _coll.broadcast(_flat([p.detach() for p in ps]),
                                       self.mesh.data_axes, 0, self.mesh)
                for p, v in zip(ps, _unflat(flat, ps)):
                    p.copy_(v)
        if self.fsdp_group is None or self._shard_params is None:
            return
        from ..nn.clip import ClipGradByNorm
        from ..optimizer.optimizer import Adafactor, Lamb
        if isinstance(optimizer, (Lamb, Adafactor)) or isinstance(
                getattr(optimizer, "grad_clip", None), ClipGradByNorm):
            raise NotImplementedError(
                "per-tensor norms (Lamb, Adafactor, ClipGradByNorm) over "
                "fsdp shards are not ported (ROADMAP A6.4)")
        dts = self._shard_params({k: p.detach() for k, p in params.items()})
        fs = self.mesh.axis_names.index("fsdp")
        for name, dt in dts.items():
            pl = dt.placements[fs]
            if pl.is_shard():
                p = params[name]
                self.sharded[name] = (pl.dim, p.shape)
                self.shards[name] = dt.to_local().clone()
        self.reshard()

    def opt_params(self, params: Dict[str, torch.Tensor]):
        """What the optimizer updates: the shards of sharded parameters,
        the parameters themselves otherwise."""
        return {k: self.shards.get(k, p) for k, p in params.items()}

    # -- fsdp gather / free ----------------------------------------------
    def _group_by_dtype(self, names):
        groups: Dict[torch.dtype, List[str]] = {}
        for k in names:
            groups.setdefault(self.shards[k].dtype, []).append(k)
        return groups

    def _gather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """[R * n] from each rank's [n], over the fsdp group (staged
        through pinned host memory under gloo on a card)."""
        g = self.fsdp_group
        h = _coll.wire(flat, g)
        out = torch.empty(self.fsdp * h.numel(), dtype=h.dtype,
                          device=h.device,
                          pin_memory=h.device.type == "cpu" and flat.is_cuda)
        _GATHER(out, h, group=g)
        return _coll.back(out, flat)

    def _gather_many(self, items: List[Tuple[int, torch.Tensor]]):
        """Full tensors of ``(sharded dim, shard)`` items: one all-gather
        a dtype."""
        out: List[Optional[torch.Tensor]] = [None] * len(items)
        by_dt: Dict[torch.dtype, List[int]] = {}
        for i, (_, t) in enumerate(items):
            by_dt.setdefault(t.dtype, []).append(i)
        for idx in by_dt.values():
            flat = self._gather_flat(_flat([items[i][1] for i in idx]))
            per = flat.view(self.fsdp, -1)
            o = 0
            for i in idx:
                dim, t = items[i]
                n = t.numel()
                out[i] = torch.cat([per[r, o:o + n].view(t.shape)
                                    for r in range(self.fsdp)], dim=dim)
                o += n
        return out

    def gather_full(self, tensors: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Full tensors from the shards of sharded names."""
        names = list(tensors)
        fulls = self._gather_many([(self.sharded[k][0], tensors[k])
                                   for k in names])
        return dict(zip(names, fulls))

    def unshard(self) -> None:
        """Full parameters from the shards, before a forward."""
        if not self.shards:
            return
        full = self.gather_full(self.shards)
        for k, t in full.items():
            self._params[k].data = t

    def reshard(self) -> None:
        """Free the full parameters (their storage), after a step."""
        for k in self.shards:
            p = self._params[k]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    def chunk(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.sharded[name][0]
        return torch.chunk(full, self.fsdp, dim=dim)[
            self.fsdp_index].contiguous()

    def refresh_shards(self) -> None:
        """Shards from the (unsharded) parameters: after a load wrote
        full values into them."""
        with torch.no_grad():
            for k in self.shards:
                self.shards[k].copy_(self.chunk(k, self._params[k].detach()))

    # -- the step ---------------------------------------------------------
    def loss_weight(self, loss_fn, labels) -> Optional[torch.Tensor]:
        """This rank's count over the global count, where the loss names
        its count; None (an even average) otherwise."""
        counter = getattr(loss_fn, "count", None)
        if not self.active or counter is None:
            return None
        c = torch.as_tensor(counter(*labels)).to(torch.float32).reshape(())
        total = c.clone()
        _coll.all_reduce_(total, self.data_group)
        return c / total

    def reduce(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor,
               weighted: bool):
        """Reduce this rank's gradients and (weighted) loss: returns the
        gradients the optimizer takes (shards of sharded names) and the
        global loss, identical on every rank."""
        if not self.active:
            return grads, loss
        t0 = time.perf_counter()
        out = dict(grads)
        rep = [k for k in grads if k not in self.sharded]
        # replicated: one flat all-reduce a dtype over every data rank,
        # the loss in the float32 bucket
        by_dt: Dict[torch.dtype, List[str]] = {}
        for k in rep:
            by_dt.setdefault(grads[k].dtype, []).append(k)
        by_dt.setdefault(torch.float32, [])
        loss_out = None
        for dt, names in by_dt.items():
            parts = [grads[k] for k in names]
            if dt == torch.float32:
                parts = parts + [loss.detach().reshape(1)]
            flat = _flat(parts)
            _coll.all_reduce_(flat, self.data_group)
            if not weighted:
                flat.div_(self.n)
            vals = _unflat(flat, parts)
            for k, v in zip(names, vals):
                out[k] = v
            if dt == torch.float32:
                loss_out = vals[-1].reshape(())
        # sharded: reduce-scatter over fsdp, then all-reduce over dp
        if self.sharded:
            sh = [k for k in grads if k in self.sharded]
            for names in self._group_by_dtype(sh).values():
                rows = []
                for k in names:
                    pieces = torch.chunk(grads[k], self.fsdp,
                                         dim=self.sharded[k][0])
                    rows.append(torch.stack([p.contiguous().reshape(-1)
                                             for p in pieces]))
                inp = torch.cat(rows, dim=1).reshape(-1)
                res = self._scatter_flat(inp)
                if self.dp_group is not None:
                    _coll.all_reduce_(res, self.dp_group)
                if not weighted:
                    res.div_(self.n)
                for k, v in zip(names, _unflat(
                        res, [self.shards[k] for k in names])):
                    out[k] = v
        self.reduce_seconds += time.perf_counter() - t0
        return out, loss_out

    def _scatter_flat(self, inp: torch.Tensor) -> torch.Tensor:
        g = self.fsdp_group
        h = _coll.wire(inp, g)
        out = torch.empty(h.numel() // self.fsdp, dtype=h.dtype,
                          device=h.device)
        _SCATTER(out, h, group=g)
        return _coll.back(out, inp)

    def global_loss(self, loss: torch.Tensor,
                    weight: Optional[torch.Tensor]) -> torch.Tensor:
        """The global mean of an evaluation loss (no gradient)."""
        if not self.active:
            return loss
        x = (loss.detach().float() * weight if weight is not None
             else loss.detach().float()).reshape(1).clone()
        _coll.all_reduce_(x, self.data_group)
        if weight is None:
            x.div_(self.n)
        return x.reshape(())

    def gather_rows(self, x):
        """The global batch's rows of a per-row output (metric outputs,
        predictions), in rank order."""
        if not self.active or not isinstance(x, torch.Tensor) \
                or x.dim() == 0:
            return x
        return torch.cat(_coll.all_gather_list(x, self.data_group), dim=0)

    def norm_context(self):
        """Global norms and finiteness over the fsdp shards."""
        if not self.sharded:
            return contextlib.nullcontext()
        return _clip.sharded_norms(set(self.sharded), self.fsdp_group)

    def rows_context(self, split: bool):
        from ..core import rng
        if not (self.active and split):
            return contextlib.nullcontext()
        return rng.batch_rows(self.data_index, self.n)

    def barrier(self) -> None:
        if self.active:
            x = torch.zeros(1)
            dist.all_reduce(x, group=self._host_group())

    def _host_group(self):
        """A gloo group over the data ranks for host barriers (the data
        group itself where it is gloo)."""
        if dist.get_backend(self.data_group) == "gloo":
            return self.data_group
        if not hasattr(self, "_gloo"):
            self._gloo = dist.new_group(
                dist.get_process_group_ranks(self.data_group),
                backend="gloo")
        return self._gloo

    # -- checkpoint trees -------------------------------------------------
    def _map_sharded(self, tree, fn):
        """``fn(name, leaf)`` on every tensor leaf held under a sharded
        parameter's name (parameters and their optimizer state)."""
        if isinstance(tree, dict):
            return {k: (fn(k, v) if k in self.sharded
                        and isinstance(v, torch.Tensor)
                        else self._map_sharded(v, fn))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._map_sharded(v, fn) for v in tree)
        return tree

    def full_tree(self, tree):
        """The unsharded training state: every shard gathered (a
        collective on every rank), as ``DTensor.full_tensor()`` does."""
        if not self.sharded:
            return tree
        items: List[Tuple[int, torch.Tensor]] = []

        class _Slot:
            def __init__(self, i):
                self.i = i

        def collect(name, v):
            items.append((self.sharded[name][0], v))
            return _Slot(len(items) - 1)
        keyed = self._map_sharded(tree, collect)
        fulls = self._gather_many(items)

        def put(t):
            if isinstance(t, dict):
                return {k: put(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(put(v) for v in t)
            return fulls[t.i] if isinstance(t, _Slot) else t
        return put(keyed)

    def local_tree(self, tree):
        """This rank's shards of a restored unsharded tree."""
        if not self.sharded:
            return tree
        return self._map_sharded(
            tree, lambda k, v: self.chunk(k, torch.as_tensor(v)))
