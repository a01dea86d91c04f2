"""The distributed state of a ``Model`` on a mesh: the gradient
reduction, the global loss, fsdp shards, tensor-parallel slices and
pipeline stages.

In the JAX package, ``distributed_model`` attaches shardings and XLA
compiles one SPMD program: each device computes on its rows and its
pieces of the parameters, and the collectives are inserted where the
sharded and replicated parts of the step meet. The port runs one process
a rank and does that part of the program by hand (the reference's
EagerReducer, distributed/collective/reducer.h:88), after the backward
and before the update:

- **dp.** Every rank holds every parameter. Gradients of its rows are
  all-reduced over the data ranks in one flat bucket a dtype, the loss
  riding in the float32 bucket, and divided by the ranks that split the
  batch — or, where the loss names its count (``loss.count(*labels)``:
  the tokens a mean runs over, which a loss mask or ``ignore_index``
  makes differ between ranks), each rank's loss is weighted by its count
  over the global count before the backward and the sum is the result.
  Every rank then holds the same bits, and the update keeps the replicas
  equal.
- **fsdp.** A parameter whose logical ``embed`` dim the rules map to the
  fsdp axis lives as this rank's shard (a plain tensor; the network's
  parameter holds no storage between steps). The shards are all-gathered
  into the parameters before a forward, the full gradients
  reduce-scattered back to shards after the backward (then all-reduced
  over the other axes that replicate it), and the optimizer updates the
  shards, so its state is sharded like its parameter.
- **tp.** A parameter the rules split over ``tp`` is this rank's slice,
  in the network itself (``p.data``), from set-up on: the layers compute
  on their slices with the collectives of ``collective.copy_to_tp`` /
  ``reduce_from_tp``. Every tp rank computes the same loss, so the
  gradients of tp-replicated parameters are equal across them already
  and are not reduced over tp; the slices' gradients stay local.
- **pp.** A pipelined trunk's stacked parameters (a leading
  ``pp_stage`` dim) are this rank's stages. Each pp rank computes the
  loss of its rows of the pipeline's output (``pp_rows``), so the loss
  and the gradients of the parameters outside the trunk (replicated over
  pp) are reduced over the data ranks and pp; the stages' over the data
  ranks only.
- **sp.** Every sp rank of a data slice takes the same rows; the
  sequence-parallel GPT keeps its slice of the sequence after the
  embeddings and runs ring attention over the ``sp`` group, which its
  layers and its criterion learn at set-up (``attach_sp``). Each sp rank
  computes the loss of its positions (their next-token labels come from
  the whole label row, the last position of the last rank predicting
  nothing), so the loss is count-weighted over the data ranks, pp and
  sp, and the gradients of parameters (replicated over sp: partial sums
  over the rank's tokens) are summed over sp as well.

Norms (the numeric guard, ``ClipGradByGlobalNorm``, ``ClipGradByNorm``,
Lamb, LarsMomentum, Adafactor) sum each piece's squares across the ranks
that hold the other pieces (``nn.clip.sharded_norms``). A checkpoint, a
``Model.save`` or a load moves between the rank's pieces and the whole
tensors in the JAX package's names and layouts (:meth:`full_tree`,
:meth:`local_tree`). A mesh of one rank leaves every tensor untouched,
so a ``dp=1`` step equals the unsharded step bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..nn import clip as _clip
from . import collective as _coll
from .mesh import AXIS_ORDER, DeviceMesh
from .sharding import (LogicalRules, check_runnable,
                       check_sequence_parallel, full_from_pieces,
                       local_piece, param_layout, row_groups,
                       tp_permutation)

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


def _axes(*names) -> Tuple[str, ...]:
    return tuple(a for a in AXIS_ORDER if a in names)


class MeshSync:
    """One per ``Model`` under ``distributed_model``."""

    def __init__(self, mesh: DeviceMesh,
                 rules: Optional[LogicalRules] = None):
        check_runnable(mesh)
        self.mesh = mesh
        self.rules = rules or LogicalRules()
        self.n = mesh.data_size
        self.pp = mesh.axis_size("pp")
        self.tp = mesh.axis_size("tp")
        self.sp = mesh.axis_size("sp")
        # the ranks whose rows (and sequence slices) of the global batch
        # make the loss
        self.rows = self.n * self.pp * self.sp
        self.active = mesh.size > 1
        self._groups: Dict[Tuple[str, ...], object] = {}
        self.data_group = self.group(mesh.data_axes)
        self.data_index = mesh.index(mesh.data_axes)
        self.rows_axes = _axes(*mesh.data_axes, *(
            ("pp",) if self.pp > 1 else ()), *(
            ("sp",) if self.sp > 1 else ()))
        self.rows_group = self.group(self.rows_axes)
        self.fsdp = mesh.axis_size("fsdp")
        self.fsdp_group = self.group(("fsdp",))
        self.fsdp_index = mesh.local_rank("fsdp")
        self.pp_group = self.group(("pp",))
        self.pp_index = mesh.local_rank("pp")
        self.tp_group = _coll.TPGroup(mesh) if self.tp > 1 else None
        self.sp_group = _coll.SPGroup(mesh) if self.sp > 1 else None
        self.world = self.group(mesh.axis_names)
        # fsdp: name -> (dim, full shape); name -> this rank's shard
        self.sharded: Dict[str, Tuple[int, torch.Size]] = {}
        self.shards: Dict[str, torch.Tensor] = {}
        # tp / pp: name -> {"tp": (dim, permutation), "pp": dim}
        self.pieces: Dict[str, dict] = {}
        self.row_groups = 1   # the microbatches the data axes split
        self.full_shapes: Dict[str, torch.Size] = {}
        self._params: Dict[str, torch.nn.Parameter] = {}
        self._set_up = False
        self.reduce_seconds = 0.0

    def group(self, axes):
        """The process group of the live ``axes`` (None when none is
        live, or on a one-rank mesh), built once."""
        axes = _axes(*axes)
        live = tuple(a for a in axes if self.mesh.has_axis(a))
        if not live:
            return None
        if live not in self._groups:
            self._groups[live] = self.mesh.group(live)
        return self._groups[live]

    @property
    def is_writer(self) -> bool:
        """The rank that writes checkpoints (global rank 0)."""
        return not dist.is_initialized() or dist.get_rank() == 0

    # -- set-up ---------------------------------------------------------
    def setup(self, params: Dict[str, torch.nn.Parameter],
              network=None, loss=None) -> None:
        """Once, before the first step: every rank takes the mesh's first
        rank's values; given the ``network`` (a Model's: its parameters'
        logical axes), its tp- and pp-split parameters become this rank's
        pieces, and under fsdp each sharded parameter this rank's
        shard; under sp its layers and the ``loss`` learn the sp
        group."""
        if self._set_up:
            return
        check_sequence_parallel(network, self.mesh)
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
                                       self.mesh.axis_names, 0, self.mesh)
                for p, v in zip(ps, _unflat(flat, ps)):
                    p.copy_(v)
        if network is None:
            return
        meta = network.param_meta()
        if self.tp > 1 or self.pp > 1:
            self._split(network, meta)
        if self.sp_group is not None:
            for m in [*network.modules(), loss]:
                if hasattr(m, "attach_sp"):
                    m.attach_sp(self.sp_group)
        if self.fsdp_group is None:
            return
        for name, p in params.items():
            shape = self.full_shapes.get(name, p.shape)
            dim = param_layout(name, shape, meta, self.mesh,
                               self.rules).get("fsdp")
            if dim is not None:
                self.sharded[name] = (dim, p.shape)
                p._full_shape = shape
                self.shards[name] = local_piece(
                    p.detach(), dim, self.fsdp, self.fsdp_index)
        self.reshard()

    def _split(self, network, meta) -> None:
        """This rank's tp slices and pp stages of ``network``'s
        parameters, in place; the layers learn their tp group."""
        from .pipeline import PipelineParallel
        pipes = [m for m in network.modules()
                 if isinstance(m, PipelineParallel)]
        if self.pp > 1 and not pipes:
            raise ValueError(
                "a pp mesh needs a pipelined network (a PipelineParallel "
                "trunk, e.g. models.gpt.GPTForCausalLMPipe)")
        for pipe in pipes:
            pipe.attach_mesh(self.mesh)
        self.row_groups = row_groups(network, self.mesh)
        with torch.no_grad():
            for name, p in network.named_parameters():
                lay = param_layout(name, p.shape, meta, self.mesh,
                                   self.rules)
                piece = {}
                if "pp" in lay:
                    if lay["pp"] != 0:
                        raise ValueError(f"{name}: the pp stage dim must "
                                         f"lead, got dim {lay['pp']}")
                    piece["pp"] = 0
                if "tp" in lay:
                    _check_tp_owner(network, name)
                    perm = tp_permutation(network, name, self.tp)
                    piece["tp"] = (lay["tp"], perm)
                if not piece:
                    continue
                self.full_shapes[name] = p.shape
                self.pieces[name] = piece
                p._full_shape = p.shape   # what the planner counts
                p.data = self._local(name, p.detach())
        if self.tp_group is not None:
            for m in list(network.modules()):
                if hasattr(m, "attach_tp"):
                    m.attach_tp(self.tp_group)

    def _local(self, name, full, dim_of=lambda d: d):
        piece = self.pieces[name]
        x = full
        if "pp" in piece and dim_of(0) is not None:
            x = local_piece(x, dim_of(0), self.pp, self.pp_index)
        if "tp" in piece:
            d, perm = piece["tp"]
            if dim_of(d) is not None:
                x = local_piece(x, dim_of(d), self.tp, self.tp_group.index,
                                perm)
        return x

    def opt_params(self, params: Dict[str, torch.Tensor]):
        """What the optimizer updates: the shards of sharded parameters,
        the parameters (this rank's pieces) otherwise."""
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

    def release(self, network, *others) -> None:
        """Give ``network`` its whole parameters back (fsdp shards
        gathered, tp slices and pp stages joined: collectives on every
        rank) and take it and ``others`` (a loss) off the mesh's groups,
        so that the Model can go on another mesh."""
        with torch.no_grad():
            self.unshard()
            params = dict(network.named_parameters())
            full = self.full_tree({k: p.detach() for k, p in params.items()},
                                  fsdp=False)
            for k, t in full.items():
                params[k].data = t
        for p in params.values():
            p.__dict__.pop("_full_shape", None)
        self.shards.clear()
        self.sharded.clear()
        self.pieces.clear()
        from .pipeline import PipelineParallel
        for m in [*network.modules(), *others]:
            if hasattr(m, "attach_tp"):
                m._tp = None
            if hasattr(m, "attach_sp"):
                m._sp = None
            if isinstance(m, PipelineParallel):
                m.attach_mesh(None)

    def chunk(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.sharded[name][0]
        return local_piece(full, dim, self.fsdp, self.fsdp_index)

    def refresh_shards(self) -> None:
        """Shards from the (unsharded) parameters: after a load wrote
        full values into them."""
        with torch.no_grad():
            for k in self.shards:
                self.shards[k].copy_(self.chunk(k, self._params[k].detach()))

    # -- the batch ----------------------------------------------------------
    def pp_rows(self, tree, dim: int = 0):
        """This pp rank's rows of the pipeline's output, for labels:
        piece ``pp index`` of the ``dim`` rows (a whole microbatch each
        when the microbatches divide by pp)."""
        if self.pp <= 1:
            return tree
        from ..io import _tree_map

        def take(x):
            shape = getattr(x, "shape", ())
            if len(shape) <= dim:
                return x
            if shape[dim] % self.pp:
                raise ValueError(
                    f"{shape[dim]} rows do not split over pp={self.pp}: "
                    f"the pipeline's output lands on the pp ranks in "
                    f"equal row blocks")
            b = shape[dim] // self.pp
            sl = [slice(None)] * dim + [slice(self.pp_index * b,
                                              (self.pp_index + 1) * b)]
            return x[tuple(sl)]
        return _tree_map(take, tree)

    # -- the step ---------------------------------------------------------
    def loss_weight(self, loss_fn, labels) -> Optional[torch.Tensor]:
        """This rank's count over the global count, where the loss names
        its count; None (an even average) otherwise."""
        counter = getattr(loss_fn, "count", None)
        if self.rows_group is None or counter is None:
            return None
        c = torch.as_tensor(counter(*labels)).to(torch.float32).reshape(())
        total = c.clone()
        _coll.all_reduce_(total, self.rows_group)
        return c / total

    def _reduce_axes(self, name: str) -> Tuple[str, ...]:
        """The axes over which a (non-fsdp) gradient is summed: the data
        axes, sp, and pp unless it is a pipeline stage."""
        pp = () if "pp" in self.pieces.get(name, ()) else ("pp",)
        return _axes(*self.mesh.data_axes, "sp", *pp)

    def reduce(self, grads: Dict[str, torch.Tensor], loss: torch.Tensor,
               weighted: bool):
        """Reduce this rank's gradients and (weighted) loss: returns the
        gradients the optimizer takes (shards of sharded names) and the
        global loss, identical on every rank."""
        if not self.active:
            return grads, loss
        t0 = time.perf_counter()
        out = dict(grads)
        # one flat all-reduce a (group, dtype), the loss in the float32
        # bucket of the rows group
        buckets: Dict[Tuple, List[str]] = {}
        for k in grads:
            if k not in self.sharded:
                key = (self._reduce_axes(k), str(grads[k].dtype))
                buckets.setdefault(key, []).append(k)
        buckets.setdefault((self.rows_axes, str(torch.float32)), [])
        loss_out = loss
        for (axes, dt), names in sorted(buckets.items()):
            group = self.group(axes)
            parts = [grads[k] for k in names]
            with_loss = axes == self.rows_axes and dt == str(torch.float32)
            if with_loss:
                parts = parts + [loss.detach().reshape(1)]
            if not parts or (group is None and weighted):
                continue
            flat = _flat(parts)
            if group is not None:
                _coll.all_reduce_(flat, group)
            if not weighted:
                flat.div_(self.rows)
            vals = _unflat(flat, parts)
            for k, v in zip(names, vals):
                out[k] = v
            if with_loss:
                loss_out = vals[-1].reshape(())
        # sharded: reduce-scatter over fsdp, then all-reduce over the
        # other axes that replicate the shard
        if self.sharded:
            sh = [k for k in grads if k in self.sharded]
            for names in self._group_by_dtype(sh).values():
                by_rest: Dict[Tuple[str, ...], List[str]] = {}
                for k in names:
                    rest = tuple(a for a in self._reduce_axes(k)
                                 if a != "fsdp")
                    by_rest.setdefault(rest, []).append(k)
                for rest, ks in sorted(by_rest.items()):
                    rows = []
                    for k in ks:
                        pieces = torch.chunk(grads[k], self.fsdp,
                                             dim=self.sharded[k][0])
                        rows.append(torch.stack(
                            [p.contiguous().reshape(-1) for p in pieces]))
                    inp = torch.cat(rows, dim=1).reshape(-1)
                    res = self._scatter_flat(inp)
                    if self.group(rest) is not None:
                        _coll.all_reduce_(res, self.group(rest))
                    if not weighted:
                        res.div_(self.rows)
                    for k, v in zip(ks, _unflat(
                            res, [self.shards[k] for k in ks])):
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
        if self.rows_group is None:
            return loss
        x = (loss.detach().float() * weight if weight is not None
             else loss.detach().float()).reshape(1).clone()
        _coll.all_reduce_(x, self.rows_group)
        if weight is None:
            x.div_(self.rows)
        return x.reshape(())

    def gather_seq(self, x):
        """The whole sequence (dim 1) of a per-position output (logits),
        from the sp ranks' slices, in rank order."""
        if self.sp_group is None or not isinstance(x, torch.Tensor) \
                or x.dim() < 2:
            return x
        return torch.cat(_coll.all_gather_list(x, self.sp_group.group),
                         dim=1)

    def gather_rows(self, x, split: bool = True):
        """The global batch's rows of a per-row output (metric outputs,
        predictions), in rank order: the pp ranks' rows of their data
        rank's, then (when the data ranks ``split`` the batch) the data
        ranks'."""
        if self.rows_group is None or not isinstance(x, torch.Tensor) \
                or x.dim() == 0:
            return x
        if self.pp_group is not None:
            x = torch.cat(_coll.all_gather_list(x, self.pp_group), dim=0)
        if self.data_group is None or not split:
            return x
        parts = _coll.all_gather_list(x, self.data_group)
        g = self.row_groups
        if g > 1 and x.shape[0] % g == 0:
            # each data rank's rows are its slice of every microbatch
            # (sharding.shard_batch): put the microbatches back together
            parts = [p.reshape(g, -1, *p.shape[1:]) for p in parts]
            return torch.cat(parts, dim=1).reshape(-1, *x.shape[1:])
        return torch.cat(parts, dim=0)

    def norm_context(self):
        """Norms and finiteness over the pieces: each sharded name with
        the axes and group of its other pieces and its split dims."""
        spec = {}
        for k in set(self.sharded) | set(self.pieces):
            piece = self.pieces.get(k, {})
            axes, dims = [], {}
            if k in self.sharded:
                axes.append("fsdp")
                dims[self.sharded[k][0]] = self.fsdp
            if "pp" in piece:
                axes.append("pp")
                dims[0] = self.pp
            if "tp" in piece:
                axes.append("tp")
                dims[piece["tp"][0]] = self.tp
            axes = _axes(*axes)
            spec[k] = (axes, self.group(axes), dims)
        if not spec:
            return contextlib.nullcontext()
        return _clip.sharded_norms(spec, self.world)

    def rows_context(self, split: bool):
        from ..core import rng
        if not (self.n > 1 and split):
            return contextlib.nullcontext()
        return rng.batch_rows(self.data_index, self.n, self.row_groups)

    def barrier(self) -> None:
        if self.active:
            x = torch.zeros(1)
            dist.all_reduce(x, group=self._host_group())

    def _host_group(self):
        """A gloo group over every rank of the mesh for host barriers
        (the mesh's own group where it is gloo)."""
        if dist.get_backend(self.world) == "gloo":
            return self.world
        if not hasattr(self, "_gloo"):
            self._gloo = dist.new_group(
                dist.get_process_group_ranks(self.world), backend="gloo")
        return self._gloo

    # -- checkpoint trees -------------------------------------------------
    def _leaf_dim(self, path, name: str, leaf, dim: int) -> Optional[int]:
        """The dim of a state leaf under ``name`` that the parameter's
        split ``dim`` maps to: the same dim for a leaf of the parameter's
        rank; Adafactor's factored statistics drop a dim (``vr`` the
        last, ``vc`` the one before), so a split of the dropped dim
        leaves them whole; None where the leaf is not split."""
        nd = len(self.full_shapes.get(name, self._params[name].shape
                                      if name in self._params else ()))
        if leaf.dim() == nd and leaf.numel():
            return dim
        if leaf.dim() == nd - 1 and leaf.numel():
            if "vr" in path:
                return dim if dim < nd - 1 else None
            if "vc" in path:
                return dim if dim < nd - 2 else (
                    nd - 2 if dim == nd - 1 else None)
        return None

    def _map_split(self, tree, fn, path=()):
        """``fn(path, name, leaf)`` on every tensor leaf held under a
        split parameter's name (parameters and their optimizer state)."""
        names = set(self.sharded) | set(self.pieces)
        if isinstance(tree, dict):
            return {k: (fn(path, k, v) if k in names
                        and hasattr(v, "shape")
                        else self._map_split(v, fn, path + (k,)))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._map_split(v, fn, path) for v in tree)
        return tree

    def full_tree(self, tree, fsdp: bool = True):
        """The whole training state in the JAX package's layouts: every
        fsdp shard (unless ``fsdp`` is False: the tree already holds full
        fsdp tensors), tp slice and pp stage gathered (collectives on
        every rank), as ``DTensor.full_tensor()`` does."""
        if not (self.sharded and fsdp) and not self.pieces:
            return tree
        items: List[Tuple[int, torch.Tensor]] = []

        class _Slot:
            def __init__(self, i, path, name, leaf):
                self.i, self.path, self.name, self.leaf = i, path, name, leaf

        def collect(path, name, v):
            if fsdp and name in self.sharded:
                d = self._leaf_dim(path, name, v, self.sharded[name][0])
                if d is not None:
                    items.append((d, v))
                    return _Slot(len(items) - 1, path, name, v)
            return _Slot(None, path, name, v)
        keyed = self._map_split(tree, collect)
        fulls = self._gather_many(items) if items else []

        def put(t):
            if isinstance(t, dict):
                return {k: put(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(put(v) for v in t)
            if not isinstance(t, _Slot):
                return t
            x = fulls[t.i] if t.i is not None else t.leaf
            return self._join(t.path, t.name, x)
        return put(keyed)

    def _join(self, path, name, x):
        """A leaf's tp slices and pp stages gathered."""
        piece = self.pieces.get(name)
        if not piece:
            return x
        if "tp" in piece:
            d, perm = piece["tp"]
            ld = self._leaf_dim(path, name, x, d)
            if ld is not None:
                x = full_from_pieces(_coll.all_gather_list(
                    x, self.tp_group.group), ld, perm)
        if "pp" in piece and self._leaf_dim(path, name, x, 0) is not None:
            x = torch.cat(_coll.all_gather_list(x, self.pp_group), dim=0)
        return x

    def local_tree(self, tree, fsdp: bool = True):
        """This rank's pieces of a restored whole tree (its pp stages and
        tp slices, and, unless ``fsdp`` is False, its fsdp shards)."""
        if not (self.sharded and fsdp) and not self.pieces:
            return tree

        def cut(path, name, v):
            v = torch.as_tensor(v)
            if name in self.pieces:
                v = self._local(name, v, lambda d: self._leaf_dim(
                    path, name, v, d))
            if fsdp and name in self.sharded:
                d = self._leaf_dim(path, name, v, self.sharded[name][0])
                if d is not None:
                    v = local_piece(v, d, self.fsdp, self.fsdp_index)
            return v
        return self._map_split(tree, cut)


def _check_tp_owner(network, name: str) -> None:
    """A tp-split parameter needs the layer that owns it to compute on
    slices (a ``tp_params`` entry, and ``attach_tp``): a plain layer
    would compute on a slice as if it were the whole tensor."""
    parts = name.split(".")
    for i in range(len(parts) - 1, -1, -1):
        mod = network.get_submodule(".".join(parts[:i])) if i else network
        rest = ".".join(parts[i:])
        inner = getattr(mod, "tp_inner", None)
        if inner is not None:      # a pipeline's stacked stage parameter
            mod, rest = inner(rest)
            return _check_tp_owner(mod, rest)
        if rest in getattr(mod, "tp_params", ()):
            return
    raise NotImplementedError(
        f"{name} is split over tp by the rules, but the layer that owns it "
        f"does not compute on tp slices (tp_params / attach_tp: the GPT "
        f"family's attention, MLP, embeddings and head)")
