"""Pipeline parallelism over the ``pp`` mesh axis (the port's counterpart
of ``paddle_tpu/parallel/pipeline.py``).

Reference implementation being replaced: ``PipelineLayer`` with
LayerDesc/SharedLayerDesc (python/paddle/distributed/fleet/meta_parallel/
parallel_layers/pp_layers.py:162/:58/:77) and ``PipelineParallel``'s
schedule over point-to-point sends (meta_parallel/pipeline_parallel.py,
pp_utils/p2p_communication.py), interleaved by ``virtual_pp_degree``.

Layout: as in the JAX package, the stage-chunks' weights are ONE
parameter each with a leading ``pp_stage`` dim of ``S = pp * v`` chunks
in round-robin order (position ``r*v + c`` holds chunk ``c*pp + r``);
homogeneous chunks (every in-chunk layer structurally equal) also stack
the layer dim, ``[S, per, ...]`` keyed by suffix (``attn__qkv_proj__
weight``), others keep flat ``[S, ...]`` keys (``0__attn__...``). So the
state dict is the JAX package's, and a pp rank of a Model on the mesh
holds rows ``r*v .. r*v + v`` of each: its chunks ``c*pp + r``
(``parallel.reducer``).

Schedule: the JAX package runs one SPMD ``lax.scan`` over ticks; at tick
``t`` rank ``r`` runs chunk ``c*pp + r`` with ``c = ((t - r) % S) // pp``
on the microbatch injected at ``t - k`` (microbatch ``j`` enters at
``(j // pp) * S + j % pp``; waves of pp, one ring lap a wave). The port
runs the same tick table, one process a rank, and skips the bubble ticks
where the JAX program computes on garbage: a **GPipe fill-drain
schedule** in the circular (interleaved) order — every microbatch's
forward through all ticks, then the ticks in reverse for the backward.
Activations go rank to rank by point-to-point send / recv at the end of
each tick (``collective.exchange``), gradients back the same way.

Randomness: the JAX body folds the tick into one base key,
``fold_in(base_key, t)`` with ``base_key = next_key()`` drawn once a
forward; the port draws the same key and runs chunk ``k`` of microbatch
``j`` under the same ``t``, whatever rank runs it. Homogeneous chunks
fold each layer's index into ``next_key("stage_layers")`` as the JAX
package's inner scan does.

Rematerialization (``remat=True``, the default, as the JAX package's
GPT pipe): the forward keeps each chunk's input only; the backward
recomputes the chunk under the same key, AMP state and mask slices
before differentiating it, so each of a rank's blocks runs its forward
twice a microbatch. The backward runs inside a ``torch.autograd``
function's backward (a reentrant backward a chunk).

Output: the last chunk's outputs gather on the last rank, which hands
each pp rank its block of the batch rows, so the head and the loss
downstream run data-parallel over pp (``MeshSync.pp_rows`` gives the
labels the same rows). With microbatches that divide by pp a rank's
block is whole microbatches, the JAX package's layout.

Constraints (as in the JAX package): the chunks must be structurally
identical and buffer-free; embeddings and the head stay outside the
pipelined trunk (``models.gpt.GPTForCausalLMPipe``).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import amp
from ..core import rng, threefry
from ..nn.layer import Layer, LayerList, Sequential
from . import collective as _coll
from .mesh import DeviceMesh, get_mesh


# ---------------------------------------------------------------------------
# declarative stage description (API parity with pp_layers.py)
# ---------------------------------------------------------------------------

class LayerDesc:
    """Deferred layer construction (ref: pp_layers.py:58 LayerDesc)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> Layer:
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """Weight-tied layer appearing in several stages (ref:
    pp_layers.py:77). Tied weights live outside the pipelined trunk, so
    this is kept for API parity."""

    def __init__(self, key: str, layer_cls, *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.key = key


class PipelineLayer(Layer):
    """Groups a flat layer list into ``num_stages`` equal stage-chunks
    (ref: pp_layers.py:162). With interleaving, ``num_stages`` is the
    TOTAL chunk count ``pp * virtual_pp_degree``."""

    def __init__(self, layers: Sequence, num_stages: int):
        super().__init__()
        built: List[Layer] = [l.build() if isinstance(l, LayerDesc) else l
                              for l in layers]
        if len(built) % num_stages != 0:
            raise ValueError(
                f"{len(built)} layers do not split evenly into "
                f"{num_stages} stages")
        per = len(built) // num_stages
        self.num_stages = num_stages
        self.layers_per_stage = per
        self.stages = LayerList([Sequential(*built[s * per:(s + 1) * per])
                                 for s in range(num_stages)])

    def forward(self, x):
        """Dense (non-pipelined) execution."""
        for stage in self.stages:
            x = stage(x)
        return x


def _round_robin_order(pp: int, v: int) -> List[int]:
    """Stacking order: position r*v + c holds chunk c*pp + r."""
    return [c * pp + r for r in range(pp) for c in range(v)]


def tick_table(pp: int, v: int, m: int):
    """``table[t][r]``: the ``(microbatch, chunk)`` rank ``r`` runs at
    tick ``t`` of the JAX package's circular schedule, or None (a bubble
    tick)."""
    S = pp * v
    ticks = ((m - 1) // pp) * S + ((m - 1) % pp) + S
    table = []
    for t in range(ticks):
        row = []
        for r in range(pp):
            k = (((t - r) % S) // pp) * pp + r
            t0 = t - k
            j = (t0 // S) * pp + t0 % S
            row.append((j, k) if t0 >= 0 and t0 % S < pp and j < m
                       else None)
        table.append(row)
    return table


class PipelineParallel(Layer):
    """Wraps a PipelineLayer for pipelined execution under the mesh's
    ``pp`` axis (ref: meta_parallel/pipeline_parallel.py; interleaving
    ref: pp_layers.py virtual_pp_degree), with the JAX package's stacked
    parameters (see the module docstring).

    ``forward(x)`` on a mesh with a ``pp`` axis pipelines the trunk with
    ``num_microbatches`` microbatches of ``x``'s rows and returns THIS pp
    rank's block of the output rows; without one it runs the chunks
    densely in order. ``mb_spec`` is accepted for the JAX signature: the
    port's data split is ``shard_batch``'s, before the pipeline.

    CHECKPOINT LAYOUT NOTE: ``load_flat_state_dict`` maps the flat
    pre-stacking layout (``{j}__{suffix}`` keys of ``[S, ...]``) onto the
    stacked one, as in the JAX package."""

    def __init__(self, pipe: PipelineLayer, num_microbatches: int = 1,
                 virtual_pp_degree: int = 1,
                 mesh: Optional[DeviceMesh] = None, mb_spec=None,
                 remat: bool = True):
        super().__init__()
        if pipe.num_stages % virtual_pp_degree:
            raise ValueError(
                f"num_stages {pipe.num_stages} not divisible by "
                f"virtual_pp_degree {virtual_pp_degree}")
        self.num_stages = pipe.num_stages
        self.virtual_pp_degree = virtual_pp_degree
        self.num_microbatches = num_microbatches
        self._mesh = mesh
        self._remat = remat
        pp = pipe.num_stages // virtual_pp_degree
        chunks = list(pipe.stages)
        for i, ch in enumerate(chunks):
            if any(True for _ in ch.named_buffers()):
                raise ValueError(
                    "pipelined trunk must be buffer-free (stage "
                    f"{i} registers buffers, e.g. BatchNorm stats)")
        # the structural prototype of one chunk: NOT a sublayer; its own
        # parameters are replaced by the stacked ones in every call
        object.__setattr__(self, "_proto", chunks[0])
        metas = chunks[0].param_meta()
        keys = sorted(dict(chunks[0].named_parameters()).keys())
        for ch in chunks[1:]:
            if sorted(dict(ch.named_parameters()).keys()) != keys:
                raise ValueError("pipeline stages are not structurally "
                                 "identical; SPMD pipelining requires it")
        order = _round_robin_order(pp, virtual_pp_degree)
        self._keys = keys
        self._per = pipe.layers_per_stage
        self._layer_suffixes = self._detect_homogeneous(chunks[0], keys,
                                                        metas)
        chunk_params = [dict(c.named_parameters()) for c in chunks]
        with torch.no_grad():
            if self._layer_suffixes:
                for sfx in self._layer_suffixes:
                    stacked = torch.stack([
                        torch.stack([chunk_params[i][f"{j}.{sfx}"]
                                     for j in range(self._per)])
                        for i in order])
                    meta = metas[f"0.{sfx}"]
                    axes = meta.axes or (None,) * (stacked.dim() - 2)
                    self._add(sfx, stacked, meta.trainable,
                              ("pp_stage", None, *axes))
            else:
                for key in keys:
                    stacked = torch.stack([chunk_params[i][key]
                                           for i in order])
                    axes = metas[key].axes or (None,) * (stacked.dim() - 1)
                    self._add(key, stacked, metas[key].trainable,
                              ("pp_stage", *axes))
        for p in chunks[0].parameters():   # the prototype holds no values
            p.data = torch.empty(0, dtype=p.dtype)

    def _add(self, key, value, trainable, axes):
        name = key.replace(".", "__")
        self.register_parameter(name, torch.nn.Parameter(
            value.clone(), requires_grad=trainable))
        self.set_param_axes(name, axes)

    def _detect_homogeneous(self, chunk, keys, metas):
        """Suffix list when every layer in the chunk is structurally
        identical (same parameter suffixes, shapes, trainability and
        logical axes per layer index); None otherwise."""
        per = self._per
        if per <= 1:
            return None
        by_idx: dict = {}
        for key in keys:
            m = re.match(r"^(\d+)\.(.+)$", key)
            if not m:
                return None
            by_idx.setdefault(int(m.group(1)), set()).add(m.group(2))
        if sorted(by_idx) != list(range(per)):
            return None
        suffixes = by_idx[0]
        if any(s != suffixes for s in by_idx.values()):
            return None
        params = dict(chunk.named_parameters())
        for sfx in suffixes:
            if len({tuple(params[f"{j}.{sfx}"].shape)
                    for j in range(per)}) != 1:
                return None
            meta0 = metas[f"0.{sfx}"]
            for j in range(1, per):
                mj = metas[f"{j}.{sfx}"]
                if mj.trainable != meta0.trainable or mj.axes != meta0.axes:
                    return None
        return sorted(suffixes)

    def load_flat_state_dict(self, sd):
        """Load a pre-stacking checkpoint (flat ``{j}__{suffix}`` keys,
        each ``[S, ...]``) into the homogeneous stacked layout
        (``{suffix}`` keys, ``[S, per, ...]``) by re-stacking the layer
        dim. Already-stacked dicts pass through unchanged."""
        from ..interop import load_reference_state
        if self._layer_suffixes:
            out = dict(sd)
            for sfx in self._layer_suffixes:
                name = sfx.replace(".", "__")
                flat = [f"{j}__{name}" for j in range(self._per)]
                if name not in out and all(k in out for k in flat):
                    out[name] = np.stack(
                        [np.asarray(out.pop(k)) for k in flat], axis=1)
            sd = out
        return load_reference_state(self, sd)

    # -- the mesh and tensor parallelism inside the chunks ------------------
    def attach_mesh(self, mesh: DeviceMesh) -> None:
        """The mesh whose ``pp`` axis runs this trunk (a Model's)."""
        self._mesh = mesh

    def _inner_name(self, key: str) -> str:
        """The prototype's name of a stacked parameter's value."""
        sfx = key.replace("__", ".")
        return f"0.{sfx}" if self._layer_suffixes else sfx

    def tp_inner(self, key: str):
        """(prototype chunk, its parameter name) of a stacked key."""
        return self._proto, self._inner_name(key)

    def tp_permutation(self, key: str, tp: int):
        from .sharding import tp_permutation
        return tp_permutation(self._proto, self._inner_name(key), tp)

    def attach_tp(self, tp) -> None:
        for m in self._proto.modules():
            if m is not self and hasattr(m, "attach_tp"):
                m.attach_tp(tp)

    # -- execution ------------------------------------------------------------
    def _stacked(self):
        keys = self._layer_suffixes or self._keys
        return {k: getattr(self, k.replace(".", "__")) for k in keys}

    def _run_chunk(self, stacked, pos: int, x):
        """Chunk at stacked position ``pos`` on ``x`` in the ambient key
        stream (the dense order)."""
        from torch.func import functional_call
        if self._layer_suffixes:
            for j in range(self._per):
                x = functional_call(
                    self._proto[0], {s: v[pos][j]
                                     for s, v in stacked.items()}, (x,))
            return x
        return functional_call(
            self._proto, {k: v[pos] for k, v in stacked.items()}, (x,))

    def _chunk_body(self, stacked, pos: int, x):
        """The pipelined chunk body inside its tick's key guard: a
        homogeneous chunk folds each layer's index into one
        ``next_key("stage_layers")``, as the JAX package's inner scan."""
        from torch.func import functional_call
        if not self._layer_suffixes:
            return self._run_chunk(stacked, pos, x)
        base = rng.current_stream().next_key("stage_layers")
        for j in range(self._per):
            with rng.key_guard(threefry.fold_in(base, j)):
                x = functional_call(
                    self._proto[0], {s: v[pos][j]
                                     for s, v in stacked.items()}, (x,))
        return x

    def forward(self, x):
        mesh = self._mesh or get_mesh(required=False)
        stacked = self._stacked()
        v = self.virtual_pp_degree
        self._proto.train(self.training)
        if mesh is None or mesh.axis_size("pp") <= 1:
            pp = self.num_stages // v
            for k in range(self.num_stages):
                x = self._run_chunk(stacked, (k % pp) * v + (k // pp), x)
            return x
        pp = mesh.axis_size("pp")
        if pp * v != self.num_stages:
            raise ValueError(
                f"mesh pp={pp} x virtual_pp_degree={v} != "
                f"{self.num_stages} pipeline stages")
        run = _Schedule(self, mesh, stacked, x)
        if not torch.is_grad_enabled():
            return run.forward(x)
        dummy = torch.zeros((), device=x.device, requires_grad=True)
        return _Pipeline.apply(run, x, dummy)


class _Pipeline(torch.autograd.Function):
    """The pipelined trunk as one autograd node: the forward runs every
    tick; the backward runs them in reverse, differentiating each chunk
    (parameter gradients accumulate into the stacked parameters) and
    passing input gradients rank to rank."""

    @staticmethod
    def forward(ctx, run, x, dummy):
        ctx.run = run
        return run.forward(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.run.backward(g), None


class _Schedule:
    """One pipelined forward (and its backward) of a PipelineParallel on
    this pp rank."""

    def __init__(self, pipe: PipelineParallel, mesh, stacked, x):
        self.pipe = pipe
        self.stacked = stacked
        self.pp = mesh.axis_size("pp")
        self.v = pipe.virtual_pp_degree
        self.S = self.pp * self.v
        self.r = mesh.local_rank("pp")
        self.group = mesh.group("pp")
        self.m = pipe.num_microbatches
        b = x.shape[0]
        if b % self.m:
            raise ValueError(
                f"batch {b} not divisible by {self.m} microbatches")
        if b % self.pp:
            raise ValueError(
                f"batch {b} does not split over pp={self.pp} ranks")
        self.mb_shape = (b // self.m,) + tuple(x.shape[1:])
        self.dtype, self.device = x.dtype, x.device
        first = next(iter(stacked.values())).shape[0]
        # stacked rows of this rank's chunks: all S before the Model's
        # set-up split them, its own v after
        self.offset = self.r * self.v if first == self.S else 0
        self.table = tick_table(self.pp, self.v, self.m)
        self.base_key = rng.next_key()
        self.amp_state = amp._saved_state()
        # the chunks run on microbatches: a data rank's rows of each
        self.slices = rng.one_block(rng.saved_slices())
        self.grad = torch.is_grad_enabled()
        self.remat = pipe._remat
        self.saved = {}

    def _body(self, k: int, t: int, h):
        pos = self.offset + k // self.pp
        with rng.key_guard(threefry.fold_in(self.base_key, t)), \
                amp._restored(self.amp_state), \
                rng.restored_slices(self.slices):
            return self.pipe._chunk_body(self.stacked, pos, h)

    def _xfer(self, t, out, dst_of, src_of, send_if, recv_if):
        """The end of tick ``t``: send ``out`` (when this rank's work
        qualifies) and receive from the neighbour whose work does."""
        mine = self.table[t][self.r]
        src = src_of(self.r)
        theirs = self.table[t][src]
        sends = [(out, dst_of(self.r))] if mine and send_if(mine[1]) \
            else []
        recvs = [(self.mb_shape, self.dtype, self.device, src)] \
            if theirs and recv_if(theirs[1]) else []
        got = _coll.exchange(sends, recvs, self.group)
        return got[0] if recvs else None

    def forward(self, x):
        pp, S = self.pp, self.S
        xm = x.reshape((self.m,) + self.mb_shape)
        outs = [None] * self.m
        recv = None
        for t in range(len(self.table)):
            w = self.table[t][self.r]
            y = None
            if w:
                j, k = w
                h = xm[j] if k == 0 else recv
                if self.grad and not self.remat:
                    h = h.detach().requires_grad_()
                    with torch.enable_grad():
                        y = self._body(k, t, h)
                    self.saved[w] = (h, y)
                    y = y.detach()
                else:
                    with torch.no_grad():
                        y = self._body(k, t, h)
                    if self.grad:
                        self.saved[w] = h.detach()
                if k == S - 1:
                    outs[j] = y
            recv = self._xfer(t, y, lambda r: (r + 1) % pp,
                              lambda r: (r - 1) % pp,
                              lambda k: k < S - 1, lambda k: k < S - 1)
        # the last rank holds every output: each rank takes its rows
        last = pp - 1
        rows = self.m * self.mb_shape[0] // pp
        block = (rows,) + self.mb_shape[1:]
        if self.r == last:
            blocks = torch.cat(outs).split(rows)
            _coll.exchange([(blocks[q], q) for q in range(pp) if q != last],
                           [], self.group)
            return blocks[last].clone()
        return _coll.exchange(
            [], [(block, self.dtype, self.device, last)], self.group)[0]

    def backward(self, g):
        pp, S = self.pp, self.S
        last = pp - 1
        if self.r == last:
            got = _coll.exchange(
                [], [(tuple(g.shape), g.dtype, g.device, q)
                     for q in range(pp) if q != last], self.group)
            got.insert(last, g)
            gouts = torch.cat(got).split(self.mb_shape[0])
        else:
            _coll.exchange([(g, last)], [], self.group)
            gouts = None
        gxm = [None] * self.m
        recv = None
        for t in reversed(range(len(self.table))):
            w = self.table[t][self.r]
            gx = None
            if w:
                j, k = w
                gy = gouts[j] if k == S - 1 else recv
                if self.remat:
                    h = self.saved.pop(w).requires_grad_()
                    with torch.enable_grad():
                        y = self._body(k, t, h)
                else:
                    h, y = self.saved.pop(w)
                torch.autograd.backward(y, gy.to(y.dtype))
                gx = h.grad
                if k == 0:
                    gxm[j] = gx
            recv = self._xfer(t, gx, lambda r: (r - 1) % pp,
                              lambda r: (r + 1) % pp,
                              lambda k: k > 0, lambda k: k > 0)
        if self.r != 0:
            return None
        return torch.cat(gxm).reshape((-1,) + self.mb_shape[1:])
