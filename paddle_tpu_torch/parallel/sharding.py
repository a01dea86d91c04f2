"""Logical-axis sharding rules → DTensor placements (the port's
counterpart of ``paddle_tpu/parallel/sharding.py``).

Each parameter declares its *logical* axes once, at layer definition
(``Layer.param_meta``, e.g. ``("embed", "mlp")``); a rule table maps
them onto *mesh* axes — the Flax/T5X "logical axis rules" idiom, with
the JAX package's table and resolution, so both packages shard the same
dims over the same axes:

 - Megatron TP (mp_layers.py:30/95/171): ``mlp``/``heads``/``vocab`` → tp
 - ZeRO param sharding (group_sharded_stage3.py:60): ``embed`` → fsdp
 - expert parallel (moe_layer.py:244): ``expert`` → ep

Where the JAX package places a global array with a ``NamedSharding``,
the port gives each rank its piece: :func:`shard_spec` is the
``torch.distributed.tensor`` placements of a parameter on the mesh,
:func:`shard_params` the ``DTensor`` of this rank's shard (sliced from
the full value every rank holds, no communication), :func:`shard_batch`
this rank's rows of the global batch. ``dp``, ``fsdp``, ``tp``, ``pp``
and ``sp`` run: a Model on the mesh holds its tp slices and pp stages as
plain tensors (:func:`param_layout`, :func:`local_piece`,
:func:`full_from_pieces`); under ``sp`` every rank of a data slice holds
the same rows and the sequence-parallel GPT keeps its slice of the
sequence (:func:`with_logical_constraint`, :func:`seq_slice`). ``ep``
resolves like the JAX package's but raises where it would execute
(ROADMAP A7.1).

Tensor parallelism and the fused qkv weight: the JAX GPT declares it as
one ``heads`` dim of width ``h + 2 * kv * hd``, which GSPMD splits
contiguously. A port rank computes its own heads, so it needs their q,
k and v columns: a layer names a permutation of such a dim
(``tp_permutation``), the columns are permuted into head-aligned slices
before the split, and permuted back when the slices are gathered.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import _tree_map
from .mesh import DeviceMesh, get_mesh

# (logical axis, mesh axis) — first matching rule whose mesh axis is live
# and evenly divides the dimension wins.
DEFAULT_RULES: Tuple[Tuple[str, str], ...] = (
    ("batch", "dp"),
    ("batch", "fsdp"),
    ("pp_stage", "pp"),
    ("expert", "ep"),
    ("vocab", "tp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", "tp"),
    ("embed", "fsdp"),
    ("seq", "sp"),
)

# live mesh axes whose execution waits for its ROADMAP item (dp, fsdp,
# tp, pp and sp run)
NOT_PORTED = {"ep": "A7.1 (the MoE layers)"}


def check_runnable(mesh: DeviceMesh) -> None:
    """Raise for a live mesh axis whose execution is not ported."""
    for axis, item in NOT_PORTED.items():
        if mesh.has_axis(axis):
            raise NotImplementedError(
                f"a live {axis!r} mesh axis is not ported yet (ROADMAP "
                f"{item}); the port runs dp, fsdp, tp, pp and sp")


def check_sequence_parallel(network, mesh: DeviceMesh) -> None:
    """Raise for a live ``sp`` axis under a network that does not compute
    on its slice of the sequence (the port slices the sequence in the
    sequence-parallel GPT, ``GPTConfig(sequence_parallel=True)``; the JAX
    package's GSPMD would shard any network's activations)."""
    if not mesh.has_axis("sp"):
        return
    mods = network.modules() if network is not None else ()
    if not any(getattr(getattr(m, "cfg", None), "sequence_parallel", False)
               for m in mods):
        raise NotImplementedError(
            "a live 'sp' mesh axis runs a network that computes on its "
            "slice of the sequence: models.gpt with "
            "GPTConfig(sequence_parallel=True) (ring attention)")


class LogicalRules:
    def __init__(self, rules: Sequence[Tuple[str, str]] = DEFAULT_RULES):
        self.rules = tuple(rules)

    def mesh_axes(self, logical: Optional[Tuple[Optional[str], ...]],
                  shape: Tuple[int, ...], mesh: DeviceMesh) -> Tuple:
        """Resolve logical dim names to the JAX package's PartitionSpec
        entries (a mesh axis, a tuple of them, or None per dim; trailing
        Nones dropped), skipping mesh axes already taken by another dim.
        A logical name matching several rules collects ALL its live mesh
        axes (e.g. ``batch`` → ``("dp", "fsdp")``)."""
        if logical is None:
            return ()
        used = set()
        out: List[Any] = []
        for dim, name in enumerate(logical):
            picks = []
            if name is not None and dim < len(shape):
                prod = 1
                for lname, maxis in self.rules:
                    if (lname == name and maxis not in used
                            and mesh.has_axis(maxis)
                            and shape[dim] % (
                                prod * mesh.axis_size(maxis)) == 0):
                        picks.append(maxis)
                        used.add(maxis)
                        prod *= mesh.axis_size(maxis)
            out.append(tuple(picks) if len(picks) > 1
                       else (picks[0] if picks else None))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


def _placements(spec: Tuple, mesh: DeviceMesh) -> List:
    """DTensor placements (one per mesh dim) of a PartitionSpec."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def named_sharding(axes, shape, mesh: Optional[DeviceMesh] = None,
                   rules: Optional[LogicalRules] = None) -> List:
    """The DTensor placements of an array of ``shape`` whose dims carry
    the logical ``axes``."""
    mesh = mesh or get_mesh()
    rules = rules or LogicalRules()
    return _placements(rules.mesh_axes(axes, tuple(shape), mesh), mesh)


def shard_spec(name: Optional[str], shape, meta,
               mesh: Optional[DeviceMesh] = None,
               rules: Optional[LogicalRules] = None) -> List:
    """THE placement a parameter gets at runtime: ``meta[name].axes``
    through the rules (replicated where the parameter has no axes)."""
    axes = getattr(meta.get(name), "axes", None) \
        if (meta and name is not None) else None
    return named_sharding(axes, shape, mesh, rules)


def local_chunk(x: torch.Tensor, placements, mesh: DeviceMesh):
    """This rank's piece of the full ``x`` under ``placements`` (mesh
    dims left to right, ``torch.chunk`` pieces, as DTensor does)."""
    for axis, pl in zip(mesh.axis_names, placements):
        if pl.is_shard():
            x = torch.chunk(x, mesh.axis_size(axis), dim=pl.dim)[
                mesh.local_rank(axis)]
    return x


def shard_params(params: Dict[str, torch.Tensor], meta: Dict[str, Any],
                 mesh: Optional[DeviceMesh] = None,
                 rules: Optional[LogicalRules] = None
                 ) -> Dict[str, Any]:
    """Each parameter as the DTensor of this rank's shard under its
    placement (every rank holds the same full values — the same seed —
    so no communication). Parameters with no annotation are
    replicated."""
    from torch.distributed.tensor import DTensor
    mesh = mesh or get_mesh()
    rules = rules or LogicalRules()
    out = {}
    for name, v in params.items():
        v = v.detach()
        pl = shard_spec(name, v.shape, meta, mesh, rules)
        out[name] = DTensor.from_local(
            local_chunk(v, pl, mesh).contiguous(), mesh.mesh, pl,
            run_check=False, shape=v.shape, stride=v.stride())
    return out


def _rows(x, dim: int, mesh: DeviceMesh, groups: int = 1):
    """This rank's slice of dim ``dim`` over the data axes, or x itself
    where the dim does not divide (replicated). With ``groups`` (a
    pipeline's microbatches) the dim is ``groups`` equal blocks and the
    rank takes its slice of each, in block order."""
    n = mesh.data_size
    shape = getattr(x, "shape", ())
    if n <= 1 or len(shape) <= dim or shape[dim] % n:
        return x
    i = mesh.index(mesh.data_axes)
    if groups > 1 and shape[dim] % (n * groups) == 0:
        b = shape[dim] // (n * groups)
        idx = [(g * n + i) * b + r for g in range(groups) for r in range(b)]
        return x[tuple([slice(None)] * dim + [idx])]
    b = shape[dim] // n
    sl = [slice(None)] * dim + [slice(i * b, (i + 1) * b)]
    return x[tuple(sl)]


def shard_batch(batch, mesh: Optional[DeviceMesh] = None, groups: int = 1):
    """This rank's rows of the global batch: the leading dim split over
    the data axes (dp, then fsdp), as the JAX package places it. A
    scalar, or a final partial batch whose leading dim does not divide
    the data ranks, stays whole (replicated — correct, just unsharded
    for that one step); non-array leaves pass through. ``groups``: a
    pipeline's microbatches on a pp mesh, each split over the data axes
    (the rank's rows are its slice of each microbatch, as the JAX
    package shards the microbatches)."""
    mesh = mesh or get_mesh()
    return _tree_map(lambda x: _rows(x, 0, mesh, groups), batch)


def shard_superbatch(batch, mesh: Optional[DeviceMesh] = None,
                     groups: int = 1):
    """``shard_batch`` for the fused train loop's [K, batch, ...]
    superbatches: dim 0 is the per-slab step axis (whole on every rank),
    dim 1 the batch axis split over the data axes; a dim 1 that does
    not divide stays whole."""
    mesh = mesh or get_mesh()
    return _tree_map(lambda x: _rows(x, 1, mesh, groups), batch)


def row_groups(network, mesh: DeviceMesh) -> int:
    """The blocks of a batch the data axes split one by one: a pipelined
    network's microbatches on a mesh with a live pp axis, else 1."""
    from .pipeline import PipelineParallel
    if not mesh.has_axis("pp"):
        return 1
    pipes = [m for m in network.modules() if isinstance(m, PipelineParallel)]
    return pipes[0].num_microbatches if pipes else 1


def is_split(x, dim: int = 0, mesh: Optional[DeviceMesh] = None) -> bool:
    """Whether :func:`shard_batch` (``dim`` 0) or
    :func:`shard_superbatch` (``dim`` 1) splits a leaf of this shape."""
    mesh = mesh or get_mesh()
    shape = np.shape(x)
    return mesh.data_size > 1 and len(shape) > dim and \
        shape[dim] % mesh.data_size == 0


def replicate(tree, mesh: Optional[DeviceMesh] = None):
    """Every rank takes the mesh's first rank's values (a broadcast over
    the mesh), tensors in place; other leaves pass through."""
    from . import collective
    mesh = mesh or get_mesh()
    axes = mesh.axis_names

    def put(x):
        if isinstance(x, torch.Tensor) and mesh.size > 1:
            with torch.no_grad():
                x.copy_(collective.broadcast(x, axes, src=0, mesh=mesh))
        return x
    return _tree_map(put, tree)


def seq_slice(x, dim: int, size: int, index: int):
    """Piece ``index`` of ``size`` equal pieces of the sequence dim
    ``dim`` of ``x`` (a sequence-parallel rank's positions); raises the
    JAX package's error where the sequence does not divide."""
    s = x.shape[dim]
    if s % size:
        raise ValueError(f"sequence {s} not divisible by sp={size}")
    n = s // size
    return x.narrow(dim, index * n, n)


def with_logical_constraint(x, logical: Tuple[Optional[str], ...],
                            mesh: Optional[DeviceMesh] = None,
                            rules: Optional[LogicalRules] = None):
    """In-graph activation sharding hint (the ``shard_op`` analog). A
    port rank's activations already have the layout its layers compute
    (rows over the data axes, tp-replicated between blocks), except for
    a dim whose logical name ``rules`` map to a live ``sp`` axis (``seq``
    under the default rules): ``x`` is then taken as the whole sequence
    and the result is this rank's slice of it (the layout the JAX
    package's ``("seq", "sp")`` rule gives)."""
    mesh = mesh or get_mesh(required=False)
    if mesh is None or not mesh.has_axis("sp"):
        return x
    rules = rules or LogicalRules()
    for dim, name in enumerate(logical):
        if name is not None and (name, "sp") in rules.rules:
            return seq_slice(x, dim, mesh.axis_size("sp"),
                             mesh.local_rank("sp"))
    return x


# -- a rank's pieces of a parameter (tp slices, pp stages, fsdp shards) ------

def param_layout(name: str, shape, meta, mesh: DeviceMesh,
                 rules: Optional[LogicalRules] = None) -> Dict[str, int]:
    """``{mesh axis: dim}`` of the live axes that split parameter
    ``name`` (of full ``shape``) under the rules."""
    spec = (rules or LogicalRules()).mesh_axes(
        getattr(meta.get(name), "axes", None), tuple(shape), mesh)
    out = {}
    for dim, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            out[a] = dim
    return out


def tp_permutation(network, name: str, tp: int):
    """The permutation (a LongTensor over the split dim) that makes the
    tp slices of parameter ``name`` head-aligned, from the innermost
    layer on its path that names one (``Layer.tp_permutation``); None
    for a plain contiguous split."""
    parts = name.split(".")
    for i in range(len(parts) - 1, -1, -1):
        mod = network.get_submodule(".".join(parts[:i])) if i else network
        fn = getattr(mod, "tp_permutation", None)
        if fn is not None:
            perm = fn(".".join(parts[i:]), tp)
            if perm is not None:
                return perm
    return None


def local_piece(x: torch.Tensor, dim: int, count: int, index: int,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Piece ``index`` of ``count`` equal pieces of ``x`` along ``dim``
    (after permuting ``dim`` by ``perm``)."""
    if perm is not None:
        x = x.index_select(dim, perm.to(x.device))
    return torch.chunk(x, count, dim=dim)[index].contiguous()


def full_from_pieces(pieces, dim: int,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tensor :func:`local_piece` split: the pieces concatenated
    along ``dim`` and the permutation undone."""
    x = torch.cat(list(pieces), dim=dim)
    if perm is not None:
        x = x.index_select(dim, torch.argsort(perm).to(x.device))
    return x
