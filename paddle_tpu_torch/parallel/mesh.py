"""Device mesh + hybrid topology (the port's counterpart of
``paddle_tpu/parallel/mesh.py``).

The JAX package names the axes of one ``jax.sharding.Mesh`` over every
device of a multi-process SPMD program. The port runs one process a
rank: a :class:`DeviceMesh` lays the ranks of the default process group
out on the same named axes, in the same order (:data:`AXIS_ORDER`, ``tp``
innermost, ``pp`` outermost), and holds a
``torch.distributed.device_mesh.DeviceMesh`` over them (``init_device_mesh``
for the whole world), whose per-axis process groups carry the collectives
of :mod:`~paddle_tpu_torch.parallel.collective` and the gradient
reduction of a ``Model`` on the mesh.

Without a process group (or over more ranks than it has) the mesh is a
layout only: sizes, axis names and rule resolution work, collectives
raise.

Canonical axis names: ``dp`` (data), ``fsdp`` (sharded-data / ZeRO),
``tp`` (tensor), ``pp`` (pipeline), ``sp`` (sequence/context), ``ep``
(expert).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "sp", "tp")

_current_mesh: Optional["DeviceMesh"] = None


def _default_device_type() -> str:
    from . import api
    dev = api.current_device()
    return dev.type if dev is not None else "cuda"


class DeviceMesh:
    """A named mesh of ranks (the HybridCommunicateGroup analog).

    ``DeviceMesh(dp=2, tp=4)`` lays 8 ranks out as a 2x4 grid, ``tp``
    innermost. An axis size of ``-1`` absorbs the remaining ranks (a
    reshape wildcard). ``devices``: the ranks (a list of global ranks or
    their count; default: the process group's world, 1 without one).
    Size-1 axes are dropped from the physical mesh but remembered, so
    rules that name them resolve to replication.
    """

    def __init__(self, devices: Optional[Sequence] = None,
                 **axis_sizes: int):
        if devices is None:
            devices = dist.get_world_size() if dist.is_initialized() else 1
        ranks = list(range(devices)) if isinstance(devices, int) \
            else [int(r) for r in devices]
        n = len(ranks)
        sizes: Dict[str, int] = {}
        wildcard = None
        for name in AXIS_ORDER:
            s = int(axis_sizes.pop(name, 1))
            if s == -1:
                if wildcard is not None:
                    raise ValueError("only one axis may be -1")
                wildcard = name
                s = 1
            sizes[name] = s
        if axis_sizes:
            raise ValueError(
                f"unknown mesh axes {sorted(axis_sizes)}; "
                f"valid: {AXIS_ORDER}")
        fixed = math.prod(sizes.values())
        if wildcard is not None:
            if n % fixed:
                raise ValueError(
                    f"{n} devices not divisible by {fixed}")
            sizes[wildcard] = n // fixed
            fixed = n
        if fixed != n:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n}")
        self.axis_sizes: Dict[str, int] = dict(sizes)
        live = [a for a in AXIS_ORDER if sizes[a] > 1]
        if not live:  # one rank: keep a 1-wide dp axis for uniformity
            live = ["dp"]
        self.axis_names: Tuple[str, ...] = tuple(live)
        self.shape: Tuple[int, ...] = tuple(sizes[a] for a in live)
        self.ranks = np.asarray(ranks).reshape(self.shape)
        self.device_type = _default_device_type()
        # the torch mesh and its process groups: only over a live
        # process group that has every rank of the layout (every rank
        # of the world constructs it, as torch requires)
        self.mesh = None
        if dist.is_initialized() and ranks == list(
                range(dist.get_world_size())):
            from torch.distributed.device_mesh import init_device_mesh
            self.mesh = init_device_mesh(self.device_type, self.shape,
                                         mesh_dim_names=self.axis_names)
        elif dist.is_initialized() and max(ranks) < dist.get_world_size():
            from torch.distributed.device_mesh import DeviceMesh as _TM
            self.mesh = _TM(self.device_type,
                            torch.as_tensor(self.ranks, dtype=torch.int),
                            mesh_dim_names=self.axis_names)
        self._groups: Dict[Tuple[str, ...], object] = {}

    # -- queries (HybridCommunicateGroup parity) ---------------------------
    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, name: str) -> int:
        return self.axis_sizes.get(name, 1)

    def has_axis(self, name: str) -> bool:
        return self.axis_sizes.get(name, 1) > 1

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes the global batch is split over (dp + fsdp)."""
        return tuple(a for a in ("dp", "fsdp") if self.has_axis(a))

    @property
    def data_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.data_axes)

    def _coords(self) -> Optional[Dict[str, int]]:
        rank = dist.get_rank() if dist.is_initialized() else 0
        idx = np.argwhere(self.ranks == rank)
        if idx.size == 0:
            return None
        return dict(zip(self.axis_names, (int(i) for i in idx[0])))

    def local_rank(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (0 off the mesh or on
        a dropped axis)."""
        pos = self._coords()
        return 0 if pos is None else pos.get(axis, 0)

    def index(self, axes) -> int:
        """This rank's position among ``axes`` (row-major in
        :data:`AXIS_ORDER`): its rank in their process group."""
        axes = _norm_axes(axes)
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.local_rank(a)
        return i

    def group(self, axes):
        """The process group of ``axes`` (an axis name or a tuple): the
        ranks that differ from this one only along them, in
        :data:`AXIS_ORDER` order. Built collectively on first use, as
        every rank runs the same program."""
        axes = _norm_axes(axes)
        if self.mesh is None:
            raise RuntimeError(
                f"{self!r} has no process group: call "
                f"parallel.init_parallel_env() before building the mesh")
        live = tuple(a for a in axes if a in self.axis_names)
        if not live:
            return None
        if len(live) == 1:
            return self.mesh.get_group(live[0])
        g = self._groups.get(live)
        if g is None:
            # ranks of every slice that varies only along `live`; each
            # rank of the world makes every group, in one order
            moved = np.moveaxis(
                self.ranks, [self.axis_names.index(a) for a in live],
                list(range(len(live))))
            flat = moved.reshape(math.prod(moved.shape[:len(live)]), -1)
            me = dist.get_rank()
            for j in range(flat.shape[1]):
                members = sorted(int(r) for r in flat[:, j])
                pg = dist.new_group(members)
                if me in members:
                    g = pg
            self._groups[live] = g
        return g

    def __enter__(self):
        self._prev_mesh = _current_mesh
        _set_current(self)
        return self

    def __exit__(self, *exc):
        _set_current(self._prev_mesh)
        return False

    def __repr__(self):
        live = {a: s for a, s in self.axis_sizes.items() if s > 1}
        return f"DeviceMesh({live or {'dp': 1}}, {self.size} devices)"


def _norm_axes(axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in AXIS_ORDER if a in axes)


def _set_current(m: Optional[DeviceMesh]) -> None:
    global _current_mesh
    _current_mesh = m


def init_mesh(devices: Optional[Sequence] = None,
              **axis_sizes: int) -> DeviceMesh:
    """Create and install the global mesh (fleet.init analog — ref:
    python/paddle/distributed/fleet/base/fleet_base.py:211).
    ``devices`` optionally restricts the mesh to a subset of the ranks."""
    global _current_mesh
    m = DeviceMesh(devices=devices, **axis_sizes)
    _current_mesh = m
    return m


def init_mesh_from_axes(axes: Dict[str, int]) -> DeviceMesh:
    """Install a mesh from a planner-style axes dict, dropping size-1
    axes (falls back to a full-width dp axis when nothing is >1)."""
    live = {k: v for k, v in axes.items() if v > 1}
    return init_mesh(**(live or {"dp": -1}))


def get_mesh(required: bool = True) -> Optional[DeviceMesh]:
    if _current_mesh is None and required:
        raise RuntimeError(
            "no DeviceMesh installed; call parallel.init_mesh(...) first")
    return _current_mesh


def set_mesh(m: Optional[DeviceMesh]) -> None:
    global _current_mesh
    _current_mesh = m
