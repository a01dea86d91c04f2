"""paddle_tpu_torch.cost_model — the counted and measured cost of one
program (the port's counterpart of ``paddle_tpu/cost_model.py``).

Reference being replaced: ``paddle.cost_model.CostModel``
(python/paddle/cost_model/cost_model.py — profiles a static Program op
by op) backed by a snapshot latency DB
(cost_model/static_op_benchmark.json).

The JAX package reads XLA's analysis of the compiled executable. The
port has no compiler to ask, so it counts one run of ``fn(*args)``:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the run (the
  matmul, convolution and attention ops torch has formulas for). The
  hand-written kernels launch through ``ctypes`` and dispatch no aten
  op, so their wrappers report each launch's FLOPs and bytes to the
  counting run (``ops._kernels.report_cost``), and B1's registered op
  (``paddle_tpu_torch::flash_attention_fwd``, what an exported program
  runs) has a FLOP formula: a step counts the same FLOPs on the kernels
  as on their plain twins.
- ``bytes_accessed``: each dispatched op's operand and result bytes,
  summed (views excluded: they move nothing). This is the unfused eager
  traffic of the run, not XLA's fused estimate, so it is larger than
  the bytes an HBM-bound fused program would move.
- ``optimal_seconds`` is None (no backend estimate, as on a JAX backend
  that gives none); ``measured_seconds`` times ``iters`` runs after
  ``warmup``, by CUDA events on the card and the host clock on the CPU.
- ``memory_profile``: the peak of live storage bytes during one run,
  tracked by a dispatch mode from each result's allocation until its
  tensor is freed, on either device; on the card
  ``torch.cuda.max_memory_allocated`` is reported beside it
  (``MemoryProfile.device_peak_bytes``).
- ``collective_elements``: the c10d collectives one run of a step
  dispatches (``torch.ops.c10d.*``, seen by a dispatch mode), with
  their element counts — the JAX version parses optimized HLO.

Counting runs the function once for real: a train step counted here
takes a step.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .ops import _kernels


@dataclass
class ProgramCost:
    flops: float                 # counted floating ops
    bytes_accessed: float        # unfused eager operand + result bytes
    output_bytes: float
    optimal_seconds: Optional[float]   # backend estimate: none here
    measured_seconds: Optional[float]  # wall time per run (if measured)
    raw: Dict[str, float] = field(default_factory=dict)

    def describe(self) -> str:
        parts = [f"{self.flops / 1e9:.2f} GFLOP",
                 f"{self.bytes_accessed / 1e6:.1f} MB accessed"]
        if self.optimal_seconds:
            parts.append(f"~{self.optimal_seconds * 1e3:.2f} ms optimal")
        if self.measured_seconds:
            parts.append(f"{self.measured_seconds * 1e3:.2f} ms measured")
        return ", ".join(parts)

    def cost_analysis(self) -> Dict[str, float]:
        """XLA's key names, so :func:`extract_cost_analysis` reads a
        ProgramCost as the JAX package reads a compiled program."""
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed,
                "bytes accessed output": self.output_bytes, **self.raw}


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _BytesMode(TorchDispatchMode):
    """Operand + result bytes of every dispatched op but views."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


def _is_cuda(args) -> bool:
    ts = _tensors(args)
    if ts:
        return ts[0].is_cuda
    return torch.cuda.is_available()


def _measure(fn, args, warmup: int, iters: int) -> float:
    for _ in range(warmup):
        fn(*args)
    if _is_cuda(args):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


class CostModel:
    """ref: paddle.cost_model.CostModel. ``profile(fn, args)`` replaces
    ``profile_measure(program, ...)`` — the program is a callable here,
    not a ProgramDesc."""

    def profile(self, fn: Callable, args: Tuple = (),
                static_argnums=(), measure: bool = False,
                warmup: int = 1, iters: int = 5) -> ProgramCost:
        """Count one run of ``fn(*args)`` (``static_argnums`` is kept for
        the JAX signature: nothing is traced here), then, with
        ``measure``, time ``iters`` more after ``warmup``."""
        flop_mode = FlopCounterMode(display=False)
        bytes_mode = _BytesMode()
        kernel = {"flops": 0.0, "bytes": 0.0, "launches": 0}

        def sink(name, flops, nbytes):
            kernel["flops"] += flops
            kernel["bytes"] += nbytes
            kernel["launches"] += 1

        _kernels.cost_sinks.append(sink)
        try:
            with flop_mode, bytes_mode:
                out = fn(*args)
            if _is_cuda(args):
                torch.cuda.synchronize()
        finally:
            _kernels.cost_sinks.remove(sink)
        counted = float(flop_mode.get_total_flops())
        out_bytes = float(sum(_nbytes(t) for t in _tensors(out)))
        measured = _measure(fn, args, warmup, iters) if measure else None
        raw = {"dispatched_ops": float(bytes_mode.ops),
               "kernel_launches": float(kernel["launches"]),
               "kernel_flops": kernel["flops"],
               "kernel_bytes": kernel["bytes"]}
        return ProgramCost(
            flops=counted + kernel["flops"],
            bytes_accessed=float(bytes_mode.bytes) + kernel["bytes"],
            output_bytes=out_bytes, optimal_seconds=None,
            measured_seconds=measured, raw=raw)

    def profile_measure(self, fn: Callable, args: Tuple = (),
                        **kw) -> ProgramCost:
        """Name parity with the reference's measuring entry point."""
        return self.profile(fn, args, measure=True, **kw)


def extract_cost_analysis(lowered_or_compiled) -> Optional[Dict[str, float]]:
    """Normalize a cost analysis (an object with ``cost_analysis()`` — a
    :class:`ProgramCost` here — whose result may be a dict, a
    per-device list, or absent) into a flat ``{metric: float}`` dict.
    Returns None instead of raising when nothing usable is reported: the
    caller counts the failure, it must never take a serving or train
    loop down."""
    try:
        analysis = lowered_or_compiled.cost_analysis()
        if isinstance(analysis, list):   # per-device list
            analysis = analysis[0] if analysis else None
        if not analysis:
            return None
        out = {k: float(v) for k, v in analysis.items()
               if isinstance(v, (int, float))}
        return out or None
    except Exception:  # noqa: BLE001 — absent analysis is data, not a bug
        return None


class ProgramCostCache:
    """Signature-keyed cache over :func:`extract_cost_analysis`: each
    program signature runs its thunk AT MOST ONCE ever — success and
    failure (None) are both cached. Bounded (LRU eviction past the cap),
    so a dynamic-shape run degrades to recounting its oldest signatures
    instead of growing host memory without bound."""

    CAP = 4096

    def __init__(self, cap: int = CAP):
        self.cap = int(cap)
        self._mu = threading.Lock()
        self._entries: "OrderedDict[Any, Optional[Dict[str, float]]]" \
            = OrderedDict()

    def get(self, key) -> Tuple[bool, Optional[Dict[str, float]]]:
        with self._mu:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True, self._entries[key]
            return False, None

    def get_or_compute(self, key,
                       lower: Callable[[], Any]
                       ) -> Optional[Dict[str, float]]:
        """Cached analysis for ``key``, computing it from the ``lower``
        thunk on first sight. A thunk that raises caches None (counted
        by the caller) — the failure is as sticky as a success."""
        hit, val = self.get(key)
        if hit:
            return val
        try:
            analysis = extract_cost_analysis(lower())
        except Exception:  # noqa: BLE001 — a failed count is data
            analysis = None
        with self._mu:
            if key not in self._entries:
                self._entries[key] = analysis
                while len(self._entries) > self.cap:
                    self._entries.popitem(last=False)
            return self._entries[key]

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()


_program_cost_cache: Optional[ProgramCostCache] = None
_program_cost_cache_mu = threading.Lock()


def program_cost_cache() -> ProgramCostCache:
    """Process-wide cache instance."""
    global _program_cost_cache
    with _program_cost_cache_mu:
        if _program_cost_cache is None:
            _program_cost_cache = ProgramCostCache()
        return _program_cost_cache


@dataclass
class MemoryProfile:
    temp_bytes: int       # peak live bytes the run allocated, outputs aside
    argument_bytes: int
    output_bytes: int
    device_peak_bytes: Optional[int] = None   # max_memory_allocated (card)

    @property
    def total_bytes(self) -> int:
        return self.temp_bytes + self.argument_bytes + self.output_bytes


class _LiveBytesMode(TorchDispatchMode):
    """The live bytes of storages allocated during a run, as a timeline
    of allocations and frees: a result whose storage is none of its
    operands' is a new allocation, live until the last tensor on it
    (views included) is freed."""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, list] = {}   # storage ptr -> [id, bytes, refs]
        self.timeline: list = []          # (allocation id, +bytes / -bytes)
        self._ids = 0

    def _release(self, key, alloc):
        ent = self.live.get(key)
        if ent is None or ent[0] != alloc:
            return
        ent[2] -= 1
        if ent[2] == 0:
            del self.live[key]
            self.timeline.append((alloc, -ent[1]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in _tensors((args, kwargs)) if t.device.type != "meta"}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st.data_ptr()
            if key in seen and key not in self.live:
                continue           # in place / a view of untracked state
            if key not in self.live:
                self._ids += 1
                self.live[key] = [self._ids, st.nbytes(), 0]
                self.timeline.append((self._ids, st.nbytes()))
            ent = self.live[key]
            ent[2] += 1
            weakref.finalize(t, self._release, key, ent[0])
        return out

    def peak_without(self, allocs) -> int:
        """Peak live bytes over the run, allocations ``allocs`` left
        out."""
        now = peak = 0
        for alloc, n in self.timeline:
            if alloc not in allocs:
                now += n
                peak = max(peak, now)
        return peak


def memory_profile_compiled(compiled) -> MemoryProfile:
    """Normalize ``compiled.memory_analysis()`` (an object, a
    per-device list, or None) into a MemoryProfile; a MemoryProfile
    passes through."""
    if isinstance(compiled, MemoryProfile):
        return compiled
    m = compiled.memory_analysis()
    if isinstance(m, list):
        m = m[0] if m else None
    if m is None:
        raise RuntimeError("memory_analysis unavailable for this program")
    if isinstance(m, MemoryProfile):
        return m
    return MemoryProfile(int(m.temp_size_in_bytes),
                         int(m.argument_size_in_bytes),
                         int(m.output_size_in_bytes))


def memory_profile(fn: Callable, args: Tuple = (),
                   static_argnums=()) -> MemoryProfile:
    """Memory of one run of ``fn(*args)``: ``temp_bytes`` is the peak of
    the live bytes the run allocated, its outputs left out;
    ``argument_bytes`` the storages of ``args``. On the card the
    allocator's peak over the run is reported beside it. Holds memory
    wins (the fused loss's missing logits, flash attention's O(s)
    temporaries) on either device."""
    cuda = _is_cuda(args)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    mode = _LiveBytesMode()
    with mode:
        out = fn(*args)
    device_peak = None
    if cuda:
        torch.cuda.synchronize()
        device_peak = int(torch.cuda.max_memory_allocated())

    def storages(tree):
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in _tensors(tree)}

    arg_bytes = sum(storages(args).values())
    outs = storages(out)
    out_allocs = {mode.live[k][0] for k in outs if k in mode.live}
    return MemoryProfile(mode.peak_without(out_allocs), arg_bytes,
                         sum(outs.values()), device_peak)


@dataclass
class CollectiveStats:
    instructions: int = 0
    elements: int = 0


# c10d op name -> the JAX package's collective name. Elements are those
# of the op's first argument: the tensors reduced in place, or the
# outputs of a gather, scatter or all-to-all (HLO's result shape)
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute", "broadcast_": "broadcast"}


class _CollectiveMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: Dict[str, CollectiveStats] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        op = _C10D.get(func._schema.name.split("::")[-1]) \
            if func.namespace == "c10d" else None
        if op is not None:
            stats = self.counts.setdefault(op, CollectiveStats())
            stats.instructions += 1
            stats.elements += sum(t.numel() for t in _tensors(args[0]))
        return func(*args, **(kwargs or {}))


def collective_elements(fn, args: Tuple = ()) -> Dict[str, CollectiveStats]:
    """Per-collective call and element counts of one run of
    ``fn(*args)`` — the communication-volume side of the perf gate
    (e.g. DP grad sync must be ONE fused all-reduce of exactly the
    parameter count: element volume catches a doubled sync, the call
    count catches per-layer unfusing). Counted from the ``c10d`` ops a
    dispatch mode sees; the names are the JAX package's (``all-reduce``,
    ``all-gather``, ...)."""
    mode = _CollectiveMode()
    with mode:
        fn(*args)
    return mode.counts
