"""``Model``, the Keras-style trainer (the port's counterpart of
``paddle_tpu/hapi/model.py``).

``prepare`` takes the optimizer, the loss, the metrics, the AMP
configuration and the numeric guard. ``train_batch`` runs one eager step
on the network's device: the forward under the AMP context and under
``rng.key_guard`` of the step's key (``rng.split_for_step(step)``, so
that dropout draws the JAX package's masks), the loss outside it (as in
the JAX package's step), each metric's ``compute`` on the forward's
output, ``loss.float().backward()``, then the optimizer's
``apply_in_place`` at ``step_idx = self._step_count``.
``train_loop_batch`` runs K such steps from a ``[K, batch, ...]``
superbatch in one call (``fit(steps_per_loop=K)``), with losses and
metric outputs stacked on the device: its loss stream equals K
``train_batch`` calls bit for bit. The loss comes back as a 0-dim device
tensor; metric outputs, the ``check_nan_inf`` loss test and the guard's
verdicts are buffered on the device and drained at log boundaries (a
read of a lazy metric log, an epoch or eval boundary, or
``_PENDING_DRAIN_CAP`` buffered steps), so a step never syncs the host.

With the numeric guard armed (``reliability/guard.py``), each step's
update is computed out of place and masked by the step's verdict into
the parameters, the optimizer state (whose step counter then lives on
the device) and the buffers: a tripped step is an exact no-op, inside a
slab too. The policy acts on the drained verdicts; inside ``fit`` with a
``checkpoint_dir`` a rollback restores the newest verified checkpoint at
or below the trip and fast-forwards the loader cursor past the poisoned
batches, and without one it escalates to ``GuardAbort``, as in the JAX
package. The fault sites ``data.poison`` and ``grad.nonfinite`` sit
where the JAX package has them.

``fit``/``evaluate``/``predict`` drive those batches from an
``io.DataLoader`` (built on the network's device when given a
``Dataset``) through the JAX package's callback sequence, with its
observability: the ``train_*`` and ``dataloader_*`` instruments, the
spans ``train.epoch``, ``train.step``, ``train.metric_drain`` and
``io.next_wait``, goodput notes, perf phases, memory-ledger rows and the
``/statusz`` provider ``train_model_<id>``. ``save``/``load`` write and
read the JAX package's ``.pdparams`` (a pickled NumPy state dict under
the same names and layouts) and ``.pdopt`` (``{"state", "step"}``), so a
file crosses between the packages in both directions.

Preemption-safe training: ``fit(checkpoint_dir=...)`` checkpoints the
complete training state through ``io.checkpoint.CheckpointManager`` —
the parameters, the optimizer state (AMP's float32 master weights
included), the buffers and the guard's EMA carry as the array tree, and
a manifest ``state`` bundle with the JAX package's fields: ``step``,
``epoch``, the loader cursor, ``rng`` (the seed and the two uint32
words of the base key) and ``metrics`` (the metric accumulators,
pickled; the port's own objects, so this one field does not cross
between the packages). ``resume`` restores it into the live tensors
(``copy_``, so the network, the optimizer and the master weights keep
their references) and continues with a loss stream bit-identical to the
uninterrupted run at any ``steps_per_loop``; a ``PreemptionGuard`` is
polled at step boundaries and flushes a final checkpoint under a
deadline before exiting ``RESTART_EXIT_CODE``.

On a mesh (``parallel.distributed_model``; the JAX package's hooks
``_shard_params`` / ``_shard_batch`` / ``_shard_superbatch`` / ``_mesh``)
every rank passes the global batch and runs its rows; after the backward
the gradients are reduced over the data ranks and the logged loss is the
global batch's (``parallel.reducer``: dp all-reduces, fsdp keeps each
sharded parameter and its optimizer state as this rank's shard), metric
outputs are gathered to the global batch's rows, and dropout draws the
rank's rows of the global mask.

The K-step slab runs eagerly; as a CUDA graph it waits for a benchmark
cell (A1 (a)). While a ``profiler.Profiler`` records, ``fit`` times its
model-perspective buckets (Dataloader, TrainStep, Callbacks, Eval) as
the JAX package's does.
"""

from __future__ import annotations

import base64
import contextlib
import math
import os
import pickle
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import amp
from ..core import flags, rng
from ..interop import load_reference_state
from ..io import DataLoader, Dataset, _tree_map
from ..io import _host_array as _host
from ..metric import Metric
from ..observability import goodput as _goodput
from ..observability import memory as _memobs
from ..observability import metrics as _obs
from ..observability import perf as _perf
from ..observability import tracing as _trace
from ..optimizer.optimizer import Optimizer
from ..reliability import faults as _faults
from ..reliability import guard as _nguard
from ..reliability.faults import FaultInjected
from .callbacks import config_callbacks


def _train_metrics():
    """Training instruments in the process-wide registry. Step time is
    the host wall time of one ``train_batch`` (the loss stays on the
    device — no forced sync); the first step of each new input
    signature is also observed into the compile histogram, as in the
    JAX package."""
    reg = _obs.default_registry()
    return {
        "step": reg.histogram(
            "train_step_seconds",
            "train_batch dispatch wall time (loss left on device)"),
        "eps": reg.histogram(
            "train_examples_per_second",
            "batch size / step wall time", buckets=_obs.RATE_BUCKETS),
        "compile_count": reg.counter(
            "train_compile_count",
            "distinct input (shape, dtype) signatures = XLA compiles"),
        "compile": reg.histogram(
            "train_compile_seconds",
            "wall time of the first step for each new signature",
            buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0,
                     300.0, 600.0)),
        "steps": reg.gauge(
            "train_step_count", "optimizer steps taken this process"),
    }


def _loop_metrics():
    """Fused K-step loop instruments: one slab = one ``train_loop_batch``
    call covering K optimizer steps."""
    reg = _obs.default_registry()
    return {
        "dispatch": reg.histogram(
            "train_loop_dispatch_seconds",
            "wall time of one fused K-step slab dispatch (losses and "
            "metrics stay on device)"),
        "slab": reg.histogram(
            "train_loop_slab_size",
            "optimizer steps fused into each dispatched slab",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)),
        "drain": reg.histogram(
            "train_loop_drain_seconds",
            "host time coercing buffered device metrics/losses at "
            "log_freq/epoch boundaries (the deferred sync)"),
    }


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def _shape_signature(inputs, labels) -> Tuple:
    """The (shape, dtype) tuple per input/label leaf: one signature of
    the recompile guard (a distinct program in the JAX package)."""
    return tuple(
        (tuple(np.shape(a)), str(getattr(a, "dtype", type(a))))
        for a in (*inputs, *labels))


def _device_counters(state, device):
    """The optimizer state with its host int counters (``t``) as 0-dim
    int32 tensors on ``device`` (filled there, no copy), so a masked
    step can leave them unchanged without a host read."""
    if isinstance(state, dict):
        return {k: _device_counters(v, device) for k, v in state.items()}
    if isinstance(state, int):
        return torch.full((), state, dtype=torch.int32, device=device)
    return state


def _copy_into(live, src, where: str):
    """Copy the restored tree ``src`` into the live tree ``live`` (same
    structure): tensors in place, host ints as ints; returns the live
    tree (a host int counter is replaced, not mutated)."""
    if isinstance(live, dict):
        if not isinstance(src, dict) or set(live) != set(src):
            raise ValueError(
                f"checkpoint {where}: keys {sorted(map(str, src))} do not "
                f"match the model's {sorted(map(str, live))}")
        return {k: _copy_into(v, src[k], f"{where}.{k}")
                for k, v in live.items()}
    if isinstance(live, (list, tuple)):
        if not isinstance(src, (list, tuple)) or len(src) != len(live):
            raise ValueError(f"checkpoint {where}: {src!r:.80} does not "
                             f"match the model's {len(live)} entries")
        return type(live)(_copy_into(v, w, f"{where}[{i}]")
                          for i, (v, w) in enumerate(zip(live, src)))
    if isinstance(live, torch.Tensor):
        src = torch.as_tensor(src)
        if tuple(src.shape) != tuple(live.shape):
            raise ValueError(
                f"checkpoint {where}: shape {tuple(src.shape)} does not "
                f"match the model's {tuple(live.shape)}")
        with torch.no_grad():
            live.copy_(src)
        return live
    if isinstance(live, int):
        return int(src)
    return src


def _stack_steps(per_step):
    """Per-step metric outputs (a tuple per metric, each a tensor or a
    tuple of tensors) stacked along a new leading step dimension."""
    if not per_step or not per_step[0]:
        return ()
    return tuple(
        tuple(torch.stack([_as_tuple(step[m])[j] for step in per_step])
              for j in range(len(_as_tuple(per_step[0][m]))))
        for m in range(len(per_step[0])))


class _FloatView:
    """Float-like lazy value: subclasses define __float__; comparisons,
    arithmetic and formatting all coerce through it, so log consumers
    that do math on plain floats keep working."""

    __slots__ = ()

    def __float__(self):  # pragma: no cover — abstract
        raise NotImplementedError

    def __format__(self, spec):
        return format(float(self), spec)

    def __repr__(self):
        return repr(float(self))

    def __bool__(self):
        return bool(float(self))

    def __eq__(self, other):
        return float(self) == other

    def __ne__(self, other):
        return float(self) != other

    def __lt__(self, other):
        return float(self) < other

    def __le__(self, other):
        return float(self) <= other

    def __gt__(self, other):
        return float(self) > other

    def __ge__(self, other):
        return float(self) >= other

    def __hash__(self):
        return hash(float(self))

    def __add__(self, other):
        return float(self) + other

    __radd__ = __add__

    def __sub__(self, other):
        return float(self) - other

    def __rsub__(self, other):
        return other - float(self)

    def __mul__(self, other):
        return float(self) * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return float(self) / other

    def __rtruediv__(self, other):
        return other / float(self)

    def __neg__(self):
        return -float(self)

    def __abs__(self):
        return abs(float(self))

    def __int__(self):
        return int(float(self))

    def __round__(self, ndigits=None):
        return round(float(self), ndigits)

    def __trunc__(self):
        return math.trunc(float(self))


class _SlabScalar(_FloatView):
    """One step's loss inside a [K]-stacked device tensor, read only if
    a consumer coerces it."""

    __slots__ = ("_arr", "_idx")

    def __init__(self, arr, idx: int):
        self._arr = arr
        self._idx = idx

    def __float__(self):
        return float(self._arr[self._idx])

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(_host(self._arr)[self._idx])
        return out.astype(dtype) if dtype is not None else out


class _LazyMetricValue(_FloatView):
    """Deferred metric read: reading the value (float(), display,
    comparison) drains the buffered device metric outputs into the
    metric accumulators — one host sync per log boundary, not per step.
    The first read memoizes, so a value coerced at its display boundary
    stays right after the metric is reset (eval pass, next epoch);
    values never read before a reset reflect the post-reset
    accumulator."""

    __slots__ = ("_model", "_metric", "_idx", "_val")

    def __init__(self, model, metric, idx: int):
        self._model = model
        self._metric = metric
        self._idx = idx
        self._val = None

    def __float__(self):
        if self._val is None:
            self._model._drain_metric_updates()
            res = self._metric.accumulate()
            res = res if isinstance(res, (list, tuple)) else [res]
            self._val = float(res[self._idx])
        return self._val


class Model:
    """Wraps a network for training, evaluation and prediction.
    ``labels`` (an input spec list) sets how many trailing fields of a
    batch are labels (one by default)."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._inputs_spec = inputs
        self._labels_spec = labels
        self._optimizer: Optional[Optimizer] = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._amp_configs = None
        self._opt_state = None
        self._step_count = 0
        self._train_step_built = False
        self.stop_training = False
        # sharding hooks (set by parallel.distributed_model) and the
        # gradient reduction / fsdp shards they imply (parallel.reducer)
        self._shard_params = None     # fn(params) -> DTensor shards
        self._shard_batch = None      # fn(batch) -> this rank's rows
        self._shard_superbatch = None  # fn([K,...] slab) -> its rows
        self._mesh = None
        self._rules = None             # the mesh's LogicalRules
        self._sync = None
        # recompile guard: distinct (shape, dtype) signatures seen
        self._shape_signatures = set()
        # device metric outputs buffered until a log/display boundary
        # coerces them (_drain_metric_updates) — no per-step host sync;
        # the check_nan_inf flag buffers its losses the same way
        self._metric_pending: List[Tuple] = []
        self._nan_pending: List[Tuple] = []
        self._loop_built = False
        # numeric guard: the policy armed at prepare(); verdicts, grad
        # norms and losses buffered per call and drained with the
        # metrics
        self._guard: Optional[_nguard.GuardPolicy] = None
        self._guard_state = None
        self._guard_pending: List[Tuple] = []
        self._last_batch_shapes = None
        # observability handles, created lazily on the first step
        self._obs = None
        self._obs_loop = None
        self._reset_mem_scope()

    # -- preparation --------------------------------------------------------
    def prepare(self, optimizer: Optional[Optimizer] = None, loss=None,
                metrics: Optional[Sequence[Metric]] = None,
                amp_configs=None, numeric_guard=None) -> None:
        """``amp_configs``: a level string (``"O1"``/``"O2"``, ``"O0"`` or
        None for none) or a dict {level, dtype, custom_white_list,
        custom_black_list}. ``metrics``: a Metric or a list of them.
        ``numeric_guard``: a ``reliability.guard.GuardPolicy`` (or True
        for the defaults) arms the numeric guard; None falls back to the
        ``numeric_guard`` flag."""
        if numeric_guard is None and flags.get_flag("numeric_guard"):
            numeric_guard = True
        if numeric_guard is True:
            numeric_guard = _nguard.GuardPolicy()
        self._guard = numeric_guard or None
        self._guard_state = None
        self._guard_pending.clear()
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            metrics = []
        elif isinstance(metrics, Metric):
            metrics = [metrics]
        self._metrics = list(metrics)
        self._amp_configs = amp_configs
        self._opt_state = None
        self._train_step_built = False
        self._loop_built = False
        self._metric_pending.clear()
        self._nan_pending.clear()
        # fresh ledger rows: the optimizer state this prepare implies
        # may differ; register what exists now, and again with the
        # optimizer state after the first step builds it
        self._reset_mem_scope()
        if _memobs.enabled():
            self._register_memory()
        self._register_status_provider()

    def _register_status_provider(self) -> None:
        """Expose train-loop state on the debug server's /statusz
        (weakref closure — a collected Model drops out of the listing).
        Idempotent per Model."""
        import weakref
        from ..observability import server as _dbgsrv
        ref = weakref.ref(self)

        def _status():
            m = ref()
            if m is None:
                return None
            out = {
                "step_count": m._step_count,
                "compiled_shapes": m.compiled_shape_count,
                "pending_metric_buffers": len(m._metric_pending),
                "loop_compiled": m._loop_built,
                "step_compiled": m._train_step_built,
                "stop_training": m.stop_training,
            }
            if m._guard is not None:
                out["numeric_guard"] = m._guard.status()
            return out

        _dbgsrv.register_status_provider(
            f"train_model_{id(self):x}", _status)

    def _reset_mem_scope(self) -> None:
        """Fresh memory-ledger scope and GC finalizer: a re-prepared or
        discarded Model's rows are released."""
        old = getattr(self, "_mem_scope", None)
        if old is not None:
            _memobs.instance().remove_scope(old)
            self._mem_finalizer.detach()
        self._mem_scope = _memobs.next_scope()
        self._mem_finalizer = _memobs.finalize_scope(
            self, self._mem_scope)

    def _register_memory(self) -> None:
        """Register the network's parameters (this rank's shards under
        fsdp) and buffers and, once built, the optimizer state, per dtype
        (from shapes only; the same rows re-registered overwrite)."""
        params = dict(self.network.named_parameters())
        if self._sync is not None:
            params.update(self._sync.shards)
        trees = {"train_params": params,
                 "train_buffers": dict(self.network.named_buffers())}
        if self._opt_state is not None:
            trees["train_opt_state"] = self._opt_state
        led = _memobs.instance()
        for owner, tree in trees.items():
            for dt, nb in _memobs.tree_bytes_by_dtype(tree).items():
                led.set_entry(self._mem_scope, owner, dt, nb)

    def _amp_context(self):
        cfg = self._amp_configs
        if not cfg:
            return contextlib.nullcontext()
        if isinstance(cfg, str):
            cfg = {"level": cfg}
        level = cfg.get("level", "O1")
        if level == "O0":
            return contextlib.nullcontext()
        return amp.auto_cast(
            enable=True, dtype=cfg.get("dtype"), level=level,
            custom_white_list=cfg.get("custom_white_list"),
            custom_black_list=cfg.get("custom_black_list"))

    def _compute_loss(self, outputs, labels):
        return self._loss(*_as_tuple(outputs), *_as_tuple(labels))

    @torch.no_grad()
    def _metric_outputs(self, outputs, labels, split: bool = False):
        """Each metric's ``compute``; on a data-parallel rank that ran its
        rows of the global batch, gathered over the data ranks in rank
        order (the global batch's rows, as one process computes them)."""
        outs = _as_tuple(outputs)
        labs = _as_tuple(labels)
        sync = self._sync
        first = outs[0].detach()
        if self._metrics and sync is not None:
            first = sync.gather_seq(first)   # sp: the whole sequence
        res = tuple(m.compute(first, labs[0]) for m in self._metrics)
        if sync is not None and (split or sync.pp > 1):
            res = _tree_map(lambda x: sync.gather_rows(x, split), res)
        return res

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _to_device(self, xs):
        dev = self._device()
        return tuple(x.to(dev) if isinstance(x, torch.Tensor)
                     else torch.as_tensor(np.asarray(x), device=dev)
                     for x in xs)

    def _trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.network.named_parameters()
                if p.requires_grad}

    # -- the mesh (parallel.distributed_model) ------------------------------
    def _mesh_sync(self):
        """The gradient reduction and fsdp shards of this Model on its
        mesh (``parallel.reducer.MeshSync``), set up collectively at the
        first use; None without a mesh."""
        if self._mesh is None:
            return None
        if self._sync is None:
            from ..parallel.reducer import MeshSync
            self._sync = MeshSync(self._mesh, self._rules)
            self._sync.setup(self._trainable(), self.network, self._loss)
        return self._sync

    def _opt_params(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer updates: the trainable parameters,
        this rank's shards of the fsdp-sharded ones."""
        params = self._trainable()
        sync = self._mesh_sync()
        return sync.opt_params(params) if sync is not None else params

    def _shard_in(self, inputs, labels, superbatch: bool = False):
        """This rank's rows of a global batch (dim 1 of a superbatch)
        through the mesh hooks, and whether they split it; on a pp mesh
        the labels are further cut to the pp rank's rows of the
        pipeline's output."""
        fn = self._shard_superbatch if superbatch else self._shard_batch
        if fn is None:
            return inputs, labels, False
        from ..parallel.sharding import is_split
        split = bool(inputs) and is_split(inputs[0], int(superbatch),
                                          self._mesh)
        labels = fn(labels)
        sync = self._mesh_sync()
        if sync is not None:
            labels = sync.pp_rows(labels, int(superbatch))
        return fn(inputs), labels, split

    def _unsharded(self):
        """Full parameters for the scope (fsdp gathers its shards)."""
        sync = self._mesh_sync()
        if sync is None or not sync.shards:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def ctx():
            sync.unshard()
            try:
                yield
            finally:
                sync.reshard()
        return ctx()

    def _named_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The network's tensors by group, for the non-finite reports."""
        return {"param": dict(self.network.named_parameters()),
                "buffer": dict(self.network.named_buffers())}

    def sync_weights(self):
        """The network's tensors are the trained weights (updated in
        place), so there is nothing to rebind; kept for the JAX
        package's API."""

    # -- recompile guard ----------------------------------------------------
    @property
    def compiled_shape_count(self) -> int:
        """Distinct input (shape, dtype) signatures the train/eval steps
        have seen (a separate XLA program each in the JAX package)."""
        return len(self._shape_signatures)

    def _guard_recompiles(self, inputs, labels, kind: str = "step",
                          sig_items: Optional[Tuple] = None) -> bool:
        """Track the distinct input signatures and warn once past
        FLAGS.recompile_warn_threshold. Returns True when this batch
        brings a new one (counted in ``train_compile_count``). ``kind``
        separates the per-batch step from the K-step loop (``"loop"``:
        one signature per superbatch shape). Threshold 0 turns the guard
        off; the set is capped at 4096."""
        thresh = flags.get_flag("recompile_warn_threshold")
        if not thresh:
            return False
        seen = self._shape_signatures
        if len(seen) >= 4096:
            return False
        if sig_items is None:
            sig_items = _shape_signature(inputs, labels)
        sig = (kind,) + sig_items
        if sig in seen:
            return False
        seen.add(sig)
        if len(seen) == thresh + 1:
            import warnings
            warnings.warn(
                f"Model step has now seen {len(seen)} distinct input "
                f"shapes. Pad or bucket variable-length data "
                f"(io.sequence.pad_sequence / LengthBucketBatchSampler), "
                f"or raise FLAGS.recompile_warn_threshold if "
                f"intentional.", stacklevel=3)
        return True

    # -- numeric-guard plumbing ---------------------------------------------
    def _maybe_poison_batch(self, inputs, k: int):
        """Fault site ``data.poison``: one check per optimizer step about
        to run. A hit NaN-poisons that step's floating input leaves (a
        copy; on the device, filled there) instead of raising: a corrupt
        record riding the data stream. Reached only while faults are
        armed."""
        bad = []
        for i in range(k):
            try:
                _faults.check("data.poison")
            except FaultInjected:
                bad.append(i)
        if not bad:
            return inputs

        def poison(x):
            if isinstance(x, torch.Tensor):
                if not x.is_floating_point():
                    return x
                a = x.clone()
                for i in ([...] if k == 1 else bad):
                    a[i] = float("nan")
                return a
            a = np.array(np.asarray(x), copy=True)
            if np.issubdtype(a.dtype, np.floating):
                if k == 1:
                    a[...] = np.nan
                else:
                    a[bad] = np.nan
            return a

        return tuple(poison(x) for x in inputs)

    def _grad_poison(self, k: int) -> np.ndarray:
        """Fault site ``grad.nonfinite``: each step's loss multiplier, 1.0
        (an exact identity) or NaN on schedule, so the loss and every
        gradient go non-finite inside the step."""
        vec = np.ones((k,), np.float32)
        if _faults.enabled():
            for i in range(k):
                try:
                    _faults.check("grad.nonfinite")
                except FaultInjected:
                    vec[i] = np.nan
        return vec

    def _buffer_guard_outs(self, verdicts, gnorms, losses,
                           step0: int, k: int) -> None:
        self._guard_pending.append((verdicts, gnorms, losses, step0, k))
        if len(self._guard_pending) >= self._PENDING_DRAIN_CAP:
            self._drain_metric_updates()

    # -- batch-level API ----------------------------------------------------
    def _check_prepared(self) -> None:
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")

    def _sig_items(self, inputs, labels):
        """The input signature, built once for the recompile guard and
        the guard's abort fingerprint (None when neither is on)."""
        if self._guard is None and \
                not flags.get_flag("recompile_warn_threshold"):
            return None
        return _shape_signature(inputs, labels)

    def _note_dispatch(self, dt: float, fresh_shape: bool, sp) -> None:
        """The instruments every train call feeds with its wall ``dt``."""
        if _perf.enabled():
            _perf.record_phase(
                "train", "compile" if fresh_shape else "dispatch", dt)
        if _goodput.enabled():
            _goodput.note("compile" if fresh_shape else "productive", dt)
        if fresh_shape:
            self._obs["compile_count"].inc()
            self._obs["compile"].observe(dt)
        if sp is not None:
            if fresh_shape:
                sp.add_event("recompile", {"signature_count": len(
                    self._shape_signatures)})
            sp.end()
        self._obs["steps"].set(self._step_count)

    def train_batch(self, inputs, labels=None) -> Dict[str, Any]:
        """One optimizer step on one batch; returns ``{"loss": <0-dim
        device tensor>}`` and the metrics' lazy values, without a host
        sync."""
        self._check_prepared()
        inputs = _as_tuple(inputs)
        labels = _as_tuple(labels) if labels is not None else ()
        if _faults.enabled():
            inputs = self._maybe_poison_batch(inputs, 1)
        sig_items = self._sig_items(inputs, labels)
        fresh_shape = self._guard_recompiles(inputs, labels,
                                             sig_items=sig_items)
        if self._obs is None:
            self._obs = _train_metrics()
        batch_n = np.shape(inputs[0])[0] if inputs and len(
            np.shape(inputs[0])) else 0
        if self._guard is not None:
            self._last_batch_shapes = list(sig_items)
        sp = _trace.start_span(
            "train.step", attrs={"batch": batch_n,
                                 "step": self._step_count}) \
            if _trace.enabled() else None
        t0 = time.perf_counter()
        try:
            poison = float(self._grad_poison(1)[0]) \
                if self._guard is not None else None
            inputs, labels, split = self._shard_in(inputs, labels)
            loss, metric_outs, verdict, gnorm = self._train_step(
                self._to_device(inputs), self._to_device(labels),
                self._step_count, poison, split)
        except BaseException as e:
            if sp is not None:
                sp.set_status("error")
                sp.end()
            _memobs.maybe_dump_oom(e, component="train")
            raise
        self._step_count += 1
        dt = time.perf_counter() - t0
        self._obs["step"].observe(dt)
        if batch_n and dt > 0:
            self._obs["eps"].observe(batch_n / dt)
        self._note_dispatch(dt, fresh_shape, sp)
        # the loss and metric outputs stay on the device; the metric
        # outputs, the guard's verdict and the check_nan_inf loss test
        # drain at a boundary
        logs = {"loss": loss}
        if self._guard is not None:
            self._buffer_guard_outs(verdict, gnorm, loss,
                                    self._step_count - 1, 1)
            self._buffer_metric_outs(metric_outs, 1, verdicts=verdict)
        else:
            if flags.get_flag("check_nan_inf"):
                self._buffer_nan_check(loss, self._step_count - 1, 1)
            self._buffer_metric_outs(metric_outs, 1)
        self._attach_metric_logs(logs)
        return logs

    def _train_step(self, inputs, labels, step_idx: int, poison=None,
                    split: bool = False):
        """One optimizer step at ``step_idx`` on device tensors: (loss,
        metric outputs, verdict, grad norm); the last two are None unless
        the guard is armed, when ``poison`` multiplies the loss. On a
        mesh (``split``: the inputs are this rank's rows of the global
        batch) the gradients are reduced over the data ranks after the
        backward and the loss is the global batch's
        (``parallel.reducer``)."""
        sync = self._mesh_sync()
        self.network.train()
        trainable = self._trainable()
        guard = self._guard
        # buffers the forward may write, restored on a tripped step
        saved_bufs = [(b, b.clone()) for b in self.network.buffers()] \
            if guard is not None else ()
        if sync is not None:
            sync.unshard()
        with rng.key_guard(rng.split_for_step(step_idx)), \
                self._amp_context(), \
                (sync.rows_context(split) if sync is not None
                 else contextlib.nullcontext()):
            out = self.network(*inputs)
        loss = self._compute_loss(out, labels).float()
        weight = sync.loss_weight(self._loss, labels) \
            if sync is not None else None
        if weight is not None:
            loss = loss * weight
        if poison is not None:
            loss = loss * poison
        metric_outs = self._metric_outputs(out, labels, split)
        loss.backward()
        loss = loss.detach()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in trainable.items()}
        params = trainable
        if sync is not None:
            grads, loss = sync.reduce(grads, loss,
                                      weighted=weight is not None)
            params = sync.opt_params(trainable)
        built = self._opt_state is None
        verdict = gnorm = None
        with (sync.norm_context() if sync is not None
              else contextlib.nullcontext()):
            if guard is None:
                self._opt_state = self._optimizer.apply_in_place(
                    params, grads, self._opt_state, step_idx)
            else:
                verdict, gnorm = self._guarded_update(
                    params, grads, loss, step_idx, saved_bufs)
        for p in trainable.values():
            p.grad = None
        if sync is not None:
            sync.reshard()
        self._train_step_built = True
        if built and _memobs.enabled():
            self._register_memory()
        return loss, metric_outs, verdict, gnorm

    @torch.no_grad()
    def _guarded_update(self, params, grads, loss, step_idx, saved_bufs):
        """The guard's step: the verdict and grad norm of ``loss`` and
        ``grads``, the update computed out of place and selected by the
        verdict into the parameters, the optimizer state and the
        buffers (an exact no-op when tripped), and the EMA moved."""
        guard = self._guard
        dev = loss.device
        values = {k: p.detach() for k, p in params.items()}
        if self._opt_state is None:
            self._opt_state = self._optimizer.init_state(values)
        self._opt_state = _device_counters(self._opt_state, dev)
        if self._guard_state is None:
            self._guard_state = guard.device_state(dev)
        verdict, gnorm = guard.inspect(loss, grads, self._guard_state)
        ok = _nguard.apply_mask(verdict, guard.mask_spikes)
        new, new_opt = self._optimizer.apply_gradients(
            values, grads, self._opt_state, step_idx)
        for k, v in new.items():
            torch.where(ok, v, values[k], out=values[k])
        for b, old in saved_bufs:
            torch.where(ok, b, old, out=b)
        self._opt_state = _nguard.mask_pytree(ok, new_opt, self._opt_state)
        self._guard_state = guard.update_state(self._guard_state, loss, ok)
        return verdict, gnorm

    def train_loop_batch(self, inputs, labels=None) -> List[Dict[str, Any]]:
        """Run one slab of K optimizer steps from a superbatch (every
        input and label leaf stacked ``[K, batch, ...]``, as
        ``io.DataLoader.superbatches`` yields). Step ``i`` runs under
        ``rng.split_for_step(step0 + i)``, so the loss stream equals K
        ``train_batch`` calls bit for bit; losses and metric outputs
        are stacked on the device, with no host sync in the slab. Returns
        K log dicts of lazy values."""
        self._check_prepared()
        inputs = _as_tuple(inputs)
        labels = _as_tuple(labels) if labels is not None else ()
        k = int(np.shape(inputs[0])[0])
        if _faults.enabled():
            inputs = self._maybe_poison_batch(inputs, k)
        sig_items = self._sig_items(inputs, labels)
        fresh_shape = self._guard_recompiles(inputs, labels, kind="loop",
                                             sig_items=sig_items)
        if self._obs is None:
            self._obs = _train_metrics()
        if self._obs_loop is None:
            self._obs_loop = _loop_metrics()
        batch_n = np.shape(inputs[0])[1] if np.ndim(inputs[0]) > 1 else 0
        if self._guard is not None:
            self._last_batch_shapes = list(sig_items)
        step0 = self._step_count
        sp = _trace.start_span(
            "train.dispatch", attrs={"k": k, "batch": batch_n,
                                     "step0": step0}) \
            if _trace.enabled() else None
        t0 = time.perf_counter()
        losses, outs, verdicts, gnorms = [], [], [], []
        try:
            poison = self._grad_poison(k) if self._guard is not None \
                else None
            inputs, labels, split = self._shard_in(inputs, labels,
                                                   superbatch=True)
            inputs = self._to_device(inputs)
            labels = self._to_device(labels)
            for i in range(k):
                loss, mo, verdict, gnorm = self._train_step(
                    [x[i] for x in inputs], [y[i] for y in labels],
                    step0 + i, None if poison is None else float(poison[i]),
                    split)
                self._step_count += 1
                losses.append(loss)
                outs.append(mo)
                verdicts.append(verdict)
                gnorms.append(gnorm)
        except BaseException as e:
            if sp is not None:
                sp.set_status("error")
                sp.end()
            _memobs.maybe_dump_oom(e, component="train")
            raise
        self._loop_built = True
        losses = torch.stack(losses)
        metric_outs = _stack_steps(outs)
        dt = time.perf_counter() - t0
        self._obs_loop["dispatch"].observe(dt)
        self._obs_loop["slab"].observe(k)
        self._obs["step"].observe(dt / k)
        if batch_n and dt > 0:
            self._obs["eps"].observe(batch_n * k / dt)
        self._note_dispatch(dt, fresh_shape, sp)
        if self._guard is not None:
            verdicts = torch.stack(verdicts)
            self._buffer_guard_outs(verdicts, torch.stack(gnorms), losses,
                                    step0, k)
            self._buffer_metric_outs(metric_outs, k, verdicts=verdicts)
        else:
            if flags.get_flag("check_nan_inf"):
                self._buffer_nan_check(losses, step0, k)
            self._buffer_metric_outs(metric_outs, k)
        out = []
        for i in range(k):
            logs: Dict[str, Any] = {"loss": _SlabScalar(losses, i)}
            self._attach_metric_logs(logs)
            out.append(logs)
        return out

    # buffered outputs after which a drain runs even if nothing reads a
    # value (verbose=0 fit, long evaluate loops): bounds the device
    # tensors the pending lists hold
    _PENDING_DRAIN_CAP = 64

    def _buffer_nan_check(self, losses, step0: int, k: int) -> None:
        """The ``check_nan_inf`` flag, deferred: buffer the device loss
        and test it at the next drain; a K-step slab's report names the
        step inside it."""
        self._nan_pending.append((losses, step0, k))
        if len(self._nan_pending) >= self._PENDING_DRAIN_CAP:
            self._drain_metric_updates()

    def _drain_guard_checks(self) -> None:
        """Test the buffered ``check_nan_inf`` losses (FloatingPointError)
        and apply the guard's policy to the buffered verdicts
        (GuardRollback / GuardAbort), each list in one host read."""
        if self._nan_pending:
            pending, self._nan_pending = self._nan_pending, []
            arrs = _host(torch.cat([p[0].reshape(-1).float()
                                    for p in pending]))
            off = 0
            for _, step0, k in pending:
                finite = np.isfinite(arrs[off:off + k])
                off += k
                if not finite.all():
                    from ..amp.debugging import find_nonfinite
                    idx = int(np.argmin(finite))
                    bad = find_nonfinite(self._named_state())
                    raise FloatingPointError(
                        f"NaN/Inf loss at step {step0 + idx}"
                        + (f" (step {idx} of a {k}-step slab)" if k > 1
                           else "")
                        + f"; non-finite tensors: "
                          f"{bad or ['(loss only)']}")
        if self._guard_pending:
            pending, self._guard_pending = self._guard_pending, []
            arrs = _host(torch.cat([torch.stack(
                [v.reshape(-1).float(), g.reshape(-1).float(),
                 lo.reshape(-1).float()]) for v, g, lo, _, _ in pending],
                dim=1))
            off = 0
            for _, _, _, step0, k in pending:
                blk = arrs[:, off:off + k]
                off += k
                self._guard.process(blk[0].astype(np.int32), blk[1],
                                    blk[2], step0, model=self)

    def _buffer_metric_outs(self, metric_outs, nsteps: int,
                            verdicts=None) -> None:
        """``verdicts`` (guard-armed train calls) rides along so that the
        drain drops the rows of masked steps: their forward ran on the
        poisoned batch, and the metrics must match the clean run minus
        that batch, as the parameters do."""
        if self._metrics:
            if len(self._metric_pending) >= self._PENDING_DRAIN_CAP:
                self._drain_metric_updates()
            self._metric_pending.append((metric_outs, nsteps, verdicts))

    def _attach_metric_logs(self, logs: Dict[str, Any]) -> None:
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            for j, n in enumerate(names):
                logs[n] = _LazyMetricValue(self, m, j)

    def _drain_metric_updates(self) -> None:
        """Fold every buffered device metric output into the host
        accumulators — one sync for all steps since the last drain (the
        deferral ``train_loop_drain_seconds`` measures); the buffered
        ``check_nan_inf`` losses and guard verdicts are tested here too,
        and raise (FloatingPointError, GuardRollback, GuardAbort)."""
        if self._metric_pending:
            sp = _trace.start_span(
                "train.metric_drain",
                attrs={"pending": len(self._metric_pending)}) \
                if _trace.enabled() else None
            t0 = time.perf_counter()
            try:
                pending, self._metric_pending = self._metric_pending, []
                for outs, nsteps, verdicts in pending:
                    keep = None
                    if verdicts is not None:
                        v = _host(verdicts).reshape(-1)
                        masked = v == 1
                        if self._guard is not None \
                                and self._guard.mask_spikes:
                            masked = masked | (v == 2)
                        if masked.any():
                            keep = ~masked
                    for m, mo in zip(self._metrics, outs):
                        mo = _as_tuple(mo)
                        if keep is None:
                            m.update_stacked(mo, nsteps)
                        elif nsteps == 1:
                            if keep[0]:
                                m.update_stacked(mo, 1)
                        else:
                            # drop the masked rows; the rest keep the
                            # per-step update
                            mos = tuple(_host(o) for o in mo)
                            for i in range(nsteps):
                                if keep[i]:
                                    m.update(*(o[i] for o in mos))
            finally:
                if sp is not None:
                    sp.end()
            if self._obs_loop is None:
                self._obs_loop = _loop_metrics()
            drain_dt = time.perf_counter() - t0
            self._obs_loop["drain"].observe(drain_dt)
            if _perf.enabled():
                _perf.record_phase("train", "drain", drain_dt)
            if _goodput.enabled():
                _goodput.note("host_gap", drain_dt)
        if self._guard_pending or self._nan_pending:
            self._drain_guard_checks()

    def drain_metrics(self) -> None:
        """Fold all deferred device metric outputs into the Metric
        accumulators, so ``metric.accumulate()`` reflects every step so
        far (manual ``train_batch``/``eval_batch`` loops)."""
        self._drain_metric_updates()

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None) -> Dict[str, Any]:
        """Forward (eval mode, under the AMP context), the loss as a
        device tensor where a loss is set, and the metrics' lazy
        values; metric outputs are buffered like the train path's."""
        inputs = _as_tuple(inputs)
        labels = _as_tuple(labels) if labels is not None else ()
        self._guard_recompiles(inputs, labels)
        self.network.eval()
        inputs, labels, split = self._shard_in(inputs, labels)
        inputs = self._to_device(inputs)
        labels = self._to_device(labels)
        sync = self._mesh_sync()
        with self._unsharded(), \
                rng.key_guard(rng.split_for_step(self._step_count)), \
                self._amp_context():
            out = self.network(*inputs)
        logs = {}
        if self._loss is not None:
            logs["loss"] = self._compute_loss(out, labels)
            if sync is not None:
                logs["loss"] = sync.global_loss(
                    logs["loss"], sync.loss_weight(self._loss, labels))
        self._buffer_metric_outs(
            self._metric_outputs(out, labels, split), 1)
        self._attach_metric_logs(logs)
        return logs

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The eval-mode forward of one batch, without the AMP context
        (as in the JAX package's predict step); on a mesh, each rank runs
        its rows and the outputs are the global batch's."""
        self.network.eval()
        inputs, _, split = self._shard_in(_as_tuple(inputs), ())
        with self._unsharded():
            out = self.network(*self._to_device(inputs))
        sync = self._sync
        if sync is not None and sync.sp > 1:
            out = _tree_map(sync.gather_seq, out)
        if sync is not None and (split or sync.pp > 1):
            out = _tree_map(lambda x: sync.gather_rows(x, split), out)
        return out

    # -- preemption-safe training state -------------------------------------
    def _full_opt_state(self):
        """The optimizer state, built by ``init_state`` from the current
        parameters if no step has built it yet (what the first step
        would build)."""
        if self._opt_state is None and self._optimizer is not None:
            self._opt_state = self._optimizer.init_state(
                {k: p.detach() for k, p in self._opt_params().items()})
            if _memobs.enabled():
                self._register_memory()
        return self._opt_state

    def _load_opt_state(self, tree) -> None:
        """Copy a restored optimizer-state tree into the live one."""
        self._opt_state = _copy_into(self._full_opt_state(), tree, "opt")

    def _state_tree(self) -> Dict[str, Any]:
        """The training state as the JAX package's checkpoint tree: the
        live tensors (a save snapshots them)."""
        named = dict(self.network.named_parameters())
        tree = {"params": self._opt_params(),
                "opt": self._full_opt_state()}
        frozen = {k: p for k, p in named.items() if not p.requires_grad}
        if frozen:
            tree["frozen"] = frozen
        persistent = self.network.state_dict(keep_vars=True)
        buffers = {k: b for k, b in self.network.named_buffers()
                   if k in persistent}
        if buffers:
            tree["buffers"] = buffers
        if self._guard_state is not None:
            # the numeric guard's EMA carry: resume (and guard
            # rollback) keeps the spike baseline instead of re-warming
            tree["guard"] = self._guard_state
        return tree

    def _save_training_state(self, mgr, loader, epoch: int,
                             boundary: bool = False,
                             force: bool = False) -> None:
        """Checkpoint the COMPLETE training state: the parameters, the
        optimizer state and the buffers as the array tree, plus the
        manifest ``state`` bundle — global step, epoch, DataLoader
        cursor, the RNG base key, and pickled metric accumulators. With
        an async manager the call stalls only for the device→host
        snapshot; the commit overlaps the next train steps. Pending
        device metric buffers are drained FIRST, so the snapshot never
        loses in-flight metric state.

        ``boundary=True`` means the epoch (and its pass over the
        loader) is COMPLETE: the state records the NEXT epoch at batch
        0 — resuming from an exhausted cursor would replay the
        finished epoch's on_epoch_begin/eval/on_epoch_end over an
        empty train pass."""
        self._drain_metric_updates()
        tree = self._state_tree()
        sync = self._mesh_sync()
        if sync is not None:
            # the unsharded tree (fsdp gathers each shard), written by
            # rank 0 while the others wait at a barrier
            tree = sync.full_tree(tree)
        cursor = loader.state_dict()
        if boundary:
            cursor = {"pass": int(cursor["pass"]) + 1, "batch": 0}
            epoch = epoch + 1
        state = {
            "step": int(self._step_count),
            "epoch": int(epoch),
            "loader": cursor,
            "rng": {"seed": int(rng._tls.global_seed),
                    "key_data": [int(w) for w in
                                 rng.get_global_stream()._key.tolist()],
                    "key_dtype": "uint32"},
            "metrics": base64.b64encode(pickle.dumps(
                [m.__dict__ for m in self._metrics],
                protocol=4)).decode("ascii"),
        }
        if sync is None or sync.is_writer:
            mgr.save(self._step_count, tree, state=state, force=force)
        if sync is not None:
            sync.barrier()

    def _restore_training_state(self, mgr, resume, loader):
        """Resume from ``mgr``: newest verified step for
        ``resume="auto"`` (or the step pinned by
        ``$PADDLE_ELASTIC_RESUME_STEP`` — an elastic respawn's hint —
        falling back to auto if that step is gone or corrupt), an
        explicit int otherwise. Returns the manifest state bundle, or
        None when the directory has no checkpoint (fresh start)."""
        from ..io.checkpoint import CheckpointCorrupt
        # identity/string checks, NOT `resume in (True, "auto")`:
        # 1 == True in Python, and resume=1 must mean STEP 1
        auto = resume == "auto" or resume is True
        step = None
        if not auto:
            step = int(resume)
        else:
            env = os.environ.get("PADDLE_ELASTIC_RESUME_STEP")
            if env:
                step = int(env)
        try:
            try:
                tree, state = mgr.restore_with_state(step)
            except (CheckpointCorrupt, FileNotFoundError):
                if not auto or step is None:
                    raise
                # the env-pinned step is gone or rotted: auto falls
                # back to the newest verifying step
                tree, state = mgr.restore_with_state(None)
        except FileNotFoundError:
            # only auto treats an empty directory as a fresh start; an
            # explicit resume=<step> that is missing (GC'd, mistyped)
            # must not silently retrain from step 0
            if not auto:
                raise
            return None
        # copy into the live tensors: the network, the optimizer state
        # (and AMP's master weights in it) keep their references; on a
        # mesh every rank restores, and fsdp keeps its shards of the tree
        live = self._state_tree()
        if self._sync is not None:
            tree = self._sync.local_tree(tree)
        for group in ("params", "frozen", "buffers"):
            _copy_into(live.get(group, {}), tree.get(group) or {}, group)
        self._load_opt_state(tree["opt"])
        if tree.get("guard") is not None:
            dev = self._device()
            if self._guard_state is None:
                self._guard_state = _tree_map(lambda x: x.to(dev),
                                              tree["guard"])
            else:
                self._guard_state = _copy_into(self._guard_state,
                                               tree["guard"], "guard")
        state = dict(state or {})
        self._step_count = int(state.get("step", mgr.latest_step() or 0))
        rng_state = state.get("rng")
        if rng_state:
            # the base key, not just the seed: next_key() calls before
            # fit() advance the stream past from_seed(seed)
            rng._tls.global_seed = int(rng_state["seed"])
            rng._tls.stack = [rng.KeyStream(torch.tensor(
                [int(w) for w in rng_state["key_data"]],
                dtype=torch.int64))]
        blob = state.get("metrics")
        if blob:
            for m, st in zip(self._metrics,
                             pickle.loads(base64.b64decode(blob))):
                m.__dict__.update(st)
        cursor = state.get("loader")
        if cursor:
            loader.load_state_dict(cursor)
        return state

    def _guard_rollback(self, mgr, loader, epoch: int, rb) -> int:
        """Recover from a :class:`reliability.guard.GuardRollback`
        raised at a drain boundary inside ``fit``: restore the newest
        VERIFIED checkpoint at or below the trip (parameters, optimizer
        state, RNG key, metric accumulators, guard EMA), then
        fast-forward the DataLoader cursor ``rb.stride`` batches PAST
        the offending step, so the poisoned range is never re-consumed.
        Returns the in-epoch batch index training resumes at. Steps
        between the checkpoint and the trip are discarded along with
        their batches. Assumes the trip landed in the checkpoint's
        epoch. No checkpoint manager / no committed step escalates to
        :class:`GuardAbort`."""
        if mgr is None:
            raise self._guard.escalate(
                rb.step, rb.kind,
                "rollback requested but fit() has no checkpoint_dir",
                model=self) from rb
        # drop buffered device state from the poisoned window — the
        # restore rewinds metric accumulators to the manifest bundle
        self._metric_pending.clear()
        self._guard_pending.clear()
        self._nan_pending.clear()
        # EXPLICIT step, never resume="auto": auto honors the
        # $PADDLE_ELASTIC_RESUME_STEP pin an elastic respawn leaves in
        # the environment for the whole process — a mid-run rollback
        # must restore the newest verified step AT OR BELOW the trip,
        # walking past steps that rotted since their manifest verified
        from ..io.checkpoint import CheckpointCorrupt
        mgr.wait_until_finished()  # in-flight async commits manifest
        cand = [s for s in mgr.verified_steps() if s <= rb.step]
        st = None
        while cand:
            try:
                st = self._restore_training_state(
                    mgr, cand.pop(), loader)
                break
            except (CheckpointCorrupt, FileNotFoundError):
                continue
        if st is None:
            raise self._guard.escalate(
                rb.step, rb.kind,
                "rollback requested before any verified checkpoint "
                "committed", model=self) from rb
        ck_step = int(st.get("step", 0))
        cur = dict(st.get("loader") or {"pass": epoch, "batch": 0})
        tripped = int(cur["batch"]) + (rb.step - ck_step)
        target = tripped + rb.stride
        loader.load_state_dict({"pass": int(cur["pass"]),
                                "batch": target})
        if _trace.enabled():
            _trace.start_span("train.guard", attrs={
                "kind": rb.kind, "action": "rollback",
                "step": rb.step, "restored_step": ck_step,
                "fast_forward_to_batch": target}).end()
        print(f"[numeric-guard] rollback: {rb.kind} at step {rb.step} "
              f"-> restored verified step {ck_step}, fast-forwarded "
              f"cursor past batch {tripped} (stride {rb.stride})",
              file=sys.stderr)
        return target

    # -- fit/evaluate/predict loops -----------------------------------------
    def _split_batch(self, batch) -> Tuple[Tuple, Tuple]:
        batch = _as_tuple(batch)
        if len(batch) == 1:
            return batch, ()
        n_labels = len(self._labels_spec) if self._labels_spec else 1
        return batch[:-n_labels], batch[-n_labels:]

    def _as_loader(self, data, batch_size, shuffle) -> DataLoader:
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              device=self._device())
        raise TypeError(f"unsupported data type {type(data)}")

    def fit(self, train_data=None, eval_data=None, batch_size: int = 1,
            epochs: int = 1, eval_freq: int = 1, log_freq: int = 10,
            save_dir: Optional[str] = None, save_freq: int = 1,
            verbose: int = 2, drop_last: bool = False, shuffle: bool = True,
            num_workers: int = 0, callbacks=None,
            steps_per_loop: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_freq: Optional[int] = None,
            resume=None, keep_checkpoints: int = 5,
            async_checkpoint: bool = True,
            preemption_guard=None,
            preemption_flush_budget: float = 30.0) -> None:
        """Train for ``epochs`` passes over ``train_data`` (a Dataset or
        a DataLoader), evaluating ``eval_data`` every ``eval_freq``
        epochs, with the JAX package's callbacks and logs.
        ``steps_per_loop`` (default ``FLAGS.steps_per_loop``) runs K
        steps a ``train_loop_batch`` call over ``[K, ...]`` superbatches,
        losses equal to K=1; a short last slab runs step by step, and the
        callbacks see every step.

        Preemption-safe training, as in the JAX package:

        - ``checkpoint_dir`` arms full-state checkpointing through
          ``io.checkpoint.CheckpointManager`` — every ``checkpoint_freq``
          optimizer steps (or each epoch when None), async by default:
          the loop stalls only for the device→host snapshot.
        - ``resume="auto"`` (or an explicit step) restores the newest
          VERIFIED checkpoint — parameters, optimizer state, RNG base
          key, DataLoader cursor (mid-epoch, mid-superbatch), and metric
          accumulators — and continues with a loss stream bit-identical
          to the uninterrupted run at any ``steps_per_loop``. An
          elastic respawn pins the step via
          ``$PADDLE_ELASTIC_RESUME_STEP``.
        - ``preemption_guard`` (an ``distributed.PreemptionGuard``) is
          polled at step boundaries: once triggered, the loop snapshots
          the current state, flushes it under ``preemption_flush_budget``
          seconds, and exits ``RESTART_EXIT_CODE`` (on a mesh of several
          data ranks it flushes only what is committed: a snapshot
          there is collective).

        On a mesh (``parallel.distributed_model``) every rank passes the
        global batch and trains on its rows; rank 0 writes the
        checkpoints (the unsharded tree, fsdp shards gathered first)
        while the others wait at a barrier, and every rank restores."""
        assert self._optimizer is not None and self._loss is not None, \
            "call prepare(optimizer, loss, ...) before fit()"
        if steps_per_loop is None:
            steps_per_loop = flags.get_flag("steps_per_loop")
        k_loop = max(int(steps_per_loop), 1)
        if k_loop > 1 and self._shard_batch is not None \
                and self._shard_superbatch is None:
            k_loop = 1  # no superbatch sharding hook wired: stay exact
        loader = self._as_loader(train_data, batch_size, shuffle)
        eval_loader = self._as_loader(eval_data, batch_size, False) \
            if eval_data is not None else None
        train_ckpt = None
        start_epoch = 0
        resume_step_in_epoch = 0
        if checkpoint_dir is not None:
            from ..io.checkpoint import CheckpointManager
            train_ckpt = CheckpointManager(
                checkpoint_dir, max_to_keep=keep_checkpoints,
                async_save=async_checkpoint)
            # not a truthiness gate: resume=0 means "restore STEP 0",
            # only None/False mean "don't resume"
            if resume is not None and resume is not False:
                st = self._restore_training_state(train_ckpt, resume,
                                                  loader)
                if st is not None:
                    start_epoch = int(st.get("epoch", 0))
                    resume_step_in_epoch = int(
                        (st.get("loader") or {}).get("batch", 0))
        last_ckpt_step = self._step_count
        last_ckpt_boundary = True  # restored/fresh state never replays

        def ckpt_tick(epoch: int, force: bool = False,
                      boundary: bool = False) -> None:
            """Step-boundary checkpoint cadence + preemption poll."""
            nonlocal last_ckpt_step, last_ckpt_boundary
            if train_ckpt is not None:
                stale = self._step_count != last_ckpt_step
                # an epoch-end tick UPGRADES a same-step mid-loop save:
                # that save recorded (epoch, exhausted cursor), which
                # would replay the finished epoch's callbacks/eval over
                # an empty train pass on resume
                upgrade = boundary and not stale and not last_ckpt_boundary
                if (stale and (force or (checkpoint_freq and
                                         self._step_count - last_ckpt_step
                                         >= checkpoint_freq))) or upgrade:
                    self._save_training_state(train_ckpt, loader, epoch,
                                              boundary=boundary,
                                              force=upgrade)
                    last_ckpt_step = self._step_count
                    last_ckpt_boundary = boundary
            if preemption_guard is not None and preemption_guard.triggered:
                def _flush():
                    if train_ckpt is None:
                        return
                    from ..reliability.retry import Deadline
                    dl = Deadline.after(preemption_flush_budget)
                    outcome = None
                    # on a mesh a snapshot is collective (rank 0 writes,
                    # fsdp gathers): a rank preempted alone flushes what
                    # is committed, and the job resumes from there
                    alone = self._sync is not None and self._sync.active
                    if self._step_count != last_ckpt_step and not alone:
                        # drain queued commits FIRST: save()'s bounded
                        # queue blocks while a snapshot is queued behind
                        # a slow commit — snapshotting into a backed-up
                        # writer could eat the whole grace budget
                        drained = train_ckpt.flush(dl)
                        if drained in ("committed", "noop"):
                            # fresh snapshot of the CURRENT step
                            self._save_training_state(
                                train_ckpt, loader, epoch,
                                boundary=boundary)
                        else:
                            outcome = drained  # timeout/error: the
                            # previous manifested step stands
                    if outcome is None:
                        outcome = train_ckpt.flush(dl)
                    print(f"[preemption] emergency checkpoint flush: "
                          f"{outcome} (step {self._step_count})",
                          file=sys.stderr)
                # runs _flush then exits RESTART_EXIT_CODE
                preemption_guard.check(save=_flush)

        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, verbose=verbose,
                                log_freq=log_freq,
                                metrics=[m.name() for m in self._metrics],
                                save_dir=save_dir)
        self.stop_training = False
        cbks.on_train_begin()
        logs: Dict[str, Any] = {}
        epoch_done = start_epoch - 1  # last fully completed epoch
        try:
            for epoch in range(start_epoch, epochs):
                if self.stop_training:
                    break
                cbks.on_epoch_begin(epoch)
                # epoch span on the fit thread's stack, so the step and
                # drain spans parent under it; closed even when an
                # exception unwinds (Span.__exit__ records the error)
                ep_span = _trace.span(
                    "train.epoch", attrs={"epoch": epoch}).__enter__() \
                    if _trace.enabled() else None
                step = resume_step_in_epoch if epoch == start_epoch else 0
                try:
                    # fold any still-buffered outputs BEFORE the reset; a
                    # mid-epoch RESUME (step > 0) skips the reset: the
                    # restored accumulators ARE this epoch's state so far
                    if step == 0:
                        self._drain_metric_updates()
                        for m in self._metrics:
                            m.reset()
                    # model-perspective buckets for profiler.summary():
                    # no-ops unless a Profiler is active (ref:
                    # profiler_statistic.py model perspective; the step
                    # runs forward, backward and update in one call, so
                    # the split is Dataloader / TrainStep / Callbacks)
                    from ..profiler import _events as _prof_events
                    from ..profiler import RecordEvent as _Rec
                    rec = _Rec if _prof_events.active \
                        else contextlib.nullcontext
                    while True:
                        # one epoch pass; restarts after a numeric-guard
                        # ROLLBACK (the newest verified checkpoint is
                        # restored and the loader cursor fast-forwarded
                        # past the offending range)
                        it = loader.superbatches(k_loop) if k_loop > 1 \
                            else iter(loader)
                        try:
                            while True:
                                with rec("Dataloader"):
                                    batch = next(it, None)
                                if batch is None:
                                    break
                                inputs, labels = self._split_batch(batch)
                                if k_loop > 1:
                                    k = int(np.shape(inputs[0])[0])
                                    if k == k_loop:
                                        with rec("TrainStep"):
                                            step_logs = \
                                                self.train_loop_batch(
                                                    inputs, labels)
                                        with rec("Callbacks"):
                                            for logs in step_logs:
                                                cbks.on_train_batch_begin(
                                                    step)
                                                cbks.on_train_batch_end(
                                                    step, logs)
                                                step += 1
                                        ckpt_tick(epoch)
                                        continue
                                    # a ragged tail slab (< K steps) runs
                                    # step by step: the same math
                                    sub = [(tuple(x[i] for x in inputs),
                                            tuple(y[i] for y in labels))
                                           for i in range(k)]
                                else:
                                    sub = [(inputs, labels)]
                                for inp, lab in sub:
                                    cbks.on_train_batch_begin(step)
                                    with rec("TrainStep"):
                                        logs = self.train_batch(inp, lab)
                                    with rec("Callbacks"):
                                        cbks.on_train_batch_end(step, logs)
                                    step += 1
                                ckpt_tick(epoch)
                            # the tail drain inside the rollback scope: a
                            # trip buffered by the pass's last batches
                            # must escalate where a rollback can still
                            # restart this epoch's iteration
                            self._drain_metric_updates()
                            break
                        except _nguard.GuardRollback as rb:
                            step = self._guard_rollback(train_ckpt,
                                                        loader, epoch, rb)
                            last_ckpt_step = self._step_count
                            if hasattr(it, "close"):
                                it.close()
                    # freeze the epoch's final train logs now (an epoch
                    # boundary is a display boundary): the eval pass
                    # below resets the shared metric accumulators
                    logs = {n: float(v) if isinstance(
                        v, (_LazyMetricValue, _SlabScalar)) else v
                        for n, v in logs.items()}
                    if eval_loader is not None and epoch % eval_freq == 0:
                        with rec("Eval"):
                            eval_logs = self.evaluate(
                                eval_loader, verbose=0, _callbacks=cbks)
                        logs.update({f"eval_{k}": v
                                     for k, v in eval_logs.items()})
                    cbks.on_epoch_end(epoch, logs)
                    # epoch-granular checkpoint default (checkpoint_freq
                    # None): one full-state save per completed epoch
                    ckpt_tick(epoch, force=checkpoint_freq is None,
                              boundary=True)
                    epoch_done = epoch
                finally:
                    if ep_span is not None:
                        ep_span.set_attr("steps", step)
                        ep_span.__exit__(*sys.exc_info())
            cbks.on_train_end(logs)
            if train_ckpt is not None:
                # final full-state save (no-op if the last step is
                # already boundary-checkpointed), keyed to the last
                # COMPLETED epoch — a stop_training break leaves `epoch`
                # naming an epoch that never ran
                ckpt_tick(epoch_done, force=True, boundary=True)
        finally:
            if train_ckpt is not None:
                # fit-exit barrier, exception path included: wait out
                # in-flight async commits and stop the writer thread. A
                # close/commit failure must not mask an exception
                # already unwinding through fit — but on a clean exit it
                # IS fit's failure (the final save never committed)
                unwinding = sys.exc_info()[0] is not None
                try:
                    train_ckpt.close()
                except BaseException:
                    if not unwinding:
                        raise

    def evaluate(self, eval_data, batch_size: int = 1, log_freq: int = 10,
                 verbose: int = 2, num_workers: int = 0, callbacks=None,
                 _callbacks=None) -> Dict[str, Any]:
        """The mean loss and the metrics over ``eval_data``, as host
        floats."""
        loader = self._as_loader(eval_data, batch_size, False)
        cbks = _callbacks or config_callbacks(
            callbacks, model=self, verbose=verbose,
            metrics=[m.name() for m in self._metrics])
        cbks.on_eval_begin()
        # drain-then-reset: buffered train-step outputs fold in first
        self._drain_metric_updates()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = self._split_batch(batch)
            logs = self.eval_batch(inputs, labels)
            if "loss" in logs:
                losses.append(logs["loss"])
            cbks.on_eval_batch_end(step, logs)
        out: Dict[str, Any] = {}
        if losses:
            # one host read for the whole pass
            out["loss"] = float(np.mean(_host(torch.stack(
                [torch.as_tensor(x).reshape(()) for x in losses]))))
        self._drain_metric_updates()
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, _as_tuple(vals)):
                out[n] = float(v)
        cbks.on_eval_end(out)
        return out

    def predict(self, test_data, batch_size: int = 1,
                num_workers: int = 0, stack_outputs: bool = False):
        """The network's outputs for every batch, as NumPy arrays
        (concatenated along the batch axis with ``stack_outputs``)."""
        loader = self._as_loader(test_data, batch_size, False)
        outputs = []
        for batch in loader:
            out = self.predict_batch(_as_tuple(batch))
            outputs.append(_tree_map(_host, out))
        if stack_outputs and outputs:
            outputs = _tree_map(lambda *xs: np.concatenate(xs, axis=0),
                                *outputs)
        return outputs

    # -- persistence --------------------------------------------------------
    def save(self, path: str, training: bool = True) -> None:
        """Saves ``path + '.pdparams'`` (a pickled NumPy state dict under
        the JAX package's names and layouts) and, with ``training``,
        ``path + '.pdopt'`` (``{"state": optimizer state, "step"}``)."""
        sync = self._mesh_sync()
        with self._unsharded():
            state = self.network.state_dict()
            if sync is not None:   # tp slices and pp stages gathered
                state = sync.full_tree(state, fsdp=False)
            state = {k: _host(v) for k, v in state.items()}
        opt = self._opt_state
        if sync is not None and opt is not None:
            opt = sync.full_tree(opt)
        if sync is not None and not sync.is_writer:
            return
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path + ".pdparams", "wb") as f:
            pickle.dump(state, f, protocol=4)
        if training and self._optimizer is not None:
            # the JAX package's optimizer state holds its counters as
            # int32 device scalars
            opt_state = _tree_map(
                lambda x: np.asarray(x, np.int32) if isinstance(x, int)
                else _host(x), opt)
            with open(path + ".pdopt", "wb") as f:
                pickle.dump({"state": opt_state,
                             "step": np.asarray(self._step_count)}, f,
                            protocol=4)

    def load(self, path: str, reset_optimizer: bool = False) -> None:
        """Loads a ``.pdparams`` file (of either package) into the
        network and, unless ``reset_optimizer``, the ``.pdopt`` beside
        it into the optimizer state and step count."""
        with open(path + ".pdparams", "rb") as f:
            state = pickle.load(f)
        sync = self._mesh_sync()
        if sync is not None:   # this rank's tp slices and pp stages
            state = sync.local_tree(state, fsdp=False)
        with self._unsharded():
            load_reference_state(self.network, state)
            if sync is not None:
                sync.refresh_shards()
        if not reset_optimizer and os.path.exists(path + ".pdopt"):
            with open(path + ".pdopt", "rb") as f:
                opt = pickle.load(f)
            dev = self._device()

            def put(x):
                a = np.asarray(x)
                if a.ndim == 0 and a.dtype.kind in "iu":
                    return int(a)
                return torch.from_numpy(np.array(a)).to(dev)
            self._opt_state = _tree_map(put, opt["state"]) \
                if opt["state"] is not None else None
            if sync is not None and self._opt_state is not None:
                self._opt_state = sync.local_tree(self._opt_state)
            self._step_count = int(opt["step"])
        else:
            self._opt_state = None

    def parameters(self):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None) -> Dict[str, int]:
        """Per-layer table and parameter counts (shapes from forward
        hooks over one forward of zeros at ``input_size``)."""
        from .summary import summary as _summary
        multi = isinstance(input_size, (list, tuple)) and input_size \
            and isinstance(input_size[0], (list, tuple))
        n = len(input_size) if multi else 1
        return _summary(self.network, input_size,
                        [dtype] * n if dtype else None)
