"""``Model``, the Keras-style trainer (the port's counterpart of
``paddle_tpu/hapi/model.py``).

``prepare`` takes the optimizer, the loss, the metrics and the AMP
configuration. ``train_batch`` runs one eager step on the network's
device: the forward under the AMP context and under ``rng.key_guard`` of
the step's key (``rng.split_for_step(step)``, so that dropout draws the
JAX package's masks), the loss outside it (as in the JAX package's
step), each metric's ``compute`` on the forward's output,
``loss.float().backward()``, then the optimizer's ``apply_in_place`` at
``step_idx = self._step_count``. The loss comes back as a 0-dim device
tensor; metric outputs and the ``check_nan_inf`` loss test are buffered
on the device and drained at log boundaries (a read of a lazy metric
log, an epoch or eval boundary, or ``_PENDING_DRAIN_CAP`` buffered
steps), so a step never syncs the host.

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

Not ported yet, each raising ``NotImplementedError`` naming its ROADMAP
item: ``fit(checkpoint_dir=, resume=, preemption_guard=)`` (A6: the
JAX package's ``io/checkpoint.py`` is built on orbax), the fused K-step
loop (``steps_per_loop > 1``, ``train_loop_batch``; A3.2) and the
numeric guard (A3.4). The profiler's model-perspective buckets record
nothing: the port has no profiler yet (A7).
"""

from __future__ import annotations

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
    """Train-loop instruments; the port fills only the drain histogram
    (the fused K-step slab is ROADMAP A3.2)."""
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


def _nan_report_names(named: Dict[str, Dict[str, torch.Tensor]]
                      ) -> List[str]:
    """Names (``param.<name>``, ``buffer.<name>``) of floating tensors
    holding a NaN or an Inf."""
    out = []
    for group, tensors in named.items():
        for k, v in tensors.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                out.append(f"{group}.{k}")
    return sorted(out)


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
        # recompile guard: distinct (shape, dtype) signatures seen
        self._shape_signatures = set()
        # device metric outputs buffered until a log/display boundary
        # coerces them (_drain_metric_updates) — no per-step host sync;
        # the check_nan_inf flag buffers its losses the same way
        self._metric_pending: List[Tuple] = []
        self._nan_pending: List[Tuple] = []
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
        custom_black_list}. ``metrics``: a Metric or a list of them. The
        numeric guard is not ported yet and raises."""
        if numeric_guard:
            raise NotImplementedError(
                "Model.prepare(numeric_guard=...) is not ported yet "
                "(ROADMAP A3.4: the numeric guard as torch ops)")
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
            return {
                "step_count": m._step_count,
                "compiled_shapes": m.compiled_shape_count,
                "pending_metric_buffers": len(m._metric_pending),
                "loop_compiled": False,
                "step_compiled": m._train_step_built,
                "stop_training": m.stop_training,
            }

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
        """Register the network's parameters and buffers and, once
        built, the optimizer state, per dtype (from shapes only; the
        same rows re-registered overwrite)."""
        trees = {"train_params": dict(self.network.named_parameters()),
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
    def _metric_outputs(self, outputs, labels):
        outs = _as_tuple(outputs)
        labs = _as_tuple(labels)
        return tuple(m.compute(outs[0].detach(), labs[0])
                     for m in self._metrics)

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

    def _guard_recompiles(self, inputs, labels, kind: str = "step") -> bool:
        """Track the distinct input signatures and warn once past
        FLAGS.recompile_warn_threshold. Returns True when this batch
        brings a new one (counted in ``train_compile_count``). Threshold
        0 turns the guard off; the set is capped at 4096."""
        thresh = flags.get_flag("recompile_warn_threshold")
        if not thresh:
            return False
        seen = self._shape_signatures
        if len(seen) >= 4096:
            return False
        sig = (kind,) + _shape_signature(inputs, labels)
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

    # -- batch-level API ----------------------------------------------------
    def train_batch(self, inputs, labels=None) -> Dict[str, Any]:
        """One optimizer step on one batch; returns ``{"loss": <0-dim
        device tensor>}`` and the metrics' lazy values, without a host
        sync."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")
        inputs = _as_tuple(inputs)
        labels = _as_tuple(labels) if labels is not None else ()
        fresh_shape = self._guard_recompiles(inputs, labels)
        if self._obs is None:
            self._obs = _train_metrics()
        batch_n = np.shape(inputs[0])[0] if inputs and len(
            np.shape(inputs[0])) else 0
        sp = _trace.start_span(
            "train.step", attrs={"batch": batch_n,
                                 "step": self._step_count}) \
            if _trace.enabled() else None
        t0 = time.perf_counter()
        try:
            loss, metric_outs = self._train_step(inputs, labels)
        except BaseException as e:
            if sp is not None:
                sp.set_status("error")
                sp.end()
            _memobs.maybe_dump_oom(e, component="train")
            raise
        self._step_count += 1
        dt = time.perf_counter() - t0
        self._obs["step"].observe(dt)
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
        if batch_n and dt > 0:
            self._obs["eps"].observe(batch_n / dt)
        self._obs["steps"].set(self._step_count)
        # the loss and metric outputs stay on the device; the metric
        # outputs and the check_nan_inf loss test drain at a boundary
        logs = {"loss": loss}
        if flags.get_flag("check_nan_inf"):
            self._buffer_nan_check(loss, self._step_count - 1, 1)
        self._buffer_metric_outs(metric_outs, 1)
        self._attach_metric_logs(logs)
        return logs

    def _train_step(self, inputs, labels):
        self.network.train()
        inputs = self._to_device(inputs)
        labels = self._to_device(labels)
        params = self._trainable()
        with rng.key_guard(rng.split_for_step(self._step_count)), \
                self._amp_context():
            out = self.network(*inputs)
        loss = self._compute_loss(out, labels).float()
        metric_outs = self._metric_outputs(out, labels)
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        built = self._opt_state is None
        self._opt_state = self._optimizer.apply_in_place(
            params, grads, self._opt_state, self._step_count)
        for p in params.values():
            p.grad = None
        self._train_step_built = True
        if built and _memobs.enabled():
            self._register_memory()
        return loss.detach(), metric_outs

    def train_loop_batch(self, inputs, labels=None):
        raise NotImplementedError(
            "Model.train_loop_batch (the fused K-step loop) is not ported "
            "yet (ROADMAP A3.2: train_loop_batch as a CUDA graph)")

    # buffered outputs after which a drain runs even if nothing reads a
    # value (verbose=0 fit, long evaluate loops): bounds the device
    # tensors the pending lists hold
    _PENDING_DRAIN_CAP = 64

    def _buffer_nan_check(self, losses, step0: int, k: int) -> None:
        """The ``check_nan_inf`` flag, deferred: buffer the device loss
        and test it at the next drain."""
        self._nan_pending.append((losses, step0, k))
        if len(self._nan_pending) >= self._PENDING_DRAIN_CAP:
            self._drain_metric_updates()

    def _drain_nan_checks(self) -> None:
        pending, self._nan_pending = self._nan_pending, []
        if not pending:
            return
        arrs = _host(torch.stack([p[0].reshape(-1) for p in pending]))
        for arr, (_, step0, k) in zip(arrs, pending):
            finite = np.isfinite(arr)
            if not finite.all():
                idx = int(np.argmin(finite))
                bad = _nan_report_names({
                    "param": dict(self.network.named_parameters()),
                    "buffer": dict(self.network.named_buffers())})
                raise FloatingPointError(
                    f"NaN/Inf loss at step {step0 + idx}"
                    + (f" (step {idx} of a {k}-step slab)" if k > 1
                       else "")
                    + f"; non-finite tensors: {bad or ['(loss only)']}")

    def _buffer_metric_outs(self, metric_outs, nsteps: int) -> None:
        if self._metrics:
            if len(self._metric_pending) >= self._PENDING_DRAIN_CAP:
                self._drain_metric_updates()
            self._metric_pending.append((metric_outs, nsteps))

    def _attach_metric_logs(self, logs: Dict[str, Any]) -> None:
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            for j, n in enumerate(names):
                logs[n] = _LazyMetricValue(self, m, j)

    def _drain_metric_updates(self) -> None:
        """Fold every buffered device metric output into the host
        accumulators — one sync for all steps since the last drain (the
        deferral ``train_loop_drain_seconds`` measures); the buffered
        ``check_nan_inf`` losses are tested here too and raise
        FloatingPointError."""
        if self._metric_pending:
            sp = _trace.start_span(
                "train.metric_drain",
                attrs={"pending": len(self._metric_pending)}) \
                if _trace.enabled() else None
            t0 = time.perf_counter()
            try:
                pending, self._metric_pending = self._metric_pending, []
                for outs, nsteps in pending:
                    for m, mo in zip(self._metrics, outs):
                        m.update_stacked(_as_tuple(mo), nsteps)
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
        if self._nan_pending:
            self._drain_nan_checks()

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
        inputs = self._to_device(inputs)
        labels = self._to_device(labels)
        with rng.key_guard(rng.split_for_step(self._step_count)), \
                self._amp_context():
            out = self.network(*inputs)
        logs = {}
        if self._loss is not None:
            logs["loss"] = self._compute_loss(out, labels)
        self._buffer_metric_outs(self._metric_outputs(out, labels), 1)
        self._attach_metric_logs(logs)
        return logs

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The eval-mode forward of one batch, without the AMP context
        (as in the JAX package's predict step)."""
        self.network.eval()
        return self.network(*self._to_device(_as_tuple(inputs)))

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
            steps_per_loop: int = 1,
            checkpoint_dir: Optional[str] = None,
            checkpoint_freq: Optional[int] = None,
            resume=None, keep_checkpoints: int = 5,
            async_checkpoint: bool = True,
            preemption_guard=None,
            preemption_flush_budget: float = 30.0) -> None:
        """Train for ``epochs`` passes over ``train_data`` (a Dataset or
        a DataLoader), evaluating ``eval_data`` every ``eval_freq``
        epochs, with the JAX package's callbacks and logs. Full-state
        checkpoints (``checkpoint_dir``, ``resume``,
        ``preemption_guard``) and ``steps_per_loop > 1`` are not ported
        yet and raise."""
        if checkpoint_dir is not None or (resume is not None
                                          and resume is not False) \
                or preemption_guard is not None:
            raise NotImplementedError(
                "fit(checkpoint_dir=, resume=, preemption_guard=) is not "
                "ported yet (ROADMAP A6: io/checkpoint.py)")
        if int(steps_per_loop) > 1:
            raise NotImplementedError(
                "fit(steps_per_loop > 1), the fused K-step loop, is not "
                "ported yet (ROADMAP A3.2: train_loop_batch as a CUDA "
                "graph)")
        assert self._optimizer is not None and self._loss is not None, \
            "call prepare(optimizer, loss, ...) before fit()"
        loader = self._as_loader(train_data, batch_size, shuffle)
        eval_loader = self._as_loader(eval_data, batch_size, False) \
            if eval_data is not None else None
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
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            # epoch span on the fit thread's stack, so the step and
            # drain spans parent under it; closed even when an exception
            # unwinds (Span.__exit__ records the error)
            ep_span = _trace.span(
                "train.epoch", attrs={"epoch": epoch}).__enter__() \
                if _trace.enabled() else None
            step = 0
            try:
                # fold any still-buffered outputs BEFORE the reset
                self._drain_metric_updates()
                for m in self._metrics:
                    m.reset()
                for batch in loader:
                    inputs, labels = self._split_batch(batch)
                    cbks.on_train_batch_begin(step)
                    logs = self.train_batch(inputs, labels)
                    cbks.on_train_batch_end(step, logs)
                    step += 1
                self._drain_metric_updates()
                # freeze the epoch's final train logs now (an epoch
                # boundary is a display boundary): the eval pass below
                # resets the shared metric accumulators
                logs = {n: float(v) if isinstance(
                    v, (_LazyMetricValue, _SlabScalar)) else v
                    for n, v in logs.items()}
                if eval_loader is not None and epoch % eval_freq == 0:
                    eval_logs = self.evaluate(eval_loader, verbose=0,
                                              _callbacks=cbks)
                    logs.update({f"eval_{k}": v
                                 for k, v in eval_logs.items()})
                cbks.on_epoch_end(epoch, logs)
            finally:
                if ep_span is not None:
                    ep_span.set_attr("steps", step)
                    ep_span.__exit__(*sys.exc_info())
        cbks.on_train_end(logs)

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
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        state = {k: _host(v) for k, v in self.network.state_dict().items()}
        with open(path + ".pdparams", "wb") as f:
            pickle.dump(state, f, protocol=4)
        if training and self._optimizer is not None:
            # the JAX package's optimizer state holds its counters as
            # int32 device scalars
            opt_state = _tree_map(
                lambda x: np.asarray(x, np.int32) if isinstance(x, int)
                else _host(x), self._opt_state)
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
        load_reference_state(self.network, state)
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
