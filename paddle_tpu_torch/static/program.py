"""Minimal Program/Variable world for the ``paddle.static`` surface (the
port's counterpart of ``paddle_tpu/static/program.py``).

Reference being replaced: python/paddle/fluid/framework.py ``Program``
(:4865) / ``Variable`` and executor.py ``Executor.run`` — a
ProgramDesc/OpDesc IR interpreted by C++ executors. As in the JAX
package there is one world: ``static.data`` makes symbolic Variables,
static ops build a closure DAG, and ``Executor.run`` evaluates the
requested fetches eagerly with the feed dict on the device
``set_device`` chose; each set of gradient targets costs one
``torch.autograd.grad`` (the JAX package makes one ``jax.grad``).
Parameters live on the Program (the Scope analog) and persist across
run() calls. ``create_parameter`` draws through the port's threefry
(``rng.next_key("init")``), so a program built after the same seed holds
the JAX package's parameters bit for bit.
"""

from __future__ import annotations

import contextlib
import math
import pickle
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _device():
    from ..core.device import current_device
    return current_device()


def _tensor(v, dtype=None):
    if isinstance(v, torch.Tensor):
        return v if dtype is None else v.to(dtype)
    t = torch.as_tensor(np.asarray(v), device=_device())
    return t if dtype is None else t.to(dtype)


def _numpy(v):
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class Variable:
    """Symbolic node: either a feed placeholder (``name``), a parameter
    handle, or an op output (``fn`` over ``deps``). Ref:
    fluid/framework.py Variable."""

    _ctr = 0

    def __init__(self, name=None, shape=None, dtype=None, fn=None,
                 deps=(), param=False):
        if name is None:
            Variable._ctr += 1
            name = f"_var_{Variable._ctr}"
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.fn = fn
        self.deps = tuple(deps)
        self.is_parameter = param
        self.persistable = param
        self.stop_gradient = not param

    # -- evaluation ---------------------------------------------------------
    def _eval(self, feeds: Dict[str, Any], prog: "Program",
              cache: Dict[int, Any]):
        if id(self) in cache:
            return cache[id(self)]
        if self.is_parameter:
            val = prog.state[self.name]
        elif self.fn is not None:
            args = [d._eval(feeds, prog, cache) if isinstance(d, Variable)
                    else d for d in self.deps]
            val = self.fn(*args)
        else:
            if self.name not in feeds:
                raise KeyError(f"feed missing for '{self.name}'")
            val = _tensor(feeds[self.name])
        cache[id(self)] = val
        return val

    def __repr__(self):
        kind = ("param" if self.is_parameter
                else "op" if self.fn else "data")
        return f"Variable({self.name!r}, {kind}, shape={self.shape})"


def _op(fn: Callable, *deps, shape=None, dtype=None) -> Variable:
    """Register an op node in the current program."""
    v = Variable(shape=shape, dtype=dtype, fn=fn, deps=deps)
    default_main_program()._vars.append(v)
    return v


class Program:
    """ref: fluid/framework.py:4865. Holds parameters (the Scope
    analog), symbolic vars, and the RNG for initializers."""

    def __init__(self):
        self.state: Dict[str, torch.Tensor] = {}
        self._vars: List[Variable] = []
        self.random_seed = 0

    def global_block(self):
        return self

    # Block-API compat: iterate vars
    def all_parameters(self):
        return [v for v in self._vars if v.is_parameter]

    def list_vars(self):
        return list(self._vars)

    def clone(self, for_test: bool = False) -> "Program":
        p = Program()
        p.state = self.state          # shared persistables (ref semantics)
        p._vars = list(self._vars)
        return p


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program=None):
    global _main_program, _startup_program
    old_m, old_s = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_m, old_s


@contextlib.contextmanager
def name_scope(prefix: str = None):
    """ref: framework.py name_scope — naming only: a
    ``torch.profiler.record_function`` range on the timeline."""
    with torch.profiler.record_function(prefix or "scope"):
        yield


@contextlib.contextmanager
def device_guard(device: str = None):
    """ref: framework.py device_guard. Accepted and recorded as a no-op:
    a program runs on the device ``set_device`` chose."""
    yield


class Scope(dict):
    def find_var(self, name):
        return self.get(name)

    def var(self, name):
        return self.setdefault(name, None)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


# -- graph-building primitives ----------------------------------------------

def data(name: str, shape, dtype="float32", lod_level=0) -> Variable:
    """Feed placeholder (ref: static/input.py data)."""
    v = Variable(name=name, shape=shape, dtype=dtype)
    default_main_program()._vars.append(v)
    return v


def _initialize(shape, initializer, seed_name: str):
    """The initial value, float32, on the program's device. The default
    (Glorot uniform) draws ``jax.random.uniform`` bit for bit from the
    ``init`` key stream, as the JAX package's ``XavierUniform`` does; a
    given initializer (``init(shape, dtype)``) is called as it is."""
    if initializer is not None:
        return initializer(list(shape), torch.float32)
    from ..core import rng as _rng
    from ..core import threefry
    from ..nn.initializer import _fan_in_out
    fi, fo = _fan_in_out(list(shape))
    limit = math.sqrt(6.0 / max(fi + fo, 1))
    return threefry.uniform(_rng.next_key("init"), tuple(shape), -limit,
                            limit, device=_device())


def create_parameter(shape, dtype="float32", name=None,
                     initializer=None, attr=None,
                     is_bias=False, default_initializer=None) -> Variable:
    """ref: static/__init__ create_parameter → LayerHelper. The value
    initializes eagerly into the program state."""
    from ..core import dtype as _dtype
    prog = default_main_program()
    v = Variable(name=name, shape=shape, dtype=dtype, param=True)
    prog._vars.append(v)
    prog.state[v.name] = _initialize(
        shape, initializer or default_initializer, v.name).to(
        device=_device(), dtype=_dtype.dtype(dtype))
    return v


def create_global_var(shape, value, dtype="float32", persistable=False,
                      name=None) -> Variable:
    from ..core import dtype as _dtype
    prog = default_main_program()
    v = Variable(name=name, shape=shape, dtype=dtype, param=True)
    v.persistable = persistable
    prog._vars.append(v)
    prog.state[v.name] = torch.full(tuple(shape), value,
                                    dtype=_dtype.dtype(dtype),
                                    device=_device())
    return v


def Print(input: Variable, first_n=-1, message=None, summarize=20,
          **_kw) -> Variable:
    """Debug print at evaluation (ref: layers/control_flow.py Print)."""
    msg = message or input.name

    def fn(x):
        print(f"{msg}: {x}")
        return x

    return _op(fn, input, shape=input.shape, dtype=input.dtype)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Host-python op inside the graph (ref: fluid/layers/nn.py py_func):
    ``func`` gets numpy arrays and its result comes back as a tensor of
    ``out``'s dtype."""
    from ..core import dtype as _dtype
    xs = x if isinstance(x, (list, tuple)) else [x]
    out_spec = out if isinstance(out, (list, tuple)) else [out]

    def fn(*vals):
        res = func(*[_numpy(v) for v in vals])
        outs = res if isinstance(res, (list, tuple)) else [res]
        ts = [_tensor(r, _dtype.dtype(o.dtype or "float32"))
              for r, o in zip(outs, out_spec)]
        return ts[0] if len(ts) == 1 else tuple(ts)

    return _op(fn, *xs, shape=out_spec[0].shape, dtype=out_spec[0].dtype)


# -- gradients --------------------------------------------------------------

def gradients(targets, inputs, target_gradients=None,
              no_grad_set=None) -> List[Variable]:
    """Symbolic grads d(targets)/d(inputs) (ref: fluid/backward.py
    gradients): a grad node per input, evaluated by one
    ``torch.autograd.grad`` over the closure DAG."""
    tgt = targets if isinstance(targets, (list, tuple)) else [targets]
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    prog = default_main_program()

    def make(i):
        g = Variable(name=f"{ins[i].name}@GRAD", shape=ins[i].shape,
                     dtype=ins[i].dtype)
        g._grad_spec = (tuple(tgt), ins[i])
        prog._vars.append(g)
        return g

    return [make(i) for i in range(len(ins))]


def append_backward(loss: Variable, parameter_list=None,
                    no_grad_set=None, callbacks=None):
    """ref: fluid/backward.py:1555. Returns [(param_var, grad_var)]."""
    prog = default_main_program()
    params = parameter_list or [v for v in prog._vars if v.is_parameter]
    grads = []
    for p in params:
        g = Variable(name=f"{p.name}@GRAD", shape=p.shape, dtype=p.dtype)
        g._grad_spec = ((loss,), p)
        prog._vars.append(g)
        grads.append((p, g))
    return grads


# -- executor over the closure DAG ------------------------------------------

class StaticExecutor:
    """Evaluate fetches of a Program with feeds (ref:
    fluid/executor.py:621 Executor; one eager pass over the closure DAG
    instead of an op-by-op C++ loop)."""

    def __init__(self, place=None):
        self.place = place

    def _grads(self, prog, feed, targets):
        """d(sum of targets)/d(state) by ONE torch.autograd.grad; a
        state tensor the targets do not reach gets zeros, as jax.grad
        gives."""
        state = {k: v.detach().requires_grad_(v.is_floating_point())
                 for k, v in prog.state.items()}
        tmp = Program()
        tmp.state = state
        tmp._vars = prog._vars
        c: Dict[int, Any] = {}
        total = sum(t._eval(feed, tmp, c).sum() for t in targets)
        names = [k for k, v in state.items() if v.requires_grad]
        gs = torch.autograd.grad(total, [state[k] for k in names],
                                 allow_unused=True)
        return {k: torch.zeros_like(state[k]) if g is None else g
                for k, g in zip(names, gs)}

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list: Sequence[Variable] = (), return_numpy=True):
        prog = program or default_main_program()
        feed = feed or {}
        outs = []
        cache: Dict[int, Any] = {}
        # ONE backward pass serves every grad fetch with the same
        # targets (fetching append_backward's P grads must not cost P
        # backward passes)
        grad_cache: Dict[tuple, Dict[str, Any]] = {}
        for f in fetch_list:
            if isinstance(f, Variable) and hasattr(f, "_grad_spec"):
                targets, wrt = f._grad_spec
                key = tuple(id(t) for t in targets)
                if key not in grad_cache:
                    grad_cache[key] = self._grads(prog, feed, targets)
                if wrt.is_parameter:
                    val = grad_cache[key][wrt.name]
                else:
                    raise ValueError(
                        "gradients w.r.t. non-parameter feeds: use "
                        "paddle.grad on a function instead")
            elif isinstance(f, Variable):
                with torch.no_grad():
                    val = f._eval(feed, prog, cache)
            else:
                val = f
            outs.append(_numpy(val) if return_numpy else val)
        return outs


# -- serialization (ref: static/io.py serialize_* / save/load) --------------

def serialize_program(feed_vars=None, fetch_vars=None,
                      program: Optional[Program] = None) -> bytes:
    prog = program or default_main_program()
    meta = [(v.name, v.shape, str(v.dtype), v.is_parameter)
            for v in prog._vars]
    return pickle.dumps(meta)


def deserialize_program(data: bytes) -> Program:
    prog = Program()
    for name, shape, dtype, is_param in pickle.loads(data):
        v = Variable(name=name, shape=shape, dtype=dtype, param=is_param)
        prog._vars.append(v)
    return prog


def serialize_persistables(feed_vars=None, fetch_vars=None,
                           program: Optional[Program] = None) -> bytes:
    prog = program or default_main_program()
    return pickle.dumps({k: _numpy(v) for k, v in prog.state.items()})


def deserialize_persistables(program: Program, data: bytes,
                             executor=None) -> None:
    program.state.update({k: _tensor(v)
                          for k, v in pickle.loads(data).items()})


def save_to_file(path: str, content: bytes) -> None:
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def save(program: Program, model_prefix: str) -> None:
    """ref: static/io.py save — params + program structure."""
    save_to_file(model_prefix + ".pdmodel", serialize_program(
        program=program))
    save_to_file(model_prefix + ".pdiparams", serialize_persistables(
        program=program))


def load(program: Program, model_prefix: str, executor=None,
         var_list=None) -> None:
    deserialize_persistables(
        program, load_from_file(model_prefix + ".pdiparams"))


def load_program_state(model_prefix: str, var_list=None):
    return {k: np.asarray(v) for k, v in pickle.loads(
        load_from_file(model_prefix + ".pdiparams")).items()}


def set_program_state(program: Program, state_dict) -> None:
    program.state.update({k: _tensor(v) for k, v in state_dict.items()})


def normalize_program(program: Program, feed_vars, fetch_vars):
    """ref: static/io.py normalize_program — prune to the fetch
    closure. The closure DAG is already minimal: evaluation only ever
    touches the fetched subgraph, so this returns the program."""
    return program


# -- strategy/compat shells -------------------------------------------------

class BuildStrategy:
    """ref: framework/details/build_strategy.h. The knobs (fusion,
    memory optimize, reduce strategy) belong to the reference's graph
    passes; the object exists so configs parse (an eager program has no
    such passes)."""

    class ReduceStrategy:
        AllReduce, Reduce = 0, 1

    class GradientScaleStrategy:
        CoeffNumDevice, One, Customized = 0, 1, 2

    def __init__(self):
        self.reduce_strategy = self.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            self.GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = None
        self.fuse_elewise_add_act_ops = None


class ExecutionStrategy:
    """ref: details/execution_strategy.h — thread counts for the SSA
    executors; kept for config parity."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 100


class CompiledProgram:
    """ref: fluid/compiler.py CompiledProgram — with_data_parallel etc.;
    this wrapper keeps scripts working."""

    def __init__(self, program, build_strategy=None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self


class ParallelExecutor:
    """ref: framework/parallel_executor.cc. Data parallelism is
    ``parallel.DataParallel`` / ``distributed_model``; this shell
    delegates to StaticExecutor for API compat."""

    def __init__(self, use_cuda=False, loss_name=None,
                 main_program=None, build_strategy=None,
                 exec_strategy=None, **_kw):
        self._exe = StaticExecutor()
        self._program = main_program

    def run(self, fetch_list=(), feed=None, return_numpy=True):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=fetch_list,
                             return_numpy=return_numpy)


class WeightNormParamAttr:
    """ref: fluid/param_attr.py WeightNormParamAttr — config carrier;
    the actual reparameterization is nn.utils.weight_norm."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


class ExponentialMovingAverage:
    """EMA of parameter values (ref: fluid/optimizer.py
    ExponentialMovingAverage, with apply/restore guards). Works on the
    Program state or any dict of tensors."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self.decay = decay
        self._ema: Dict[str, torch.Tensor] = {}
        self._backup: Dict[str, torch.Tensor] = {}
        self._step = 0

    def update(self, program: Optional[Program] = None):
        prog = program or default_main_program()
        self._step += 1
        d = min(self.decay, (1.0 + self._step) / (10.0 + self._step))
        for k, v in prog.state.items():
            prev = self._ema.get(k, v)
            self._ema[k] = d * prev + (1.0 - d) * v

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        prog = default_main_program()
        self._backup = dict(prog.state)
        prog.state.update(self._ema)
        try:
            yield
        finally:
            if need_restore:
                prog.state.update(self._backup)

    def restore(self, executor=None):
        default_main_program().state.update(self._backup)


# -- places (ref: static/__init__ cpu_places/cuda_places/...) ---------------

def cpu_places(device_count=None):
    import os
    from ..device import CPUPlace
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def _accelerator_places(kind):
    """xpu/npu/mlu places: none exist in a CUDA build (the reference's
    is_compiled_with_* story); empty list, not an error."""
    return []


def cuda_places(device_ids=None):
    from ..device import CUDAPlace
    ids = device_ids if device_ids is not None else \
        range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    return _accelerator_places("xpu")


def npu_places(device_ids=None):
    return _accelerator_places("npu")


def mlu_places(device_ids=None):
    return _accelerator_places("mlu")


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """ref: fluid/layers/learning_rate_scheduler.py exponential_decay →
    the modern optimizer.lr.ExponentialDecay."""
    from ..optimizer.lr import ExponentialDecay
    return ExponentialDecay(learning_rate=learning_rate,
                            gamma=decay_rate)


def accuracy(input, label, k=1, correct=None, total=None):
    """Graph-node accuracy (ref: static/__init__ accuracy →
    metrics.accuracy)."""
    def fn(x, y):
        topk = torch.argsort(x, dim=-1, stable=True)[..., -k:]
        hit = (topk == y.reshape(-1, 1)).any(-1)
        return hit.float().mean()

    return _op(fn, input, label, shape=(), dtype="float32")


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Graph-node AUC via the thresholded Riemann sum the metric
    module implements (ref: static/__init__ auc → metrics.auc)."""
    def fn(x, y):
        from ..metric import Auc
        m = Auc(num_thresholds=num_thresholds)
        m.update(_numpy(x), _numpy(y))
        return torch.tensor(m.accumulate(), dtype=torch.float32,
                            device=x.device)

    v = _op(fn, input, label, shape=(), dtype="float32")
    return v, None, [v]


def ctr_metric_bundle(input, label):
    """ref: static/__init__ ctr_metric_bundle (AUC + MAE/RMSE bundle
    for CTR): returns (auc_var, mae_var, rmse_var)."""
    a, _, _ = auc(input, label)
    mae = _op(lambda x, y: (x - y.to(x.dtype)).abs().mean(),
              input, label, shape=(), dtype="float32")
    rmse = _op(lambda x, y: torch.sqrt(
        ((x - y.to(x.dtype)) ** 2).mean()),
        input, label, shape=(), dtype="float32")
    return a, mae, rmse
