"""paddle_tpu_torch.static — static-graph facade (the port's
counterpart of ``paddle_tpu/static/__init__.py``).

Reference: python/paddle/static/ — Program/Executor world with
``save/load_inference_model`` (static/io.py:435/685), static ``nn``
layers, ``InputSpec``. As in the JAX package the reference's dual
dygraph/static worlds collapse into one definition, and this module is
a thin compatibility facade:

- ``InputSpec`` — shared with paddle_tpu_torch.jit;
- ``save_inference_model`` / ``load_inference_model`` — the deployment
  artifact is jit.save's exported program (``program.pt2``) + params;
- ``Executor`` — runs a static ``Program`` (the closure DAG) or a
  loaded inference program.

There is deliberately no ProgramDesc/BlockDesc IR: the exported
torch.export graph is the IR."""

from __future__ import annotations

from typing import Sequence

from .. import jit as _jit
from ..jit import InputSpec  # noqa: F401
from . import program as _program
from .program import (  # noqa: F401
    BuildStrategy, CompiledProgram, ExecutionStrategy,
    ExponentialMovingAverage, ParallelExecutor, Print, Program, Scope,
    Variable, WeightNormParamAttr, accuracy, append_backward, auc,
    cpu_places, create_global_var, create_parameter, ctr_metric_bundle,
    cuda_places, data, default_main_program, default_startup_program,
    deserialize_persistables, deserialize_program, device_guard,
    exponential_decay, global_scope, gradients, load, load_from_file,
    load_program_state, mlu_places, name_scope, normalize_program,
    npu_places, program_guard, py_func, save, save_to_file,
    scope_guard, serialize_persistables, serialize_program,
    set_program_state, xpu_places)
from . import nn  # noqa: F401


def save_inference_model(path_prefix: str, feed_vars, fetch_vars=None,
                         executor=None, layer=None,
                         input_spec: Sequence = None, **_ignored):
    """ref: static/io.py:435. Here: pass the Layer (or let
    ``feed_vars`` be the Layer for convenience) + input_spec."""
    target = layer if layer is not None else feed_vars
    spec = input_spec or fetch_vars
    if not hasattr(target, "forward") and not callable(target):
        raise ValueError(
            "save_inference_model needs the model Layer: "
            "save_inference_model(path, layer, input_spec=[...])")
    _jit.save(target, path_prefix, input_spec=spec)


def load_inference_model(path_prefix: str, executor=None, device=None,
                         **_ignored):
    """ref: static/io.py:685 → returns the loaded callable program, on
    ``device`` (the card by default)."""
    return _jit.load(path_prefix, device=device)


class Executor:
    """ref: fluid/executor.py:621 Executor.run. Dispatches on the
    program kind: a static ``Program`` (closure-DAG evaluation, the
    training direction) or a TranslatedLayer from
    load_inference_model (the serving direction)."""

    def __init__(self, place=None):
        self.place = place
        self._static = _program.StaticExecutor(place)

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        if program is None or isinstance(program, _program.Program) or \
                isinstance(program, _program.CompiledProgram):
            if isinstance(program, _program.CompiledProgram):
                program = program.program
            return self._static.run(program, feed=feed,
                                    fetch_list=fetch_list or (),
                                    return_numpy=return_numpy)
        if feed is None:
            raise ValueError("feed required")
        inputs = list(feed.values()) if isinstance(feed, dict) else \
            list(feed)
        out = program(*inputs)
        return out if isinstance(out, (list, tuple)) else [out]


# ref: paddle.static.sparsity re-exports the ASP API (static/sparsity)
from ..incubate import asp as sparsity  # noqa: E402
