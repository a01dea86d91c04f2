"""The rest of the top-level ``paddle.*`` surface (the port's
counterpart of ``paddle_tpu/compat_fill.py``): ``Tensor``, ``ParamAttr``,
``create_parameter``, ``batch``, ``check_shape``, the static / dynamic
switches, the grad-enabled switch (torch's own) and the key stream's
state under the CUDA generator's name.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from .core import rng as _rng
from .device import (CPUPlace, CUDAPinnedPlace, CUDAPlace,  # noqa: F401
                     NPUPlace)

# the tensor type itself (ref: paddle.Tensor)
Tensor = torch.Tensor

# dtype alias (ref: paddle.bool)
from .core.dtype import bool_ as bool  # noqa: E402,F401


class ParamAttr:
    """Parameter config carrier (ref: fluid/param_attr.py ParamAttr —
    name/initializer/lr/regularizer/trainable)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """Eager free-standing parameter (ref: paddle.create_parameter): drawn
    by the initializer on the CPU (``core/rng.py``'s generator), placed
    on the flat API's device, trainable unless ``attr`` says not."""
    from .core import dtype as dtype_mod
    from .core.device import current_device
    from .nn import initializer as I
    from .nn.layer import Parameter
    init = default_initializer
    if init is None and isinstance(attr, ParamAttr):
        init = attr.initializer
    if init is None:
        if is_bias:
            init = I.get_global_bias_initializer() or I.Constant(0.0)
        else:
            init = I.get_global_initializer() or I.XavierUniform()
    value = init(list(shape), dtype_mod.dtype(dtype)).to(current_device())
    trainable = attr.trainable if isinstance(attr, ParamAttr) else True
    return Parameter(value, trainable=trainable)


def batch(reader, batch_size, drop_last=False):
    """Reader-decorator batching (ref: python/paddle/batch.py)."""

    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def check_shape(shape, op_name="", expected_shape_type=(list, tuple),
                expected_element_type=(int,),
                expected_tensor_dtype=("int32", "int64")):
    """Shape-argument validator (ref: tensor/random.py check_shape via
    fluid/data_feeder.py:153). Tensors are accepted as dynamic shapes
    when integer-typed."""
    if isinstance(shape, (torch.Tensor, np.ndarray)):
        name = str(shape.dtype).split(".")[-1]
        if name not in expected_tensor_dtype:
            raise TypeError(
                f"{op_name}: Tensor shape must be "
                f"{expected_tensor_dtype}, got {name}")
        return
    if not isinstance(shape, expected_shape_type):
        raise TypeError(f"{op_name}: shape must be "
                        f"{expected_shape_type}, got {type(shape)}")
    for item in shape:
        if not isinstance(item, expected_element_type) \
                and not isinstance(item, (torch.Tensor, np.integer)):
            raise TypeError(
                f"{op_name}: shape element must be int, got "
                f"{type(item)}")


def disable_signal_handler():
    """ref: paddle.disable_signal_handler (the C++ layer's crash
    dumpers). The crash handlers here belong to the Python runtime;
    nothing to uninstall — kept for script compatibility."""


# -- static/dynamic mode toggles (ref: paddle.enable_static). One world
# here; the flag is tracked so in_dynamic_mode() answers faithfully for
# scripts that branch on it.

_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


def in_dynamic_mode() -> builtins.bool:
    return not _static_mode


class set_grad_enabled:
    """``paddle.set_grad_enabled``: applies at construction (usable as a
    statement) and restores the previous mode on context exit; the mode
    is torch's own."""

    def __init__(self, mode: builtins.bool):
        self._old = torch.is_grad_enabled()
        torch.set_grad_enabled(builtins.bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._old)
        return False


def is_grad_enabled() -> builtins.bool:
    return torch.is_grad_enabled()


def _key_data(key: torch.Tensor) -> np.ndarray:
    return np.asarray(key.tolist(), dtype=np.uint32)


def get_cuda_rng_state():
    """ref: paddle.get_cuda_rng_state — the state of the key stream
    (``core/rng.py``) in the JAX package's layout: ``{"key": uint32[2],
    "streams": {name: uint32[2]}}``, so a state taken in either package
    restores in the other."""
    stream = _rng.current_stream()
    return {"key": _key_data(stream._key),
            "streams": {k: _key_data(v) for k, v in stream._streams.items()}}


def set_cuda_rng_state(state):
    stream = _rng.current_stream()
    stream._key = torch.as_tensor(
        np.asarray(state["key"]).astype(np.int64))
    stream._streams = {
        k: torch.as_tensor(np.asarray(v).astype(np.int64))
        for k, v in state.get("streams", {}).items()}
