"""Dtype names and the default floating dtype, mapped onto torch dtypes
(the port's counterpart of ``paddle_tpu/core/dtype.py``).

``dtype`` accepts every spec the JAX package's does: a name, a numpy
dtype or scalar type, a Python type (``float`` is float64, ``int``
int64, ``bool`` bool) and a torch dtype. The port honours the dtype a
caller names: ``int64`` stays int64 where the JAX package, with x64 off,
narrows it to int32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import flags

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "f16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "f32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
}


def dtype(name) -> torch.dtype:
    """Resolve a dtype spec (a name, a numpy dtype or type, a Python
    type or a torch dtype) to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if isinstance(name, str):
        if name not in _ALIASES:
            raise TypeError(f"unknown dtype {name!r}")
        return _ALIASES[name]
    try:
        np_name = np.dtype(name).name
    except TypeError:
        raise TypeError(f"unknown dtype {name!r}") from None
    if np_name not in _ALIASES:
        raise TypeError(f"unknown dtype {name!r}")
    return _ALIASES[np_name]


def name_of(d) -> str:
    """The canonical name of a dtype spec (``torch.float32`` ->
    ``"float32"``)."""
    return str(dtype(d)).split(".")[-1]


def get_default_dtype() -> torch.dtype:
    return dtype(flags.get_flag("default_dtype"))


def set_default_dtype(d) -> None:
    flags.set_flags({"default_dtype": name_of(d)})


@contextlib.contextmanager
def default_dtype_guard(d):
    old = flags.get_flag("default_dtype")
    set_default_dtype(d)
    try:
        yield
    finally:
        flags.set_flags({"default_dtype": old})


def is_floating(d) -> bool:
    return dtype(d).is_floating_point


def is_integer(d) -> bool:
    d = dtype(d)
    return not (d.is_floating_point or d.is_complex or d is torch.bool)


def result_dtype(*args):
    """The dtype of an operation on ``args`` (tensors, dtype specs or
    Python scalars) under torch's promotion rules."""
    out = None
    for a in args:
        if isinstance(a, torch.Tensor):
            d = a.dtype
        elif isinstance(a, (bool, int, float, complex)):
            d = torch.tensor(a).dtype
        else:
            d = dtype(a)
        out = d if out is None else torch.promote_types(out, d)
    return out
