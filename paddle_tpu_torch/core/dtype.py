"""Dtype names and the default floating dtype, mapped onto torch dtypes
(the port's counterpart of ``paddle_tpu/core/dtype.py``)."""

from __future__ import annotations

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

_ALIASES = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16, "f16": float16,
    "bfloat16": bfloat16, "bf16": bfloat16, "float32": float32,
    "fp32": float32, "f32": float32, "float64": float64,
}


def dtype(name) -> torch.dtype:
    """Resolve a dtype spec (a name or a torch dtype) to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    if isinstance(name, str) and name in _ALIASES:
        return _ALIASES[name]
    raise TypeError(f"unknown dtype {name!r}")


def get_default_dtype() -> torch.dtype:
    return dtype(flags.get_flag("default_dtype"))

