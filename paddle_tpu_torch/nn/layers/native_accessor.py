"""The native sparse accessor (the port's counterpart of
``paddle_tpu/nn/layers/native_accessor.py``): the per-row push rules of
the host embedding tables, adagrad and sgd, fused into one threaded pass
over each row in C++ (``paddle_tpu_torch/csrc/sparse_accessor.cc``, the
port's own copy), bound with ``ctypes``.

Built by ``g++`` at first use (``core.native_build``). Where the JAX
package degrades quietly to numpy on a failed build, the port raises:
a test or a run sees the failure. ``PT_NATIVE_ACCESSOR=0`` selects the
numpy twin explicitly (``HostOffloadedEmbedding._apply_push``).
``counts`` records which rule each push ran.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ...core.native_build import build_native_lib

SOURCE = str(Path(__file__).resolve().parents[2] / "csrc" /
             "sparse_accessor.cc")
_LOAD_LOCK = threading.Lock()
_LIB = None

# pushes applied by each rule, for a run to prove which one ran
counts = {"native": 0, "numpy": 0}


def enabled() -> bool:
    """Whether the native rule is selected (``PT_NATIVE_ACCESSOR`` is not
    ``0``)."""
    return os.environ.get("PT_NATIVE_ACCESSOR") != "0"


def _lib():
    global _LIB
    if _LIB is not None:  # lock-free fast path (GIL-safe global read)
        return _LIB
    with _LOAD_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_native_lib(SOURCE))
            f32p = ctypes.POINTER(ctypes.c_float)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.ptsa_adagrad_push.argtypes = [
                f32p, f32p, u8p, i64p, f32p,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float, ctypes.c_float]
            lib.ptsa_adagrad_push.restype = None
            lib.ptsa_sgd_push.argtypes = [
                f32p, i64p, f32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_float]
            lib.ptsa_sgd_push.restype = None
            _LIB = lib
    return _LIB


def available() -> bool:
    """Build and load the library if the native rule is selected (call
    outside hot locks: the first call may run the compile); False where
    ``PT_NATIVE_ACCESSOR=0`` selects the twin. A failed build raises."""
    if not enabled():
        return False
    _lib()
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _check(vals, slots, grads):
    if vals.dtype != np.float32 or not vals.flags.c_contiguous:
        raise ValueError("the value pool must be C-contiguous float32")
    if grads.shape != (len(slots), vals.shape[1]):
        raise ValueError(f"gradient block {grads.shape} does not match "
                         f"{len(slots)} rows of {vals.shape[1]}")
    if len(slots) and int(slots.max()) >= len(vals):
        raise IndexError("a slot lies past the value pool")


def adagrad_push(vals: np.ndarray, acc: np.ndarray, acc_set: np.ndarray,
                 slots: np.ndarray, grads: np.ndarray, lr: float,
                 init_acc: float) -> None:
    """In place: ``acc = (acc_set ? acc : init_acc) + g^2``, ``vals -= lr
    g / sqrt(acc)`` on each row of ``slots`` (a slot < 0 is skipped)."""
    slots = np.ascontiguousarray(slots, np.int64)
    grads = np.ascontiguousarray(grads, np.float32)
    _check(vals, slots, grads)
    if acc.shape != vals.shape or acc.dtype != np.float32 or \
            acc_set.dtype != np.bool_ or not acc.flags.c_contiguous:
        raise ValueError("accumulators must match the value pool")
    _lib().ptsa_adagrad_push(
        _ptr(vals, ctypes.c_float), _ptr(acc, ctypes.c_float),
        _ptr(acc_set.view(np.uint8), ctypes.c_uint8),
        _ptr(slots, ctypes.c_int64), _ptr(grads, ctypes.c_float),
        len(slots), vals.shape[1], float(lr), float(init_acc))


def sgd_push(vals: np.ndarray, slots: np.ndarray, grads: np.ndarray,
             lr: float) -> None:
    """In place: ``vals -= lr g`` on each row of ``slots``."""
    slots = np.ascontiguousarray(slots, np.int64)
    grads = np.ascontiguousarray(grads, np.float32)
    _check(vals, slots, grads)
    _lib().ptsa_sgd_push(
        _ptr(vals, ctypes.c_float), _ptr(slots, ctypes.c_int64),
        _ptr(grads, ctypes.c_float), len(slots), vals.shape[1], float(lr))
