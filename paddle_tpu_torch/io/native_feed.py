"""Python surface of the native data-feed engine (the port's counterpart
of ``paddle_tpu/io/native_feed.py``).

Binds paddle_tpu_torch/native/datafeed.cc (the C++ analog of the
reference's DataFeed, paddle/fluid/framework/data_feed.h:779) via ctypes;
the C ABI keeps the boundary trivially stable. The library is built on
first use by ``g++`` (``core.native_build``, under
``build/paddle_tpu_torch/``; ``PTDF_CC`` overrides the compiler), and a
failed build raises.

``FileDataFeed`` iterates numpy batch tuples parsed/assembled entirely
in native threads (GIL-free), the host loop only wraps buffers — the
same split as the reference's DataFeed-thread → DeviceWorker hand-off.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.native_build import build_native_lib

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "datafeed.cc")
_BUILD_LOCK = threading.Lock()
_LIB = None


def _lib():
    global _LIB
    with _BUILD_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build_native_lib(_SRC))
        lib.ptdf_create.restype = ctypes.c_void_p
        lib.ptdf_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.ptdf_add_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ptdf_start.argtypes = [ctypes.c_void_p]
        lib.ptdf_next.restype = ctypes.c_int
        lib.ptdf_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_void_p)]
        lib.ptdf_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


class FileDataFeed:
    """Threaded native feed over text files.

    schema: e.g. ``"f32:784,i64:1"`` — column groups per line.
    Yields tuples of numpy arrays, one [rows, width] array per group
    (width-1 int groups are yielded as [rows] for label convenience).
    """

    def __init__(self, files: Sequence[str], schema: str,
                 batch_size: int = 128, sep: str = ",",
                 num_threads: int = 2, queue_capacity: int = 8,
                 shuffle_window: int = 0, seed: int = 0,
                 squeeze_labels: bool = True):
        self.files = list(files)
        self.schema = schema
        self.batch_size = batch_size
        self.sep = sep
        self.num_threads = num_threads
        self.queue_capacity = queue_capacity
        self.shuffle_window = shuffle_window
        self.seed = seed
        self.squeeze_labels = squeeze_labels
        self._groups: List[Tuple[str, int]] = []
        for item in schema.split(","):
            ty, w = item.split(":")
            if ty not in ("f32", "i64"):
                raise ValueError(
                    f"schema type {ty!r} not supported (f32/i64 only); "
                    "the native engine would silently parse it as f32")
            self._groups.append((ty, int(w)))

    def __iter__(self):
        lib = _lib()
        h = lib.ptdf_create(self.schema.encode(), self.sep.encode(),
                            self.batch_size, self.num_threads,
                            self.queue_capacity, self.shuffle_window,
                            self.seed)
        try:
            for f in self.files:
                lib.ptdf_add_file(h, os.fspath(f).encode())
            lib.ptdf_start(h)
            n_groups = len(self._groups)
            while True:
                bufs = []
                ptrs = (ctypes.c_void_p * n_groups)()
                for i, (ty, w) in enumerate(self._groups):
                    dt = np.float32 if ty == "f32" else np.int64
                    a = np.empty((self.batch_size, w), dtype=dt)
                    bufs.append(a)
                    ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
                rows = lib.ptdf_next(h, ptrs)
                if rows == 0:
                    break
                out = []
                for a, (ty, w) in zip(bufs, self._groups):
                    a = a[:rows]
                    if self.squeeze_labels and ty == "i64" and w == 1:
                        a = a.reshape(rows)
                    out.append(a)
                yield tuple(out)
        finally:
            lib.ptdf_destroy(h)
