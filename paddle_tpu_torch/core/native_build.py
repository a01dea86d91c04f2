"""Build-on-first-use of the port's native host libraries (the port's
counterpart of ``paddle_tpu/core/native_build.py``).

A C++ source under ``paddle_tpu_torch/csrc/`` is compiled by ``g++``
(``PTDF_CC`` overrides the compiler) into a shared library under
``build/paddle_tpu_torch/`` at the repository root, beside the CUDA
kernels and, like them, named by a hash of the source and the flags, so
an edited source is rebuilt, never stale. The compile writes a
temporary file renamed into place, so processes that build at once do
not read a half-written library. A failed compile raises with the
compiler's output: callers do not fall back quietly.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch"
CC_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_BUILD_LOCK = threading.Lock()


def library_path(src: str, extra_flags=()) -> Path:
    """Where the library of ``src`` built with ``extra_flags`` lives."""
    h = hashlib.blake2b(Path(src).read_bytes() + " ".join(
        (*CC_FLAGS, *extra_flags)).encode(), digest_size=8).hexdigest()
    return BUILD_DIR / f"{Path(src).stem}-{h}.so"


def build_native_lib(src: str, extra_flags=()) -> str:
    """Compile ``src`` unless its library is built; returns the
    library's path. Raises ``RuntimeError`` with the compiler's output
    on a failed compile."""
    so = library_path(src, extra_flags)
    with _BUILD_LOCK:
        if so.exists():
            return str(so)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cc = os.environ.get("PTDF_CC", "g++")
        cmd = [cc, *CC_FLAGS, *extra_flags, str(src), "-o", str(tmp)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"{cc} could not run: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):"
                               f"\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    return str(so)
