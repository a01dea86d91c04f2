"""Build and load the port's hand-written CUDA kernels.

Each source under ``paddle_tpu_torch/csrc/`` has a plain ``extern "C"``
launcher. At first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``build/paddle_tpu_torch/`` at the repository root
and loaded with ``ctypes``. The library's name carries a hash of the
source and the flags, so an edited source is rebuilt, never stale.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card usually has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch"
_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of each build this process ran (ptxas register and
# shared-memory report, from -Xptxas=-v)
build_logs: Dict[str, str] = {}

# callables (name, flops, nbytes) that ``cost_model`` registers while it
# counts one run: a ctypes launch dispatches no aten op, so each kernel
# wrapper reports its launch's work here (nothing is registered
# otherwise, and a report then costs one empty loop)
cost_sinks: list = []


def report_cost(name: str, flops: float, nbytes: float) -> None:
    for sink in cost_sinks:
        sink(name, flops, nbytes)


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    h = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                        digest_size=8).hexdigest()
    return BUILD_DIR / f"{name}-{h}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, started together. Returns the
    seconds each build took; raises with the compiler's output if one
    fails."""
    names = list(names if names is not None else SOURCES)
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate(timeout=30)
            log += f"\nnvcc timed out after {_BUILD_TIMEOUT_S} s"
        build_logs[n] = log
        seconds[n] = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first
    use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
