"""Build-on-first-use of the port's native host libraries and programs
(the port's counterpart of ``paddle_tpu/core/native_build.py``).

A C++ source under ``paddle_tpu_torch/csrc/`` or ``paddle_tpu_torch/
native/`` is compiled by ``g++`` (``PTDF_CC`` overrides the compiler)
into a shared library or a program under ``build/paddle_tpu_torch/`` at
the repository root, beside the CUDA kernels and, like them, named by a
hash of the source and the flags, so an edited source is rebuilt, never
stale. The compile writes a temporary file renamed into place, under a
file lock beside it, so processes that build at once (test workers)
build once and never read a half-written file. A failed compile raises
with the compiler's output: callers do not fall back quietly.

:func:`torch_flags` gives what a source that includes PyTorch's headers
needs: the torch wheel's own ``include/`` and ``lib/``, the C++ ABI flag
the wheel was built with (``torch._C._GLIBCXX_USE_CXX11_ABI``),
``-std=c++20`` and, where torch was built for CUDA, ``-DPT_WITH_CUDA``
with the CUDA toolkit's headers and torch's CUDA libraries.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch"
CC_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
EXE_FLAGS = ("-O2", "-std=c++17", "-pthread")
_BUILD_TIMEOUT_S = 900


def _cuda_home() -> str:
    for c in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if c and os.path.isdir(os.path.join(c, "include")):
            return c
    nvcc = shutil.which("nvcc")
    if nvcc:
        return os.path.dirname(os.path.dirname(nvcc))
    raise RuntimeError("torch is built for CUDA but no CUDA toolkit was "
                       "found (set CUDA_HOME)")


def torch_flags():
    """``(compile_flags, link_flags)`` of a source built against the
    installed torch."""
    import torch
    root = Path(torch.__file__).resolve().parent
    inc, lib = root / "include", root / "lib"
    cflags = ["-std=c++20",
              f"-D_GLIBCXX_USE_CXX11_ABI="
              f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
              f"-I{inc}", f"-I{inc / 'torch' / 'csrc' / 'api' / 'include'}"]
    libs = ["-lc10", "-ltorch_cpu"]
    if torch.version.cuda:
        cflags += ["-DPT_WITH_CUDA", f"-I{_cuda_home()}/include"]
        libs += ["-lc10_cuda", "-ltorch_cuda"]
    # --no-as-needed: a program that loads this library alone (ptserve)
    # must load torch's CUDA library, whose static initializers register
    # the CUDA kernels, though it calls none of its symbols by name
    lflags = [f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed",
              *libs]
    return cflags, lflags


def _output_path(src, flags, suffix, name=None) -> Path:
    h = hashlib.blake2b(Path(src).read_bytes() + " ".join(flags).encode(),
                        digest_size=8).hexdigest()
    return BUILD_DIR / f"{name or Path(src).stem}-{h}{suffix}"


def library_path(src: str, extra_flags=(), link_flags=()) -> Path:
    """Where the library of ``src`` built with these flags lives."""
    return _output_path(src, (*CC_FLAGS, *extra_flags, *link_flags), ".so")


def executable_path(src: str, extra_flags=(), link_flags=(),
                    name=None) -> Path:
    """Where the program of ``src`` (named ``name``, by default the
    source's stem) built with these flags lives."""
    return _output_path(src, (*EXE_FLAGS, *extra_flags, *link_flags), "",
                        name)


def _compile(out: Path, cmd_head, src, link_flags) -> str:
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # flock excludes every other open of the lock file, this process's
    # threads included, so different outputs still build in parallel
    with open(out.with_suffix(out.suffix + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():        # built meanwhile by the lock's holder
            return str(out)
        tmp = out.with_suffix(f"{out.suffix}.{os.getpid()}."
                              f"{threading.get_ident()}.tmp")
        cmd = [*cmd_head, str(src), "-o", str(tmp), *link_flags]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=_BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cmd[0]} could not build {src}: "
                               f"{e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed ("
                               f"{' '.join(cmd)}):\n{res.stdout}"
                               f"{res.stderr}")
        os.replace(tmp, out)
    return str(out)


def build_native_lib(src: str, extra_flags=(), link_flags=()) -> str:
    """Compile ``src`` into a shared library unless it is built; returns
    the library's path. ``extra_flags`` go before the source,
    ``link_flags`` after it. Raises ``RuntimeError`` with the compiler's
    output on a failed compile."""
    out = library_path(src, extra_flags, link_flags)
    cc = os.environ.get("PTDF_CC", "g++")
    return _compile(out, [cc, *CC_FLAGS, *extra_flags], src, link_flags)


def build_native_exe(src: str, extra_flags=(), link_flags=(),
                     name=None) -> str:
    """Compile and link the program ``src`` unless it is built; returns
    its path (raises as :func:`build_native_lib`)."""
    out = executable_path(src, extra_flags, link_flags, name)
    cc = os.environ.get("PTDF_CC", "g++")
    return _compile(out, [cc, *EXE_FLAGS, *extra_flags], src, link_flags)
