"""paddle_tpu_torch.inference — native serving of saved programs, and the
LLM engine (the port's counterpart of ``paddle_tpu/inference``).

Rebuild of the reference's inference API
(reference: python/paddle/inference — ``Config`` / ``create_predictor``
over the C++ AnalysisPredictor,
paddle/fluid/inference/api/analysis_predictor.h:95; C API
paddle/fluid/inference/capi_exp/). The executor is
``paddle_tpu_torch/native/predictor.cc``: a C++ runner over libtorch
that loads a ``paddle_tpu_torch.jit.save`` artifact (``program.pt2``,
``params.pbin``, ``meta.json``), keeps the state resident on the device
and interprets the exported graph with no Python in the loop; its
attention is the op ``paddle_tpu_torch::flash_attention_fwd``, kernel
B1 on the card. This module is the ctypes facade; the same library
links into any C++ server (``ptserve``, ``native/predictor_main.cc``).

The runner library, the op library it calls and ``ptserve`` are built
by ``g++`` against the installed torch on first use
(``core.native_build``), under ``build/paddle_tpu_torch/``. A predictor
runs on the card unless its ``Config`` names another device; with no
card, creating one raises. Nothing falls back to Python's ``jit.load``.
"""

from __future__ import annotations

import ctypes
import json
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..core import native_build

_NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
_SRC = _NATIVE_DIR / "predictor.cc"
_MAIN_SRC = _NATIVE_DIR / "predictor_main.cc"

# codes shared with jit/__init__.py and predictor.cc
_DTYPE_BY_CODE = ["float32", "float64", "int32", "int64", "bfloat16",
                  "float16", "uint8", "int8", "bool", "uint32", "uint64",
                  "int16", "uint16"]
_CODE_BY_DTYPE = {d: i for i, d in enumerate(_DTYPE_BY_CODE)}


def _runner_flags():
    from ..ops import flash_attention as fa
    cflags, lflags = native_build.torch_flags()
    cflags.append(f'-DPT_TORCH_OPS_LIB="{fa.ops_library_path()}"')
    return cflags, lflags


def build_runner() -> str:
    """Build (once) and return the runner library's path."""
    return native_build.build_native_lib(str(_SRC), *_runner_flags())


def build_ptserve() -> str:
    """Build (once) and return the path of ``ptserve``, linked against
    the runner library."""
    lib = Path(build_runner())
    return native_build.build_native_exe(
        str(_MAIN_SRC), (), (f"-L{lib.parent}", f"-l:{lib.name}",
                             f"-Wl,-rpath,{lib.parent}"), name="ptserve")


_libs = {}


def _load_lib(path: str):
    lib = _libs.get(path)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(path)
    vp, i32, u32, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                         ctypes.c_int64)
    run_args = [vp, ctypes.POINTER(vp), ctypes.POINTER(u32),
                ctypes.POINTER(u32), ctypes.POINTER(i64), i32,
                ctypes.c_char_p, ctypes.c_size_t]
    sigs = {
        "ptpred_create": (vp, [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_size_t]),
        "ptpred_run": (i32, run_args),
        "ptpred_run2": (vp, run_args),
        "ptpred_num_outputs": (i32, [vp]),
        "ptpred_out_ndim": (i32, [vp, i32]),
        "ptpred_out_dim": (i64, [vp, i32, i32]),
        "ptpred_out_dtype": (u32, [vp, i32]),
        "ptpred_out_data": (vp, [vp, i32]),
        "ptpred_out_nbytes": (i64, [vp, i32]),
        "ptpred_destroy": (None, [vp]),
        "ptpred_b1_launches": (i64, []),
        "ptres_num_outputs": (i32, [vp]),
        "ptres_ndim": (i32, [vp, i32]),
        "ptres_dim": (i64, [vp, i32, i32]),
        "ptres_dtype": (u32, [vp, i32]),
        "ptres_data": (vp, [vp, i32]),
        "ptres_nbytes": (i64, [vp, i32]),
        "ptres_destroy": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _libs[path] = lib
    return lib


def default_plugin() -> str:
    """The runner library: ``PT_PREDICTOR_LIB`` if set, else the one
    built from ``native/predictor.cc`` (built on first use)."""
    return os.environ.get("PT_PREDICTOR_LIB") or build_runner()


def default_plugin_options() -> str:
    """The runner's create options, ``'key=t:value;...'``
    (``PT_PREDICTOR_OPTIONS``; the one key is ``num_threads=i:N``, the
    CPU's intra-op threads); empty by default."""
    return os.environ.get("PT_PREDICTOR_OPTIONS", "")


class Config:
    """ref: paddle.inference.Config — model location + runtime knobs.
    ``device``: where the program runs, ``"cuda"`` (the card, the
    default), ``"cuda:N"`` or ``"cpu"``."""

    def __init__(self, model_dir: Optional[str] = None,
                 device: Optional[str] = None):
        self.model_dir = model_dir
        self.device = device or "cuda"
        self.plugin_path: Optional[str] = None
        self.plugin_options: Optional[str] = None

    def set_model(self, model_dir: str):
        self.model_dir = model_dir

    def set_pjrt_plugin(self, path: str, options: str = ""):
        """The runner library and its options (the JAX package's PJRT
        plugin slot)."""
        self.plugin_path = path
        self.plugin_options = options


class _Handle:
    """Input/output tensor handle (ref: predictor.get_input_handle /
    copy_from_cpu / copy_to_cpu)."""

    def __init__(self):
        self._arr: Optional[np.ndarray] = None

    def copy_from_cpu(self, arr):
        self._arr = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return self._arr

    def reshape(self, shape):
        if self._arr is not None:
            self._arr = self._arr.reshape(shape)


class _Result:
    """Owns one request's native result (``ptpred_run2``) for as long as
    an array views its memory."""

    def __init__(self, lib, res):
        self._lib, self._res = lib, res

    def __del__(self):
        self._lib.ptres_destroy(self._res)

    def array(self, i) -> np.ndarray:
        """Output ``i``: a view of the result's host memory (no copy), or
        for bfloat16, a float32 widening of it (exact: numpy has no
        bfloat16, and jit.save writes bfloat16 state as float32)."""
        lib, res = self._lib, self._res
        shape = tuple(lib.ptres_dim(res, i, d)
                      for d in range(lib.ptres_ndim(res, i)))
        dtype = _DTYPE_BY_CODE[lib.ptres_dtype(res, i)]
        nbytes = lib.ptres_nbytes(res, i)
        if nbytes == 0:  # empty output: data() may be NULL
            return np.empty(shape, np.float32 if dtype == "bfloat16"
                            else dtype)
        raw = (ctypes.c_uint8 * nbytes).from_address(lib.ptres_data(res, i))
        raw.owner = self   # the view keeps the result alive
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            return bits.view(np.float32).reshape(shape)
        return np.frombuffer(raw, dtype).reshape(shape)


class Predictor:
    """ref: paddle.inference.Predictor over AnalysisPredictor."""

    def __init__(self, config: Config):
        if not config.model_dir:
            raise ValueError("Config.model_dir not set")
        # the program's attention op and its launcher (built on first
        # use) come from the op module, as in a jit.load
        from ..ops import flash_attention  # noqa: F401
        lib = _load_lib(config.plugin_path or default_plugin())
        options = config.plugin_options \
            if config.plugin_options is not None else \
            default_plugin_options()
        err = ctypes.create_string_buffer(4096)
        self._h = lib.ptpred_create(str(config.device).encode(),
                                    options.encode(),
                                    os.fspath(config.model_dir).encode(),
                                    err, len(err))
        if not self._h:
            raise RuntimeError(
                f"predictor create failed: {err.value.decode()}")
        self._lib = lib
        self.device = str(config.device)
        with open(os.path.join(config.model_dir, "meta.json")) as f:
            self._meta = json.load(f)
        n_in = len(self._meta.get("input_spec", []))
        self._in_names = [f"input_{i}" for i in range(n_in)]
        n_out = len(self._meta.get("outputs", [])) or \
            lib.ptpred_num_outputs(self._h)
        self._out_names = [f"output_{i}" for i in range(n_out)]
        self._inputs = {n: _Handle() for n in self._in_names}
        self._outputs = {n: _Handle() for n in self._out_names}

    # -- array-style API ----------------------------------------------------
    def run(self, inputs: Optional[Sequence[np.ndarray]] = None
            ) -> List[np.ndarray]:
        """Execute one request. Thread-safe when ``inputs`` is passed
        explicitly: each call owns its result handle (``ptpred_run2``)
        and ctypes releases the GIL for the native call, so N server
        threads share one predictor (the reference requires a predictor
        clone per thread — analysis_predictor.h:95). The handle-style API
        (get_input_handle / get_output_handle) stores per-predictor state
        and stays single-threaded."""
        lib = self._lib
        explicit_inputs = inputs
        if inputs is None:
            inputs = [self._inputs[n].copy_to_cpu()
                      for n in self._in_names]
        arrs = [np.ascontiguousarray(a) for a in inputs]
        # the program's dtypes (int32 ids become its int64) and shapes,
        # checked here so that a wrong request fails before any upload
        exp = self._meta.get("exported_inputs")
        if exp:
            if len(arrs) != len(exp):
                raise ValueError(
                    f"expected {len(exp)} inputs, got {len(arrs)}")
            for i, (a, e) in enumerate(zip(arrs, exp)):
                es = e["shape"]  # symbolic dims serialize as strings
                if len(a.shape) != len(es) or any(
                        isinstance(d, int) and d != ad
                        for d, ad in zip(es, a.shape)):
                    raise ValueError(
                        f"input {i}: expected shape {es}, "
                        f"got {list(a.shape)}")
            arrs = [a if str(a.dtype) == e["dtype"]
                    else np.ascontiguousarray(a.astype(e["dtype"]))
                    for a, e in zip(arrs, exp)]
        n = len(arrs)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs])
        dtypes = (ctypes.c_uint32 * n)(
            *[_CODE_BY_DTYPE[str(a.dtype)] for a in arrs])
        ndims = (ctypes.c_uint32 * n)(*[a.ndim for a in arrs])
        dims_flat: List[int] = []
        for a in arrs:
            dims_flat.extend(a.shape)
        dims = (ctypes.c_int64 * len(dims_flat))(*dims_flat)
        err = ctypes.create_string_buffer(4096)
        res = lib.ptpred_run2(self._h, ptrs, dtypes, ndims, dims, n,
                              err, len(err))
        if not res:
            raise RuntimeError(f"predictor run failed: "
                               f"{err.value.decode()}")
        result = _Result(lib, res)
        outs = [result.array(i) for i in range(lib.ptres_num_outputs(res))]
        if explicit_inputs is None:
            # handle-style callers read these back; explicit-input
            # (thread-safe) calls skip the shared store entirely
            for n_, a in zip(self._out_names, outs):
                self._outputs[n_].copy_from_cpu(a)
        return outs

    # -- handle-style API (reference parity) --------------------------------
    def get_input_names(self):
        return list(self._in_names)

    def get_output_names(self):
        return list(self._out_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ptpred_destroy(h)
            self._h = None


def create_predictor(config: Config) -> Predictor:
    """ref: paddle.inference.create_predictor."""
    return Predictor(config)


class DynamicBatcher:
    """Micro-batching front-end over a predictor.

    The reference scales serving by running one AnalysisPredictor clone
    per server thread (reference:
    paddle/fluid/inference/api/analysis_predictor.h:95 + capi_exp
    thread pools) — each clone holds its own scopes. Here one predictor
    serves many request threads, and a coalescer packs up to B queued
    rows into a single device call, so that the card runs wide products
    instead of many narrow ones.

    ``submit(inputs)`` (each input's leading dim = this request's row
    count) returns a Future. A worker thread drains the queue: after
    the first request arrives it waits at most ``max_delay_ms`` for
    more, packs rows up to ``max_batch``, pads the tail by repeating
    the final row (one device call shape a batch size), runs once, and
    slices each request's rows back out of the outputs. Requests that
    would overflow the pack are held for the next cycle, preserving
    order.
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 max_delay_ms: float = 2.0):
        if max_batch is None:
            exp = getattr(predictor, "_meta", {}).get("exported_inputs")
            if exp and isinstance(exp[0]["shape"][0], int):
                max_batch = exp[0]["shape"][0]
            else:
                raise ValueError(
                    "max_batch not given and the artifact's leading "
                    "input dim is not a static int")
        self._pred = predictor
        self.max_batch = int(max_batch)
        self.max_delay = max_delay_ms / 1000.0
        import queue
        import threading
        self._q: "queue.Queue" = queue.Queue()
        self._held = None  # overflow request deferred to the next pack
        self._closed = False
        # makes the closed-check + put atomic against close(): no
        # submit can enqueue after the STOP sentinel, so _drain is
        # guaranteed to see every accepted request
        self._mu = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        # served/coalesced stats for tests and monitoring
        self.n_requests = 0
        self.n_device_calls = 0

    def submit(self, inputs: Sequence[np.ndarray]):
        from concurrent.futures import Future
        arrs = [np.ascontiguousarray(a) for a in inputs]
        rows = arrs[0].shape[0]
        if rows > self.max_batch:
            raise ValueError(
                f"request rows {rows} > max_batch {self.max_batch}")
        if any(a.shape[0] != rows for a in arrs):
            raise ValueError("all inputs must share the leading dim")
        fut: Future = Future()
        with self._mu:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._q.put((arrs, rows, fut))
        return fut

    def run(self, inputs: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Blocking convenience wrapper around submit()."""
        return self.submit(inputs).result()

    # -- worker -------------------------------------------------------------
    def _take(self, timeout):
        if self._held is not None:
            item, self._held = self._held, None
            return item
        import queue
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _loop(self):
        import time
        while True:
            first = self._take(timeout=0.1)
            if first is None:
                if self._closed:
                    return self._drain()
                continue
            if first == "STOP":
                return self._drain()
            pack = [first]
            used = first[1]
            deadline = time.monotonic() + self.max_delay
            while used < self.max_batch:
                rest = deadline - time.monotonic()
                nxt = self._take(timeout=max(rest, 0.0))
                if nxt is None:
                    break
                if nxt == "STOP":
                    self._flush(pack, used)
                    return self._drain()
                if used + nxt[1] > self.max_batch:
                    self._held = nxt  # keep order; goes in the next pack
                    break
                pack.append(nxt)
                used += nxt[1]
            self._flush(pack, used)

    def _drain(self):
        """Serve everything accepted before close() — a graceful close
        must not drop work whose submit() already succeeded (submit's
        closed-check is atomic with the STOP put, so all queued items
        were accepted). Packs and flushes exactly like the live loop;
        a predictor error still fails only its own pack's futures, and
        no future is ever left forever-pending."""
        import queue
        leftovers = [self._held] if self._held is not None else []
        self._held = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        pack, used = [], 0
        for item in leftovers:
            if item == "STOP":
                continue
            if used + item[1] > self.max_batch and pack:
                self._flush(pack, used)
                pack, used = [], 0
            pack.append(item)
            used += item[1]
        if pack:
            self._flush(pack, used)

    def _flush(self, pack, used):
        try:
            # batch-build inside the guard: a shape-mismatched request
            # must fail its pack's futures, not kill the worker thread
            n_in = len(pack[0][0])
            batched = []
            for j in range(n_in):
                parts = [req[0][j] for req in pack]
                cat = np.concatenate(parts, axis=0)
                if used < self.max_batch:  # pad: repeat the last row
                    padrow = cat[-1:]
                    cat = np.concatenate(
                        [cat] + [padrow] * (self.max_batch - used),
                        axis=0)
                batched.append(cat)
            outs = self._pred.run(batched)
        except BaseException as e:
            for _, _, fut in pack:
                fut.set_exception(e)
            return
        self.n_requests += len(pack)
        self.n_device_calls += 1
        ofs = 0
        for arrs, rows, fut in pack:
            # copy: a view would pin the whole max_batch output alive
            # for as long as the caller holds its rows
            fut.set_result([o[ofs:ofs + rows].copy() for o in outs])
            ofs += rows

    def close(self):
        with self._mu:
            self._closed = True
            self._q.put("STOP")
        self._worker.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_LLM_NAMES = ("LLMEngine", "serve_llm", "AdmissionShed", "AdmissionTimeout",
              "RequestCancelled", "DecodeCarry", "EngineClosed",
              "OverloadShed")


def __getattr__(name):
    # lazy: the LLM engine pulls in model/ops modules that serving a
    # saved program never needs
    if name in _LLM_NAMES:
        from . import llm
        return getattr(llm, name)
    if name == "PrefixCache":
        from .prefix_cache import PrefixCache
        return PrefixCache
    raise AttributeError(name)
