"""paddle_tpu_torch.jit — program capture, saved programs, deployment
(the port's counterpart of ``paddle_tpu/jit/__init__.py``).

Reference being replaced:
- ``@paddle.jit.to_static`` — the AST rewriter turning dygraph Python
  into ProgramDesc (dygraph_to_static/program_translator.py:239
  StaticFunction, :991 ProgramTranslator);
- ``paddle.jit.save/load`` — serialized inference programs + params
  (fluid/dygraph/jit.py; static/io.py:435 save_inference_model), loaded
  back as TranslatedLayer.

Design: ``to_static`` wraps a Layer (or function) and runs it eagerly —
the port's kernels launch from eager code, and nothing here falls back
to hide an error. ``save`` captures the eval forward with
``torch.export`` as a function of ``(params, buffers, *inputs)`` — the
state explicit, as the JAX package exports it — and writes, into the
directory ``path``:

- ``program.pt2`` — the ``ExportedProgram`` (``torch.export.save``).
  The flash attention of a traced forward is the registered op
  ``torch.ops.paddle_tpu_torch.flash_attention_fwd`` (kernel B1 on the
  card, its twin on the CPU), never the twin's math;
- ``params.pkl`` — ``{"params": {name: ndarray}, "buffers": {...}}``,
  the JAX package's layout (bfloat16 written as float32, as
  ``framework.save`` does: numpy has no bfloat16);
- ``params.pbin`` — the same state in the JAX package's binary layout
  (``_write_pbin``: params then buffers, each sorted by name), not
  written for an encrypted artifact;
- ``meta.json`` — the JAX package's keys (``input_spec``,
  ``exported_inputs``, ``outputs``, ``n_state_args``, ``platforms``,
  ``format_version``).

The JAX package also writes ``program.mlir.bc`` and
``compile_options.pb`` for its native PJRT predictor; they have no torch
counterpart. The port's native runner (``native/predictor.cc``, behind
``inference.create_predictor`` and ``ptserve``) serves ``program.pt2``
with ``params.pbin`` and ``meta.json`` from C++ over libtorch, its
attention the same op. ``InputSpec`` ``None``
dims become ``torch.export.Dim.DYNAMIC`` dims (traced at distinct
example sizes, so no two are assumed equal); torch.export leaves sizes 0
and 1 out of a dynamic dim's range.
"""

from __future__ import annotations

import io as _io
import json
import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import dtype as _dtype
from ..nn.layer import Layer, functional_call, split_state
from ..ops import flash_attention as _flash  # noqa: F401  (registers B1's op)


class InputSpec:
    """Shape/dtype spec for traced inputs (ref: paddle.static.InputSpec)."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(shape)
        self.dtype = _dtype.dtype(dtype)
        self.name = name

    def to_aval(self, first: int = 0):
        """A meta tensor of the traced example shape: the k-th ``None``
        dim takes example size ``first + k`` of ``_EXAMPLE_SIZES``."""
        sizes = iter(_EXAMPLE_SIZES[(first + k) % len(_EXAMPLE_SIZES)]
                     for k in range(len(self.shape)))
        return torch.empty(tuple(next(sizes) if d is None else int(d)
                                 for d in self.shape),
                           dtype=self.dtype, device="meta")

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype})"


# example sizes of dynamic dims: distinct, and none 0 or 1, so the tracer
# neither specializes a dim nor assumes two dims equal
_EXAMPLE_SIZES = (3, 5, 7, 11, 13, 17, 19, 23)


class StaticFunction:
    """Wrapper around a Layer/function (ref analog:
    program_translator.py:239). Calls run eagerly, honoring the layer's
    live train/eval mode (training mode writes BatchNorm statistics back,
    as eager code does)."""

    def __init__(self, fn_or_layer, input_spec=None):
        self._target = fn_or_layer
        self.input_spec = input_spec
        self._layer = fn_or_layer if isinstance(fn_or_layer, Layer) \
            else None

    def __call__(self, *args, **kwargs):
        return self._target(*args, **kwargs)

    @property
    def layer(self):
        return self._layer


def to_static(fn=None, input_spec=None, **_ignored):
    """``@paddle.jit.to_static`` analog (ref: fluid/dygraph/jit.py).
    Honors @not_to_static markers and ProgramTranslator.enable(False)
    (both leave the function as it is)."""
    if fn is None:
        return lambda f: to_static(f, input_spec=input_spec)
    if getattr(fn, "_not_to_static", False) \
            or not ProgramTranslator.enable_to_static:
        return fn
    return StaticFunction(fn, input_spec=input_spec)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

_PROGRAM_FILE = "program.pt2"
_PARAMS_FILE = "params.pkl"
_META_FILE = "meta.json"
_PBIN_FILE = "params.pbin"              # binary params, flatten order

_DTYPE_CODES = {
    "float32": 0, "float64": 1, "int32": 2, "int64": 3, "bfloat16": 4,
    "float16": 5, "uint8": 6, "int8": 7, "bool": 8, "uint32": 9,
    "uint64": 10, "int16": 11, "uint16": 12,
}


def _write_pbin(path: str, named_arrays) -> None:
    """params.pbin: magic 'PTP1', u32 count, then per entry
    u32 name_len, name, u32 dtype_code, u32 ndim, u64 dims[], u64 nbytes,
    raw bytes — readable with no Python on the serving side."""
    import struct
    with open(path, "wb") as f:
        f.write(b"PTP1")
        f.write(struct.pack("<I", len(named_arrays)))
        for name, arr in named_arrays:
            arr = np.asarray(arr)
            raw = arr.tobytes()
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", _DTYPE_CODES[str(arr.dtype)]))
            f.write(struct.pack("<I", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _Forward(torch.nn.Module):
    """The eval forward as a function of (params, buffers, *inputs). The
    layer is held outside the module's state, so the exported program
    lifts no copy of its tensors: the state comes in as inputs."""

    def __init__(self, layer):
        super().__init__()
        self.__dict__["_layer"] = layer

    def forward(self, params, buffers, *inputs):
        out, _ = functional_call(self._layer, params, buffers, *inputs,
                                 training=False)
        return out


def _dims(shape):
    # symbolic dims (dynamic shapes) serialize as their name
    return [int(d) if isinstance(d, int) else str(d) for d in shape]


def _export(layer, params, buffers, input_spec):
    examples, dyn = [], []
    n_dyn = 0
    dev = next(iter(params.values())).device if params else \
        torch.device("cpu")
    for s in input_spec:
        if not isinstance(s, InputSpec):
            s = InputSpec(tuple(s.shape), s.dtype)
        aval = s.to_aval(n_dyn)
        examples.append(torch.zeros(aval.shape, dtype=s.dtype, device=dev))
        dims = {i: torch.export.Dim.DYNAMIC
                for i, d in enumerate(s.shape) if d is None}
        dyn.append(dims or None)
        n_dyn += len(dims)
    with torch.no_grad():
        return torch.export.export(
            _Forward(layer), (params, buffers, *examples),
            dynamic_shapes=({k: None for k in params},
                            {k: None for k in buffers}, tuple(dyn)),
            strict=False)


def save(layer, path: str, input_spec: Sequence[InputSpec] = None,
         encrypt_key: bytes = None) -> None:
    """Export layer → ``program.pt2`` + params (ref: paddle.jit.save →
    __model__ + params; static/io.py:435). ``path`` is used as a
    directory. The program takes (params, buffers, *inputs) explicitly,
    so the parameters are swappable at serve time.

    ``encrypt_key``: encrypt the program/params artifact files at rest
    (``io.crypto``, the JAX package's scheme); ``load`` needs the same
    key. An encrypted artifact gets no ``params.pbin``: the native side
    serves plaintext artifacts only."""
    if isinstance(layer, StaticFunction):
        input_spec = input_spec or layer.input_spec
        layer = layer.layer
        if layer is None:
            raise ValueError("save() needs a Layer-backed StaticFunction")
    if input_spec is None:
        raise ValueError("save() requires input_spec")
    os.makedirs(path, exist_ok=True)
    params, buffers = split_state(layer)
    params = {k: v.detach() for k, v in params.items()}
    buffers = dict(buffers)
    exported = _export(layer, params, buffers, input_spec)
    if globals().get("_code_level", 0):
        # set_code_level analog: the transformed-code dump here is the
        # exported program's graph
        print(exported.graph_module.code)

    def _write_artifact(fname, data):
        # encrypted artifacts never hit disk as plaintext
        if encrypt_key is not None:
            from ..io import crypto
            data = crypto.encrypt_bytes(data, encrypt_key)
        with open(os.path.join(path, fname), "wb") as f:
            f.write(data)

    # the example inputs hold the whole state: the program is saved
    # without them (params.pkl carries the state once)
    exported.example_inputs = None
    buf = _io.BytesIO()
    torch.export.save(exported, buf)
    _write_artifact(_PROGRAM_FILE, buf.getvalue())
    state = {"params": {k: _numpy(v) for k, v in params.items()},
             "buffers": {k: _numpy(v) for k, v in buffers.items()}}
    _write_artifact(_PARAMS_FILE, pickle.dumps(state))
    if encrypt_key is None:
        flat_named = (
            [(k, state["params"][k]) for k in sorted(params)] +
            [(k, state["buffers"][k]) for k in sorted(buffers)])
        _write_pbin(os.path.join(path, _PBIN_FILE), flat_named)

    n_state = len(params) + len(buffers)
    placeholders = [n for n in exported.graph.nodes if n.op == "placeholder"]
    user_in = placeholders[len(placeholders) - len(input_spec):]
    out_node = next(n for n in exported.graph.nodes if n.op == "output")
    outs = [a.meta["val"] for a in out_node.args[0]
            if isinstance(a, torch.fx.Node) and isinstance(
                a.meta.get("val"), torch.Tensor)]
    meta = {
        "input_spec": [{"shape": [d if d is None or isinstance(d, int)
                                  else str(d)
                                  for d in getattr(s, "shape", ())],
                        "dtype": _dtype.name_of(getattr(s, "dtype"))}
                       for s in input_spec],
        "exported_inputs": [{"shape": _dims(n.meta["val"].shape),
                             "dtype": _dtype.name_of(n.meta["val"].dtype)}
                            for n in user_in],
        "outputs": [{"shape": _dims(o.shape),
                     "dtype": _dtype.name_of(o.dtype)} for o in outs],
        "n_state_args": n_state,
        "platforms": [next(iter(params.values())).device.type
                      if params else "cpu"],
        "format_version": 2,
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f)


class TranslatedLayer:
    """Loaded saved program (ref: TranslatedLayer in fluid/dygraph/io.py;
    C++ twin: paddle/fluid/jit/layer.h). Callable; params are restorable
    and swappable (``set_state_dict``)."""

    def __init__(self, exported, params, buffers):
        self._exported = exported
        self._params = params
        self._buffers = buffers
        self._call = exported.module()

    def __call__(self, *inputs):
        with torch.no_grad():
            return self._call(self._params, self._buffers, *inputs)

    def state_dict(self):
        return {**self._params, **self._buffers}

    def set_state_dict(self, state):
        for tree in (self._params, self._buffers):
            for k in tree:
                if k in state:
                    tree[k] = torch.as_tensor(
                        np.asarray(state[k]) if not isinstance(
                            state[k], torch.Tensor) else state[k],
                        dtype=tree[k].dtype, device=tree[k].device)


def load(path: str, decrypt_key: bytes = None,
         device=None) -> TranslatedLayer:
    """ref: paddle.jit.load. Pass ``decrypt_key`` for artifacts saved
    with ``encrypt_key`` (authentication failure raises before any
    bytes are deserialized). ``device``: where the program and its
    state run, the card by default (raises with no card)."""
    from ..core.device import resolve_device
    from ..io import crypto
    dev = resolve_device(device)

    def read(fname):
        full = os.path.join(path, fname)
        if crypto.is_encrypted(full):
            if decrypt_key is None:
                raise ValueError(
                    f"{fname} is encrypted; pass decrypt_key")
            return crypto.decrypt_file_bytes(full, decrypt_key)
        if decrypt_key is not None:
            # a caller holding a key expects AUTHENTICATED artifacts;
            # accepting a plaintext file here would let an attacker
            # strip the encryption and feed an unauthenticated pickle
            raise ValueError(
                f"{fname} is NOT encrypted but decrypt_key was given "
                "— refusing to load an unauthenticated artifact")
        with open(full, "rb") as f:
            return f.read()

    exported = torch.export.load(_io.BytesIO(read(_PROGRAM_FILE)))
    from torch.export.passes import move_to_device_pass
    exported = move_to_device_pass(exported, dev)
    state = pickle.load(_io.BytesIO(read(_PARAMS_FILE)))
    # the program's state placeholders (params, then buffers, in the
    # saved order) give each tensor its traced dtype: a bfloat16 tensor
    # was written as float32
    from torch.export.graph_signature import InputKind
    names = list(state["params"]) + list(state["buffers"])
    placeholders = [n for n in exported.graph.nodes if n.op == "placeholder"]
    avals = [n.meta["val"] for n, spec in zip(
        placeholders, exported.graph_signature.input_specs)
        if spec.kind == InputKind.USER_INPUT][:len(names)]
    dtypes = {k: a.dtype for k, a in zip(names, avals)}

    def tensor(k, v):
        return torch.as_tensor(v, device=dev).to(dtypes[k])

    params = {k: tensor(k, v) for k, v in state["params"].items()}
    buffers = {k: tensor(k, v) for k, v in state["buffers"].items()}
    return TranslatedLayer(exported, params, buffers)


# -- surface completion ------------------------------------------------------

def not_to_static(fn=None):
    """Mark a function to be skipped by to_static conversion (ref:
    jit/__init__ not_to_static): to_static returns it as it is."""
    if fn is None:
        return not_to_static
    fn._not_to_static = True
    return fn


_verbosity = 0
_code_level = 0


def set_verbosity(level: int = 0, also_to_stdout: bool = False) -> None:
    """ref: jit/dy2static logging verbosity (recorded; nothing here is
    transformed)."""
    global _verbosity
    _verbosity = int(level)


def set_code_level(level: int = 100, also_to_stdout: bool = False) -> None:
    """ref: jit/dy2static set_code_level — would print transformed AST
    code; the traced analog is the exported program's graph code,
    printed by jit.save when the level is nonzero."""
    global _code_level
    _code_level = int(level)


class ProgramTranslator:
    """ref: dygraph_to_static/program_translator.py:991. One-world
    compat: enable(False) makes to_static a passthrough."""

    _instance = None
    enable_to_static = True

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static: bool) -> None:
        ProgramTranslator.enable_to_static = bool(enable_to_static)


class TracedLayer:
    """ref: fluid/dygraph/jit.py TracedLayer (trace + save). The traced
    artifact is the layer + example inputs; save_inference_model
    delegates to jit.save at the inputs' shapes."""

    def __init__(self, layer, inputs):
        self._layer = layer
        self._inputs = inputs

    @staticmethod
    def trace(layer, inputs):
        out = layer(*inputs)
        return out, TracedLayer(layer, inputs)

    def __call__(self, *args):
        return self._layer(*args)

    def save_inference_model(self, path, feed=None, fetch=None):
        specs = [InputSpec(shape=list(np.shape(i)),
                           dtype=i.dtype if isinstance(i, torch.Tensor)
                           else str(np.asarray(i).dtype))
                 for i in self._inputs]
        save(self._layer, path, input_spec=specs)

