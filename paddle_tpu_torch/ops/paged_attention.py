"""Ragged paged attention over a block-paged KV pool
(the port's counterpart of ``paddle_tpu/ops/paged_attention.py``).

KV lives in fixed-size PAGES ``[num_pages, page_size, kv_heads, d]``
shared by all sequences; a block table maps each sequence's logical
positions to pages. :func:`ragged_paged_attention` is the one entry
point the engine calls for decode steps and prefill chunks alike: each
query row carries its own table row and causal limit.

Three implementations, chosen by ``impl``:

- ``"kernel"`` (default): :func:`paged_attention_kernel`, the
  hand-written CUDA kernel B4 (``csrc/paged_attention.cu``) for a CUDA
  tensor, and its plain twin for a CPU tensor;
- ``"plain"``: :func:`paged_attention_torch`, the gather + dense masked
  softmax of the JAX package's ``_gathered_attention``;
- ``"reference"``: :func:`ragged_paged_attention_reference`, all f32.

The pool is updated IN PLACE by :func:`kv_write` (the JAX package
returns a new array; here a write into the pool saves a copy of it).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Union

import torch

from . import _kernels

# LLMEngine(kv_dtype=...) values: the storage dtype of the paged pool.
# "int8" stores quantized pages with a per-row scale table beside them.
KV_DTYPES = {
    "f32": torch.float32, "float32": torch.float32,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "f16": torch.float16, "float16": torch.float16,
    "int8": torch.int8,
}


class QuantizedKV(NamedTuple):
    """An int8 paged store: ``pages`` [..., num_pages, page_size,
    kv_heads, d] int8 and ``scales`` [..., num_pages, page_size] f32,
    the symmetric absmax scale of every page row (see
    :func:`quantize_kv`)."""

    pages: torch.Tensor
    scales: torch.Tensor


KVStore = Union[torch.Tensor, QuantizedKV]


def kv_zeros(shape, dtype, device=None) -> KVStore:
    """A zeroed KV store; ``dtype`` is a torch dtype or a KV_DTYPES
    key. int8 yields a :class:`QuantizedKV`."""
    if isinstance(dtype, str):
        dtype = KV_DTYPES[dtype]
    if dtype == torch.int8:
        return QuantizedKV(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(tuple(shape)[:-2], dtype=torch.float32,
                        device=device))
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_layer(store: KVStore, i) -> KVStore:
    """Per-layer view of a [L, ...]-stacked store."""
    if isinstance(store, QuantizedKV):
        return QuantizedKV(store.pages[i], store.scales[i])
    return store[i]


def kv_page_size(store: KVStore) -> int:
    return _split_kv(store)[0].shape[-3]


def kv_nbytes(store: KVStore) -> int:
    """Device bytes of the store including the scale table."""
    if isinstance(store, QuantizedKV):
        return (store.pages.numel() * store.pages.element_size() +
                store.scales.numel() * store.scales.element_size())
    return store.numel() * store.element_size()


def quantize_kv(rows, eps: float = 1e-8):
    """Per-row symmetric absmax int8 quantization of KV rows
    [..., kv_heads, d] -> (int8 rows, f32 scales [...]). A pure
    function of the values, byte-identical to the JAX package's."""
    x = rows.float()
    amax = x.abs().amax(dim=(-2, -1))
    scale = torch.clamp(amax, min=eps) / 127.0
    q = torch.clamp(torch.round(x / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def kv_write(store: KVStore, layer, page_idx, offs, rows) -> KVStore:
    """Write KV rows [..., kv_heads, d] into the pool at (layer,
    page_idx, offs), quantizing on write for a :class:`QuantizedKV`.
    Writes in place and returns the store."""
    if isinstance(store, QuantizedKV):
        q, s = quantize_kv(rows)
        store.pages[layer][page_idx, offs] = q
        store.scales[layer][page_idx, offs] = s
        return store
    store[layer][page_idx, offs] = rows.to(store.dtype)
    return store


def _split_kv(store: KVStore):
    if isinstance(store, QuantizedKV):
        return store.pages, store.scales
    return store, None


def paged_attention_torch(q, k_pages, v_pages, token_tables, token_lens,
                          scale: Optional[float] = None, k_scales=None,
                          v_scales=None):
    """The plain twin of kernel B4: a port of the JAX package's
    ``_gathered_attention`` for one query row per token. Gathers each
    row's whole table of pages, dequantizes, expands GQA and runs a
    masked f32 softmax. q [T, H, d]; pages [NP, ps, KVH, d]; tables
    [T, P] (-1 reads page 0); lens [T] (0 gives a zero row). Returns
    [T, H, d] in q's dtype."""
    t, n_heads, d = q.shape
    _, page_size, kv_heads, _ = k_pages.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    tables = token_tables.long().clamp(min=0)         # [T, P]
    k = k_pages[tables]                               # [T, P, ps, KVH, d]
    v = v_pages[tables]
    if k_scales is not None:
        k = k.float() * k_scales[tables][..., None, None]
        v = v.float() * v_scales[tables][..., None, None]
    L = tables.shape[1] * page_size
    k = k.reshape(t, L, kv_heads, d).float()
    v = v.reshape(t, L, kv_heads, d).float()
    if n_heads != kv_heads:
        rep = n_heads // kv_heads
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("thd,tlhd->thl", q.float(), k) * scale
    lens = token_lens.long()
    mask = torch.arange(L, device=q.device)[None, :] < lens[:, None]
    logits = logits.masked_fill(~mask[:, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    # fully masked rows (limit 0): zeros, not NaN
    p = torch.where((lens > 0)[:, None, None], p, torch.zeros_like(p))
    out = torch.einsum("thl,tlhd->thd", p, v)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# kernel B4 (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------

# launches of kernel B4 since the last reset; the wrapper adds one per
# launch and nothing else touches it but a caller's reset to 0
launches = 0

# dtype codes of csrc/paged_attention.cu
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3}
_HEAD_DIMS = (64, 128)
_MAX_SMEM = 227 * 1024
_launcher = None


def _load_launcher():
    global _launcher
    if _launcher is None:
        lib = _kernels.library("paged_attention")
        fn = lib.paged_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = i
        smem = lib.paged_attention_smem_bytes
        smem.argtypes = [i, i, i, i]
        smem.restype = ctypes.c_longlong
        _launcher = (fn, smem)
    return _launcher


def _check_cuda_args(q, k_pages, v_pages, tables, lens, k_scales,
                     v_scales):
    dev = q.device
    named = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                 block_tables=tables, context_lens=lens)
    if k_scales is not None or v_scales is not None:
        named.update(k_scales=k_scales, v_scales=v_scales)
    for n, x in named.items():
        if not isinstance(x, torch.Tensor) or x.device != dev:
            raise ValueError(f"{n} must be a tensor on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{n} must be contiguous")
    if q.dim() != 3 or q.dtype not in _Q_CODES:
        raise ValueError(f"q must be [T, H, d] f32/bf16/f16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.dtype != v_pages.dtype \
            or k_pages.dtype not in _KV_CODES:
        raise ValueError(
            f"k/v pages must be matching [NP, ps, KVH, d] "
            f"f32/bf16/f16/int8, got {tuple(k_pages.shape)} "
            f"{k_pages.dtype} and {tuple(v_pages.shape)} {v_pages.dtype}")
    t, n_heads, d = q.shape
    n_pages, page_size, kv_heads, dk = k_pages.shape
    if d != dk or d not in _HEAD_DIMS:
        raise ValueError(f"head_dim {d} (pages {dk}) not in {_HEAD_DIMS}")
    if n_heads % kv_heads or n_heads // kv_heads > 128:
        raise ValueError(f"{n_heads} q heads over {kv_heads} kv heads")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scales is not None) or quant != (v_scales is not None):
        raise ValueError("int8 pages need k_scales and v_scales; other "
                         "dtypes take none")
    if quant:
        for n, x in (("k_scales", k_scales), ("v_scales", v_scales)):
            if x.dtype != torch.float32 or \
                    tuple(x.shape) != (n_pages, page_size):
                raise ValueError(f"{n} must be f32 [{n_pages}, "
                                 f"{page_size}]")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != t:
        raise ValueError(f"block_tables must be int32 [{t}, P]")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (t,):
        raise ValueError(f"context_lens must be int32 [{t}]")
    for n in ("k_pages", "v_pages"):
        if named[n].data_ptr() % 16:
            raise ValueError(f"{n} must be 16-byte aligned")


def paged_attention_kernel(q, k_pages, v_pages, block_tables,
                           context_lens, scale: Optional[float] = None,
                           k_scales=None, v_scales=None):
    """Kernel B4: ragged paged attention, same contract as
    :func:`paged_attention_torch`. A CUDA tensor launches the CUDA
    kernel (raising on what it does not take, or on a failed launch); a
    CPU tensor runs the plain twin."""
    if not q.is_cuda:
        return paged_attention_torch(q, k_pages, v_pages, block_tables,
                                     context_lens, scale, k_scales,
                                     v_scales)
    global launches
    _check_cuda_args(q, k_pages, v_pages, block_tables, context_lens,
                     k_scales, v_scales)
    fn, smem_bytes = _load_launcher()
    t, n_heads, d = q.shape
    _, page_size, kv_heads, _ = k_pages.shape
    kv_code = _KV_CODES[k_pages.dtype]
    smem = smem_bytes(kv_code, d, page_size, n_heads // kv_heads)
    if smem > _MAX_SMEM:
        raise ValueError(f"page_size {page_size} needs {smem} bytes of "
                         f"shared memory, over {_MAX_SMEM}")
    out = torch.empty_like(q)
    if t == 0:
        return out
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), _Q_CODES[q.dtype], k_pages.data_ptr(),
             v_pages.data_ptr(), kv_code,
             k_scales.data_ptr() if k_scales is not None else None,
             v_scales.data_ptr() if v_scales is not None else None,
             block_tables.data_ptr(), context_lens.data_ptr(),
             out.data_ptr(), t, n_heads, kv_heads, d, page_size,
             block_tables.shape[1], sm_scale, stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def ragged_paged_attention(q, kv_k: KVStore, kv_v: KVStore,
                           token_tables, token_lens,
                           scale: Optional[float] = None,
                           impl: str = "kernel"):
    """THE ragged paged-attention entry point: q [T, heads, d], each
    row t with its own block-table row ``token_tables[t]`` [P] and
    causal limit ``token_lens[t]`` (0 = padding -> zero row), over a
    plain or int8 (:class:`QuantizedKV`) pool. Returns [T, heads, d] in
    q's dtype. ``impl``: ``"kernel"``, ``"plain"`` or ``"reference"``
    (see the module docstring)."""
    kp, ks = _split_kv(kv_k)
    vp, vs = _split_kv(kv_v)
    if impl == "kernel":
        return paged_attention_kernel(q, kp, vp, token_tables, token_lens,
                                      scale=scale, k_scales=ks,
                                      v_scales=vs)
    if impl == "plain":
        return paged_attention_torch(q, kp, vp, token_tables, token_lens,
                                     scale, ks, vs)
    if impl == "reference":
        return ragged_paged_attention_reference(
            q, kv_k, kv_v, token_tables, token_lens,
            scale=scale).to(q.dtype)
    raise ValueError(f"unknown impl {impl!r}")


def ragged_paged_attention_reference(q, kv_k: KVStore, kv_v: KVStore,
                                     token_tables, token_lens,
                                     scale: Optional[float] = None):
    """All-f32 reference (the int8 tolerance baseline): q, the
    dequantized pages and every intermediate are f32, and so is the
    result."""
    kp, ks = _split_kv(kv_k)
    vp, vs = _split_kv(kv_v)
    return paged_attention_torch(q.float(), kp, vp, token_tables,
                                 token_lens, scale, ks, vs)
