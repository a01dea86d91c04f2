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

from ..core.device import resolve_device
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


class PagedKVCache:
    """Page-pool KV storage plus per-request block tables.

    k/v pages: [num_pages, page_size, kv_heads, head_dim]; block table
    [max_seqs, pages_per_seq] of page ids (-1 = unallocated);
    context_lens [max_seqs]. Allocation is host-side (the serving
    control plane); the tensors live on ``device`` (the GPU unless
    ``device="cpu"``) and are written in place."""

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, max_seqs: int, pages_per_seq: int,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        self.page_size = page_size
        self.k_pages = torch.zeros((num_pages, page_size, kv_heads,
                                    head_dim), dtype=dtype, device=device)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.block_tables = torch.full((max_seqs, pages_per_seq), -1,
                                       dtype=torch.int32, device=device)
        self.context_lens = torch.zeros((max_seqs,), dtype=torch.int32,
                                        device=device)
        self._free = list(range(num_pages - 1, -1, -1))

    def allocate(self, seq: int, n_tokens: int) -> None:
        """Reserve pages for n_tokens of sequence ``seq``."""
        need = -(-n_tokens // self.page_size)
        if need > self.block_tables.shape[1]:
            raise ValueError(
                f"sequence {seq} needs {need} pages but the block "
                f"table holds {self.block_tables.shape[1]} "
                f"(pages_per_seq); raise pages_per_seq or evict")
        have = int((self.block_tables[seq] >= 0).sum())
        for slot in range(have, need):
            if not self._free:
                raise RuntimeError("KV page pool exhausted")
            self.block_tables[seq, slot] = self._free.pop()

    def free(self, seq: int) -> None:
        for pid in [int(p) for p in self.block_tables[seq] if p >= 0]:
            self._free.append(pid)
        self.block_tables[seq] = -1
        self.context_lens[seq] = 0

    def append(self, seq: int, k_new, v_new) -> None:
        """Write [t, kv_heads, d] new tokens at the sequence's end, one
        contiguous slice per page they touch."""
        t = int(k_new.shape[0])
        start = int(self.context_lens[seq])
        self.allocate(seq, start + t)
        ps = self.page_size
        i = 0
        while i < t:
            pos = start + i
            page = int(self.block_tables[seq, pos // ps])
            off = pos % ps
            span = min(ps - off, t - i)
            self.k_pages[page, off:off + span] = k_new[i:i + span]
            self.v_pages[page, off:off + span] = v_new[i:i + span]
            i += span
        self.context_lens[seq] = start + t


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

# launches of kernel B4 since the last reset: one per wrapper call, which
# runs the split kernel and, where a row spans more than one partition,
# the merge kernel after it (so a run of the engine counts one per layer
# per prefill chunk or decode step). The wrapper adds one per call and
# nothing else touches it but a caller's reset to 0.
launches = 0

# dtype codes of csrc/paged_attention.cu
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.int8: 3}
# paged_attention_launch's code for pools not aligned to the rows' copies
_MISALIGNED = -1
_launcher = None


def partition_pages(t: int, kv_heads: int, pages_per_seq: int,
                    page_size: int = 16) -> int:
    """Pages one block of the split kernel takes (its flash-decoding
    partition): at 16-token pages the largest of 16 and 8 that still
    gives the launch 512 (row, kv head, partition) blocks, about 4 for
    each of the H100's 132 SMs, else 4; larger pages take as many
    fewer pages (at least one). Fewer, longer partitions merge less;
    more, shorter ones fill the card when there are few rows."""
    shrink = max(1, page_size // 16)
    for n in (16, 8):
        n = max(1, n // shrink)
        if t * kv_heads * -(-pages_per_seq // n) >= 512:
            return n
    return max(1, 4 // shrink)


def _load_launcher():
    global _launcher
    if _launcher is None:
        fn = _kernels.library("paged_attention").paged_attention_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, p, p, p, p, p, p, p, i, i, i, i, i,
                       i, i, ctypes.c_float, p]
        fn.restype = i
        _launcher = fn
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
    if d != dk or d <= 0:
        raise ValueError(f"q and the pages differ in head dim: q {d}, "
                         f"pages {dk}")
    if n_heads % kv_heads:
        raise ValueError(f"{n_heads} q heads are not a multiple of "
                         f"{kv_heads} kv heads")
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
    fn = _load_launcher()
    t, n_heads, d = q.shape
    _, page_size, kv_heads, _ = k_pages.shape
    out = torch.empty_like(q)
    if t == 0:
        return out
    pages_per_seq = block_tables.shape[1]
    part_pages = partition_pages(t, kv_heads, pages_per_seq, page_size)
    n_parts = -(-pages_per_seq // part_pages)
    part_ml = part_acc = None
    if n_parts > 1:   # partials of rows that span several partitions
        part_ml = torch.empty((t, n_heads, n_parts, 2), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((t, n_heads, n_parts, d),
                               dtype=torch.float32, device=q.device)
    sm_scale = scale if scale is not None else 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), _Q_CODES[q.dtype], k_pages.data_ptr(),
             v_pages.data_ptr(), _KV_CODES[k_pages.dtype],
             k_scales.data_ptr() if k_scales is not None else None,
             v_scales.data_ptr() if v_scales is not None else None,
             block_tables.data_ptr(), context_lens.data_ptr(),
             out.data_ptr(),
             part_ml.data_ptr() if part_ml is not None else None,
             part_acc.data_ptr() if part_acc is not None else None,
             t, n_heads, kv_heads, d, page_size, pages_per_seq,
             part_pages, sm_scale, stream)
    if err == _MISALIGNED:
        raise ValueError("k_pages and v_pages must be aligned to the "
                         "widest copy (16, 8, 4, 2 or 1 bytes) that "
                         "divides a row")
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    if _kernels.cost_sinks:
        # the work follows the context lengths: read on the host (a
        # synchronization) only while a cost model counts
        keys = int(context_lens.sum())
        _kernels.report_cost(
            "paged_attention", 4.0 * n_heads * d * keys,
            2 * q.numel() * q.element_size() +
            2 * keys * kv_heads * d * k_pages.element_size() +
            block_tables.numel() * 4 + t * 4)
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


def paged_attention_chunk(q, k_pages, v_pages, block_tables, base_lens,
                          scale: Optional[float] = None,
                          impl: str = "kernel"):
    """Multi-query attention over paged KV: ``q`` [B, K, heads, d]
    carries K new tokens per sequence written at positions
    ``base_lens[b] .. base_lens[b] + K - 1``; query j attends the first
    ``base_lens[b] + j + 1`` positions (0 = inactive slot -> zero rows).
    Returns [B, K, heads, d].

    Deprecated alias: the rectangular case of
    :func:`ragged_paged_attention`, rows flattened."""
    b, kq, h, d = q.shape
    limit = torch.where(
        base_lens[:, None] > 0,
        base_lens[:, None] + torch.arange(kq, device=q.device)[None, :] + 1,
        torch.zeros((), dtype=base_lens.dtype, device=q.device))
    out = ragged_paged_attention(
        q.reshape(b * kq, h, d).contiguous(), k_pages, v_pages,
        block_tables.repeat_interleave(kq, dim=0).contiguous(),
        limit.reshape(-1).to(torch.int32), scale=scale, impl=impl)
    return out.reshape(b, kq, h, d)


def paged_attention_ragged(q, k_pages, v_pages, token_tables,
                           token_lens, scale: Optional[float] = None,
                           impl: str = "kernel"):
    """Deprecated alias of :func:`ragged_paged_attention`."""
    return ragged_paged_attention(q, k_pages, v_pages, token_tables,
                                  token_lens, scale=scale, impl=impl)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale: Optional[float] = None, impl: str = "kernel"):
    """Single-query attention over paged KV (the decode step): q [B,
    heads, d], one table row and context length per query. Deprecated
    alias: the T = B case of :func:`ragged_paged_attention`."""
    return ragged_paged_attention(q, k_pages, v_pages, block_tables,
                                  context_lens, scale=scale, impl=impl)
