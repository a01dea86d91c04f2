"""Continuous-batching LLM engine over a paged KV pool
(the port's counterpart of ``paddle_tpu/inference/llm.py``).

The default engine runs the JAX engine's default serving path: chunked
ragged prefill over a refcounted prefix cache (:mod:`.prefix_cache`),
served as ONE ragged mixed tick of prefill chunk rows and decode rows
(:class:`_MixedTick`) inside a :class:`DecodeCarry` slab of
``decode_ticks_per_dispatch`` ticks, with pure decode steps
(:class:`_PagedDecode`) or decode slabs once the prefill queue is empty.
``mixed_tick=False`` keeps the alternating prefill-chunk / decode-step
loop (:class:`_ChunkedPrefill`), which ``lookahead > 0`` needs. Every
attention goes through
:func:`~paddle_tpu_torch.ops.paged_attention.ragged_paged_attention`,
kernel B4 on the GPU.

Page 0 of the pool is a scratch page: padding rows, inactive slots and
masked slab ticks write there, so every shape stays fixed. The pools
are written in place (the JAX engine threads them functionally); a
shared prefix page is never written, and every launch runs on one CUDA
stream, so a page registered after the dispatch that writes it is
never read before it is written. Sampling keys are
``fold_in(fold_in(PRNGKey(seed), nonce), position)`` with JAX's own
threefry recipe (:mod:`paddle_tpu_torch.core.threefry`), so greedy and
nonce-pinned ``temperature > 0`` streams are token-identical to the JAX
engine's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from ..core import threefry
from ..core.device import resolve_device
from ..models.gpt import _lm_logits
from ..nn.layer import Layer
from ..ops.paged_attention import (KV_DTYPES, KVStore, kv_layer,
                                   kv_page_size, kv_write, kv_zeros,
                                   ragged_paged_attention)
from ..ops.rotary import apply_rotary_pos_emb, rope_tables
from .prefix_cache import PrefixCache, page_digests

ATTENTION_IMPLS = ("kernel", "plain", "reference")


class EngineClosed(RuntimeError):
    """The engine is shut (or shutting) down."""


def _sample(logits, temperature, key, nonces, positions,
            any_sampled: bool = True):
    """Per-slot sampling: temperature<=0 -> greedy. logits [B, V],
    temperature [B], key [2]. The per-token key is
    fold_in(fold_in(key, nonce), position), so a stream depends only on
    WHAT is sampled, never on how the scheduler got there.
    ``any_sampled=False`` (no slot has temperature > 0) skips the
    random draw, whose result would be discarded."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    keys = threefry.fold_in(threefry.fold_in(key, nonces), positions)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sampled = threefry.categorical(keys, scaled)
    return torch.where(temperature > 0.0, sampled, greedy)


def _write_slots(tables, positions, active, page_size):
    """(page, offset) in the pool where each row's K/V lands; inactive
    rows go to scratch page 0. A row past its table's end (a masked
    slab tick) reads the last entry, then goes to scratch too."""
    idx = (positions // page_size).clamp(max=tables.shape[1] - 1)
    page_idx = tables.clamp(min=0).gather(1, idx[:, None])[:, 0]
    page_idx = torch.where(active, page_idx, torch.zeros_like(page_idx))
    return page_idx.long(), (positions % page_size).long()


def _layer_step(net, x, layer, i, pos_ids, rope, page_idx, offs,
                k_pages, v_pages, tables, lens, attention_impl):
    """One decoder block over T token rows ``x`` [1 or B, ., H]: write
    the rows' K/V into the pool, attend over each row's paged context,
    and return the block's output."""
    cfg = net.cfg
    hd = cfg.head_dim
    lead = x.shape[:2]
    h = layer.ln_1(x)
    qkv = layer.attn.qkv_proj(h)
    q, k, v = torch.split(
        qkv, [cfg.hidden_size, cfg.num_kv_heads * hd,
              cfg.num_kv_heads * hd], dim=-1)
    q = q.reshape(*lead, cfg.num_heads, hd)
    k = k.reshape(*lead, cfg.num_kv_heads, hd)
    v = v.reshape(*lead, cfg.num_kv_heads, hd)
    if rope is not None:
        q, k = apply_rotary_pos_emb(q, k, *rope, position_ids=pos_ids)
    rows = lead[0] * lead[1]
    kv_write(k_pages, i, page_idx, offs,
             k.reshape(rows, cfg.num_kv_heads, hd))
    kv_write(v_pages, i, page_idx, offs,
             v.reshape(rows, cfg.num_kv_heads, hd))
    att = ragged_paged_attention(
        q.reshape(rows, cfg.num_heads, hd).contiguous(),
        kv_layer(k_pages, i),
        kv_layer(v_pages, i), tables, lens, impl=attention_impl)
    x = x + layer.attn.out_proj(att.reshape(*lead, cfg.hidden_size))
    return x + layer.mlp(layer.ln_2(x))


def _rope(cfg, device):
    if not cfg.use_rope:
        return None
    cos, sin = rope_tables(cfg.head_dim, cfg.max_position_embeddings,
                           cfg.rope_base)
    return (torch.from_numpy(cos).to(device),
            torch.from_numpy(sin).to(device))


def _ragged_forward(net, tokens, positions, limits, tables, k_pages,
                    v_pages, attention_impl):
    """T token rows of any mix of sequences as one forward: each row
    writes its K/V at its position and attends its own table row up to
    its limit (0 = padding). Returns the final hidden rows [T, H]."""
    gpt = net.gpt
    pos_ids = positions[None, :]                        # [1, T]
    x = gpt.embeddings(tokens[None, :], position_ids=pos_ids)
    page_idx, offs = _write_slots(tables, positions, limits > 0,
                                  kv_page_size(k_pages))
    rope = _rope(net.cfg, x.device)
    for i, layer in enumerate(gpt.layers):
        x = _layer_step(net, x, layer, i, pos_ids, rope, page_idx, offs,
                        k_pages, v_pages, tables, limits, attention_impl)
    return gpt.ln_f(x)[0]


def _lm_rows(net, rows):
    """Logits [B, V] of hidden rows [B, H]."""
    return _lm_logits(net.cfg, net.gpt.embeddings, rows[:, None],
                      getattr(net, "lm_head", None))[:, 0]


class DecodeCarry(NamedTuple):
    """Per-slot decode state carried through one slab of ticks (B =
    max_seqs), all on the device:

    - ``tokens`` [B]: each slot's last sampled token, the next tick's
      input;
    - ``positions`` [B]: where ``tokens`` is written (the slot's
      context length); advances by one per active tick;
    - ``budgets`` [B]: tokens the slot may still emit in this slab,
      zeroed on EOS; 0 marks the slot inactive, and its tick is a masked
      no-op (K/V to scratch page 0, tokens and positions held);
    - ``k_pages`` / ``v_pages``: the paged pool, written in place.

    Block tables, temperatures, nonces and the key stay outside: the
    slab reserves its pages at entry. A mixed slab installs a prompt's
    first token, start position and budget at the tick its prompt
    completes. The draft fields (speculative decoding) stay ``None``."""

    tokens: torch.Tensor
    positions: torch.Tensor
    budgets: torch.Tensor
    k_pages: KVStore
    v_pages: KVStore
    draft_k_pages: Optional[KVStore] = None
    draft_v_pages: Optional[KVStore] = None


class _PagedDecode(Layer):
    """One batched decode step: feed each active slot's last token,
    write its K/V into the pages, attend over the paged context, sample
    the next token on the device. The pool is updated in place."""

    def __init__(self, net, attention_impl: str = "kernel"):
        super().__init__()
        self.net = net
        self.attention_impl = attention_impl

    def forward(self, tokens, positions, block_tables, context_lens,
                k_pages, v_pages, temperature, nonces, key,
                any_sampled: bool = True):
        net, gpt = self.net, self.net.gpt
        pos_ids = positions[:, None]                        # [B, 1]
        x = gpt.embeddings(tokens[:, None], position_ids=pos_ids)
        # inactive slots (context_len 0) write to scratch page 0
        page_idx, offs = _write_slots(block_tables, positions,
                                      context_lens > 0,
                                      kv_page_size(k_pages))
        rope = _rope(net.cfg, x.device)
        for i, layer in enumerate(gpt.layers):
            x = _layer_step(net, x, layer, i, pos_ids, rope, page_idx,
                            offs, k_pages, v_pages, block_tables,
                            context_lens, self.attention_impl)
        logits = _lm_rows(net, gpt.ln_f(x)[:, 0])
        return _sample(logits, temperature, key, nonces, positions,
                       any_sampled)


class _ChunkedPrefill(Layer):
    """One RAGGED prefill chunk: T prompt tokens drawn from one or more
    requests, as one batched forward. Each row carries its own table
    row, position and causal limit (its position + 1); earlier rows of
    the chunk have written their K/V before any row attends, so the
    chunk is causal. For each slot whose prompt completes here,
    ``sample_idx`` points at its last prompt row, whose logits are
    sampled into the returned [max_seqs] token vector."""

    def __init__(self, net, attention_impl: str = "kernel"):
        super().__init__()
        self.net = net
        self.attention_impl = attention_impl

    def forward(self, tokens, positions, limits, tables, sample_idx,
                sample_pos, k_pages, v_pages, temperatures, nonces, key,
                any_sampled: bool = True):
        x = _ragged_forward(self.net, tokens, positions, limits, tables,
                            k_pages, v_pages, self.attention_impl)
        # only the finishing slots' last rows need the LM head
        logits = _lm_rows(self.net, x[sample_idx.long()])
        return _sample(logits, temperatures, key, nonces, sample_pos,
                       any_sampled)


class _MixedTick(Layer):
    """ONE ragged mixed tick: C prefill chunk rows (packed as in
    :class:`_ChunkedPrefill`) and B decode rows (each slot's last
    token, as in :class:`_PagedDecode`) as a single forward of C + B
    rows, so one attention launch per layer serves both phases. Each
    row's math is independent of the others, so streams are identical
    to the alternating loop's. Slot b samples from its finishing prompt
    row (``fin_row``) when its prompt completes this tick, else from its
    decode row C + b, at ``fin_pos`` or its feed position."""

    def __init__(self, net, attention_impl: str = "kernel"):
        super().__init__()
        self.net = net
        self.attention_impl = attention_impl

    def forward(self, ptok, ppos, plim, ptbl, fin, fin_row, fin_pos,
                dtok, dpos, dlens, tables, k_pages, v_pages, temps,
                nonces, key, any_sampled: bool = True):
        c, b = ptok.shape[0], dtok.shape[0]
        x = _ragged_forward(
            self.net, torch.cat([ptok, dtok]), torch.cat([ppos, dpos]),
            torch.cat([plim, dlens]),
            torch.cat([ptbl.clamp(min=0), tables.clamp(min=0)]),
            k_pages, v_pages, self.attention_impl)
        rows = torch.where(fin, fin_row.long(),
                           c + torch.arange(b, device=x.device))
        logits = _lm_rows(self.net, x[rows])
        return _sample(logits, temps, key, nonces,
                       torch.where(fin, fin_pos, dpos), any_sampled)


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "future",
                 "tokens", "slot", "truncated", "t_submit", "t_first",
                 "t_done", "closing", "drain_after", "accepts_inflight",
                 "seq", "nonce", "prefill_pos", "prefill_done", "digests",
                 "n_cached", "n_reg_pages")

    def __init__(self, prompt, max_new_tokens, temperature):
        self.prompt = list(map(int, prompt))
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.future: Future = Future()
        self.tokens: List[int] = []
        self.slot = -1
        self.truncated = False
        self.t_submit = time.monotonic()
        self.t_first = None
        self.t_done = None
        # a "closing" request gets no new steps; its pages stay held
        # until every issued step naming its slot is fetched
        self.closing = False
        self.drain_after = -1
        # closed for budget reasons (not EOS): still wants in-flight
        # tokens
        self.accepts_inflight = False
        self.seq = 0            # submission order (admission is FIFO)
        self.nonce = 0          # sampling-key salt
        self.prefill_pos = 0    # next prompt position to compute
        self.prefill_done = False
        self.digests: List[bytes] = []   # rolling digests of full pages
        self.n_cached = 0       # prompt tokens served by the cache
        self.n_reg_pages = 0    # prompt pages registered as shared


def _not_ported(arg: str, item: str):
    return NotImplementedError(
        f"LLMEngine({arg}) is not ported yet (ROADMAP Queue A: {item})")


class LLMEngine:
    """Continuous-batching engine over one model, on the device
    ``device`` (the GPU unless ``device="cpu"``).

    ``submit(prompt_ids, ...)`` returns a Future resolving to a dict
    with the generated ids; requests join the running batch at the next
    step boundary and leave on EOS/length. ``generate`` is the blocking
    convenience wrapper.

    Page-pool sizing: ``(num_pages - 1) * page_size`` tokens of KV
    (page 0 is scratch) shared by up to ``max_seqs`` sequences. A
    sequence that would outgrow the pool mid-decode is finished early
    with ``truncated=True``; a request whose prompt alone can never fit
    fails its future.

    ``prefix_cache`` (default on): full prompt pages become immutable,
    refcounted and keyed by rolling digests; a request whose prompt
    prefix matches maps them read-only and prefills only the rest;
    refcount-zero pages are evicted LRU under page pressure.
    ``mixed_tick`` (default ``FLAGS.mixed_tick``, on): prefill chunk rows
    and decode rows ride one ragged tick. ``decode_ticks_per_dispatch``
    (default ``FLAGS.decode_ticks_per_dispatch``, 1): ticks issued back
    to back as one :class:`DecodeCarry` slab before the host reads the
    tokens. ``lookahead``: steps of the alternating loop issued ahead of
    the fetch; it conflicts with a slab (``ValueError``) and with an
    explicit ``mixed_tick=True`` (``ValueError``), while the flag's
    default yields to it. Streams are token-identical across all of
    these. ``draft_net`` (speculative decoding) raises
    ``NotImplementedError`` naming its ROADMAP item.

    ``kv_dtype``: pool storage dtype, ``"f32"``/``"bf16"``/``"f16"`` or
    ``"int8"`` (quantized pages with per-row f32 scales; default
    ``FLAGS.kv_dtype``, else ``cache_dtype``). ``attention_impl``:
    ``"kernel"`` (kernel B4), ``"plain"`` or ``"reference"``.

    Counters: ``n_prefill_ticks`` (chunks of prefill work),
    ``n_decode_ticks`` (decode ticks that emitted a token),
    ``n_dispatched_ticks`` (forward passes issued, masked slab ticks
    included: one attention launch per layer each), ``n_mixed_slabs``,
    ``n_prompt_tokens`` and ``n_cached_tokens``."""

    def __init__(self, net, max_seqs: int = 8, page_size: int = 16,
                 num_pages: int = 512, max_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (64, 256, 1024),
                 eos_token_id: Optional[int] = None,
                 cache_dtype=torch.float32, seed: int = 0,
                 lookahead: int = 0, attention_impl: str = "kernel",
                 draft_net=None, prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 decode_ticks_per_dispatch: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 mixed_tick: Optional[bool] = None, device=None):
        if draft_net is not None:
            raise _not_ported("draft_net=...", "speculative decoding")
        self.lookahead = int(lookahead)
        if decode_ticks_per_dispatch is None:
            decode_ticks_per_dispatch = _flags.get_flag(
                "decode_ticks_per_dispatch")
        self.decode_ticks_per_dispatch = max(
            1, int(decode_ticks_per_dispatch))
        if self.decode_ticks_per_dispatch > 1 and self.lookahead:
            raise ValueError(
                "decode_ticks_per_dispatch > 1 does not compose with "
                "lookahead: a slab must drain at its boundary (the "
                "device decides how far positions advanced), and the "
                "slab already keeps the device busy for N ticks per "
                "fetch; use one knob or the other")
        # only an EXPLICIT mixed_tick=True conflicts with lookahead: the
        # flag's default yields to it
        mixed_explicit = mixed_tick is not None
        if mixed_tick is None:
            mixed_tick = _flags.get_flag("mixed_tick")
        self.mixed_tick = bool(mixed_tick)
        if self.mixed_tick and self.lookahead:
            if mixed_explicit:
                raise ValueError(
                    "mixed_tick does not compose with lookahead: a mixed "
                    "slab must drain at its boundary (the device decides "
                    "which tick each slot's prompt completed and how far "
                    "its decode advanced); use one knob or the other")
            self.mixed_tick = False
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {attention_impl!r}")
        self.device = resolve_device(device)
        cfg = net.cfg
        self.cfg = cfg
        self.net = net.to(self.device).eval()
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_len = min(max_len or cfg.max_position_embeddings,
                           cfg.max_position_embeddings)
        self.pages_per_seq = -(-self.max_len // page_size)
        self.eos_token_id = eos_token_id
        self.prefill_buckets = sorted(
            b for b in prefill_buckets if b <= self.max_len) or \
            [self.max_len]
        self.prefill_chunk = int(prefill_chunk or self.prefill_buckets[0])
        if kv_dtype is None:
            kv_dtype = _flags.get_flag("kv_dtype") or None
        if kv_dtype is None:
            kv_dtype = next((k for k, v in KV_DTYPES.items()
                             if v == cache_dtype), str(cache_dtype))
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected "
                             f"one of {sorted(KV_DTYPES)}")
        self.kv_dtype = kv_dtype
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        self.k_pages = kv_zeros(shape, kv_dtype, self.device)
        self.v_pages = kv_zeros(shape, kv_dtype, self.device)
        # host-side control plane (numpy: mutated by the allocator)
        self.block_tables = np.zeros((max_seqs, self.pages_per_seq),
                                     np.int32)
        self.context_lens = np.zeros((max_seqs,), np.int32)
        self.temperatures = np.zeros((max_seqs,), np.float32)
        self._nonces = np.zeros((max_seqs,), np.int32)
        self._free_pages = list(range(num_pages - 1, 0, -1))  # 0=scratch
        self._cache = PrefixCache(page_size) if prefix_cache else None
        self._slots: List[Optional[_Request]] = [None] * max_seqs
        # device-chained last tokens (authoritative between fetches)
        self._tokens_dev = torch.zeros((max_seqs,), dtype=torch.int64,
                                       device=self.device)
        self._key = threefry.prng_key(seed, device=self.device)
        self._eos = -1 if eos_token_id is None else int(eos_token_id)
        self._decode = _PagedDecode(self.net, attention_impl)
        self._chunk = _ChunkedPrefill(self.net, attention_impl)
        self._mixed = _MixedTick(self.net, attention_impl)
        # (issue_seq, slots, device tokens, kind, meta) of each issued
        # step: "p" a prefill chunk that completes prompts, "d" a decode
        # step, "D" a decode slab and "M" a mixed slab ([n_ticks,
        # max_seqs] tokens; meta holds the host copy of the entry
        # budgets and positions the drain replays)
        self._inflight: deque = deque()
        self._issue_seq = 0
        self._fetch_seq = 0
        self._nonce_seq = 0
        self._prefill_q: deque = deque()
        self._mu = threading.Lock()
        self._pending: List[_Request] = []
        self._closed = False
        self._wake = threading.Event()
        self.n_prefill_ticks = 0
        self.n_decode_ticks = 0
        self.n_dispatched_ticks = 0
        self.n_mixed_slabs = 0
        self.n_prompt_tokens = 0
        self.n_cached_tokens = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- public API ---------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0,
               nonce: Optional[int] = None) -> Future:
        """``nonce`` pins the sampling-key salt instead of this engine's
        submission counter: two identically seeded engines given the
        same prompt and nonce produce identical streams. Must be in
        [0, 2**31)."""
        if len(prompt_ids) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt_ids)} + max_new_tokens "
                f"{max_new_tokens} exceeds engine max_len {self.max_len}")
        if not prompt_ids:
            raise ValueError("empty prompt")
        if nonce is not None and not 0 <= int(nonce) < 2 ** 31:
            raise ValueError(f"nonce {nonce} out of int32 range")
        req = _Request(prompt_ids, max_new_tokens, temperature)
        with self._mu:
            if self._closed:
                raise EngineClosed("engine closed")
            req.seq = self._nonce_seq
            req.nonce = req.seq if nonce is None else int(nonce)
            self._nonce_seq += 1
            self._pending.append(req)
        self._wake.set()
        return req.future

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[dict]:
        futs = [self.submit(p, max_new_tokens, temperature)
                for p in prompts]
        return [f.result() for f in futs]

    def close(self):
        with self._mu:
            self._closed = True
        self._wake.set()
        self._worker.join(timeout=60)
        if self._cache is not None and not self._worker.is_alive():
            # every request is resolved, so every shared page is at
            # refcount zero: the pool returns to its full free size
            self._free_pages.extend(self._cache.flush())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ----------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        if self._free_pages:
            return self._free_pages.pop()
        if self._cache is not None and self._cache.evictable_count:
            # LRU eviction over refcount-zero cached pages; pages mapped
            # by a live sequence are never candidates
            return self._cache.evict_one()
        return None

    def _avail_pages(self) -> int:
        """Pages the allocator could produce now (free + evictable)."""
        n = len(self._free_pages)
        if self._cache is not None:
            n += self._cache.evictable_count
        return n

    def _ensure_page(self, slot: int, pos: int) -> bool:
        """Page for token position ``pos`` allocated? Allocate on
        demand; False -> pool exhausted."""
        idx = pos // self.page_size
        if idx >= self.pages_per_seq:
            return False
        if self.block_tables[slot, idx] == 0:
            page = self._alloc_page()
            if page is None:
                return False
            self.block_tables[slot, idx] = page
        return True

    def _free_slot(self, slot: int):
        for page in map(int, self.block_tables[slot]):
            if page <= 0:
                continue
            if self._cache is not None and self._cache.is_shared(page):
                # drop this sequence's reference; at zero the page stays
                # cached (evictable)
                self._cache.release(page)
            else:
                self._free_pages.append(page)
        self.block_tables[slot] = 0
        self.context_lens[slot] = 0
        self._slots[slot] = None

    def _finish(self, slot: int):
        """Resolve and reclaim; called once the slot has no in-flight
        steps."""
        req = self._slots[slot]
        req.t_done = time.monotonic()
        self._free_slot(slot)
        if req.future.done():
            return
        req.future.set_result({
            "prompt_ids": req.prompt,
            "output_ids": req.tokens,
            "truncated": req.truncated,
            "ttft_s": (req.t_first - req.t_submit)
            if req.t_first else None,
            "latency_s": req.t_done - req.t_submit,
        })

    def _begin_close(self, slot: int, accept_inflight: bool = False):
        req = self._slots[slot]
        req.closing = True
        req.accepts_inflight = accept_inflight
        req.drain_after = self._issue_seq

    def _maybe_finalize(self):
        for slot, req in enumerate(self._slots):
            if req is not None and req.closing \
                    and self._fetch_seq >= req.drain_after:
                self._finish(slot)

    def _inflight_tokens(self, slot: int) -> int:
        """Tokens issued for ``slot`` and not fetched yet: one per step
        naming it, its entry budget for a slab."""
        n = 0
        for _, slots, _, kind, meta in self._inflight:
            if kind in ("D", "M"):
                n += meta["budgets"].get(slot, 0)
            elif slot in slots:
                n += 1
        return n

    def _admit(self, req: _Request) -> str:
        """"ok" (admitted), "retry" (out of slots/pages for now) or
        "never" (the prompt cannot fit this pool). Admission maps the
        cached prefix's pages read-only, reserves the suffix's pages and
        queues its prefill; no device work."""
        n = len(req.prompt)
        ps = self.page_size
        need = -(-n // ps)
        if need > min(self.num_pages - 1, self.pages_per_seq):
            return "never"
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            return "retry"
        matched: List[int] = []
        if self._cache is not None:
            if not req.digests:      # retries reuse the hashed prompt
                req.digests = page_digests(req.prompt, ps)
            # match up to the last full page <= n - 1 tokens: the last
            # prompt position's logits must be computed to sample
            matched = self._cache.lookup(req.digests[:(n - 1) // ps])
        m = len(matched)
        # matched pages in the LRU stop being evictable once acquired
        reserved = sum(self._cache.is_evictable(p) for p in matched) \
            if self._cache is not None else 0
        if need - m > self._avail_pages() - reserved:
            active = any(s is not None for s in self._slots)
            return "retry" if active else "never"
        for idx, page in enumerate(matched):
            self._cache.acquire(page)
            self.block_tables[slot, idx] = page
        for idx in range(m, need):
            self.block_tables[slot, idx] = self._alloc_page()
        req.slot = slot
        req.n_cached = m * ps
        req.prefill_pos = req.n_cached
        req.n_reg_pages = m
        self._slots[slot] = req
        self.temperatures[slot] = req.temperature
        self._nonces[slot] = req.nonce
        self._prefill_q.append(req)
        self.n_prompt_tokens += n
        self.n_cached_tokens += req.n_cached
        return "ok"

    def _register_pages(self, touched: List[_Request]):
        """Promote the full prompt pages a dispatch just wrote to shared
        (immutable from here on: every later write of the sequence lands
        at positions >= len(prompt)). The dispatch is on the stream
        before any later reader of the page."""
        if self._cache is None:
            return
        ps = self.page_size
        for req in touched:
            for i in range(req.n_reg_pages, req.prefill_pos // ps):
                self._cache.register(req.digests[i],
                                     int(self.block_tables[req.slot, i]),
                                     req.prompt[i * ps:(i + 1) * ps])
            req.n_reg_pages = max(req.n_reg_pages, req.prefill_pos // ps)

    def _harvest(self, slot: int) -> bool:
        """True if the slot's request is complete after its last
        token."""
        req = self._slots[slot]
        tok = req.tokens[-1]
        if self.eos_token_id is not None and tok == self.eos_token_id:
            return True
        return len(req.tokens) >= req.max_new_tokens

    def _live_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots)
                if s is not None and not s.closing and s.prefill_done]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _any_sampled(self, slots) -> bool:
        return bool((self.temperatures[list(slots)] > 0.0).any())

    def _pack_chunk(self, T: int, tok, pos, lim, tbl):
        """Fill one chunk's rows (the [T] / [T, P] arrays given) from
        the prefill queue's head request(s). Returns the requests whose
        rows it holds and, for those whose prompt completes in it,
        (request, row of its last prompt token)."""
        touched, finishing = [], []
        used = 0
        while self._prefill_q and used < T:
            req = self._prefill_q[0]
            n = len(req.prompt)
            take = min(T - used, n - req.prefill_pos)
            p = req.prefill_pos + np.arange(take)
            tok[used:used + take] = req.prompt[req.prefill_pos:
                                               req.prefill_pos + take]
            pos[used:used + take] = p
            lim[used:used + take] = p + 1
            tbl[used:used + take] = self.block_tables[req.slot]
            req.prefill_pos += take
            used += take
            touched.append(req)
            if req.prefill_pos >= n:
                self._prefill_q.popleft()
                finishing.append((req, used - 1))
            else:
                break   # chunk budget exhausted mid-prompt
        return touched, finishing

    def _prefill_tick(self):
        """ONE chunk of prefill work (the alternating loop): up to
        ``prefill_chunk`` prompt tokens from the queue's head
        request(s), packed ragged into one forward. Requests whose
        prompt completes here move to decode; their first token chains
        into ``_tokens_dev`` on the device and is fetched later like any
        decode token."""
        T = self.prefill_chunk
        tok = np.zeros((T,), np.int64)
        pos = np.zeros((T,), np.int64)
        lim = np.zeros((T,), np.int32)
        tbl = np.zeros((T, self.pages_per_seq), np.int32)
        sample_idx = np.zeros((self.max_seqs,), np.int64)
        sample_pos = np.zeros((self.max_seqs,), np.int64)
        touched, finishing = self._pack_chunk(T, tok, pos, lim, tbl)
        for req, row in finishing:
            sample_idx[req.slot] = row
            sample_pos[req.slot] = len(req.prompt) - 1
        nxt = self._chunk(
            self._dev(tok), self._dev(pos), self._dev(lim),
            self._dev(tbl), self._dev(sample_idx), self._dev(sample_pos),
            self.k_pages, self.v_pages, self._dev(self.temperatures),
            self._dev(self._nonces), self._key,
            any_sampled=self._any_sampled(r.slot for r, _ in finishing))
        if finishing:
            mask = np.zeros((self.max_seqs,), bool)
            for req, _ in finishing:
                mask[req.slot] = True
            self._tokens_dev = torch.where(self._dev(mask), nxt,
                                           self._tokens_dev)
            self._issue_seq += 1
            self._inflight.append((self._issue_seq,
                                   [r.slot for r, _ in finishing], nxt,
                                   "p", None))
            for req, _ in finishing:
                req.prefill_done = True
                self.context_lens[req.slot] = len(req.prompt)
        self._register_pages(touched)
        self.n_prefill_ticks += 1
        self.n_dispatched_ticks += 1

    def _issue(self, live: List[int]):
        """Dispatch ONE decode step for the live slots; tokens chain
        from the previous step on the device."""
        for slot in list(live):
            req = self._slots[slot]
            if len(req.tokens) + self._inflight_tokens(slot) >= \
                    req.max_new_tokens:
                # length completion is already certain on the host
                self._begin_close(slot, accept_inflight=True)
                live.remove(slot)
                continue
            pos = int(self.context_lens[slot])
            if pos >= self.max_len or not self._ensure_page(slot, pos):
                # the pool (or max_len) cannot hold the next token
                req.truncated = True
                self._begin_close(slot, accept_inflight=True)
                live.remove(slot)
        if not live:
            return
        positions = np.zeros((self.max_seqs,), np.int64)
        lens = np.zeros((self.max_seqs,), np.int32)
        for slot in live:
            positions[slot] = self.context_lens[slot]
            lens[slot] = self.context_lens[slot] + 1
        tokens = self._decode(
            self._tokens_dev, self._dev(positions),
            self._dev(self.block_tables), self._dev(lens), self.k_pages,
            self.v_pages, self._dev(self.temperatures),
            self._dev(self._nonces), self._key,
            any_sampled=self._any_sampled(live))
        self._tokens_dev = tokens
        self._issue_seq += 1
        self._inflight.append((self._issue_seq, list(live), tokens, "d",
                               None))
        for slot in live:
            self.context_lens[slot] += 1
        self.n_decode_ticks += 1
        self.n_dispatched_ticks += 1

    def _plan_slab(self, live: List[int], N: int):
        """The decode side of a slab, shared by the decode slab and the
        mixed slab. Per live slot: the tokens it still wants (length
        completion decided on the host, as in :meth:`_issue`), pages
        reserved for up to N tokens, truncation when even the next
        token cannot be covered (exactly N=1's decision), the slab
        shrunk to the smallest boundary every slot can cover, and pages
        reserved beyond it returned. Mutates ``live`` (closing finished
        or truncated slots). Returns ``(plan, entry_bud, n_eff)``:
        ``plan[slot] = (pos0, covered, want)`` and ``entry_bud[slot]``
        the slot's budget at slab entry."""
        ps = self.page_size
        plan: Dict[int, tuple] = {}
        new_pages: List[tuple] = []   # (slot, idx) allocated here
        for slot in list(live):
            req = self._slots[slot]
            want = req.max_new_tokens - len(req.tokens) - \
                self._inflight_tokens(slot)
            if want <= 0:
                self._begin_close(slot, accept_inflight=True)
                live.remove(slot)
                continue
            pos0 = int(self.context_lens[slot])
            covered = 0
            for j in range(min(N, want)):
                pos = pos0 + j
                if pos >= self.max_len:
                    break
                idx = pos // ps
                if self.block_tables[slot, idx] == 0:
                    page = self._alloc_page()
                    if page is None:
                        break
                    self.block_tables[slot, idx] = page
                    new_pages.append((slot, idx))
                covered += 1
            if covered == 0:
                req.truncated = True
                self._begin_close(slot, accept_inflight=True)
                live.remove(slot)
                continue
            plan[slot] = (pos0, covered, want)
        n_eff = N
        for pos0, covered, want in plan.values():
            if covered < min(N, want):
                n_eff = min(n_eff, covered)
        entry_bud = {slot: min(n_eff, want, covered)
                     for slot, (pos0, covered, want) in plan.items()}
        for slot, idx in new_pages:
            pos0 = plan[slot][0]
            if idx > (pos0 + entry_bud[slot] - 1) // ps:
                self._free_pages.append(int(self.block_tables[slot, idx]))
                self.block_tables[slot, idx] = 0
        return plan, entry_bud, n_eff

    def _run_slab(self, carry: DecodeCarry, n_ticks: int, any_sampled,
                  xs: Optional[dict] = None):
        """``n_ticks`` ticks issued back to back with no host read
        between them: each is the decode step (or, given the packed
        chunk rows ``xs``, the mixed tick) masked by ``budgets > 0``.
        A masked tick writes only scratch page 0 and holds the carry,
        so every tick runs (skipping an idle one would need the host to
        read the device). Returns ([n_ticks, max_seqs] tokens, carry)."""
        tables = self._dev(self.block_tables)
        temps = self._dev(self.temperatures)
        nonces = self._dev(self._nonces)
        c = carry
        toks = []
        for j in range(n_ticks):
            active = c.budgets > 0
            lens = torch.where(active, c.positions + 1,
                               torch.zeros_like(c.positions)).int()
            if xs is None:
                nxt = self._decode(c.tokens, c.positions, tables, lens,
                                   c.k_pages, c.v_pages, temps, nonces,
                                   self._key, any_sampled=any_sampled)
                fin = torch.zeros_like(active)
            else:
                fin = xs["fin"][j]
                nxt = self._mixed(
                    xs["tok"][j], xs["pos"][j], xs["lim"][j],
                    xs["tbl"][j], fin, xs["row"][j], xs["fpos"][j],
                    c.tokens, c.positions, lens, tables, c.k_pages,
                    c.v_pages, temps, nonces, self._key,
                    any_sampled=any_sampled)
            emits = active | fin
            budgets = torch.where(active, c.budgets - 1, c.budgets)
            positions = torch.where(active, c.positions + 1, c.positions)
            if xs is not None:
                # prompt completed this tick: its first token was just
                # sampled, grant - 1 tokens remain, next write at
                # len(prompt)
                budgets = torch.where(fin, xs["grant"][j] - 1, budgets)
                positions = torch.where(fin, xs["fpos"][j] + 1, positions)
            budgets = torch.where(emits & (nxt == self._eos),
                                  torch.zeros_like(budgets), budgets)
            c = c._replace(tokens=torch.where(emits, nxt, c.tokens),
                           positions=positions, budgets=budgets)
            toks.append(c.tokens)
        self.n_dispatched_ticks += n_ticks
        return torch.stack(toks), c

    def _carry(self, plan, budgets) -> DecodeCarry:
        pos = np.zeros((self.max_seqs,), np.int64)
        bud = np.zeros((self.max_seqs,), np.int64)
        for slot, b in budgets.items():
            pos[slot] = plan[slot][0]
            bud[slot] = b
        return DecodeCarry(tokens=self._tokens_dev,
                           positions=self._dev(pos),
                           budgets=self._dev(bud), k_pages=self.k_pages,
                           v_pages=self.v_pages)

    def _issue_slab(self, live: List[int]):
        """Up to ``decode_ticks_per_dispatch`` decode ticks for the live
        slots as one slab. The host plans budgets and reserves pages at
        entry (:meth:`_plan_slab`); EOS, sampling, position advance and
        page writes happen on the device; the drain replays the
        device's masking from the host copy of the entry budgets."""
        plan, budgets, n_eff = self._plan_slab(
            live, self.decode_ticks_per_dispatch)
        if not live:
            return
        toks, carry = self._run_slab(self._carry(plan, budgets), n_eff,
                                     self._any_sampled(live))
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        # context_lens advances at the DRAIN (mid-slab EOS decides how
        # far each slot went)
        self._inflight.append((self._issue_seq, list(live), toks, "D",
                               {"budgets": budgets,
                                "pos0": {s: plan[s][0] for s in live}}))

    def _issue_mixed(self, live: List[int]):
        """One MIXED slab: up to ``decode_ticks_per_dispatch`` ragged
        mixed ticks, each serving a ``prefill_chunk``-token slice of the
        prefill queue and the live slots' decode step as one forward
        (:class:`_MixedTick`). The decode side is planned as in
        :meth:`_issue_slab`; the prefill side packs the whole slab's
        chunk schedule, and a request whose prompt completes at tick j
        gets pages for and a grant of ``min(max_new_tokens, n_eff - j,
        coverable)`` tokens, installed into the carry at tick j so that
        it decodes from tick j + 1 on without the host."""
        N = self.decode_ticks_per_dispatch
        ps = self.page_size
        C = self.prefill_chunk
        plan, entry_bud, n_eff = self._plan_slab(live, N)
        # drain metadata: decode slots emit from tick 0 at pos0; slots
        # whose prompt completes start at their tick with pos0 =
        # len(prompt) - 1 (the first emission takes context to
        # len(prompt))
        meta_bud = dict(entry_bud)
        meta_pos0 = {s: plan[s][0] for s in plan}
        start: Dict[int, int] = {}
        B, P = self.max_seqs, self.pages_per_seq
        ptok = np.zeros((n_eff, C), np.int64)
        ppos = np.zeros((n_eff, C), np.int64)
        plim = np.zeros((n_eff, C), np.int32)
        ptbl = np.zeros((n_eff, C, P), np.int32)
        fin = np.zeros((n_eff, B), bool)
        fin_row = np.zeros((n_eff, B), np.int64)
        fin_pos = np.zeros((n_eff, B), np.int64)
        grant = np.zeros((n_eff, B), np.int64)
        touched: List[_Request] = []
        pticks = 0
        for j in range(n_eff):
            if not self._prefill_q:
                # queue drained: stop here; the next iteration's decode
                # slab serves the rest without padded chunk rows
                break
            tch, finishing = self._pack_chunk(C, ptok[j], ppos[j],
                                              plim[j], ptbl[j])
            touched += [r for r in tch if r not in touched]
            pticks += 1
            for req, row in finishing:
                n = len(req.prompt)
                # the first token plus as many decode ticks as the slab
                # has left and pages can cover (a clamped grant is no
                # truncation: the next slab entry re-plans)
                g = 1
                for tt in range(1, min(req.max_new_tokens, n_eff - j)):
                    pos = n + tt - 1
                    if pos >= self.max_len:
                        break
                    idx = pos // ps
                    if self.block_tables[req.slot, idx] == 0:
                        page = self._alloc_page()
                        if page is None:
                            break
                        self.block_tables[req.slot, idx] = page
                    g += 1
                fin[j, req.slot] = True
                fin_row[j, req.slot] = row
                fin_pos[j, req.slot] = n - 1
                grant[j, req.slot] = g
                start[req.slot] = j
                meta_bud[req.slot] = g
                meta_pos0[req.slot] = n - 1
                req.prefill_done = True
        # the slab runs as long as the prefill schedule needs, rounded
        # up to a power of two (the reference's bound on compiled
        # lengths; the padding ticks still decode), budgets and grants
        # clamped to it
        n_run = min(n_eff, 1 << (max(1, pticks) - 1).bit_length())
        for slot in list(meta_bud):
            j0 = start.get(slot, 0)
            meta_bud[slot] = min(meta_bud[slot], n_run - j0)
            if slot in start:
                grant[j0, slot] = meta_bud[slot]
        slots = sorted(meta_bud)
        xs = {"tok": ptok, "pos": ppos, "lim": plim, "tbl": ptbl,
              "fin": fin, "row": fin_row, "fpos": fin_pos,
              "grant": grant}
        xs = {k: self._dev(np.ascontiguousarray(v[:n_run]))
              for k, v in xs.items()}
        toks, carry = self._run_slab(
            self._carry(plan, {s: min(entry_bud[s], n_run)
                               for s in plan}),
            n_run, self._any_sampled(slots), xs)
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        self._inflight.append(
            (self._issue_seq, slots, toks, "M",
             {"budgets": meta_bud, "pos0": meta_pos0, "start": start}))
        self._register_pages(touched)
        self.n_mixed_slabs += 1
        self.n_prefill_ticks += pticks

    def _deliver_token(self, slot: int, req: _Request, tok: int):
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = time.monotonic()
        if self.eos_token_id is not None and tok == self.eos_token_id:
            req.accepts_inflight = False  # nothing after EOS
        if not req.closing and self._harvest(slot):
            self._begin_close(slot)

    def _wants(self, req: Optional[_Request]) -> bool:
        """Whether a fetched token still belongs to ``req`` (not an
        overrun token of a finished request)."""
        return req is not None and not (
            req.closing and (not req.accepts_inflight or
                             len(req.tokens) >= req.max_new_tokens))

    def _drain_one(self):
        """Fetch the oldest in-flight step's tokens and deliver them."""
        seq, slots, tokens, kind, meta = self._inflight.popleft()
        host = tokens.cpu().numpy()      # the only blocking fetch
        self._fetch_seq = seq
        if kind in ("D", "M"):
            self._drain_slab(slots, host, meta)
        else:
            for slot in slots:
                req = self._slots[slot]
                if self._wants(req):
                    self._deliver_token(slot, req, int(host[slot]))
        self._maybe_finalize()

    def _drain_slab(self, slots: List[int], host, meta: dict):
        """Deliver a slab's [n_ticks, max_seqs] tokens by replaying the
        device's masking from the host copy of the entry budgets: tick
        j delivers to every slot still active at j (budget left, no EOS
        yet; from its start tick for a prompt completed in the slab).
        Advances each slot's context length by its emitted count and
        counts the realized ticks."""
        remaining = dict(meta["budgets"])
        start = meta.get("start") or {}
        emitted = {s: 0 for s in slots}
        for j in range(host.shape[0]):
            for slot in slots:
                if j < start.get(slot, 0) or remaining.get(slot, 0) <= 0:
                    continue
                req = self._slots[slot]
                if not self._wants(req):
                    remaining[slot] = 0
                    continue
                tok = int(host[j, slot])
                remaining[slot] -= 1
                if tok == self._eos:
                    remaining[slot] = 0  # the device zeroed it too
                self._deliver_token(slot, req, tok)
                emitted[slot] += 1
        for slot in slots:
            if self._slots[slot] is not None:
                self.context_lens[slot] = meta["pos0"][slot] + \
                    emitted[slot]
        self.n_decode_ticks += max(emitted.values(), default=0)

    def _admit_pending(self, pending: List[_Request]):
        for req in sorted(pending, key=lambda r: r.seq):
            verdict = self._admit(req)
            if verdict == "never":
                req.future.set_exception(ValueError(
                    f"prompt of {len(req.prompt)} tokens cannot fit the "
                    f"KV page pool ({self.num_pages - 1} usable pages "
                    f"of {self.page_size} tokens, {self.pages_per_seq} "
                    f"pages/sequence)"))
            elif verdict == "retry":
                with self._mu:
                    self._pending.append(req)

    def _fail_all(self, err: Exception):
        """A device error: every slotted request fails with it (never a
        'successful' result), its pages return to the pool, and the
        engine keeps serving new requests."""
        self._inflight.clear()
        self._prefill_q.clear()
        self._fetch_seq = self._issue_seq
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._free_slot(slot)
            if not req.future.done():
                req.future.set_exception(err)
        if self._cache is not None:
            # every shared page is at refcount zero now; a failed call
            # may have left registered pages with wrong KV: drop them
            self._free_pages.extend(self._cache.flush())

    @torch.inference_mode()
    def _loop(self):
        while True:
            try:
                with self._mu:
                    closed = self._closed
                    pending, self._pending = self._pending, []
                self._admit_pending(pending)
                busy = False
                mixed = self.mixed_tick and bool(self._prefill_q)
                if mixed:
                    # ONE mixed slab: the prefill queue's chunk rows and
                    # the live slots' decode ticks ride one forward per
                    # tick
                    self._issue_mixed(self._live_slots())
                    busy = True
                elif self._prefill_q:
                    # the alternating loop: ONE chunk of prefill, then
                    # ONE decode step (or slab) below
                    self._prefill_tick()
                    busy = True
                live = [] if mixed else self._live_slots()
                if live and self.decode_ticks_per_dispatch > 1:
                    self._issue_slab(live)
                    busy = True
                elif live:
                    self._issue(live)
                    busy = True
                if busy:
                    # fetch with a lag; slabs (decode and mixed) drain
                    # to their boundary: the next slab's budgets need
                    # this one's realized EOS/length outcome
                    lag = 0 if (self.decode_ticks_per_dispatch > 1 or
                                self.mixed_tick) else self.lookahead
                    while len(self._inflight) > lag:
                        self._drain_one()
                    continue
                while self._inflight:   # nothing to issue: drain
                    self._drain_one()
                self._maybe_finalize()
                if not any(s is not None for s in self._slots):
                    if closed:
                        with self._mu:
                            leftovers, self._pending = self._pending, []
                        for req in leftovers:
                            req.future.set_exception(
                                EngineClosed("engine closed"))
                        return
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as e:  # noqa: BLE001 - resolve the futures
                self._fail_all(e)
