"""Continuous-batching LLM engine over a paged KV pool
(the port's counterpart of ``paddle_tpu/inference/llm.py``).

This slice ports the JAX engine's tick-by-tick loop: each loop
iteration runs ONE ragged prefill chunk (:class:`_ChunkedPrefill`,
``prefill_chunk`` prompt tokens drawn from the admitted requests), then
ONE decode step for the live slots (:class:`_PagedDecode`), then fetches
the sampled tokens in issue order. Every attention of both goes through
:func:`~paddle_tpu_torch.ops.paged_attention.ragged_paged_attention`,
kernel B4 on the GPU.

Page 0 of the pool is a scratch page: padding rows and inactive slots
write there, so every shape stays fixed. Sampling keys are
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
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from ..core import threefry
from ..core.device import resolve_device
from ..models.gpt import _lm_logits
from ..nn.layer import Layer
from ..ops.paged_attention import (KV_DTYPES, kv_layer, kv_page_size,
                                   kv_write, kv_zeros,
                                   ragged_paged_attention)
from ..ops.rotary import apply_rotary_pos_emb, rope_tables

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
        ps = kv_page_size(k_pages)
        pos_ids = positions[:, None]                        # [B, 1]
        x = gpt.embeddings(tokens[:, None], position_ids=pos_ids)
        # where each slot's new token lands in the pool; inactive slots
        # (context_len 0) write to scratch page 0
        page_idx = block_tables.gather(1, (positions // ps)[:, None])[:, 0]
        page_idx = torch.where(context_lens > 0, page_idx,
                               torch.zeros_like(page_idx)).long()
        offs = (positions % ps).long()
        rope = _rope(net.cfg, x.device)
        for i, layer in enumerate(gpt.layers):
            x = _layer_step(net, x, layer, i, pos_ids, rope, page_idx,
                            offs, k_pages, v_pages, block_tables,
                            context_lens, self.attention_impl)
        x = gpt.ln_f(x)
        logits = _lm_logits(net.cfg, gpt.embeddings, x,
                            getattr(net, "lm_head", None))[:, 0]
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
        net, gpt = self.net, self.net.gpt
        ps = kv_page_size(k_pages)
        pos_ids = positions[None, :]                        # [1, T]
        x = gpt.embeddings(tokens[None, :], position_ids=pos_ids)
        page_idx = tables.clamp(min=0).gather(
            1, (positions // ps)[:, None])[:, 0]
        page_idx = torch.where(limits > 0, page_idx,
                               torch.zeros_like(page_idx)).long()
        offs = (positions % ps).long()
        rope = _rope(net.cfg, x.device)
        for i, layer in enumerate(gpt.layers):
            x = _layer_step(net, x, layer, i, pos_ids, rope, page_idx,
                            offs, k_pages, v_pages, tables, limits,
                            self.attention_impl)
        x = gpt.ln_f(x)
        # only the finishing slots' last rows need the LM head
        rows = x[0][sample_idx.long()]                      # [B, H]
        logits = _lm_logits(net.cfg, gpt.embeddings, rows[:, None],
                            getattr(net, "lm_head", None))[:, 0]
        return _sample(logits, temperatures, key, nonces, sample_pos,
                       any_sampled)


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "future",
                 "tokens", "slot", "truncated", "t_submit", "t_first",
                 "t_done", "closing", "drain_after", "accepts_inflight",
                 "seq", "nonce", "prefill_pos", "prefill_done")

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

    This slice runs the JAX engine's alternating prefill-chunk /
    decode-step loop with ``lookahead=0``, and defaults the prefix cache
    and the mixed tick to OFF: the JAX package pins both token-identical
    to this loop. Arguments of features not ported yet (``draft_net``,
    ``mixed_tick=True``, ``decode_ticks_per_dispatch > 1``,
    ``lookahead > 0``, ``prefix_cache=True``) raise
    ``NotImplementedError`` naming their ROADMAP item.

    ``kv_dtype``: pool storage dtype, ``"f32"``/``"bf16"``/``"f16"`` or
    ``"int8"`` (quantized pages with per-row f32 scales; default
    ``FLAGS.kv_dtype``, else ``cache_dtype``). ``attention_impl``:
    ``"kernel"`` (kernel B4), ``"plain"`` or ``"reference"``."""

    def __init__(self, net, max_seqs: int = 8, page_size: int = 16,
                 num_pages: int = 512, max_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (64, 256, 1024),
                 eos_token_id: Optional[int] = None,
                 cache_dtype=torch.float32, seed: int = 0,
                 lookahead: int = 0, attention_impl: str = "kernel",
                 draft_net=None, prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 decode_ticks_per_dispatch: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 mixed_tick: Optional[bool] = None, device=None):
        if draft_net is not None:
            raise _not_ported("draft_net=...", "speculative decoding")
        if prefix_cache:
            raise _not_ported("prefix_cache=True", "prefix cache")
        if lookahead:
            raise _not_ported("lookahead>0", "lookahead")
        if mixed_tick is None:
            mixed_tick = _flags.get_flag("mixed_tick")
        if mixed_tick:
            raise _not_ported("mixed_tick=True", "mixed tick")
        if decode_ticks_per_dispatch is None:
            decode_ticks_per_dispatch = _flags.get_flag(
                "decode_ticks_per_dispatch")
        if int(decode_ticks_per_dispatch) > 1:
            raise _not_ported("decode_ticks_per_dispatch>1",
                              "decode slab")
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
        self._slots: List[Optional[_Request]] = [None] * max_seqs
        # device-chained last tokens (authoritative between fetches)
        self._tokens_dev = torch.zeros((max_seqs,), dtype=torch.int64,
                                       device=self.device)
        self._key = threefry.prng_key(seed, device=self.device)
        self._decode = _PagedDecode(self.net, attention_impl)
        self._chunk = _ChunkedPrefill(self.net, attention_impl)
        # (issue_seq, slots, device tokens [max_seqs]) of each issued
        # prefill chunk that completes prompts and of each decode step
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- scheduler ----------------------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        return self._free_pages.pop() if self._free_pages else None

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
        for page in self.block_tables[slot]:
            if page > 0:
                self._free_pages.append(int(page))
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
        return sum(1 for _, slots, _ in self._inflight if slot in slots)

    def _admit(self, req: _Request) -> str:
        """"ok" (admitted), "retry" (out of slots/pages for now) or
        "never" (the prompt cannot fit this pool). Admission reserves
        the prompt's pages and queues its prefill; no device work."""
        n = len(req.prompt)
        need = -(-n // self.page_size)
        if need > min(self.num_pages - 1, self.pages_per_seq):
            return "never"
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            return "retry"
        if need > len(self._free_pages):
            active = any(s is not None for s in self._slots)
            return "retry" if active else "never"
        for idx in range(need):
            self.block_tables[slot, idx] = self._alloc_page()
        req.slot = slot
        self._slots[slot] = req
        self.temperatures[slot] = req.temperature
        self._nonces[slot] = req.nonce
        self._prefill_q.append(req)
        return "ok"

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

    def _prefill_tick(self):
        """ONE chunk of prefill work: up to ``prefill_chunk`` prompt
        tokens from the queue's head request(s), packed ragged into one
        forward. Requests whose prompt completes here move to decode;
        their first token chains into ``_tokens_dev`` on the device and
        is fetched later like any decode token."""
        T = self.prefill_chunk
        tok = np.zeros((T,), np.int64)
        pos = np.zeros((T,), np.int64)
        lim = np.zeros((T,), np.int32)
        tbl = np.zeros((T, self.pages_per_seq), np.int32)
        sample_idx = np.zeros((self.max_seqs,), np.int64)
        sample_pos = np.zeros((self.max_seqs,), np.int64)
        finishing: List[_Request] = []
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
            if req.prefill_pos >= n:
                self._prefill_q.popleft()
                finishing.append(req)
                sample_idx[req.slot] = used - 1
                sample_pos[req.slot] = n - 1
            else:
                break   # chunk budget exhausted mid-prompt
        nxt = self._chunk(
            self._dev(tok), self._dev(pos), self._dev(lim),
            self._dev(tbl), self._dev(sample_idx), self._dev(sample_pos),
            self.k_pages, self.v_pages, self._dev(self.temperatures),
            self._dev(self._nonces), self._key,
            any_sampled=self._any_sampled(r.slot for r in finishing))
        if finishing:
            mask = np.zeros((self.max_seqs,), bool)
            for req in finishing:
                mask[req.slot] = True
            self._tokens_dev = torch.where(self._dev(mask), nxt,
                                           self._tokens_dev)
            self._issue_seq += 1
            self._inflight.append((self._issue_seq,
                                   [r.slot for r in finishing], nxt))
            for req in finishing:
                req.prefill_done = True
                self.context_lens[req.slot] = len(req.prompt)
        self.n_prefill_ticks += 1

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
        self._inflight.append((self._issue_seq, list(live), tokens))
        for slot in live:
            self.context_lens[slot] += 1
        self.n_decode_ticks += 1

    def _deliver_token(self, slot: int, req: _Request, tok: int):
        req.tokens.append(tok)
        if req.t_first is None:
            req.t_first = time.monotonic()
        if self.eos_token_id is not None and tok == self.eos_token_id:
            req.accepts_inflight = False  # nothing after EOS
        if not req.closing and self._harvest(slot):
            self._begin_close(slot)

    def _drain_one(self):
        """Fetch the oldest in-flight step's tokens and deliver them."""
        seq, slots, tokens = self._inflight.popleft()
        host = tokens.cpu().numpy()      # the only blocking fetch
        self._fetch_seq = seq
        for slot in slots:
            req = self._slots[slot]
            if req is None:
                continue
            if req.closing and (not req.accepts_inflight or
                                len(req.tokens) >= req.max_new_tokens):
                continue  # overrun token of a finished request
            self._deliver_token(slot, req, int(host[slot]))
        self._maybe_finalize()

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

    @torch.inference_mode()
    def _loop(self):
        while True:
            try:
                with self._mu:
                    closed = self._closed
                    pending, self._pending = self._pending, []
                self._admit_pending(pending)
                busy = False
                if self._prefill_q:
                    # ONE chunk of prefill, then ONE decode step: a long
                    # prompt's chunks interleave with decode steps
                    self._prefill_tick()
                    busy = True
                live = self._live_slots()
                if live:
                    self._issue(live)
                    busy = True
                while self._inflight:
                    self._drain_one()
                self._maybe_finalize()
                if not busy and not any(s is not None
                                        for s in self._slots):
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
