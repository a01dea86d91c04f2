"""Continuous-batching LLM engine over a paged KV pool
(the port's counterpart of ``paddle_tpu/inference/llm.py``).

The default engine runs the JAX engine's default serving path: chunked
ragged prefill over a refcounted prefix cache (:mod:`.prefix_cache`),
served as ONE ragged mixed tick of prefill chunk rows and decode rows
(:class:`_MixedTick`) inside a :class:`DecodeCarry` slab of
``decode_ticks_per_dispatch`` ticks, with pure decode steps
(:class:`_PagedDecode`) or decode slabs once the prefill queue is empty.
``mixed_tick=False`` keeps the alternating prefill-chunk / decode-step
loop (:class:`_ChunkedPrefill`), which ``lookahead > 0`` needs. With a
``draft_net`` the engine decodes speculatively: rounds of K chained
draft probes, one ragged verify window (:class:`_PagedVerify`) and the
accept rule (:func:`_spec_accept`), N rounds to a slab, or the legacy
host-paced greedy round. Every paged attention goes through
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
    rows, and rows past their table's end (a verify window or draft
    probe running past ``max_len``), go to scratch page 0."""
    idx = positions // page_size
    inside = idx < tables.shape[1]
    page_idx = tables.clamp(min=0).gather(
        1, idx.clamp(max=tables.shape[1] - 1)[:, None])[:, 0]
    page_idx = torch.where(active & inside, page_idx,
                           torch.zeros_like(page_idx))
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


# speculative-sampling key salts, folded into the engine key before the
# (nonce, position) folds: every random decision of a round depends only
# on what is sampled and never collides with the plain _sample keys.
# DRAFT salts the draft's proposals, ACCEPT the rejection test, RESID the
# residual sample at the first rejection.
_SPEC_DRAFT_SALT = 0x5D
_SPEC_ACCEPT_SALT = 0x5A
_SPEC_RESID_SALT = 0x5B


def _salted_keys(key, salt, nonces, positions):
    return threefry.fold_in(threefry.fold_in(threefry.fold_in(key, salt),
                                             nonces), positions)


def _softmax(x):
    """``jax.nn.softmax`` over the last axis, written as it is."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _spec_accept(tokens_mat, draft_logits, verify_logits, temps, nonces,
                 positions, key, any_sampled: bool = True):
    """The speculative accept/commit rule (B slots, K = spec_tokens).

    ``tokens_mat`` [B, K]: the verify window, the committed last token t0
    and the K-1 proposals; ``draft_logits`` [B, K-1, V]: the draft
    distribution each proposal was sampled from; ``verify_logits`` [B, K,
    V]: the target's logits after each window token; ``temps``,
    ``nonces``, ``positions`` [B]: temperature, key salt and t0's feed
    position (decision i keys on ``positions + i``).

    Returns ``(out, n_acc)``: ``out`` [B, K] holds the accepted proposals
    in columns ``0..n_acc-1`` and the committed correction or bonus in
    column ``n_acc``; a round commits ``n_acc + 1`` tokens before
    clamping. Greedy rows accept the prefix of proposals equal to
    argmax(p_i), so their tokens are the plain greedy chain whatever the
    draft. T > 0 rows accept proposal t ~ q_i when u * q_i(t) <= p_i(t)
    and at the first rejection commit a sample of normalize(max(p_i -
    q_i, 0)) (p_i where that is all zero); when all K-1 are accepted the
    bonus is a plain :func:`_sample` of p_{K-1}. ``any_sampled=False``
    (no row has T > 0) skips the random draws."""
    kq = tokens_mat.shape[1]
    greedy_v = torch.argmax(verify_logits, dim=-1)            # [B, K]
    props = tokens_mat[:, 1:]                                 # [B, K-1]
    accept = props == greedy_v[:, :kq - 1]
    sampled = temps > 0.0
    if any_sampled:
        t_inv = (1.0 / torch.clamp(temps, min=1e-6))[:, None, None]
        p_all = _softmax(verify_logits * t_inv)
        q_all = _softmax(draft_logits * t_inv)
        p_at = p_all[:, :kq - 1].gather(2, props[..., None])[..., 0]
        q_at = q_all.gather(2, props[..., None])[..., 0]
        u = torch.stack([
            threefry.uniform(_salted_keys(key, _SPEC_ACCEPT_SALT, nonces,
                                          positions + i), ())
            for i in range(kq - 1)], dim=1)
        accept = torch.where(sampled[:, None], u * q_at <= p_at, accept)
    n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)    # [B]
    # the correction at the break index a < K-1: argmax(p_a) for greedy
    # rows, a residual sample for T > 0 rows
    ia = n_acc.clamp(0, kq - 2)
    corr = greedy_v.gather(1, ia[:, None])[:, 0]
    if any_sampled:
        at = ia[:, None, None].expand(-1, 1, p_all.shape[-1])
        p_a = p_all.gather(1, at)[:, 0]
        q_a = q_all.gather(1, at)[:, 0]
        resid = torch.clamp(p_a - q_a, min=0.0)
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid,
                            p_a)
        rtok = threefry.categorical(
            _salted_keys(key, _SPEC_RESID_SALT, nonces, positions + ia),
            torch.log(resid))
        corr = torch.where(sampled, rtok, corr)
    bonus = _sample(verify_logits[:, kq - 1], temps, key, nonces,
                    positions + kq - 1, any_sampled)
    corr = torch.where(n_acc == kq - 1, bonus, corr)
    idx = torch.arange(kq, device=tokens_mat.device)[None, :]
    shifted = torch.cat([props, props[:, -1:]], dim=1)
    out = torch.where(idx < n_acc[:, None], shifted, corr[:, None])
    return out, n_acc


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
    completes.

    ``draft_k_pages`` / ``draft_v_pages`` (spec slab engines only, else
    ``None``): the draft model's paged pool, with its own layer and head
    dims and the same page allocator and block tables. A spec round's K
    draft probes write there and its verify window writes the target
    pool; ``positions`` then advances by the committed run, and rejected
    KV stays beyond it, overwritten before any later round reads it."""

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
    the next token on the device. The pool is updated in place.

    ``return_logits``: also return the [B, V] logits the token was
    sampled from (the spec slab's draft probe, whose distribution q_i is
    the rejection test's denominator)."""

    def __init__(self, net, attention_impl: str = "kernel",
                 return_logits: bool = False):
        super().__init__()
        self.net = net
        self.attention_impl = attention_impl
        self.return_logits = return_logits

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
        nxt = _sample(logits, temperature, key, nonces, positions,
                      any_sampled)
        return (nxt, logits) if self.return_logits else nxt


class _PagedVerify(Layer):
    """The speculative verify pass: K tokens per slot (the committed last
    token and K-1 draft proposals) through the target in one ragged
    forward of B x K rows. Row j of slot b sits at ``base_lens[b] + j``
    and attends up to ``base_lens[b] + j + 1`` over the slot's table,
    repeated K times (inactive slots, ``base_lens`` 0, write scratch page
    0), so it sees exactly the context the j-th sequential decode step
    would. A limit past the table's span is cut to it (such a row sees
    the whole table, as in the plain twin), so B4 never reads past a
    table row. Returns the target's logits [B, K, V]."""

    def __init__(self, net, attention_impl: str = "kernel"):
        super().__init__()
        self.net = net
        self.attention_impl = attention_impl

    def forward(self, tokens, base_lens, block_tables, k_pages, v_pages):
        b, kq = tokens.shape
        pos = base_lens[:, None] + torch.arange(kq, device=tokens.device)
        span = block_tables.shape[1] * kv_page_size(k_pages)
        lim = torch.where(base_lens[:, None] > 0, pos + 1,
                          torch.zeros_like(pos)).clamp(max=span).int()
        x = _ragged_forward(self.net, tokens.reshape(-1), pos.reshape(-1),
                            lim.reshape(-1),
                            block_tables.repeat_interleave(kq, dim=0),
                            k_pages, v_pages, self.attention_impl)
        return _lm_rows(self.net, x).reshape(b, kq, -1)


class _PagedPrefill(Layer):
    """The legacy speculative path's one-shot prompt prefill of ONE
    sequence: a dense causal forward over the prompt padded to a bucket
    (``net.init_caches`` / ``forward(caches=...)``), its per-layer K/V
    scattered into the sequence's pages (padding positions to scratch
    page 0), and the first token sampled from the last prompt row."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, ids, true_len: int, block_row, k_pages, v_pages,
                temperature, nonce, key, any_sampled: bool = True):
        s = ids.shape[1]
        ps = kv_page_size(k_pages)
        caches = self.net.init_caches(1, s, dtype=k_pages.dtype)
        logits, caches = self.net(ids, caches=caches)
        pos = torch.arange(s, device=ids.device)
        page_idx = torch.where(pos < true_len, block_row.long()[pos // ps],
                               torch.zeros_like(pos))
        offs = pos % ps
        for i, (k_c, v_c, _) in enumerate(caches):
            kv_write(k_pages, i, page_idx, offs, k_c[0])
            kv_write(v_pages, i, page_idx, offs, v_c[0])
        last = torch.full((1,), true_len - 1, dtype=torch.int64,
                          device=ids.device)
        return _sample(logits[0, true_len - 1][None], temperature[None],
                       key, nonce[None], last, any_sampled)[0]


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
    these.

    ``draft_net`` / ``spec_tokens`` (K, default 4): speculative decoding.
    A draft model with the target's vocabulary proposes K - 1 tokens a
    round through its own paged pool (same page allocator and block
    tables, int8 included), and one target pass verifies them
    (:class:`_PagedVerify`). ``spec_slab`` (default ``FLAGS.spec_slab``,
    on): ``decode_ticks_per_dispatch`` whole rounds run back to back on
    the device with no host read (:meth:`_issue_spec_slab`); greedy rows
    are token-identical to plain decoding whatever the draft, and
    ``temperature > 0`` rows are served by rejection sampling, keyed on
    (nonce, position) only. Every prompt chunk also runs through the
    draft into its pool, so the prefix cache and the mixed tick stay on;
    a mixed slab gives a spec engine each prompt's first token only.
    ``spec_slab=False``: the legacy host-paced round (greedy only, the
    prompt prefilled densely in one bucket, no prefix cache, no int8,
    one round per host read; ``decode_ticks_per_dispatch`` clamps to 1
    and ``mixed_tick`` off). Neither mode composes with ``lookahead``.

    ``kv_dtype``: pool storage dtype, ``"f32"``/``"bf16"``/``"f16"`` or
    ``"int8"`` (quantized pages with per-row f32 scales; default
    ``FLAGS.kv_dtype``, else ``cache_dtype``). ``attention_impl``:
    ``"kernel"`` (kernel B4), ``"plain"`` or ``"reference"``.

    Counters: ``n_prefill_ticks`` (chunks of prefill work),
    ``n_decode_ticks`` (decode ticks that emitted a token),
    ``n_dispatched_ticks`` (paged forward passes of the target issued,
    masked slab ticks and verify passes included: one attention launch
    per layer each; the legacy dense prefill is not one),
    ``n_draft_passes`` (the same for the draft: prompt chunks and
    probes), ``n_mixed_slabs``, ``n_prompt_tokens`` and
    ``n_cached_tokens``; for speculative engines ``n_spec_rounds``
    (rounds that emitted), ``n_draft_steps`` (K per such round),
    ``n_spec_proposed`` and ``n_spec_accepted`` (draft tokens offered to
    and committed by the verifier)."""

    def __init__(self, net, max_seqs: int = 8, page_size: int = 16,
                 num_pages: int = 512, max_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (64, 256, 1024),
                 eos_token_id: Optional[int] = None,
                 cache_dtype=torch.float32, seed: int = 0,
                 lookahead: int = 0, attention_impl: str = "kernel",
                 draft_net=None, spec_tokens: int = 4,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 decode_ticks_per_dispatch: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 mixed_tick: Optional[bool] = None,
                 spec_slab: Optional[bool] = None, device=None):
        if spec_slab is None:
            spec_slab = _flags.get_flag("spec_slab")
        self.spec_slab = bool(spec_slab) and draft_net is not None
        legacy_spec = draft_net is not None and not self.spec_slab
        self.lookahead = int(lookahead)
        if decode_ticks_per_dispatch is None:
            decode_ticks_per_dispatch = _flags.get_flag(
                "decode_ticks_per_dispatch")
        self.decode_ticks_per_dispatch = max(
            1, int(decode_ticks_per_dispatch))
        if legacy_spec:
            self.decode_ticks_per_dispatch = 1
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
        self.mixed_tick = bool(mixed_tick) and not legacy_spec
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
        if kv_dtype == "int8" and legacy_spec:
            raise ValueError(
                "kv_dtype='int8' does not compose with the legacy inline "
                "speculative path (spec_slab=False): its dense prefill "
                "writes plain pages. The spec slab (spec_slab=True, the "
                "default) runs a quantized draft pool; use it, or drop "
                "int8")
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
        # the legacy speculative path prefills inline and keeps no cache
        self._cache = PrefixCache(page_size) \
            if prefix_cache and not legacy_spec else None
        self._slots: List[Optional[_Request]] = [None] * max_seqs
        # device-chained last tokens (authoritative between fetches)
        self._tokens_dev = torch.zeros((max_seqs,), dtype=torch.int64,
                                       device=self.device)
        self._key = threefry.prng_key(seed, device=self.device)
        self._eos = -1 if eos_token_id is None else int(eos_token_id)
        self._decode = _PagedDecode(self.net, attention_impl)
        self._chunk = _ChunkedPrefill(self.net, attention_impl)
        self._mixed = _MixedTick(self.net, attention_impl)
        self.spec_k = 0
        self.draft_k_pages = self.draft_v_pages = None
        if draft_net is not None:
            if self.lookahead:
                raise ValueError(
                    "speculative decoding does not compose with "
                    "lookahead (the verify fetch is the round barrier)")
            if spec_tokens < 2:
                raise ValueError("spec_tokens must be >= 2")
            if draft_net.cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary")
            self.spec_k = int(spec_tokens)
            self.draft_net = draft_net.to(self.device).eval()
            dcfg = draft_net.cfg
            # the draft's own pool: its dims, the target's pages and
            # tables (a page id holds both models' KV of the same tokens)
            dshape = (dcfg.num_layers, num_pages, page_size,
                      dcfg.num_kv_heads, dcfg.head_dim)
            self.draft_k_pages = kv_zeros(dshape, kv_dtype, self.device)
            self.draft_v_pages = kv_zeros(dshape, kv_dtype, self.device)
            self._draft_decode = _PagedDecode(self.draft_net,
                                              attention_impl,
                                              return_logits=True)
            self._verify = _PagedVerify(self.net, attention_impl)
            if legacy_spec:
                self._prefill = _PagedPrefill(self.net)
                self._draft_prefill = _PagedPrefill(self.draft_net)
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
        self.n_draft_passes = 0
        self.n_spec_rounds = 0
        self.n_draft_steps = 0
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
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
        legacy_spec = self.spec_k and not self.spec_slab
        if legacy_spec and len(prompt_ids) > self.prefill_buckets[-1]:
            # only the legacy inline prefill is bucket-shaped
            raise ValueError(
                f"prompt {len(prompt_ids)} exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}; raise "
                f"prefill_buckets")
        if not prompt_ids:
            raise ValueError("empty prompt")
        if legacy_spec and temperature > 0.0:
            raise ValueError(
                "the legacy speculative path (spec_slab=False) is "
                "greedy-only; spec slab engines (spec_slab=True, the "
                "default) serve temperature > 0 by rejection sampling")
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
            if kind in ("D", "M", "S"):
                n += meta["budgets"].get(slot, 0)
            elif slot in slots:
                n += 1
        return n

    def _admit(self, req: _Request) -> str:
        """"ok" (admitted), "retry" (out of slots/pages for now) or
        "never" (the prompt cannot fit this pool). Admission maps the
        cached prefix's pages read-only, reserves the suffix's pages and
        queues its prefill; no device work. A legacy speculative engine
        prefills inline instead (:meth:`_admit_inline`)."""
        if self.spec_k and not self.spec_slab:
            return self._admit_inline(req)
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

    def _bucket(self, n: int) -> int:
        return next((b for b in self.prefill_buckets if n <= b),
                    self.prefill_buckets[-1])

    def _admit_inline(self, req: _Request) -> str:
        """The legacy speculative path's admission: the whole prompt
        through :class:`_PagedPrefill` at its bucket, into the target's
        pages and the draft's (whose sampled token is discarded); the
        first token chains into ``_tokens_dev`` and is fetched like a
        decode token."""
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
        # the slot owns the request before any page or device call, so a
        # failing prefill returns its pages through _fail_all
        req.slot = slot
        self._slots[slot] = req
        for idx in range(need):
            self.block_tables[slot, idx] = self._alloc_page()
        ids = np.zeros((1, self._bucket(n)), np.int64)
        ids[0, :n] = req.prompt
        ids, row = self._dev(ids), self._dev(self.block_tables[slot])
        nonce = torch.tensor(req.nonce, device=self.device)
        nxt = self._prefill(
            ids, n, row, self.k_pages, self.v_pages,
            torch.tensor(req.temperature, device=self.device), nonce,
            self._key, any_sampled=req.temperature > 0.0)
        self._draft_prefill(ids, n, row, self.draft_k_pages,
                            self.draft_v_pages,
                            torch.zeros((), device=self.device), nonce,
                            self._key, any_sampled=False)
        tokens = self._tokens_dev.clone()
        tokens[slot] = nxt
        self._tokens_dev = tokens
        self._issue_seq += 1
        self._inflight.append((self._issue_seq, [slot], tokens, "p", None))
        req.prefill_done = True
        self.context_lens[slot] = n
        self.temperatures[slot] = req.temperature
        self._nonces[slot] = req.nonce
        self.n_prompt_tokens += n
        return "ok"

    def _draft_fill(self, tok, pos, lim, tbl):
        """The draft's ride-along over a packed chunk schedule (device
        tensors [T] / [T, P]): the same rows through the draft net into
        its pool, so every prompt position a verify window reads has
        draft KV. Prefill and quantize-on-write are deterministic, so a
        shared prefix page holds the same draft KV for every request
        that maps it."""
        _ragged_forward(self.draft_net, tok, pos, lim, tbl,
                        self.draft_k_pages, self.draft_v_pages,
                        self._draft_decode.attention_impl)
        self.n_draft_passes += 1

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
        tok, pos, lim, tbl = map(self._dev, (tok, pos, lim, tbl))
        nxt = self._chunk(
            tok, pos, lim, tbl, self._dev(sample_idx),
            self._dev(sample_pos), self.k_pages, self.v_pages,
            self._dev(self.temperatures), self._dev(self._nonces),
            self._key,
            any_sampled=self._any_sampled(r.slot for r, _ in finishing))
        if self.spec_slab:
            self._draft_fill(tok, pos, lim, tbl)
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

    def _carry(self, pos0, budgets) -> DecodeCarry:
        """The carry at slab entry: ``pos0[slot]`` and ``budgets[slot]``
        for the slots given, budget 0 (masked) for the rest."""
        pos = np.zeros((self.max_seqs,), np.int64)
        bud = np.zeros((self.max_seqs,), np.int64)
        for slot, b in budgets.items():
            pos[slot] = pos0[slot]
            bud[slot] = b
        return DecodeCarry(tokens=self._tokens_dev,
                           positions=self._dev(pos),
                           budgets=self._dev(bud), k_pages=self.k_pages,
                           v_pages=self.v_pages,
                           draft_k_pages=self.draft_k_pages,
                           draft_v_pages=self.draft_v_pages)

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
        pos0 = {s: plan[s][0] for s in live}
        toks, carry = self._run_slab(self._carry(pos0, budgets), n_eff,
                                     self._any_sampled(live))
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        # context_lens advances at the DRAIN (mid-slab EOS decides how
        # far each slot went)
        self._inflight.append((self._issue_seq, list(live), toks, "D",
                               {"budgets": budgets, "pos0": pos0}))

    def _issue_mixed(self, live: List[int]):
        """One MIXED slab: up to ``decode_ticks_per_dispatch`` ragged
        mixed ticks, each serving a ``prefill_chunk``-token slice of the
        prefill queue and the live slots' decode step as one forward
        (:class:`_MixedTick`). The decode side is planned as in
        :meth:`_issue_slab`; the prefill side packs the whole slab's
        chunk schedule, and a request whose prompt completes at tick j
        gets pages for and a grant of ``min(max_new_tokens, n_eff - j,
        coverable)`` tokens, installed into the carry at tick j so that
        it decodes from tick j + 1 on without the host. A speculative
        engine calls it with no live slots and takes each prompt's first
        token only (its decode belongs to :meth:`_issue_spec_slab`,
        whose rounds keep the draft pool complete), and the draft rides
        along over the slab's whole chunk schedule."""
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
                g_want = 1 if self.spec_k else \
                    min(req.max_new_tokens, n_eff - j)
                g = 1
                for tt in range(1, g_want):
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
            self._carry({s: plan[s][0] for s in plan},
                        {s: min(entry_bud[s], n_run) for s in plan}),
            n_run, self._any_sampled(slots), xs)
        if self.spec_slab:
            # padding rows carry limit 0 and write scratch page 0
            self._draft_fill(xs["tok"].reshape(-1), xs["pos"].reshape(-1),
                             xs["lim"].reshape(-1),
                             xs["tbl"].reshape(-1, self.pages_per_seq))
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        self._inflight.append(
            (self._issue_seq, slots, toks, "M",
             {"budgets": meta_bud, "pos0": meta_pos0, "start": start}))
        self._register_pages(touched)
        self.n_mixed_slabs += 1
        self.n_prefill_ticks += pticks

    def _issue_spec_slab(self, live: List[int]):
        """Up to ``decode_ticks_per_dispatch`` speculative rounds for the
        live slots as one slab (:meth:`_run_spec_slab`). In-flight
        records drain first: a prompt's first token must land before the
        budgets are planned. At entry the host plans each slot's budget
        and reserves pages for every position the slab could commit (up
        to N x K); ``cov`` carries the covered frontier to the device,
        which clamps each round's acceptance to ``cov - position``. Pages
        reserved past what the rounds commit stay with their slot."""
        while self._inflight:
            self._drain_one()
        live = [s for s in live if self._slots[s] is not None
                and not self._slots[s].closing]
        N, K = self.decode_ticks_per_dispatch, self.spec_k
        budgets: Dict[int, int] = {}
        pos0s: Dict[int, int] = {}
        cov = np.zeros((self.max_seqs,), np.int64)
        for slot in list(live):
            req = self._slots[slot]
            want = req.max_new_tokens - len(req.tokens)
            if want <= 0:
                self._begin_close(slot, accept_inflight=True)
                live.remove(slot)
                continue
            pos0 = int(self.context_lens[slot])
            covered = 0
            for j in range(min(N * K, want)):
                pos = pos0 + j
                if pos >= self.max_len or not self._ensure_page(slot, pos):
                    break
                covered += 1
            if covered == 0:
                # the next token cannot be cached: plain decode's
                # truncation
                req.truncated = len(req.tokens) < req.max_new_tokens
                self._begin_close(slot)
                live.remove(slot)
                continue
            budgets[slot] = min(want, covered)
            pos0s[slot] = pos0
            cov[slot] = pos0 + covered
        if not live:
            self._maybe_finalize()
            return
        # every active round commits >= 1 token a slot, so rounds past
        # the largest budget would all be idle
        n_run = min(N, max(budgets.values()))
        ys, carry = self._run_spec_slab(self._carry(pos0s, budgets),
                                        self._dev(cov), n_run,
                                        self._any_sampled(live))
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        # context_lens advances at the drain, from the realized counts
        self._inflight.append((self._issue_seq, list(live), ys, "S",
                               {"budgets": budgets, "pos0": pos0s}))

    def _run_spec_slab(self, carry: DecodeCarry, cov, n_rounds: int,
                       any_sampled: bool):
        """``n_rounds`` speculative rounds back to back with no host read.
        A round: K chained draft probes at positions p .. p+K-1 (the K-th
        only writes draft KV, so a fully accepted round leaves no gap;
        probes past ``cap = cov - p`` write scratch), one verify window,
        :func:`_spec_accept`, the clamp ``n_emit = min(n_acc + 1, budget,
        cap)``, EOS on the device, and the carry advanced by the
        committed run. A slot with budget 0 is masked; a round with no
        active slot still runs (skipping it would need a host read), so
        B4's launches follow the rounds dispatched. Returns ((tokens [n,
        B, K], n_emit [n, B]), carry)."""
        tables = self._dev(self.block_tables)
        temps = self._dev(self.temperatures)
        nonces = self._dev(self._nonces)
        dkey = threefry.fold_in(self._key, _SPEC_DRAFT_SALT)
        K = self.spec_k
        cols = torch.arange(K, device=self.device)[None, :]
        c = carry
        outs, emits = [], []
        for _ in range(n_rounds):
            active = c.budgets > 0
            zero = torch.zeros_like(c.positions)
            cap = torch.where(active, cov - c.positions, zero).clamp(0, K)
            cur, tok_cols, dlog_cols = c.tokens, [c.tokens], []
            for j in range(K):
                lens = torch.where(active & (j < cap), c.positions + j + 1,
                                   zero).int()
                cur, dlg = self._draft_decode(
                    cur, c.positions + j, tables, lens, c.draft_k_pages,
                    c.draft_v_pages, temps, nonces, dkey,
                    any_sampled=any_sampled)
                if j < K - 1:
                    tok_cols.append(cur)
                    dlog_cols.append(dlg)
            tokens_mat = torch.stack(tok_cols, dim=1)
            vlg = self._verify(tokens_mat, torch.where(active, c.positions,
                                                       zero),
                               tables, c.k_pages, c.v_pages)
            out, n_acc = _spec_accept(tokens_mat,
                                      torch.stack(dlog_cols, dim=1), vlg,
                                      temps, nonces, c.positions,
                                      self._key, any_sampled)
            n_emit = torch.minimum(n_acc + 1, torch.minimum(c.budgets, cap))
            n_emit = torch.where(active, n_emit, zero)
            is_eos = (cols < n_emit[:, None]) & (out == self._eos)
            any_eos = is_eos.any(dim=1)
            n_emit = torch.where(any_eos, is_eos.int().argmax(dim=1) + 1,
                                 n_emit)
            last = out.gather(1, (n_emit - 1).clamp(min=0)[:, None])[:, 0]
            budgets = torch.where(active, c.budgets - n_emit, c.budgets)
            c = c._replace(
                tokens=torch.where(n_emit > 0, last, c.tokens),
                positions=c.positions + n_emit,
                budgets=torch.where(any_eos, zero, budgets))
            outs.append(out)
            emits.append(n_emit)
        self.n_dispatched_ticks += n_rounds
        self.n_draft_passes += n_rounds * K
        return (torch.stack(outs), torch.stack(emits)), c

    def _spec_round(self, live: List[int]):
        """One legacy speculative round, paced by the host: K greedy draft
        steps propose, one verify pass checks, the host commits the
        accepted prefix and the target's own next token. A slot whose
        next K positions cannot all be cached (``max_len`` or the pool)
        clamps its acceptance to the ``cap`` it has; only ``cap == 0``
        truncates. The K-th draft step writes the last proposal's draft
        KV; its token is discarded."""
        # a just-admitted request's first token lands before this round's
        while self._inflight:
            self._drain_one()
        live = [s for s in live if self._slots[s] is not None
                and not self._slots[s].closing]
        K = self.spec_k
        caps = {}
        for slot in list(live):
            req = self._slots[slot]
            base = int(self.context_lens[slot])
            cap = 0
            for pos in range(base, base + K):
                if pos >= self.max_len or not self._ensure_page(slot, pos):
                    break
                cap += 1
            if cap == 0:
                req.truncated = len(req.tokens) < req.max_new_tokens
                self._begin_close(slot)
                live.remove(slot)
            else:
                caps[slot] = cap
        if not live:
            self._maybe_finalize()
            return
        base_arr = np.zeros((self.max_seqs,), np.int64)
        for slot in live:
            base_arr[slot] = self.context_lens[slot]
        tables = self._dev(self.block_tables)
        zeros_temp = torch.zeros((self.max_seqs,), device=self.device)
        nonces = self._dev(self._nonces)
        cur = self._tokens_dev
        tok_cols = [cur]
        for j in range(K):
            pos = np.where(base_arr > 0, base_arr + j, 0)
            lens = np.where(base_arr > 0, np.minimum(
                base_arr + j + 1, self.pages_per_seq * self.page_size),
                0).astype(np.int32)
            cur, _ = self._draft_decode(
                cur, self._dev(pos), tables, self._dev(lens),
                self.draft_k_pages, self.draft_v_pages, zeros_temp, nonces,
                self._key, any_sampled=False)
            if j < K - 1:
                tok_cols.append(cur)
        tokens_mat = torch.stack(tok_cols, dim=1)
        greedy = torch.argmax(
            self._verify(tokens_mat, self._dev(base_arr), tables,
                         self.k_pages, self.v_pages), dim=-1)
        self.n_draft_steps += K
        self.n_draft_passes += K
        self.n_dispatched_ticks += 1
        self.n_spec_rounds += 1
        host_g = greedy.cpu().numpy()          # the round's host read
        host_d = tokens_mat.cpu().numpy()
        new_last = self._tokens_dev.cpu().numpy().copy()
        for slot in live:
            g, d = host_g[slot], host_d[slot]
            # accept within the cache capacity: positions >= base + cap
            # went to scratch, so the queries after them are not backed
            i = 0
            while i < min(K - 1, caps[slot] - 1) and d[i + 1] == g[i]:
                i += 1
            self.n_spec_proposed += K - 1
            self.n_spec_accepted += i
            req = self._slots[slot]
            for tok in list(d[1:i + 1]) + [int(g[i])]:
                req.tokens.append(int(tok))
                if self._harvest(slot):
                    break
            # the cache is valid over t0 .. d_i; g_i is the next input
            self.context_lens[slot] = int(base_arr[slot]) + i + 1
            new_last[slot] = int(g[i])
            if self._harvest(slot):
                self._begin_close(slot)
        self._tokens_dev = self._dev(new_last)
        self._maybe_finalize()

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
        if kind == "S":
            # (committed tokens [N, B, K], realized counts [N, B])
            host = tokens[0].cpu().numpy()
            host_emit = tokens[1].cpu().numpy()
        else:
            host = tokens.cpu().numpy()      # the only blocking fetch
        self._fetch_seq = seq
        if kind == "S":
            self._drain_spec_slab(slots, host, host_emit, meta)
        elif kind in ("D", "M"):
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

    def _drain_spec_slab(self, slots: List[int], host_t, host_emit,
                         meta: dict):
        """Deliver a spec slab's tokens by replaying the device's
        decisions: round j commits ``host_emit[j, slot]`` of its K token
        lanes, clamped by the host copy of the entry budgets; tokens
        after EOS or a close are never surfaced. Advances each slot's
        context length by its committed count and counts rounds,
        proposals and acceptances (a round proposes K - 1 tokens, and
        all but the last committed token came from the draft)."""
        remaining = dict(meta["budgets"])
        K = self.spec_k
        emitted = {s: 0 for s in slots}
        for j in range(host_t.shape[0]):
            row_live = False
            for slot in slots:
                if remaining.get(slot, 0) <= 0:
                    continue
                req = self._slots[slot]
                if not self._wants(req):
                    remaining[slot] = 0
                    continue
                e = min(int(host_emit[j, slot]), remaining[slot])
                if e <= 0:
                    continue
                row_live = True
                self.n_spec_proposed += K - 1
                self.n_spec_accepted += e - 1
                for t in range(e):
                    tok = int(host_t[j, slot, t])
                    remaining[slot] -= 1
                    if tok == self._eos:
                        remaining[slot] = 0  # the device zeroed it too
                    self._deliver_token(slot, req, tok)
                    emitted[slot] += 1
                    if remaining[slot] <= 0:
                        break
                    if req.closing and not req.accepts_inflight:
                        remaining[slot] = 0
                        break
            if row_live:
                self.n_spec_rounds += 1
                self.n_draft_steps += K
        for slot in slots:
            if self._slots[slot] is not None:
                self.context_lens[slot] = meta["pos0"][slot] + \
                    emitted[slot]

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
                    # tick (a spec engine's decode is its rounds, below)
                    self._issue_mixed(
                        [] if self.spec_k else self._live_slots())
                    busy = True
                elif self._prefill_q:
                    # the alternating loop: ONE chunk of prefill, then
                    # ONE decode step (or slab) below
                    self._prefill_tick()
                    busy = True
                live = self._live_slots() if self.spec_k or not mixed \
                    else []
                if live and self.spec_slab:
                    self._issue_spec_slab(live)
                    busy = True
                elif live and self.spec_k:
                    self._spec_round(live)
                    busy = True
                elif live and self.decode_ticks_per_dispatch > 1:
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
