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

import hashlib
import threading
import time
import weakref
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
from ..observability import audit as _audit
from ..observability import goodput as _goodput
from ..observability import memory as _memobs
from ..observability import metrics as _obs
from ..observability import perf as _perf
from ..observability import propagation as _propagation
from ..observability import server as _dbgsrv
from ..observability import tracing as _trace
from ..ops.paged_attention import (KV_DTYPES, KVStore, QuantizedKV,
                                   _split_kv, kv_layer, kv_nbytes,
                                   kv_page_size, kv_write, kv_zeros,
                                   ragged_paged_attention, rows_per_run,
                                   run_counts)
from ..ops.rotary import apply_rotary_pos_emb, rope_tables
from ..reliability import faults as _faults
from ..reliability.retry import DeadlineExceeded, as_deadline
from .prefix_cache import PrefixCache, page_digests

ATTENTION_IMPLS = ("kernel", "plain", "reference")


class AdmissionShed(RuntimeError):
    """Terminal admission verdict: the engine refused the request to
    protect itself (bounded queue overflow, or a draining health
    state). Distinct from ``"retry"`` (transient) and ``"never"`` (the
    prompt can't fit the pool): a shed request was viable — the ENGINE
    was not. Callers should back off and try another replica.

    ``reason`` distinguishes the two verdicts for routing layers:
    ``"queue_full"`` (transient overload — retry elsewhere or later,
    HTTP 429) vs ``"draining"`` (the engine is out of rotation until
    an operator resets it — HTTP 503; the fleet router stops sending
    new admissions entirely)."""

    def __init__(self, msg: str, reason: str = "queue_full"):
        super().__init__(msg)
        self.reason = reason


class OverloadShed(AdmissionShed):
    """The overload controller's typed admission verdict: the
    request was refused BEFORE any prefill work because either its
    deadline is predicted unmeetable (``reason="hopeless"`` — shedding
    a doomed request in 0.1 ms beats failing it after seconds of
    stolen compute) or the brownout ladder admits protected classes
    only (``reason="brownout"``). Subclasses :class:`AdmissionShed` so
    every existing handler — serve_llm's 429 mapping, the router's
    budget-free rebalance, HTTPReplica's error contract — treats it as
    the shed it is; the extra fields make the verdict auditable:
    ``predicted_s``/``deadline_s`` say WHY it was hopeless and
    ``retry_after_s`` is the backoff the fleet wants clients to honor
    (serve_llm forwards it as the ``Retry-After`` header)."""

    def __init__(self, msg: str, reason: str = "hopeless",
                 predicted_s=None, deadline_s=None,
                 retry_after_s=None):
        super().__init__(msg, reason=reason)
        self.predicted_s = predicted_s
        self.deadline_s = deadline_s
        self.retry_after_s = retry_after_s


class AdmissionTimeout(TimeoutError):
    """The admission retry budget ran out: the request waited in the
    ``"retry"`` cycle past the engine's ``admit_timeout`` without slots
    or pages freeing up."""


class RequestCancelled(RuntimeError):
    """The request was cancelled via :meth:`LLMEngine.cancel` before
    it finished; its KV pages are reclaimed and its span tree closed."""


class EngineClosed(RuntimeError):
    """The engine is shut (or shutting) down. A routing layer treats
    this like draining — rebalance to a sibling, never a client
    error: a replica that is closing is out of rotation, and the
    request it refused lost nothing (``serve_llm`` maps it to HTTP
    503 for the same reason)."""


# health state machine: consecutive device errors walk the engine
# healthy → degraded → draining; any successful fetch resets to healthy
# unless draining (sticky — operator recovers via reset_health()).
_HEALTH_CODE = {"healthy": 0, "degraded": 1, "draining": 2}


def _engine_metrics():
    """Serving instruments in the process-wide registry (shared across
    engines by design — one serving process, one scrape surface). The
    names are the standard paged-attention-engine lens (PAPERS.md
    "Ragged Paged Attention" evaluates on exactly these)."""
    reg = _obs.default_registry()
    return {
        "ttft": reg.histogram(
            "llm_ttft_seconds",
            "submit → first token latency (prefill + queue)"),
        "queue_wait": reg.histogram(
            "llm_queue_wait_seconds",
            "submit → admission wait (slot/page availability)"),
        "step": reg.histogram(
            "llm_decode_step_seconds",
            "wall time between consecutive decode-step fetches"),
        "tps": reg.histogram(
            "llm_decode_tokens_per_second",
            "tokens emitted per second of decode wall time",
            buckets=_obs.RATE_BUCKETS),
        "occupancy": reg.histogram(
            "llm_batch_occupancy",
            "live slots / max_seqs at each issued step",
            buckets=_obs.RATIO_BUCKETS),
        "kv_util": reg.gauge(
            "llm_kv_page_utilization",
            "allocated KV pages / usable pool size"),
        "tokens": reg.counter(
            "llm_tokens_generated", "tokens emitted to requests"),
        "prefills": reg.counter(
            "llm_prefills", "admitted prompts (one prefill each)"),
        "completed": reg.counter(
            "llm_requests_completed",
            "requests resolved in full (disjoint from truncated/failed)"),
        "truncated": reg.counter(
            "llm_requests_truncated",
            "requests finished early on pool/length pressure"),
        "failed": reg.counter(
            "llm_requests_failed",
            "requests whose future resolved with an exception"),
        # prefix cache + chunked prefill (this PR's lens)
        "prompt_tokens": reg.counter(
            "llm_prompt_tokens", "prompt tokens submitted (admitted "
            "requests; reused + recomputed)"),
        "cache_hit_tokens": reg.counter(
            "llm_prefix_cache_hit_tokens",
            "prompt tokens served from cached prefix pages (not "
            "recomputed)"),
        "cache_hit_rate": reg.gauge(
            "llm_prefix_cache_hit_rate",
            "cumulative prefix-cache hit rate: reused / prompt tokens"),
        "shared_pages": reg.gauge(
            "llm_prefix_cache_pages",
            "refcounted pages resident in the prefix cache (shared + "
            "evictable)"),
        # cross-replica KV-page migration (disaggregated fleet): the
        # engine counts its own sides (export/import/rejected); the
        # router observes the end-to-end kv_migrate_seconds histogram
        "migrate_pages": reg.counter(
            "kv_migrate_pages_total",
            "KV pages migrated across replicas, by direction "
            "(export / import / rejected)",
            label_names=("direction",)),
        "migrate_bytes": reg.counter(
            "kv_migrate_bytes_total",
            "serialized KV bytes migrated across replicas, by "
            "direction (export / import / rejected)",
            label_names=("direction",)),
        "prefill_queue": reg.gauge(
            "llm_prefill_queue_depth",
            "admitted requests with un-prefilled prompt tokens"),
        "prefill_ticks": reg.counter(
            "llm_prefill_ticks",
            "chunked-prefill engine ticks (one chunk each)"),
        "decode_ticks": reg.counter(
            "llm_decode_ticks", "decode engine ticks (one step each)"),
        "mixed_slabs": reg.counter(
            "llm_mixed_slabs_total",
            "fused MIXED prefill+decode slab dispatches (one ragged "
            "batch of chunk rows + decode rows per tick, inside the "
            "DecodeCarry scan; mixed_tick engines only)"),
        "mixed_prefill_tokens": reg.counter(
            "llm_mixed_prefill_tokens_total",
            "prompt tokens computed INSIDE mixed slabs (admitted to "
            "the scan with zero host dispatches between phases)"),
        "tick_ratio": reg.gauge(
            "llm_prefill_decode_tick_ratio",
            "prefill ticks / decode ticks since engine start"),
        # device-resident decode loop (fused slabs): how many ticks
        # each dispatch actually realized, and how often the host
        # touched the device at all — the dispatch-overhead lens the
        # --decode-ticks bench sweep reads
        "slab_ticks": reg.histogram(
            "llm_decode_slab_ticks",
            "realized decode ticks per fused-slab dispatch (max "
            "emitted across slots; < decode_ticks_per_dispatch when "
            "every slot finished mid-slab or the slab shrank to a "
            "page boundary)",
            buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)),
        "host_dispatches": reg.counter(
            "llm_host_dispatches_total",
            "XLA dispatches issued by the engine loop (prefill "
            "chunks, decode steps/slabs, speculative draft+verify "
            "passes) — the quantity fused slabs divide by N"),
        # speculative decoding (draft-K/verify-1 rounds; both the
        # legacy host-orchestrated path and the on-device spec slab
        # feed these — the acceptance lens tools/llm_bench.py --spec
        # sweeps over draft K)
        "spec_rounds": reg.counter(
            "llm_spec_rounds_total",
            "speculative draft+verify rounds executed (slab engines: "
            "realized scan ticks; legacy engines: host rounds)"),
        "spec_draft_tokens": reg.counter(
            "llm_spec_draft_tokens_total",
            "draft tokens proposed to the verifier (spec_tokens - 1 "
            "per round per emitting slot)"),
        "spec_accept_rate": reg.gauge(
            "llm_spec_accept_rate",
            "cumulative committed draft proposals / proposed draft "
            "tokens (the bonus/correction token is not a proposal "
            "and is excluded from both sides)"),
        # hardened failure semantics (docs/RELIABILITY.md): these
        # outcomes are terminal and disjoint from completed/truncated/
        # failed — submitted = completed + truncated + failed + shed +
        # deadline_exceeded + cancelled + admission_timeout
        "shed": reg.counter(
            "llm_shed_total",
            "requests refused under load (bounded admission queue "
            "overflow or a draining engine)"),
        "deadline": reg.counter(
            "llm_deadline_exceeded_total",
            "requests resolved DeadlineExceeded at a queue/prefill/"
            "decode boundary"),
        "cancelled": reg.counter(
            "llm_cancelled_total", "requests cancelled via cancel()"),
        "admit_timeout": reg.counter(
            "llm_admission_timeout_total",
            "requests whose admission retry budget expired"),
        "device_retries": reg.counter(
            "llm_device_retries_total",
            "per-request re-admissions after a device error"),
        "device_errors": reg.counter(
            "llm_device_errors_total",
            "engine-loop device/compile errors caught"),
        "health": reg.gauge(
            "llm_health_state",
            "engine health: 0 healthy, 1 degraded, 2 draining"),
        "queue_depth": reg.gauge(
            "llm_admission_queue_depth",
            "submitted requests not yet admitted (new submissions "
            "shed at max_pending; device-error re-admissions re-enter "
            "above it, so the ceiling is max_pending + max_seqs)"),
        # served-FLOPs attribution (the cost denominator SLO classes
        # get): analytic 2*N_params FLOPs per COMPUTED token — cached
        # prefix tokens cost ~0 and are excluded; counted once, at the
        # completed/truncated finish (a failed-over request charges
        # only the replica that actually finished it)
        "served_flops": reg.counter(
            "llm_served_flops_total",
            "analytic forward FLOPs served to finished requests "
            "(2*N_params per computed prompt/output token), by tenant",
            label_names=("tenant",)),
    }




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
                k_pages, v_pages, tables, lens, attention_impl, seq_rows):
    """One decoder block over T token rows ``x`` [1 or B, ., H]: write
    the rows' K/V into the pool, attend over each row's paged context
    (``seq_rows``: the rows a sequence holds on average, 0 where not
    known),
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
        kv_layer(v_pages, i), tables, lens, impl=attention_impl,
        seq_rows=seq_rows)
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
                    v_pages, attention_impl, seq_rows=0):
    """T token rows of any mix of sequences as one forward: each row
    writes its K/V at its position and attends its own table row up to
    its limit (0 = padding); ``seq_rows``: the rows a sequence holds on
    average among the live ones
    (:func:`~paddle_tpu_torch.ops.paged_attention.rows_per_run`), 0 where
    not known. Returns the final hidden rows [T, H]."""
    gpt = net.gpt
    pos_ids = positions[None, :]                        # [1, T]
    x = gpt.embeddings(tokens[None, :], position_ids=pos_ids)
    page_idx, offs = _write_slots(tables, positions, limits > 0,
                                  kv_page_size(k_pages))
    rope = _rope(net.cfg, x.device)
    for i, layer in enumerate(gpt.layers):
        x = _layer_step(net, x, layer, i, pos_ids, rope, page_idx, offs,
                        k_pages, v_pages, tables, limits, attention_impl,
                        seq_rows)
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
                            context_lens, self.attention_impl, 1)
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
                            k_pages, v_pages, self.attention_impl, kq)
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
                any_sampled: bool = True, seq_rows: float = 0):
        x = _ragged_forward(self.net, tokens, positions, limits, tables,
                            k_pages, v_pages, self.attention_impl,
                            seq_rows)
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
                nonces, key, any_sampled: bool = True, seq_rows: float = 0):
        c, b = ptok.shape[0], dtok.shape[0]
        x = _ragged_forward(
            self.net, torch.cat([ptok, dtok]), torch.cat([ppos, dpos]),
            torch.cat([plim, dlens]),
            torch.cat([ptbl.clamp(min=0), tables.clamp(min=0)]),
            k_pages, v_pages, self.attention_impl, seq_rows)
        rows = torch.where(fin, fin_row.long(),
                           c + torch.arange(b, device=x.device))
        logits = _lm_rows(self.net, x[rows])
        return _sample(logits, temps, key, nonces,
                       torch.where(fin, fin_pos, dpos), any_sampled)


def _scale_nbytes(store: KVStore) -> int:
    """Bytes of an int8 store's scale table (0 for a plain pool)."""
    if isinstance(store, QuantizedKV):
        return store.scales.numel() * store.scales.element_size()
    return 0


class _ModelCost(NamedTuple):
    """Analytic cost coefficients of one model's paged forward pass
    (:func:`_model_cost`)."""

    row_flops: float      # 2 x non-embedding parameters, per token row
    attn_flops: float     # QK^T + PV over one context token, all layers
    head_flops: float     # 2 x hidden x vocab, per sampled row
    weight_bytes: float   # every parameter read once a pass
    kv_token_bytes: float  # K and V of one token, all layers (+ scales)


def _model_cost(net, pool: KVStore) -> _ModelCost:
    cfg = net.cfg
    trunk = sum(p.numel() for p in net.gpt.layers.parameters()) + \
        sum(p.numel() for p in net.gpt.ln_f.parameters())
    per_tok = 2 * cfg.num_kv_heads * cfg.head_dim * \
        _split_kv(pool)[0].element_size()
    if isinstance(pool, QuantizedKV):
        per_tok += 2 * pool.scales.element_size()
    return _ModelCost(
        row_flops=2.0 * trunk,
        attn_flops=4.0 * cfg.num_layers * cfg.num_heads * cfg.head_dim,
        head_flops=2.0 * cfg.hidden_size * cfg.vocab_size,
        weight_bytes=float(sum(p.numel() * p.element_size()
                               for p in net.parameters())),
        kv_token_bytes=float(cfg.num_layers * per_tok))


def _pass_cost(c: _ModelCost, rows: int, attn_tokens: int,
               kv_tokens: int, sampled: int, passes: int = 1):
    """(FLOPs, bytes) of ``passes`` forward passes computing ``rows``
    token rows in all (padding included, as the device computes them),
    attending ``attn_tokens`` context tokens summed over rows, reading
    ``kv_tokens`` tokens of KV pages (a page once a sequence) and
    sampling ``sampled`` rows through the LM head."""
    return (rows * c.row_flops + attn_tokens * c.attn_flops +
            sampled * c.head_flops,
            passes * c.weight_bytes + kv_tokens * c.kv_token_bytes)


class _Request:
    __slots__ = ("prompt", "max_new_tokens", "temperature", "future",
                 "tokens", "slot", "truncated", "t_submit", "t_first",
                 "t_done", "closing", "drain_after", "accepts_inflight",
                 "nonce", "prefill_pos", "prefill_done", "digests",
                 "n_cached", "n_reg_pages", "spans", "deadline",
                 "priority", "req_id", "admit_attempts",
                 "device_retries", "cancelled", "queued", "t_enqueued",
                 "tenant", "chain", "prior_chain", "prior_tokens")

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
        self.nonce = 0          # sampling-key salt
        self.prefill_pos = 0    # next prompt position to compute
        self.prefill_done = False
        self.digests: List[bytes] = []   # rolling digests of full pages
        self.n_cached = 0       # prompt tokens served by the cache
        self.n_reg_pages = 0    # prompt pages registered as shared
        # {"root", "queue", "prefill", "first_token", "decode"} span
        # tree, or None when tracing is off
        self.spans = None
        # failure semantics: deadline (a Deadline or None), admission
        # priority (higher admits first), public id (the cancel()
        # handle, also the submission order) and the two retry budgets'
        # consumption counters
        self.deadline = None
        self.priority = 0
        self.req_id = -1
        self.admit_attempts = 0
        self.device_retries = 0
        self.cancelled = False
        # True while the request occupies the bounded admission queue;
        # t_enqueued starts the CURRENT admission cycle (a device retry
        # resets it, so admit_timeout bounds time in the queue)
        self.queued = False
        self.t_enqueued = self.t_submit
        self.tenant: Optional[str] = None
        # stream-integrity chain (observability/audit.py), extended at
        # the drain; prior_* snapshot the stream before a device retry,
        # which must re-emit that exact prefix under the same nonce
        self.chain = b""
        self.prior_chain: Optional[bytes] = None
        self.prior_tokens: Optional[List[int]] = None


def _engine_memory_provider(ref):
    """Live memory-ledger source over a weakref'd engine: the paged KV
    pool split into free / private / prefix-cache-shared pages (shared
    pages counted once), scratch page 0, an int8 pool's scale tables
    and a speculative engine's draft pool, computed at read time from
    the allocator's host counters. Headroom is ``eng._avail_pages()``,
    the quantity admission consults; free + private + shared + scratch
    == num_pages at any instant."""

    def _provider():
        eng = ref()
        if eng is None or eng._closed:
            return None
        pb = eng._page_bytes
        pbk = eng._tgt_page_bytes - eng._tgt_scale_bytes
        usable = eng.num_pages - 1
        free = len(eng._free_pages)
        cache = eng._cache
        shared = cache.shared_page_count if cache is not None else 0
        migrated = cache.migrated_page_count if cache is not None else 0
        private = max(0, usable - free - shared)
        dt = {"dtype": eng.kv_dtype}
        rows = [
            {"owner": "kv_pool", "kind": "free", "bytes": free * pbk,
             "detail": dt},
            {"owner": "kv_pool", "kind": "private",
             "bytes": private * pbk, "detail": dt},
            {"owner": "kv_pool", "kind": "prefix_shared",
             "bytes": (shared - migrated) * pbk, "detail": dt},
            {"owner": "kv_pool", "kind": "scratch", "bytes": pbk,
             "detail": {"note": "page 0: masked/inactive writes",
                        "dtype": eng.kv_dtype}},
        ]
        if migrated:
            # shared pages installed by import_pages rather than a
            # local prefill (prefix_shared above excludes them)
            rows.append(
                {"owner": "kv_pool", "kind": "migrated",
                 "bytes": migrated * pbk,
                 "detail": {"note": "prefix pages installed by "
                                    "cross-replica KV migration",
                            "dtype": eng.kv_dtype}})
        if eng._tgt_scale_bytes:
            rows.append(
                {"owner": "kv_pool", "kind": "scale_table",
                 "bytes": eng.num_pages * eng._tgt_scale_bytes,
                 "detail": {"note": "int8 per-token dequantization "
                                    "scales (f32, beside the pool)"}})
        if eng._draft_page_bytes:
            rows.append(
                {"owner": "draft_pool", "kind": "pages",
                 "bytes": eng.num_pages * (eng._draft_page_bytes -
                                           eng._draft_scale_bytes),
                 "detail": {"note": "speculative draft model KV "
                                    "(shares the kv_pool page "
                                    "allocator and block tables)",
                            "dtype": eng.kv_dtype}})
            if eng._draft_scale_bytes:
                rows.append(
                    {"owner": "draft_pool", "kind": "scale_table",
                     "bytes": eng.num_pages * eng._draft_scale_bytes,
                     "detail": {"note": "int8 draft-pool per-token "
                                        "dequantization scales"}})
        return {"rows": rows,
                "headroom_pages": eng._avail_pages(),
                "page_bytes": pb}

    return _provider


def _engine_status_provider(ref):
    """/statusz snapshot closure over a weakref'd engine: occupancy,
    page pool, prefix-cache and tick state — the live-inspection view
    of the aggregates the metric registry accumulates. Reads are
    lock-free by design (python ints/lists; a debug snapshot may be a
    tick stale)."""

    def _status():
        eng = ref()
        if eng is None or eng._closed:
            return None
        live = sum(1 for s in eng._slots if s is not None)
        usable = eng.num_pages - 1
        out = {
            "max_seqs": eng.max_seqs,
            "live_slots": live,
            "occupancy": round(live / eng.max_seqs, 4),
            "free_pages": len(eng._free_pages),
            "usable_pages": usable,
            "kv_page_utilization": round(
                (usable - len(eng._free_pages)) / usable, 4),
            "inflight_steps": len(eng._inflight),
            "prefill_queue_depth": len(eng._prefill_q),
            "admission_queue_depth": eng._n_queued,
            "health": eng.health,
            "consecutive_device_errors": eng._consec_device_errors,
            "lookahead": eng.lookahead,
            "decode_ticks_per_dispatch": eng.decode_ticks_per_dispatch,
            "mixed_tick": eng.mixed_tick,
            "kv_dtype": eng.kv_dtype,
            "host_dispatches": eng.n_host_dispatches,
            "flops_per_token": eng.flops_per_token,
            "n_steps": eng.n_steps,
            "n_tokens": eng.n_tokens,
            "prompt_tokens": eng.n_prompt_tokens,
            "ticks": {"prefill": eng.n_prefill_ticks,
                      "decode": eng.n_decode_ticks,
                      "mixed": eng.n_mixed_slabs},
        }
        cache = eng._cache
        if cache is not None:
            out["prefix_cache"] = {
                "shared_pages": cache.shared_page_count,
                "evictable_pages": cache.evictable_count,
                "hit_tokens": eng.n_cached_tokens,
                "hit_rate": round(
                    eng.n_cached_tokens / eng.n_prompt_tokens, 4)
                if eng.n_prompt_tokens else 0.0,
                "migrated_pages": cache.migrated_page_count,
                "pages_imported": cache.n_imported,
            }
        if eng.spec_k:
            prop = eng.n_spec_proposed
            out["speculative"] = {
                "spec_tokens": eng.spec_k,
                "mode": "slab" if eng.spec_slab else "legacy",
                "rounds": eng.n_spec_rounds,
                "draft_steps": eng.n_draft_steps,
                "draft_tokens_proposed": prop,
                "draft_tokens_accepted": eng.n_spec_accepted,
                "accept_rate": round(eng.n_spec_accepted / prop, 4)
                if prop else 0.0,
            }
        return out

    return _status


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
    and committed by the verifier).

    Failure semantics (the JAX engine's): ``max_pending`` bounds the
    admission queue (a submit past it, or to a ``"draining"`` engine,
    resolves :class:`AdmissionShed`); ``admit_timeout`` seconds in the
    retry cycle resolve :class:`AdmissionTimeout`; ``submit``'s
    ``deadline`` resolves ``DeadlineExceeded`` and :meth:`cancel`
    :class:`RequestCancelled` at the next boundary, pages reclaimed. A
    device error re-admits each slotted request under its nonce up to
    ``device_retry_budget`` times (the stream is identical) and fails
    it after; ``degraded_after`` / ``drain_after`` consecutive errors
    walk :attr:`health` to ``"degraded"`` / ``"draining"`` (sticky
    until :meth:`reset_health`). :meth:`export_pages` /
    :meth:`import_pages` move prefix-cache pages between engines in the
    ``kv_pages/v1`` wire format (:mod:`.kv_transfer`). Metrics, spans,
    stream digests and the memory / perf / goodput ledgers feed
    :mod:`paddle_tpu_torch.observability`; :func:`serve_llm` serves the
    engine over HTTP."""

    def __init__(self, net, max_seqs: int = 8, page_size: int = 16,
                 num_pages: int = 512, max_len: Optional[int] = None,
                 prefill_buckets: Sequence[int] = (64, 256, 1024),
                 eos_token_id: Optional[int] = None,
                 cache_dtype=torch.float32, seed: int = 0,
                 lookahead: int = 0, attention_impl: str = "kernel",
                 draft_net=None, spec_tokens: int = 4,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 max_pending: int = 256,
                 admit_timeout: Optional[float] = 300.0,
                 device_retry_budget: int = 0,
                 degraded_after: int = 1,
                 drain_after: int = 8,
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
        self.max_pending = int(max_pending)
        self.admit_timeout = admit_timeout
        self.device_retry_budget = int(device_retry_budget)
        self.degraded_after = int(degraded_after)
        self.drain_after = int(drain_after)
        self._init_control_plane(draft_net, spec_tokens)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _init_control_plane(self, draft_net, spec_tokens: int):
        """Failure-semantics state, metrics, the knob fingerprint, the
        analytic program costs and the observability registrations
        (memory ledger, /statusz, /healthz, POST /reset_health)."""
        self._ctl: List = []   # closures the worker runs at a boundary
        self._n_queued = 0            # submitted, not yet admitted
        self._by_id: dict = {}        # req_id -> _Request (cancel handle)
        self._consec_device_errors = 0
        self._health = "healthy"
        # brownout clamp: caps every later submit's max_new_tokens
        self.overload_max_new_tokens: Optional[int] = None
        self.n_steps = 0
        self.n_tokens = 0
        self.n_host_dispatches = 0
        self._m = _engine_metrics()
        self._last_fetch_t: Optional[float] = None
        # served-FLOPs unit: 2 x parameters per computed token
        self.flops_per_token = 2.0 * float(
            sum(p.numel() for p in self.net.parameters()))
        # perf registry handles, one per program signature; a program's
        # first drained record (its kernels' first build and launch)
        # goes to the "compile" phase instead of its MFU accounting
        self._perf_programs: Dict[tuple, object] = {}
        self._perf_skipped: set = set()
        self._perf_scope = _perf.next_scope()
        _perf.finalize_scope(self, self._perf_scope)
        # chunk dispatches since the last first-token ("p") record:
        # [count, flops, bytes]
        self._perf_chunks = [0, 0.0, 0.0]
        self._costs = {"target": _model_cost(self.net, self.k_pages)}
        if self.spec_k:
            self._costs["draft"] = _model_cost(self.draft_net,
                                               self.draft_k_pages)
        # knob fingerprint (stream auditor): what must match across
        # engines for "token-identical" to hold, the draft hashed by
        # its config, K and its state_dict's shapes and dtypes
        draft_hash = None
        if draft_net is not None:
            fh = hashlib.blake2b(digest_size=8)
            fh.update(repr(draft_net.cfg).encode())
            fh.update(str(int(spec_tokens)).encode())
            for t in self.draft_net.state_dict().values():
                fh.update(str(tuple(t.shape)).encode())
                fh.update(str(t.dtype).replace("torch.", "").encode())
            draft_hash = fh.hexdigest()
        self.knob_fingerprint = {
            "kv_dtype": self.kv_dtype, "spec_k": self.spec_k,
            "spec_slab": bool(self.spec_slab), "draft": draft_hash}
        self.audit_scope = "engine"
        # memory ledger: bytes one page holds across layers, K and V
        # (the draft pool shares the allocator, so its bytes fold in)
        n = self.num_pages
        self._tgt_page_bytes = (kv_nbytes(self.k_pages) +
                                kv_nbytes(self.v_pages)) // n
        self._tgt_scale_bytes = (_scale_nbytes(self.k_pages) +
                                 _scale_nbytes(self.v_pages)) // n
        self._draft_page_bytes = self._draft_scale_bytes = 0
        if self.spec_k:
            self._draft_page_bytes = (kv_nbytes(self.draft_k_pages) +
                                      kv_nbytes(self.draft_v_pages)) // n
            self._draft_scale_bytes = (
                _scale_nbytes(self.draft_k_pages) +
                _scale_nbytes(self.draft_v_pages)) // n
        self._page_bytes = self._tgt_page_bytes + self._draft_page_bytes
        self._mem_scope = _memobs.next_scope()
        _memobs.finalize_scope(self, self._mem_scope)
        if _memobs.enabled():
            _memobs.register_provider(
                self._mem_scope,
                _engine_memory_provider(weakref.ref(self)))
            n_carry = 4 if self.decode_ticks_per_dispatch > 1 else 1
            _memobs.set_entry(
                self._mem_scope, "decode_carry", "scratch",
                n_carry * self.max_seqs * 8,
                detail={"arrays": "tokens/positions/budgets + "
                                  "_tokens_dev" if n_carry == 4
                                  else "_tokens_dev"})
        self._status_name = f"llm_engine_{id(self):x}"
        _dbgsrv.register_status_provider(
            self._status_name, _engine_status_provider(weakref.ref(self)))
        ref = weakref.ref(self)
        _dbgsrv.register_health_provider(
            self._status_name,
            lambda: (lambda e: None if e is None or e._closed
                     else e.health)(ref()))
        _dbgsrv.register_reset_handler(
            self._status_name,
            lambda: (lambda e: None if e is None or e._closed
                     else e.reset_health())(ref()))
        self._m["health"].set(0)

    # -- public API ---------------------------------------------------------
    @property
    def health(self) -> str:
        """"healthy" | "degraded" | "draining". Draining engines shed
        every new submission; degraded ones serve but are one error
        streak from draining."""
        return self._health

    def reset_health(self) -> None:
        """Operator escape hatch: clear the draining latch (e.g. after
        the device recovered) and resume admitting."""
        self._consec_device_errors = 0
        self._health = "healthy"
        self._m["health"].set(0)
        self._wake.set()

    def set_overload_clamp(self, max_new_tokens: Optional[int]) -> None:
        """Set (or clear, with None) the brownout clamp: every later
        submit's ``max_new_tokens`` is capped at this value (requests
        in flight keep the budget they were admitted with)."""
        self.overload_max_new_tokens = (
            None if max_new_tokens is None else int(max_new_tokens))

    def cancel(self, request_id: int) -> bool:
        """Cancel a submitted request by the ``request_id`` attribute of
        its future. Returns False if unknown or already resolved. The
        engine loop resolves the future with :class:`RequestCancelled`,
        frees the request's KV pages and closes its span tree at the
        next boundary."""
        with self._mu:
            req = self._by_id.get(request_id)
        if req is None or req.future.done():
            return False
        req.cancelled = True
        self._wake.set()
        return True

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               temperature: float = 0.0, deadline=None,
               priority: int = 0, nonce: Optional[int] = None,
               trace_context=None,
               tenant: Optional[str] = None) -> Future:
        """Queue one request; the future resolves to a dict with the
        generated ids (and, with the stream auditor on,
        ``stream_digest``, ``nonce`` and ``knobs``) and carries
        ``request_id`` (the :meth:`cancel` handle).

        ``nonce`` pins the sampling-key salt instead of this engine's
        submission counter: two identically seeded engines given the
        same prompt and nonce produce identical streams. Must be in
        [0, 2**31). ``deadline``: seconds from now or a ``Deadline``.
        ``priority``: higher admits first. ``tenant``: the label of
        ``llm_served_flops_total``. ``trace_context``: a remote parent
        for the ``llm.request`` span tree (a Span/SpanContext, a W3C
        ``traceparent`` string or a headers mapping); malformed context
        or disabled tracing degrade to a local (or no) tree. A full
        admission queue or a draining engine resolves the future with
        :class:`AdmissionShed` at once."""
        cap = self.overload_max_new_tokens
        if cap is not None and max_new_tokens > int(cap):
            max_new_tokens = int(cap)
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
        req.deadline = as_deadline(deadline)
        req.priority = int(priority)
        req.tenant = str(tenant) if tenant else None
        remote_ctx = (_propagation.context_from(trace_context)
                      if _trace.enabled() and trace_context is not None
                      else None)
        with self._mu:
            if self._closed:
                raise EngineClosed("engine closed")
            req.req_id = self._nonce_seq
            req.nonce = req.req_id if nonce is None else int(nonce)
            self._nonce_seq += 1
            # shedding is a submit-time verdict: a full admission queue
            # or a draining engine resolves the future here, never
            # queued
            shed_why = shed_reason = None
            if self._health == "draining":
                shed_why = "engine is draining (health state machine)"
                shed_reason = "draining"
            elif self._n_queued >= self.max_pending:
                shed_why = (f"admission queue full "
                            f"({self._n_queued}/{self.max_pending})")
                shed_reason = "queue_full"
            if shed_why is not None:
                self._m["shed"].inc()
                if _trace.enabled():
                    root = _trace.start_span(
                        "llm.request", parent=remote_ctx, attrs={
                            "prompt_tokens": len(req.prompt),
                            "nonce": req.nonce, "outcome": "shed",
                            "error": shed_why})
                    root.set_status("error").end()
                req.future.set_exception(
                    AdmissionShed(shed_why, reason=shed_reason))
                req.future.request_id = req.req_id
                return req.future
            if _trace.enabled():
                # the tree roots here, inside the lock, so it exists
                # before the loop sees the request; the loop parents
                # every phase off the request object
                root = _trace.start_span(
                    "llm.request", parent=remote_ctx, attrs={
                        "prompt_tokens": len(req.prompt),
                        "max_new_tokens": req.max_new_tokens,
                        "temperature": req.temperature,
                        "nonce": req.nonce})
                if remote_ctx is not None:
                    root.set_attr("remote_parent", True)
                req.spans = {"root": root,
                             "queue": _trace.start_span(
                                 "llm.queue", parent=root, t0=root.t0)}
            self._pending.append(req)
            self._by_id[req.req_id] = req
            req.queued = True
            self._n_queued += 1
        self._wake.set()
        req.future.request_id = req.req_id
        return req.future

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 temperature: float = 0.0) -> List[dict]:
        """Blocking batch convenience, windowed: at most
        ``max_pending // 2`` submissions are outstanding at once, so a
        batch wider than the admission queue never sheds its own
        tail."""
        outs: List[Optional[dict]] = [None] * len(prompts)
        window = max(1, self.max_pending // 2)
        inflight: deque = deque()
        for i, p in enumerate(prompts):
            while len(inflight) >= window:
                j, f = inflight.popleft()
                outs[j] = f.result()
            inflight.append((i, self.submit(p, max_new_tokens,
                                            temperature)))
        for j, f in inflight:
            outs[j] = f.result()
        return outs

    # -- KV-page migration --------------------------------------------------
    def _post_ctl(self, fn) -> Future:
        """Post a closure for the worker to run at its next loop
        boundary (no launch in flight; the pools are the worker's) and
        return the Future it resolves."""
        fut: Future = Future()

        def op():
            try:
                fut.set_result(fn())
            except BaseException as e:  # noqa: BLE001 - to the caller
                fut.set_exception(e)

        with self._mu:
            if self._closed:
                raise EngineClosed("engine closed")
            self._ctl.append((op, fut))
        self._wake.set()
        return fut

    def _wire_kv_dtype(self) -> str:
        """The pool's dtype as the ``kv_pages/v1`` wire names it (the
        JAX package's spelling: "float32", "bfloat16", "float16" or
        "int8")."""
        if isinstance(self.k_pages, QuantizedKV):
            return "int8"
        return str(self.k_pages.dtype).replace("torch.", "")

    def export_pages(self, digests, timeout: float = 60.0) -> dict:
        """Serialize the longest RESIDENT prefix run of ``digests`` (hex
        strings or bytes, chain order from the root) into a
        ``kv_pages/v1`` payload: raw page blocks at the pool dtype
        (int8 bytes + per-token-row scales for int8 pools), each page's
        tokens and the rolling digest chain. A pure read, run on the
        worker at a loop boundary."""
        if self._cache is None:
            raise RuntimeError(
                "export_pages requires the prefix cache "
                "(LLMEngine(prefix_cache=True))")
        if _faults.enabled():
            _faults.check("kv.export")
        hexes = [d if isinstance(d, str) else d.hex() for d in digests]
        return self._post_ctl(
            lambda: self._do_export_pages(hexes)).result(timeout=timeout)

    def import_pages(self, payload: dict, timeout: float = 60.0) -> dict:
        """Verify and install a ``kv_pages/v1`` payload as shared,
        refcount-zero prefix-cache residents. Every page is verified on
        ingest (digest chain, checksum, exact pool geometry:
        :func:`.kv_transfer.verify_payload`); rejected pages are
        reported and allocate nothing. Returns ``{"imported",
        "duplicates", "rejected"}``; a geometry mismatch (kv_dtype,
        page_size, shape) raises ValueError."""
        if self._cache is None:
            raise RuntimeError(
                "import_pages requires the prefix cache "
                "(LLMEngine(prefix_cache=True))")
        if _faults.enabled():
            _faults.check("kv.import")
        return self._post_ctl(
            lambda: self._do_import_pages(payload)).result(timeout=timeout)

    def _do_export_pages(self, hexes: List[str]) -> dict:
        from . import kv_transfer as _kvt
        from .prefix_cache import _SEED, chain_digest
        cache = self._cache
        run = []  # (digest, page, tokens): the resident prefix run
        parent = _SEED
        for hx in hexes:
            try:
                d = bytes.fromhex(hx)
            except ValueError:
                break
            page = cache.page_of(d)
            toks = cache.tokens_of(d)
            # stop at the first digest not resident, or a chain break
            if page is None or toks is None or \
                    chain_digest(parent, toks) != d:
                break
            run.append((d, page, toks))
            parent = d
        kp, ksc = _split_kv(self.k_pages)
        vp, vsc = _split_kv(self.v_pages)
        L, _n, ps, H, Dh = kp.shape
        recs: List[dict] = []
        n_bytes = 0

        def page_bytes(t, j):
            return t[:, j].contiguous().view(torch.uint8).numpy().tobytes()

        if run:
            idx = torch.tensor([p for _, p, _ in run], device=kp.device)
            # one gather and copy a pool, on the stream after the
            # dispatches that wrote the pages
            k_h, v_h = kp[:, idx].cpu(), vp[:, idx].cpu()
            ks_h = ksc[:, idx].cpu() if ksc is not None else None
            vs_h = vsc[:, idx].cpu() if vsc is not None else None
            parent = _SEED
            for j, (d, _pg, toks) in enumerate(run):
                k_b, v_b = page_bytes(k_h, j), page_bytes(v_h, j)
                ks_b = page_bytes(ks_h, j) if ks_h is not None else b""
                vs_b = page_bytes(vs_h, j) if vs_h is not None else b""
                recs.append(_kvt.encode_page(d, parent, toks,
                                             k_b, v_b, ks_b, vs_b))
                n_bytes += len(k_b) + len(v_b) + len(ks_b) + len(vs_b)
                parent = d
        if recs:
            self._m["migrate_pages"].labels("export").inc(len(recs))
            self._m["migrate_bytes"].labels("export").inc(n_bytes)
        return _kvt.make_payload(recs, kv_dtype=self._wire_kv_dtype(),
                                 page_size=self.page_size,
                                 kv_shape=(L, ps, H, Dh))

    def _do_import_pages(self, payload: dict) -> dict:
        from . import kv_transfer as _kvt
        cache = self._cache
        kp, ksc = _split_kv(self.k_pages)
        vp, vsc = _split_kv(self.v_pages)
        L, _n, ps, H, Dh = kp.shape
        kv_shape = (L, ps, H, Dh)
        kv_nb = L * ps * H * Dh * kp.element_size()
        sc_nb = L * ps * 4 if ksc is not None else 0
        accepted, rejected = _kvt.verify_payload(
            payload, kv_dtype=self._wire_kv_dtype(),
            page_size=self.page_size, kv_shape=kv_shape,
            kv_nbytes=kv_nb, scale_nbytes=sc_nb,
            resident=lambda d: cache.page_of(d) is not None)
        dups = 0
        alloc = []  # (record, target page id)
        for i, rec in enumerate(accepted):
            if cache.page_of(rec.digest) is not None:
                dups += 1
                continue
            pg = self._alloc_page()
            if pg is None:
                # pool exhausted: the rest of the chain cannot install
                # (and would be unmatchable behind the gap anyway)
                rejected.extend(
                    {"digest": r.digest.hex(), "reason": "no_free_pages"}
                    for r in accepted[i:]
                    if cache.page_of(r.digest) is None)
                break
            alloc.append((rec, pg))

        def stack(blobs, dtype, shape):
            return torch.stack(
                [torch.frombuffer(bytearray(b), dtype=dtype).reshape(shape)
                 for b in blobs], dim=1).to(kp.device)

        n_bytes = 0
        if alloc:
            idx = torch.tensor([pg for _, pg in alloc], device=kp.device)
            kp[:, idx] = stack([r.k for r, _ in alloc], kp.dtype, kv_shape)
            vp[:, idx] = stack([r.v for r, _ in alloc], vp.dtype, kv_shape)
            if ksc is not None:
                ksc[:, idx] = stack([r.k_scales for r, _ in alloc],
                                    torch.float32, (L, ps))
                vsc[:, idx] = stack([r.v_scales for r, _ in alloc],
                                    torch.float32, (L, ps))
            for rec, pg in alloc:
                cache.register_imported(rec.digest, pg, rec.tokens)
                n_bytes += rec.nbytes
            self._m["migrate_pages"].labels("import").inc(len(alloc))
            self._m["migrate_bytes"].labels("import").inc(n_bytes)
        if rejected:
            self._m["migrate_pages"].labels("rejected").inc(
                len(rejected))
        self._update_kv_gauge()
        return {"imported": len(alloc), "duplicates": dups,
                "rejected": rejected}

    def close(self):
        _dbgsrv.unregister_status_provider(self._status_name)
        _dbgsrv.unregister_health_provider(self._status_name)
        _dbgsrv.unregister_reset_handler(self._status_name)
        # drop this engine's perf programs and memory-ledger rows: a
        # closed engine's pool must not keep reporting capacity
        _perf.instance().remove_scope(self._perf_scope)
        self._perf_programs.clear()
        _memobs.instance().remove_scope(self._mem_scope)
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
        self._update_kv_gauge()

    def _update_kv_gauge(self):
        usable = self.num_pages - 1
        self._m["kv_util"].set((usable - len(self._free_pages)) / usable)
        if self._cache is not None:
            self._m["shared_pages"].set(self._cache.shared_page_count)

    def _end_request_spans(self, req: _Request, outcome: str,
                           error=None) -> None:
        """Close every open span of the request's tree at one timestamp
        (idempotent); the root records the outcome."""
        sp = req.spans
        if sp is None:
            return
        tp = time.perf_counter()
        for key in ("queue", "prefill", "first_token", "decode"):
            s = sp.get(key)
            if s is not None and not s.ended:
                if error is not None:
                    s.set_status("error")
                s.end(tp)
        root = sp["root"]
        root.set_attr("outcome", outcome)
        root.set_attr("output_tokens", len(req.tokens))
        if error is not None:
            root.set_status("error").set_attr("error", str(error))
        root.end(tp)
        req.spans = None

    def _finish(self, slot: int):
        """Resolve and reclaim; called once the slot has no in-flight
        steps."""
        req = self._slots[slot]
        req.t_done = time.monotonic()
        self._free_slot(slot)
        with self._mu:
            self._by_id.pop(req.req_id, None)
        if req.future.done():
            # cancelled / deadline-exceeded mid-flight: resolved at the
            # boundary that aborted it; this pass reclaims the pages
            return
        if req.truncated:
            self._m["truncated"].inc()
        else:
            self._m["completed"].inc()
        # served FLOPs: the computed tokens' analytic cost (cached
        # prefix tokens excluded), counted once, at the finish
        served = self.flops_per_token * max(
            0, len(req.prompt) - req.n_cached + len(req.tokens))
        self._m["served_flops"].labels(req.tenant or "default").inc(
            served)
        if req.spans is not None:
            req.spans["root"].set_attr("served_flops", served)
            if req.tenant:
                req.spans["root"].set_attr("tenant", req.tenant)
        self._end_request_spans(
            req, "truncated" if req.truncated else "completed")
        out = {
            "prompt_ids": req.prompt,
            "output_ids": req.tokens,
            "truncated": req.truncated,
            "served_flops": served,
            "ttft_s": (req.t_first - req.t_submit)
            if req.t_first else None,
            "latency_s": req.t_done - req.t_submit,
        }
        if _audit.enabled():
            # a device retry must have re-emitted the exact prefix the
            # failed incarnation delivered
            if req.prior_tokens is not None:
                p = len(req.prior_tokens)
                pos = _audit.first_divergence(req.prior_tokens,
                                              req.tokens[:p])
                _audit.record(
                    self.audit_scope, "failover", pos is None,
                    position=pos,
                    chain_ours=_audit.chain_of(
                        req.nonce, req.tokens[:p]),
                    chain_theirs=req.prior_chain,
                    request_id=req.req_id, nonce=req.nonce,
                    knobs_ours=self.knob_fingerprint,
                    knobs_theirs=self.knob_fingerprint,
                    detail=f"device-retry prefix "
                           f"({req.device_retries} retry/ies, "
                           f"{p} prior token(s))")
            out["stream_digest"] = req.chain.hex()
            out["nonce"] = req.nonce
            out["knobs"] = self.knob_fingerprint
        req.future.set_result(out)

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

    def _typed_outcome(self, req: _Request):
        """(outcome, counter, exc) the API already promised this
        request, or None: an accepted cancel() beats an expired
        deadline beats nothing. One place decides, for the admission
        boundary, the per-tick police pass and the device-error
        handler."""
        if req.cancelled:
            return ("cancelled", self._m["cancelled"],
                    RequestCancelled(
                        f"request {req.req_id} cancelled after "
                        f"{len(req.tokens)} token(s)"))
        if req.deadline is not None and req.deadline.expired:
            return ("deadline", self._m["deadline"],
                    DeadlineExceeded(
                        f"request {req.req_id} deadline expired after "
                        f"{len(req.tokens)} token(s), "
                        f"{req.admit_attempts} admission attempt(s)"))
        return None

    def _abort_slot(self, slot: int, outcome: str, exc: BaseException,
                    counter) -> None:
        """Terminal mid-flight resolution (cancel / deadline): resolve
        the future now, close the span tree, stop issuing for the slot;
        the pages stay held until the in-flight steps drain past it."""
        req = self._slots[slot]
        if req in self._prefill_q:
            self._prefill_q = deque(
                r for r in self._prefill_q if r is not req)
        counter.inc()
        self._end_request_spans(req, outcome, error=exc)
        if not req.future.done():
            req.future.set_exception(exc)
        with self._mu:
            self._by_id.pop(req.req_id, None)
        self._begin_close(slot, accept_inflight=False)

    def _police_slots(self):
        """Per-tick boundary: cancellation and deadline expiry of the
        slotted requests."""
        for slot, req in enumerate(self._slots):
            if req is None or req.closing:
                continue
            promised = self._typed_outcome(req)
            if promised is not None:
                outcome, counter, exc = promised
                self._abort_slot(slot, outcome, exc, counter)

    def _update_health(self) -> None:
        if self._health != "draining":
            n = self._consec_device_errors
            if n >= self.drain_after:
                self._health = "draining"
            elif n >= self.degraded_after:
                self._health = "degraded"
            else:
                self._health = "healthy"
        self._m["health"].set(_HEALTH_CODE[self._health])

    def _perf_program(self, kind: str, sig: tuple, cost, steps: int = 1):
        """Register a program signature in the perf registry once per
        (kind, sig), with the analytic cost of the dispatch that first
        runs it. Callers gate on ``_perf.enabled()``."""
        key = (kind,) + tuple(sig)
        h = self._perf_programs.get(key)
        if h is None and key not in self._perf_programs \
                and len(self._perf_programs) < _perf.PROGRAM_CAP:
            h = _perf.register_program("llm", kind, sig=tuple(sig),
                                       cost=cost, steps=steps,
                                       scope=self._perf_scope)
            self._perf_programs[key] = h
        return h

    def _perf_attribute(self, kind: str, host_shape0: int, emitted: int,
                        cost) -> None:
        """Attribute the fetch-to-fetch wall interval to the drained
        record's program and breakdown phase (the interval
        ``_observe_step`` measures). Each program's first fetch, which
        waited on its kernels' first build and launch, goes to the
        "compile" phase instead. A "p" record covers every chunk
        dispatched since the last one (chunks that finish no prompt
        push no record), so it takes their summed cost."""
        n = 1
        if kind == "M":
            pkey = ("mixed_tick", host_shape0)
        elif kind == "S":
            pkey = ("spec_round", host_shape0)
        elif kind == "D":
            pkey = ("decode_loop", host_shape0)
        elif kind == "d":
            pkey = ("decode_step",)
        else:
            pkey = ("prefill_chunk",)
            n, f, b = self._perf_chunks
            n = max(1, n)
            cost = (f, b) if f else None
            self._perf_chunks = [0, 0.0, 0.0]
        if pkey not in self._perf_skipped:
            self._perf_skipped.add(pkey)
            if self._last_fetch_t is not None:
                cdt = time.monotonic() - self._last_fetch_t
                if _perf.enabled():
                    _perf.record_phase("llm", "compile", cdt)
                if _goodput.enabled():
                    _goodput.note("compile", cdt)
            return
        if self._last_fetch_t is None:
            return
        pdt = time.monotonic() - self._last_fetch_t
        if _perf.enabled():
            h = self._perf_programs.get(pkey)
            if h is not None:
                h.record(pdt, tokens=emitted, dispatches=n, cost=cost)
            _perf.record_phase(
                "llm", "prefill" if kind == "p" else "decode", pdt)
        if _goodput.enabled():
            _goodput.note("productive", pdt)

    def _count_dispatch(self, n: int = 1) -> None:
        """Engine-loop dispatches, counted as the JAX engine counts its
        jit dispatches (a slab is one)."""
        self.n_host_dispatches += n
        self._m["host_dispatches"].inc(n)

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
        prefills inline instead (:meth:`_admit_inline`). "shed": the
        engine is draining."""
        if self._health == "draining":
            return "shed"
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
        self._note_queue_wait(req)
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
        self._dequeue_accounting(req)
        self.temperatures[slot] = req.temperature
        self._nonces[slot] = req.nonce
        self._prefill_q.append(req)
        self.n_prompt_tokens += n
        self.n_cached_tokens += req.n_cached
        self._m["prompt_tokens"].inc(n)
        if req.n_cached:
            self._m["cache_hit_tokens"].inc(req.n_cached)
        self._m["cache_hit_rate"].set(
            self.n_cached_tokens / self.n_prompt_tokens)
        self._m["prefills"].inc()
        self._update_kv_gauge()
        if req.spans is not None:
            # queue ends and prefill begins at one timestamp
            tp = time.perf_counter()
            req.spans["queue"].end(tp)
            req.spans["prefill"] = _trace.start_span(
                "llm.prefill", parent=req.spans["root"], t0=tp,
                attrs={"slot": slot, "prompt_tokens": n,
                       "cache_hit_tokens": req.n_cached})
            req.spans["root"].add_event(
                "admitted", {"slot": slot,
                             "cache_hit_tokens": req.n_cached}, ts=tp)
        return "ok"

    def _note_queue_wait(self, req: _Request):
        """Admission decided: everything before now was queue wait."""
        qdt = time.monotonic() - req.t_enqueued
        self._m["queue_wait"].observe(qdt)
        if _goodput.enabled():
            _goodput.note("queue_wait", qdt)

    def _first_token_span(self, req: _Request):
        """The prompt is computed (its last chunk issued): what remains
        before the first token reaches the host is the drain."""
        if req.spans is not None:
            tp = time.perf_counter()
            req.spans["prefill"].end(tp)
            req.spans["first_token"] = _trace.start_span(
                "llm.first_token", parent=req.spans["root"], t0=tp)

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
        self._note_queue_wait(req)
        if req.spans is not None:
            tp = time.perf_counter()
            req.spans["queue"].end(tp)
            req.spans["prefill"] = _trace.start_span(
                "llm.prefill", parent=req.spans["root"], t0=tp,
                attrs={"slot": slot, "prompt_tokens": n,
                       "inline": True})
        # the slot owns the request before any page or device call, so
        # the device-error handler reclaims the pages of a failing
        # prefill and applies the retry budget
        req.slot = slot
        self._slots[slot] = req
        self._dequeue_accounting(req)
        for idx in range(need):
            self.block_tables[slot, idx] = self._alloc_page()
        if _faults.enabled():
            _faults.check("device.dispatch")
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
        self._count_dispatch(2)
        tokens = self._tokens_dev.clone()
        tokens[slot] = nxt
        self._tokens_dev = tokens
        self._issue_seq += 1
        self._inflight.append((self._issue_seq, [slot], tokens, "p", None))
        req.prefill_done = True
        self._first_token_span(req)
        self.context_lens[slot] = n
        self.temperatures[slot] = req.temperature
        self._nonces[slot] = req.nonce
        self.n_prompt_tokens += n
        self._m["prompt_tokens"].inc(n)
        self._m["prefills"].inc()
        self._update_kv_gauge()
        return "ok"

    def _draft_fill(self, tok, pos, lim, tbl, seq_rows: float = 0):
        """The draft's ride-along over a packed chunk schedule (device
        tensors [T] / [T, P]): the same rows through the draft net into
        its pool, so every prompt position a verify window reads has
        draft KV. Prefill and quantize-on-write are deterministic, so a
        shared prefix page holds the same draft KV for every request
        that maps it."""
        _ragged_forward(self.draft_net, tok, pos, lim, tbl,
                        self.draft_k_pages, self.draft_v_pages,
                        self._draft_decode.attention_impl, seq_rows)
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

    def _pack_chunk(self, T: int, tok, pos, lim, tbl, tick=None):
        """Fill one chunk's rows (the [T] / [T, P] arrays given) from
        the prefill queue's head request(s). Returns the requests whose
        rows it holds, (request, row of its last prompt token) for
        those whose prompt completes in it, and the KV tokens the chunk
        reads (each request's context up to its last row, once)."""
        touched, finishing = [], []
        used = kv = 0
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
            kv += req.prefill_pos
            touched.append(req)
            if req.spans is not None:
                ev = {"tokens": take, "pos": req.prefill_pos}
                if tick is not None:
                    ev["tick"] = tick
                req.spans["prefill"].add_event("chunk", ev)
            if req.prefill_pos >= n:
                self._prefill_q.popleft()
                finishing.append((req, used - 1))
            else:
                break   # chunk budget exhausted mid-prompt
        return touched, finishing, kv

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
        touched, finishing, kv = self._pack_chunk(T, tok, pos, lim, tbl)
        for req, row in finishing:
            sample_idx[req.slot] = row
            sample_pos[req.slot] = len(req.prompt) - 1
        if _faults.enabled():
            _faults.check("device.dispatch")
        if _perf.enabled():
            cost = _pass_cost(self._costs["target"], T, int(lim.sum()),
                              kv, self.max_seqs)
            self._perf_program("prefill_chunk", (), cost)
            pc = self._perf_chunks
            self._perf_chunks = [pc[0] + 1, pc[1] + cost[0],
                                 pc[2] + cost[1]]
        run = rows_per_run(lim, tbl, self.page_size)
        tok, pos, lim, tbl = map(self._dev, (tok, pos, lim, tbl))
        nxt = self._chunk(
            tok, pos, lim, tbl, self._dev(sample_idx),
            self._dev(sample_pos), self.k_pages, self.v_pages,
            self._dev(self.temperatures), self._dev(self._nonces),
            self._key,
            any_sampled=self._any_sampled(r.slot for r, _ in finishing),
            seq_rows=run)
        self._count_dispatch()
        if self.spec_slab:
            self._draft_fill(tok, pos, lim, tbl, run)
            self._count_dispatch()
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
                self._first_token_span(req)
        self._register_pages(touched)
        self.n_prefill_ticks += 1
        self.n_dispatched_ticks += 1
        self._m["prefill_ticks"].inc()
        self._update_kv_gauge()

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
        if _faults.enabled():
            _faults.check("device.dispatch")
        meta = None
        if _perf.enabled():
            n_ctx = int(lens.sum())
            meta = {"cost": _pass_cost(self._costs["target"],
                                       self.max_seqs, n_ctx, n_ctx,
                                       self.max_seqs)}
            self._perf_program("decode_step", (), meta["cost"])
        tokens = self._decode(
            self._tokens_dev, self._dev(positions),
            self._dev(self.block_tables), self._dev(lens), self.k_pages,
            self.v_pages, self._dev(self.temperatures),
            self._dev(self._nonces), self._key,
            any_sampled=self._any_sampled(live))
        self._count_dispatch()
        self._tokens_dev = tokens
        self._issue_seq += 1
        self._inflight.append((self._issue_seq, list(live), tokens, "d",
                               meta))
        for slot in live:
            self.context_lens[slot] += 1
        self.n_decode_ticks += 1
        self.n_dispatched_ticks += 1
        self._m["decode_ticks"].inc()
        self._m["occupancy"].observe(len(live) / self.max_seqs)
        self._update_kv_gauge()

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
                  xs: Optional[dict] = None, seq_rows=()):
        """``n_ticks`` ticks issued back to back with no host read
        between them: each is the decode step (or, given the packed
        chunk rows ``xs``, the mixed tick, whose sequences hold
        ``seq_rows[j]`` rows on average) masked by ``budgets > 0``.
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
                    any_sampled=any_sampled, seq_rows=seq_rows[j])
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
        if _faults.enabled():
            _faults.check("device.dispatch")
            _faults.check("engine.slab")
        pos0 = {s: plan[s][0] for s in live}
        meta = {"budgets": budgets, "pos0": pos0}
        if _perf.enabled():
            meta["cost"] = self._slab_cost(n_eff, budgets, pos0, {}, 0)
            self._perf_program("decode_loop", (n_eff,), meta["cost"],
                               steps=n_eff)
        toks, carry = self._run_slab(self._carry(pos0, budgets), n_eff,
                                     self._any_sampled(live))
        self._count_dispatch()
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        # context_lens advances at the DRAIN (mid-slab EOS decides how
        # far each slot went)
        self._inflight.append((self._issue_seq, list(live), toks, "D",
                               meta))
        self._m["occupancy"].observe(len(live) / self.max_seqs)
        self._update_kv_gauge()

    def _slab_cost(self, n_ticks: int, budgets, pos0, start,
                   chunk_rows: int, chunk_attn: int = 0,
                   chunk_kv: int = 0):
        """Analytic (FLOPs, bytes) of a decode or mixed slab of
        ``n_ticks`` ticks, each B decode rows (+ ``chunk_rows`` chunk
        rows of a mixed tick, attending ``chunk_attn`` and reading
        ``chunk_kv`` tokens over the whole slab). A decode slot
        attends pos0 + 1 + t tokens at its t-th tick; a slot whose
        prompt completes at tick j0 decodes from j0 + 1 (its first
        token comes from its chunk row). EOS is not foreseen."""
        ctx = 0
        for slot, b in budgets.items():
            first = 1 if slot in start else 0
            ctx += sum(pos0[slot] + 1 + t for t in range(first, b))
        B = self.max_seqs
        return _pass_cost(self._costs["target"],
                          n_ticks * (B + chunk_rows), ctx + chunk_attn,
                          ctx + chunk_kv, n_ticks * B, passes=n_ticks)

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
        pticks = chunk_kv = 0
        for j in range(n_eff):
            if not self._prefill_q:
                # queue drained: stop here; the next iteration's decode
                # slab serves the rest without padded chunk rows
                break
            tch, finishing, kv = self._pack_chunk(
                C, ptok[j], ppos[j], plim[j], ptbl[j], tick=j)
            touched += [r for r in tch if r not in touched]
            pticks += 1
            chunk_kv += kv
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
                self._first_token_span(req)
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
        if _faults.enabled():
            _faults.check("device.dispatch")
            _faults.check("engine.slab")
        meta = {"budgets": meta_bud, "pos0": meta_pos0, "start": start}
        n_prefill_tokens = int((plim[:n_run] > 0).sum())
        if _perf.enabled():
            meta["cost"] = self._slab_cost(
                n_run, meta_bud, meta_pos0, start, C,
                int(plim[:n_run].sum()), chunk_kv)
            self._perf_program("mixed_tick", (n_run,), meta["cost"],
                               steps=n_run)
        xs = {"tok": ptok, "pos": ppos, "lim": plim, "tbl": ptbl,
              "fin": fin, "row": fin_row, "fpos": fin_pos,
              "grant": grant}
        xs = {k: self._dev(np.ascontiguousarray(v[:n_run]))
              for k, v in xs.items()}
        # the rows a sequence holds in each tick: its chunk's runs, and a
        # run of one row for each slot that decodes in the slab
        runs = []
        for j in range(n_run):
            live, n = run_counts(plim[j], ptbl[j], ps)
            runs.append((live + len(slots)) / (n + len(slots))
                        if n + len(slots) else 0.0)
        toks, carry = self._run_slab(
            self._carry({s: plan[s][0] for s in plan},
                        {s: min(entry_bud[s], n_run) for s in plan}),
            n_run, self._any_sampled(slots), xs, runs)
        self._count_dispatch()
        if self.spec_slab:
            # padding rows carry limit 0 and write scratch page 0
            self._draft_fill(xs["tok"].reshape(-1), xs["pos"].reshape(-1),
                             xs["lim"].reshape(-1),
                             xs["tbl"].reshape(-1, self.pages_per_seq),
                             rows_per_run(plim[:n_run].reshape(-1),
                                          ptbl[:n_run].reshape(-1, P), ps))
            self._count_dispatch()
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        self._inflight.append((self._issue_seq, slots, toks, "M", meta))
        self._register_pages(touched)
        self.n_mixed_slabs += 1
        self.n_prefill_ticks += pticks
        self._m["prefill_ticks"].inc(pticks)
        self._m["mixed_slabs"].inc()
        if n_prefill_tokens:
            self._m["mixed_prefill_tokens"].inc(n_prefill_tokens)
        self._m["occupancy"].observe(len(slots) / self.max_seqs)
        self._update_kv_gauge()

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
        if _faults.enabled():
            _faults.check("device.dispatch")
            _faults.check("engine.slab")
        # every active round commits >= 1 token a slot, so rounds past
        # the largest budget would all be idle
        n_run = min(N, max(budgets.values()))
        meta = {"budgets": budgets, "pos0": pos0s}
        if _perf.enabled():
            meta["cost"] = self._spec_cost(n_run, pos0s)
            self._perf_program("spec_round", (n_run,), meta["cost"],
                               steps=n_run)
        ys, carry = self._run_spec_slab(self._carry(pos0s, budgets),
                                        self._dev(cov), n_run,
                                        self._any_sampled(live))
        self._count_dispatch()
        self._tokens_dev = carry.tokens
        self._issue_seq += 1
        # context_lens advances at the drain, from the realized counts
        self._inflight.append((self._issue_seq, list(live), ys, "S",
                               meta))
        self._m["occupancy"].observe(len(live) / self.max_seqs)
        self._update_kv_gauge()

    def _spec_cost(self, n_rounds: int, pos0s):
        """Analytic (FLOPs, bytes) of ``n_rounds`` spec rounds: K draft
        probes of B rows and one verify window of B x K rows a round,
        every row through its LM head; contexts taken at their entry
        positions (acceptance is not foreseen)."""
        B, K = self.max_seqs, self.spec_k
        ctx = sum(p + 1 for p in pos0s.values())
        fd, bd = _pass_cost(self._costs["draft"], B * K, ctx * K, ctx,
                            B * K, passes=K)
        fv, bv = _pass_cost(self._costs["target"], B * K, ctx * K, ctx,
                            B * K)
        return (n_rounds * (fd + fv), n_rounds * (bd + bv))

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
        if _faults.enabled():
            _faults.check("device.dispatch")
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
            self._count_dispatch()
            if j < K - 1:
                tok_cols.append(cur)
        tokens_mat = torch.stack(tok_cols, dim=1)
        greedy = torch.argmax(
            self._verify(tokens_mat, self._dev(base_arr), tables,
                         self.k_pages, self.v_pages), dim=-1)
        self._count_dispatch()
        self.n_draft_steps += K
        self.n_draft_passes += K
        self.n_dispatched_ticks += 1
        self.n_spec_rounds += 1
        self.n_steps += 1
        self._m["spec_rounds"].inc()
        self._m["occupancy"].observe(len(live) / self.max_seqs)
        self._update_kv_gauge()
        host_g = greedy.cpu().numpy()          # the round's host read
        host_d = tokens_mat.cpu().numpy()
        new_last = self._tokens_dev.cpu().numpy().copy()
        emitted = 0
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
                if _audit.enabled():
                    # accepted runs land here, not through
                    # _deliver_token: the same chain rule
                    req.chain = _audit.extend(req.chain, req.nonce,
                                              len(req.tokens) - 1,
                                              int(tok))
                self.n_tokens += 1
                emitted += 1
                if self._harvest(slot):
                    break
            # the cache is valid over t0 .. d_i; g_i is the next input
            self.context_lens[slot] = int(base_arr[slot]) + i + 1
            new_last[slot] = int(g[i])
            if self._harvest(slot):
                self._begin_close(slot)
        self._tokens_dev = self._dev(new_last)
        self._m["spec_draft_tokens"].inc(len(live) * (K - 1))
        if self.n_spec_proposed:
            self._m["spec_accept_rate"].set(
                self.n_spec_accepted / self.n_spec_proposed)
        self._observe_step(emitted)
        self._maybe_finalize()

    def _deliver_token(self, slot: int, req: _Request, tok: int,
                       seq: int) -> None:
        """Append ONE fetched token to its request: the stream chain,
        TTFT on the first, span bookkeeping, EOS, length harvest."""
        if _faults.enabled():
            # audit.flip: corrupt this token (seeded, replayable) before
            # the chain extends over it, so the corrupted stream is
            # self-consistent and only a chain-vs-chain check sees it
            try:
                _faults.check("audit.flip")
            except _faults.FaultInjected:
                tok = int(tok) ^ 1
        req.tokens.append(tok)
        if _audit.enabled():
            req.chain = _audit.extend(req.chain, req.nonce,
                                      len(req.tokens) - 1, tok)
        self.n_tokens += 1
        if req.t_first is None:
            req.t_first = time.monotonic()
            self._m["ttft"].observe(req.t_first - req.t_submit)
            if req.spans is not None:
                tp = time.perf_counter()
                ft = req.spans.get("first_token")
                if ft is not None:
                    ft.end(tp)
                req.spans["decode"] = _trace.start_span(
                    "llm.decode", parent=req.spans["root"], t0=tp)
                req.spans["root"].add_event(
                    "first_token",
                    {"ttft_s": round(req.t_first - req.t_submit, 6)},
                    ts=tp)
        elif req.spans is not None and "decode" in req.spans:
            req.spans["decode"].add_event(
                "fetch", {"n_tokens": len(req.tokens), "issue_seq": seq})
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
        if _faults.enabled():
            _faults.check("device.transfer")
        seq, slots, tokens, kind, meta = self._inflight.popleft()
        if kind == "S":
            # (committed tokens [N, B, K], realized counts [N, B])
            host = tokens[0].cpu().numpy()
            host_emit = tokens[1].cpu().numpy()
        else:
            host = tokens.cpu().numpy()      # the only blocking fetch
        self._fetch_seq = seq
        if self._consec_device_errors:
            # a successful fetch ends the error streak (draining is
            # sticky until reset_health)
            self._consec_device_errors = 0
            self._update_health()
        if kind == "S":
            emitted = self._drain_spec_slab(seq, slots, host, host_emit,
                                            meta)
        elif kind in ("D", "M"):
            emitted = self._drain_slab(seq, slots, host, meta)
        else:
            if kind == "d":
                self.n_steps += 1
            emitted = 0
            for slot in slots:
                req = self._slots[slot]
                if self._wants(req):
                    self._deliver_token(slot, req, int(host[slot]), seq)
                    emitted += 1
        if _perf.enabled() or _goodput.enabled():
            self._perf_attribute(
                kind, host.shape[0] if kind in ("D", "M", "S") else 0,
                emitted, meta.get("cost") if meta else None)
        self._observe_step(emitted, timed=(kind != "p"))
        self._maybe_finalize()

    def _drain_slab(self, seq: int, slots: List[int], host,
                    meta: dict) -> int:
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
                self._deliver_token(slot, req, tok, seq)
                emitted[slot] += 1
        ticks = max(emitted.values(), default=0)
        for slot in slots:
            if self._slots[slot] is not None:
                self.context_lens[slot] = meta["pos0"][slot] + \
                    emitted[slot]
                sp = self._slots[slot].spans
                if sp is not None and "decode" in sp:
                    sp["decode"].add_event(
                        "slab", {"issue_seq": seq, "ticks": ticks,
                                 "tokens": emitted[slot]})
        self.n_steps += ticks
        self.n_decode_ticks += ticks
        self._m["decode_ticks"].inc(ticks)
        self._m["slab_ticks"].observe(ticks)
        return sum(emitted.values())

    def _drain_spec_slab(self, seq: int, slots: List[int], host_t,
                         host_emit, meta: dict) -> int:
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
        rounds = proposed = 0
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
                proposed += K - 1
                self.n_spec_proposed += K - 1
                self.n_spec_accepted += e - 1
                for t in range(e):
                    tok = int(host_t[j, slot, t])
                    remaining[slot] -= 1
                    if tok == self._eos:
                        remaining[slot] = 0  # the device zeroed it too
                    self._deliver_token(slot, req, tok, seq)
                    emitted[slot] += 1
                    if remaining[slot] <= 0:
                        break
                    if req.closing and not req.accepts_inflight:
                        remaining[slot] = 0
                        break
            if row_live:
                rounds += 1
        for slot in slots:
            if self._slots[slot] is not None:
                self.context_lens[slot] = meta["pos0"][slot] + \
                    emitted[slot]
                sp = self._slots[slot].spans
                if sp is not None and "decode" in sp:
                    sp["decode"].add_event(
                        "slab", {"issue_seq": seq, "rounds": rounds,
                                 "tokens": emitted[slot]})
        self.n_steps += rounds
        self.n_spec_rounds += rounds
        self.n_draft_steps += rounds * K
        if rounds:
            self._m["spec_rounds"].inc(rounds)
        if proposed:
            self._m["spec_draft_tokens"].inc(proposed)
        if self.n_spec_proposed:
            self._m["spec_accept_rate"].set(
                self.n_spec_accepted / self.n_spec_proposed)
        self._m["slab_ticks"].observe(rounds)
        return sum(emitted.values())

    def _observe_step(self, emitted: int, timed: bool = True):
        """Per-fetch timing into the step-time and tokens/s histograms
        (fetch to fetch). ``timed=False`` (first-token fetches): count
        the tokens, keep prefill wall time out of the decode
        histograms, and restart the fetch clock."""
        now = time.monotonic()
        if timed and self._last_fetch_t is not None:
            dt = now - self._last_fetch_t
            self._m["step"].observe(dt)
            if dt > 0 and emitted:
                self._m["tps"].observe(emitted / dt)
        if emitted:
            self._m["tokens"].inc(emitted)
        self._last_fetch_t = now

    @torch.inference_mode()
    def _loop(self):
        while True:
            try:
                with self._mu:
                    closed = self._closed
                    pending, self._pending = self._pending, []
                    ctl, self._ctl = self._ctl, []
                # control ops run here: the previous iteration drained
                # its launches to the lag boundary, and every launch
                # runs on one stream. Each op resolves its own future.
                for op, _fut in ctl:
                    op()
                # higher priority admits first; FIFO (submission order)
                # within a priority; retries re-sort with new arrivals
                pending.sort(key=lambda r: (-r.priority, r.req_id))
                for req in pending:
                    self._harvest_admit(req)
                self._police_slots()
                self._m["queue_depth"].set(self._n_queued)
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
                self._m["prefill_queue"].set(len(self._prefill_q))
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
                if self.n_decode_ticks or self.n_prefill_ticks:
                    self._m["tick_ratio"].set(
                        self.n_prefill_ticks / max(1, self.n_decode_ticks))
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
                # an idle gap ends here: the first fetch after it must
                # not time the whole wait as one decode step
                self._last_fetch_t = None
                if not any(s is not None for s in self._slots):
                    if closed:
                        with self._mu:
                            leftovers, self._pending = self._pending, []
                            ctl_left, self._ctl = self._ctl, []
                        for req in leftovers:
                            self._end_request_spans(
                                req, "failed", error="engine closed")
                            req.future.set_exception(
                                EngineClosed("engine closed"))
                        for _op, fut in ctl_left:
                            if not fut.done():
                                fut.set_exception(
                                    EngineClosed("engine closed"))
                        return
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as e:  # noqa: BLE001 - resolve the futures
                self._on_device_error(e, pending)

    def _on_device_error(self, e: Exception, pending: List[_Request]):
        """A device error (or an injected fault) in the loop: fail OR
        re-admit the slotted requests (``device_retry_budget``), reclaim
        their pages, walk the health state machine, and keep serving.
        An out-of-memory error first flight-dumps the memory ledger's
        owner table, before any page is reclaimed. A sticky CUDA error
        poisons the context, so its retries fail again and the health
        walks to "draining"."""
        _memobs.maybe_dump_oom(e, component="llm")
        self._inflight.clear()
        self._prefill_q.clear()
        self._fetch_seq = self._issue_seq
        self._perf_chunks = [0, 0.0, 0.0]
        self._consec_device_errors += 1
        self._m["device_errors"].inc()
        if _goodput.enabled() and self._last_fetch_t is not None:
            # the failed call's window is recovery badput
            now_m = time.monotonic()
            _goodput.note("recovery", now_m - self._last_fetch_t)
            self._last_fetch_t = now_m
        self._update_health()
        # closers whose generation completed resolve successfully; ones
        # still owed in-flight tokens resolve short, truncated
        for slot, s in enumerate(self._slots):
            if s is not None and s.closing:
                if s.accepts_inflight and \
                        len(s.tokens) < s.max_new_tokens:
                    s.truncated = True
                self._finish(slot)
        retried = set()
        for slot, s in enumerate(self._slots):
            if s is None:
                continue
            self._free_slot(slot)
            if self._retry_after_device_error(s, e):
                retried.add(id(s))
                continue
            # an outcome the API already promised (cancel accepted,
            # deadline expired) wins over the error
            outcome, counter, exc = self._typed_outcome(s) or \
                ("failed", self._m["failed"], e)
            counter.inc()
            self._end_request_spans(s, outcome, error=exc)
            if not s.future.done():
                s.future.set_exception(exc)
            with self._mu:
                self._by_id.pop(s.req_id, None)
        # requests of this iteration's batch that were never admitted
        # did not touch the device: back into the admission queue
        with self._mu:
            for req in pending:
                if id(req) in retried or req.future.done():
                    continue
                if not any(r is req for r in self._pending):
                    self._pending.append(req)
            self._pending = [r for r in self._pending
                             if not r.future.done()]
        if self._cache is not None:
            # every slot is free, so every shared page is at refcount
            # zero: drop them (a failed call may have left registered
            # pages with wrong KV)
            self._free_pages.extend(self._cache.flush())

    def _retry_after_device_error(self, req: _Request,
                                  err: Exception) -> bool:
        """Re-admit a slotted request whose step died (its pages are
        already reclaimed) instead of failing it, up to
        ``device_retry_budget`` times. The nonce is kept, so the stream
        is identical; a retry only costs latency."""
        if req.device_retries >= self.device_retry_budget \
                or req.cancelled or req.future.done() \
                or (req.deadline is not None and req.deadline.expired):
            return False
        req.device_retries += 1
        self._m["device_retries"].inc()
        # the stream before the reset: _finish checks the retry
        # re-emitted this exact prefix
        if _audit.enabled() and req.tokens:
            req.prior_tokens = req.tokens
            req.prior_chain = req.chain
        req.tokens = []
        req.chain = b""
        req.slot = -1
        req.truncated = False
        req.t_first = None
        req.t_enqueued = time.monotonic()   # a fresh admission cycle
        req.prefill_pos = 0
        req.prefill_done = False
        req.n_cached = 0
        req.n_reg_pages = 0
        req.closing = False
        req.accepts_inflight = False
        if req.spans is not None:
            tp = time.perf_counter()
            for key in ("queue", "prefill", "first_token", "decode"):
                sp = req.spans.get(key)
                if sp is not None and not sp.ended:
                    sp.set_status("error").end(tp)
            req.spans["root"].add_event(
                "device_retry",
                {"attempt": req.device_retries,
                 "error": str(err)[:200]}, ts=tp)
            req.spans["queue"] = _trace.start_span(
                "llm.queue", parent=req.spans["root"], t0=tp)
        with self._mu:
            self._pending.append(req)
            req.queued = True
            self._n_queued += 1
        return True

    def _dequeue_accounting(self, req: _Request) -> None:
        """The request left the admission queue (took a slot, or was
        resolved without one); idempotent."""
        with self._mu:
            if req.queued:
                req.queued = False
                self._n_queued -= 1

    def _resolve_queued(self, req: _Request, outcome: str,
                        exc: BaseException, counter) -> None:
        """Terminal resolution of a request that never reached a
        slot."""
        counter.inc()
        self._end_request_spans(req, outcome, error=exc)
        if not req.future.done():
            req.future.set_exception(exc)
        with self._mu:
            self._by_id.pop(req.req_id, None)
        self._dequeue_accounting(req)

    def _harvest_admit(self, req: _Request):
        """Admit, re-queue, or resolve terminally: the admission
        boundary enforces the deadline, the cancel flag and
        ``admit_timeout``."""
        promised = self._typed_outcome(req)
        if promised is not None:
            outcome, counter, exc = promised
            self._resolve_queued(req, outcome, exc, counter)
            return
        if self.admit_timeout is not None and \
                time.monotonic() - req.t_enqueued > self.admit_timeout:
            self._resolve_queued(
                req, "admission_timeout",
                AdmissionTimeout(
                    f"request {req.req_id} not admitted within "
                    f"admit_timeout={self.admit_timeout}s "
                    f"({req.admit_attempts} attempt(s); pages never "
                    f"freed)"),
                self._m["admit_timeout"])
            return
        verdict = self._admit(req)
        if verdict == "never":
            self._resolve_queued(
                req, "failed",
                ValueError(
                    f"prompt of {len(req.prompt)} tokens cannot fit the "
                    f"KV page pool ({self.num_pages - 1} usable pages "
                    f"of {self.page_size} tokens, {self.pages_per_seq} "
                    f"pages/sequence)"),
                self._m["failed"])
        elif verdict == "shed":
            self._resolve_queued(
                req, "shed",
                AdmissionShed("engine is draining (health state "
                              "machine)", reason="draining"),
                self._m["shed"])
        elif verdict == "retry":
            req.admit_attempts += 1
            if req.spans is not None:
                req.spans["queue"].attrs["retries"] = req.admit_attempts
            with self._mu:
                self._pending.append(req)


def serve_llm(engine, host: str = "127.0.0.1", port: int = 0):
    """Minimal HTTP front for the engine (POST /generate with JSON
    {"prompt_ids": [...], "max_new_tokens": N, "temperature": t,
    "deadline_s": s, "priority": p, "nonce": n}; POST /cancel with
    {"request_id": id}). ``engine`` is anything with the engine's
    ``submit``/``cancel`` surface; bodies may also carry "tenant"
    (and, for a fleet router, "slo").
    Returns the live ThreadingHTTPServer (serve_forever on a daemon
    thread); .server_address gives the bound (host, port).

    Error mapping (the JAX engine's ``serve_llm``'s, which a fleet
    router routes on): shed → 429 (queue overflow;
    retry elsewhere/later) or 503 (draining engine; out of rotation
    until reset), DeadlineExceeded/AdmissionTimeout → 504,
    RequestCancelled → 499 (client-abandoned, nginx convention).

    Both endpoints honor a W3C ``traceparent`` request header
    (observability.propagation): the engine's span tree roots under
    the remote caller's span, giving the fleet one trace_id per
    request end to end. Absent/malformed headers degrade to a local
    root — never an error."""
    import json
    from http.server import (BaseHTTPRequestHandler,
                             ThreadingHTTPServer)

    class Handler(BaseHTTPRequestHandler):
        def _generate(self, body: dict):
            try:
                dl = body.get("deadline_s")
                kw = dict(
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    temperature=float(body.get("temperature", 0.0)),
                    deadline=float(dl) if dl is not None else None,
                    priority=int(body.get("priority", 0)))
                if body.get("nonce") is not None:
                    kw["nonce"] = int(body["nonce"])
                for k in ("tenant", "slo"):  # router-only fields
                    if body.get(k) is not None:
                        kw[k] = body[k]
                # cross-process trace propagation: a traceparent
                # header parents this request's span tree under the
                # caller's (the fleet router's router.dispatch) span.
                # Malformed values degrade to a local root inside
                # submit — a bad header can never 400 a generation
                tp = self.headers.get("traceparent")
                if tp is not None:
                    kw["trace_context"] = tp
                fut = engine.submit(body["prompt_ids"], **kw)
                out = fut.result(timeout=600)
            except AdmissionShed as e:
                # the load-shedding verdict maps to HTTP backpressure.
                # 429: transient overload, retry elsewhere/later.
                # 503: DRAINING — this engine is out of rotation until
                # an operator resets it; a balancer/router must stop
                # sending new admissions entirely.
                code = 503 if getattr(e, "reason", "") == "draining" \
                    else 429
                out = {"error": str(e), "outcome": "shed",
                       "reason": getattr(e, "reason", "")}
                # backpressure contract: a shed tells clients
                # WHEN to come back. The overload controller computes
                # the value from its limiter/ladder state and attaches
                # it to the verdict; a plain engine shed falls back to
                # a nominal second. do_POST forwards it as the
                # Retry-After header; an OverloadShed's prediction
                # rides along so the refusal is auditable client-side.
                ra = getattr(e, "retry_after_s", None)
                out["retry_after_s"] = float(ra) if ra else 1.0
                if getattr(e, "predicted_s", None) is not None:
                    out["predicted_s"] = e.predicted_s
                    out["deadline_s"] = e.deadline_s
                return code, out
            except (DeadlineExceeded, AdmissionTimeout) as e:
                return 504, {"error": str(e), "outcome": "deadline"}
            except RequestCancelled as e:
                return 499, {"error": str(e), "outcome": "cancelled"}
            except EngineClosed as e:
                # a closing replica is out of rotation, not a client
                # error: 503 tells the router to rebalance budget-free
                return 503, {"error": str(e), "outcome": "shed",
                             "reason": "draining", "retry_after_s": 1.0}
            except Exception as e:  # noqa: BLE001 — report to client
                return 400, {"error": str(e)}
            out["request_id"] = getattr(fut, "request_id", None)
            return 200, out

        def _cancel(self, body: dict):
            # cancels propagate too: the cancel lands in the SAME
            # trace as the request it kills, so a cross-process story
            # ("the router cancelled this mid-decode") reads end to
            # end on one timeline
            cspan = None
            if _trace.enabled():
                ctx = _propagation.extract(
                    self.headers.get("traceparent"))
                cspan = _trace.start_span(
                    "llm.cancel", parent=ctx,
                    attrs={"request_id": body.get("request_id")})
            try:
                ok = engine.cancel(int(body["request_id"]))
            except Exception as e:  # noqa: BLE001 — report to client
                if cspan is not None:
                    cspan.set_status("error")
                    cspan.set_attr("error", str(e)).end()
                return 400, {"error": str(e)}
            if cspan is not None:
                cspan.set_attr("cancelled", bool(ok)).end()
            return 200, {"cancelled": bool(ok)}

        def _kv_pages(self, body: dict):
            # KV-page migration endpoint (disaggregated fleet):
            # {"digests": [hex, ...]} exports; {"payload": {...}}
            # imports. Only real engines expose the surface — a
            # router fronted by serve_llm 404s here by design (page
            # transfer is replica-to-replica, not through the router's
            # public face).
            exp = getattr(engine, "export_pages", None)
            imp = getattr(engine, "import_pages", None)
            if exp is None or imp is None:
                return 404, {"error": "no KV-page surface"}
            try:
                if "digests" in body:
                    return 200, exp(body["digests"])
                return 200, imp(body["payload"])
            except EngineClosed as e:
                return 503, {"error": str(e), "outcome": "shed",
                             "reason": "draining"}
            except _faults.FaultInjected as e:
                # injected transfer fault: a 5xx the HTTP client maps
                # to ReplicaUnavailable — the router's migrate step
                # falls back to local recompute
                return 500, {"error": str(e), "outcome": "fault"}
            except Exception as e:  # noqa: BLE001 — report to client
                return 400, {"error": str(e)}

        def do_POST(self):
            routes = {"/generate": self._generate,
                      "/cancel": self._cancel,
                      "/kv_pages": self._kv_pages}
            fn = routes.get(self.path)
            if fn is None:
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                code, out = 400, {"error": "malformed JSON body"}
            else:
                code, out = fn(body)
            payload = json.dumps(out).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            # 429/503 backpressure rides a standard header so ANY
            # client — HTTPReplica, a curl, an external balancer —
            # can honor the fleet's backoff without parsing the body
            if code in (429, 503) and isinstance(out, dict) \
                    and out.get("retry_after_s") is not None:
                self.send_header("Retry-After",
                                 str(out["retry_after_s"]))
            # stream-integrity contract: a generate response carries
            # its chain head + the serving engine's knob fingerprint
            # as headers too, so a caller can verify/compare without
            # parsing the body (router-fronted responses relay the
            # SERVING replica's values — they ride the result dict)
            if code == 200 and isinstance(out, dict):
                if out.get("stream_digest") is not None:
                    self.send_header("X-Stream-Digest",
                                     str(out["stream_digest"]))
                if out.get("knobs"):
                    self.send_header("X-Engine-Knobs",
                                     json.dumps(out["knobs"],
                                                sort_keys=True))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):  # quiet test output
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
