#!/usr/bin/env python3
"""Smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, compiled from ``csrc/`` by
   ``nvcc`` for sm_90a (with the ptxas register report and, where the
   toolkit has ``cuobjdump``, each kernel's count of tensor-core
   instructions in its SASS);
3. kernels: kernel B4 against its plain PyTorch twin at the serving
   path's shapes and dtypes (decode, a prefill chunk of two sequences
   and padding, GQA, one 1024-token row, head dims 80 and 256, a mixed
   tick of 64 chunk rows and 8 decode rows sharing a 32-page prefix,
   pages of 128 and 256 tokens, 40 and 64 q heads on one kv head, head
   dim 320, a speculative verify window of 8 slots x 4 rows with rising
   limits, f32 and int8, and the same rows reversed within each slot),
   with its device time (``torch.profiler``; CUDA events
   beside it) beside the plain twin's, a one-call PyTorch yardstick's
   and the least time the card could take;
4. flash kernels: B1, B2 and B3 the same way at the training path's
   shapes (gpt2-small bf16 and f32, llama-style GQA, cross-length, head
   dim 80, head dims 256 f32, 320 bf16 and 264 f16 in the split-d
   kernels, and lengths 97 and 200 / 136 that end in a partial tile),
   each kernel's device time (``torch.profiler``) taken in
   turns with its twin's and SDPA's (median of 3 windows of 20 calls);
5. serve: GPT-2-small at full width (random weights from ``seed(0)``)
   serving eight requests through ``LLMEngine`` with its defaults
   (prefix cache, mixed tick) on kernel B4, then on the plain twin
   (token streams must be identical), then once more under
   ``torch.profiler`` (device time by kernel), then on the alternating
   loop with the cache and the mixed tick off, and on that loop with
   ``lookahead=2`` (streams identical to the main run's), then 32 greedy
   streams on an int8 KV pool against an f32 pool (agreement >= 0.9);
   then shared-prefix chat traffic (a 512-token system prompt, one
   request first, then 7 at once) on the default engine, on 4-tick
   decode slabs and with the cache and the mixed tick off: identical
   streams, 7 x 512 cached prompt tokens, B4 launched once a layer per
   dispatched tick; then speculative decoding (K 4) on the main traffic
   with a distilgpt2-shaped draft (the target's first 6 layers): the
   spec slab at N 1 and 4, on the plain twin, with the target as its
   own draft, the legacy inline round, 32 greedy streams on an int8
   pool, and a profiled run (greedy streams equal the main run's, the
   kernel run's equal the twin's, a self-draft accepting >= 0.99 of
   what the budgets allow, int8 agreement >= 0.9, B4 launched once a
   layer per paged pass of the target and of the draft);
6. serve_http: the main serve cell's engine behind ``serve_llm`` with
   the debug server up: the main traffic as 8 concurrent POSTs, in
   turns with direct ``submit`` (streams equal to the direct run's,
   ``X-Stream-Digest`` equal to the stream's audit chain,
   ``X-Engine-Knobs`` equal to the body's knobs, B4 launched once a
   layer per dispatched tick, ``/metrics`` counting the tokens
   delivered), the error map (429, 503, 504, 499, 400 and their
   counters; healthy and serving afterwards; ``/memz``, ``/perfz``,
   ``/healthz`` and ``/statusz`` scraped), a seeded device fault in
   the middle of the main traffic with ``device_retry_budget=1``
   (streams equal to the fault-free run's, retries counted, clean
   failover verdicts), a 32-page KV migration of the 512-token system
   prompt between two engines (7 x 512 cached tokens, identical
   streams), the control plane's cost (the audit, goodput, memory and
   perf ledgers on against off, in turns A B B A), a profiled HTTP run
   and a cProfile of the engine's worker thread;
7. fleet: the serve traffic through ``paddle_tpu_torch.serving``'s
   ``Router`` over replica processes on the card (``spawn_replica``,
   TCPStore membership), each an engine on kernel B4: two replicas in
   turns with one in-process engine (D F F D) and the shared-prefix
   burst on its affinity replica (7 x 512 cached tokens there); a
   SIGKILL with requests in flight (none lost, failed over under their
   nonces, the breaker open, then half-open and closed after a
   respawn); the router's federated ``/metrics`` (replicas scraped,
   tokens generated, MFU); a prefill replica whose KV pages cross
   ``/kv_pages`` into the in-process engine, one page corrupted in
   flight and rejected, no page leaked. Every stream equals the
   in-process engine's under the request's pinned nonce, and each
   process launched B4 once a layer per paged pass;
8. train: GPT-2-small at full width as ``bench.py bench_gpt`` configures
   it (seq 1024, batch 8, fused loss, AdamW 1e-4 / wd 0.01, AMP O1)
   through ``Model.train_batch`` on kernels B1-B3: 3 warm-up and 10
   timed steps, a 2-step ``torch.profiler`` window (device time by
   kernel), then 3 steps on the kernels against 3 on the plain twins
   from the same weights (losses) and one fwd+bwd each (the qkv
   projections' gradient), the fused loss's peak memory against the
   dense head's, and the flash dispatch's eager path for a short input;
9. a ``{"kernels": [...]}`` summary line, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import importlib
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM
# bytes/s and operations/s by input type (float32 outside the tensor
# cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12,
                  torch.float16: 989e12, torch.int8: 1979e12}
TOLERANCE = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.int8: 1e-4}
# flash kernels against their twins, element by element: |kernel - twin|
# <= atol + rtol * |twin|, as (rtol, atol). Half types: rtol 2 eps (each
# side rounds its output once, from f32 values that differ in summation
# order and, in B1, in the running max P is rounded against), atol eps/4
# for entries near 0. f32: 1e-5 (summation order over up to 2048 keys).
# The lse is f32 on both sides and held at the f32 limit in every case.
FLASH_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -6, 2 ** -9),
             torch.float16: (2 ** -9, 2 ** -12)}
TRAIN_LOSS_RTOL = 5e-4   # kernel run vs twin run, per step over 3 steps
# kernel run vs twin run: ||g_kernel - g_twin|| / ||g_twin|| of the qkv
# projections' gradient after one O1 fwd+bwd (bf16 roundings of O, dQ,
# dK, dV differ by an ulp here and there; a wrong tile moves it by ~0.1)
QKV_GRAD_RTOL = 1e-2
PAGE_SIZE = 16
NUM_PAGES = 1024
SPEC_K = 4           # speculative tokens a round (K - 1 proposals)
PAGES_PER_SEQ = 64   # max_len 1024 over 16-token pages
LAYERS = 12          # one launch per layer, as in one engine step
REPS = 5
FLASH_REPS, FLASH_WINDOWS = 20, 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    info = {"phase": "device", "nvidia_smi": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def _kernel_name(mangled: str) -> str:
    """``flash_fwd_mma<__nv_bfloat16,64>`` or ``paged_attention<int8>``
    from a mangled kernel name."""
    m = re.search(r"\d+((?:flash|paged)_[a-z_]+?)I(?:\d+(__nv_bfloat16|"
                  r"__half)|([fa]))(?:Li(\d+)E)?E", mangled)
    if m:
        dtype = m.group(2) or {"f": "float", "a": "int8"}[m.group(3)]
        d = f",{m.group(4)}" if m.group(4) else ""
        return f"{m.group(1)}<{dtype}{d}>"
    m = re.search(r"\d+((?:flash|paged)_[a-z_]+?)[IE]", mangled)
    return m.group(1) if m else mangled[:80]


def _ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel, from ``-Xptxas=-v``."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            report[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                report[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name]["registers"] = int(m.group(1))
    return report


def _sass_mma_counts(lib_path: str, nvcc: str):
    """Tensor-core instructions (HMMA, HGMMA) in each kernel's SASS, by
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = _kernel_name(part.split("\n", 1)[0].strip())
        counts[name] = counts.get(name, 0) + len(
            re.findall(r"\bH(?:G)?MMA\.", part))
    return counts


def phase_build() -> None:
    from paddle_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    per_kernel = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: _ptxas_report(log) for n, log in _kernels.build_logs.items()}
    nvcc = _kernels.nvcc_path()
    sass = {n: _sass_mma_counts(str(_kernels._library_path(n)), nvcc)
            for n in _kernels.SOURCES}
    emit({"phase": "build", "seconds": seconds,
          "per_kernel_s": per_kernel, "nvcc": nvcc,
          "flags": list(_kernels.NVCC_FLAGS), "ptxas": ptxas,
          "sass_tensor_core_instructions": sass})
    # the half-type B1, B2 and B3 are tensor-core kernels: the SASS of
    # each must hold mma instructions
    flash = sass.get("flash_attention")
    if flash is not None:
        mma = {k: v for k, v in flash.items() if "_mma<" in k}
        kinds = {k.split("<")[0] for k in mma}
        if kinds != {"flash_fwd_mma", "flash_bwd_dq_mma",
                     "flash_bwd_dkv_mma"} or not all(mma.values()):
            raise SystemExit(f"tensor-core flash kernels without mma "
                             f"instructions in their SASS: {mma}")


# ---------------------------------------------------------------------------
# kernel B4 against its plain twin
# ---------------------------------------------------------------------------

def _case_inputs(g, t, heads, kv_heads, d, kv_dtype, q_dtype, lens_list,
                 seqs, page_size=PAGE_SIZE, shared=0):
    """Layer-stacked pools and the rows of one launch. ``seqs[t]`` names
    the sequence of row t: rows of one sequence share a table, and every
    sequence's first ``shared`` table entries are sequence 0's (a cached
    prefix). The pool holds NUM_PAGES x PAGE_SIZE tokens at any page
    size."""
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    dev = "cuda"
    num_pages = NUM_PAGES * PAGE_SIZE // page_size
    shape = (LAYERS, num_pages, page_size, kv_heads, d)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    if kv_dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        pools = (kq, vq, ks, vs)
    else:
        pools = (k.to(kv_dtype), v.to(kv_dtype), None, None)
    del k, v
    P = PAGES_PER_SEQ * PAGE_SIZE // page_size
    perm = torch.randperm(num_pages - 1, generator=g, device=dev) + 1
    n_seq = max(seqs) + 1
    seq_tables = perm[:n_seq * P].reshape(n_seq, P).to(torch.int32)
    seq_tables[:, :shared] = seq_tables[0, :shared]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    tables = seq_tables[torch.tensor(seqs, device=dev)].clone()
    used = (lens + page_size - 1) // page_size
    cols = torch.arange(P, device=dev)[None, :]
    tables[cols >= used[:, None]] = -1           # -1 tails
    q = torch.randn((t, heads, d), generator=g, device=dev).to(q_dtype)
    return pools, tables.contiguous(), lens, q


def _layer_args(pools, i):
    kp, vp, ks, vs = pools
    return (kp[i], vp[i], None if ks is None else ks[i],
            None if vs is None else vs[i])


def _time_ms(fn):
    """Mean ms of one call over LAYERS calls on the LAYERS pools (so L2
    holds no layer's pages when its turn comes), after warm-up: the
    device time of its kernels from ``torch.profiler`` and, beside it,
    CUDA events around the calls (which also count the gaps in which the
    card waits for the host's launches)."""
    for i in range(LAYERS):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        for i in range(LAYERS):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    events = start.elapsed_time(end) / (REPS * LAYERS)
    layer = itertools.cycle(range(LAYERS))
    return _device_ms(lambda: fn(next(layer)), REPS * LAYERS), events


def _bound(tables, lens_list, t, heads, kv_heads, d, page_size, kv_dtype,
           q_dtype):
    """The least time the card could take for one launch: bytes moved
    (each live page of K and V once, however many rows attend it; int8
    scales, q, out, tables, lens) over HBM bandwidth, or operations (QK
    and PV, 2 each per head, attended position and dim) over the peak
    rate of the pool's type."""
    host = tables.cpu()
    live = set()
    for row, n in zip(host, lens_list):
        live.update(row[:-(-n // page_size)].tolist())
    pages = len(live)
    kv_elt = torch.tensor([], dtype=kv_dtype).element_size()
    q_elt = torch.tensor([], dtype=q_dtype).element_size()
    nbytes = pages * page_size * kv_heads * d * 2 * kv_elt
    if kv_dtype == torch.int8:
        nbytes += pages * page_size * 4 * 2
    nbytes += 2 * t * heads * d * q_elt + t * tables.shape[1] * 4 + t * 4
    ops = 4 * sum(lens_list) * heads * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _library_fn(pools, tables, lens, q, heads, kv_heads):
    """One torch call computing the same attention: SDPA over each
    layer's pages pre-gathered contiguously (gathering not timed)."""
    import torch.nn.functional as TF
    t, _, d = q.shape
    L = tables.shape[1] * pools[0].shape[2]
    mask = (torch.arange(L, device=q.device)[None, :] <
            lens[:, None].long())[:, None, None, :]
    idx = tables.long().clamp(min=0)
    gathered = []
    for i in range(LAYERS):
        kp, vp, ks, vs = _layer_args(pools, i)
        kv = []
        for p, s in ((kp, ks), (vp, vs)):
            x = p[idx]
            if s is not None:
                x = x.float() * s[idx][..., None, None]
            x = x.reshape(t, L, kv_heads, d).transpose(1, 2)
            kv.append(x.repeat_interleave(heads // kv_heads, dim=1)
                      .contiguous())
        gathered.append(kv)
    qq = q[:, :, None, :].to(gathered[0][0].dtype)

    def call(i):
        k, v = gathered[i]
        return TF.scaled_dot_product_attention(qq, k, v, attn_mask=mask)
    return call


def phase_kernels() -> dict:
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    decode_lens = [0, 17, 143, 269, 400, 647, 773, 932]
    # a prefill chunk: the last 40 prompt rows of one sequence, the
    # first 20 of another, 4 padding rows
    chunk_lens = list(range(861, 901)) + list(range(1, 21)) + [0] * 4
    chunk_seqs = [0] * 40 + [1] * 20 + [2] * 4
    # a speculative verify window: 8 slots x K 4 rows, each slot's rows
    # on one table with limits rising by one (B4 reads each page once for
    # the slot's run); the same rows reversed within each slot are runs
    # of one row each (every row reads its pages)
    bases = np.linspace(16, 928, 8).astype(int)
    verify_lens = [int(b) + j + 1 for b in bases for j in range(SPEC_K)]
    verify_seqs = [s for s in range(8) for _ in range(SPEC_K)]
    verify_rev = [int(b) + SPEC_K - j for b in bases for j in range(SPEC_K)]
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    all_dtypes = [(f32, f32), (bf16, f32), (bf16, bf16), (i8, f32)]
    shapes = [  # name, T, heads, kv heads, d, lens, seqs, (kv, q) dtypes
        ("decode gpt2", 8, 12, 12, 64, decode_lens, list(range(8)),
         all_dtypes),
        ("chunk gpt2", 64, 12, 12, 64, chunk_lens, chunk_seqs, all_dtypes),
        ("decode llama-gqa", 8, 16, 4, 128,
         [int(n) for n in rng.permutation(decode_lens)], list(range(8)),
         all_dtypes),
        # one row with a 1024-token context: the page split's own case
        ("decode long row", 1, 12, 12, 64, [1024], [0],
         [(f32, f32), (i8, f32)]),
        # head dim 80 (hidden 640, 8 heads) and 256, zero-filled
        ("decode d80", 8, 8, 8, 80, decode_lens, list(range(8)),
         [(f32, f32)]),
        ("decode d256 gqa", 8, 8, 2, 256, decode_lens, list(range(8)),
         [(bf16, f32)]),
        # a mixed tick of the shared-prefix traffic: 64 suffix chunk rows
        # of one request and 8 decode rows of others, the first 32 pages
        # (a 512-token prefix) shared by all rows
        ("mixed chunk+decode shared", 72, 12, 12, 64,
         list(range(513, 577)) + [530, 560, 600, 650, 690, 700, 720, 740],
         [0] * 64 + list(range(1, 9)), [(f32, f32)], dict(shared=32)),
        # shapes the Pallas kernel takes and a block does not hold whole:
        # 128- and 256-token pages, 40 and 64 q heads on one kv head
        # (gpt3-13b with num_kv_heads=1), d 320
        ("decode ps128", 8, 12, 12, 64, decode_lens, list(range(8)),
         [(f32, f32)], dict(page_size=128)),
        ("decode ps256", 8, 12, 12, 64, decode_lens, list(range(8)),
         [(f32, f32)], dict(page_size=256)),
        ("decode mqa 40/1 d128", 8, 40, 1, 128, decode_lens,
         list(range(8)), [(bf16, bf16)]),
        ("decode 64/1", 8, 64, 1, 64, decode_lens, list(range(8)),
         [(f32, f32)]),
        ("decode d320", 8, 8, 8, 320, decode_lens, list(range(8)),
         [(f32, f32)]),
        ("verify gpt2 (8 x K 4)", 8 * SPEC_K, 12, 12, 64, verify_lens,
         verify_seqs, [(f32, f32), (i8, f32)]),
        ("verify gpt2, rows reversed", 8 * SPEC_K, 12, 12, 64, verify_rev,
         verify_seqs, [(f32, f32)]),
    ]
    cases = []
    for name, t, heads, kv_heads, d, lens_list, seqs, dtypes, *extra in \
            shapes:
        extra = extra[0] if extra else {}
        page_size = extra.get("page_size", PAGE_SIZE)
        for kv_dtype, q_dtype in dtypes:
            pools, tables, lens, q = _case_inputs(
                g, t, heads, kv_heads, d, kv_dtype, q_dtype, lens_list,
                seqs, **extra)
            kp, vp, ks, vs = _layer_args(pools, 0)
            got = pa.paged_attention_kernel(q, kp, vp, tables, lens,
                                            k_scales=ks, v_scales=vs)
            want = pa.paged_attention_torch(q, kp, vp, tables, lens,
                                            k_scales=ks, v_scales=vs)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOLERANCE[q_dtype if q_dtype != torch.float32
                            else kv_dtype]
            zero_rows = got[lens == 0].abs().max().item() \
                if (lens == 0).any() else 0.0
            ok = math.isfinite(err) and err <= tol and zero_rows == 0.0

            def kern(i):
                a = _layer_args(pools, i)
                return pa.paged_attention_kernel(q, a[0], a[1], tables,
                                                 lens, k_scales=a[2],
                                                 v_scales=a[3])

            def plain(i):
                a = _layer_args(pools, i)
                return pa.paged_attention_torch(q, a[0], a[1], tables,
                                                lens, k_scales=a[2],
                                                v_scales=a[3])
            ms, ms_events = _time_ms(kern)
            plain_ms, _ = _time_ms(plain)
            library_ms, _ = _time_ms(_library_fn(pools, tables, lens, q,
                                                 heads, kv_heads))
            bound_ms, bound_by, nbytes, ops = _bound(
                tables, lens_list, t, heads, kv_heads, d, page_size,
                kv_dtype, q_dtype)
            case = {"phase": "kernel_case", "kernel": "paged_attention",
                    "case": name, "T": t, "heads": heads,
                    "kv_heads": kv_heads, "head_dim": d,
                    "page_size": page_size,
                    "shared_pages": extra.get("shared", 0),
                    "pages_per_seq": tables.shape[1],
                    "kv_dtype": str(kv_dtype), "q_dtype": str(q_dtype),
                    "lens": lens_list, "max_abs_err": err, "tol": tol,
                    "ok": ok, "ms": ms, "ms_events": ms_events,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "timing": f"device time (torch.profiler) of "
                              f"{REPS * LAYERS} calls over {LAYERS} pools",
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bytes": nbytes, "ops": ops}
            emit(case)
            cases.append(case)
            del pools, got, want
            torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel B4 disagrees with its plain twin: "
                         f"{[(c['case'], c['kv_dtype'], c['max_abs_err']) for c in bad]}")
    return cases[0]   # decode, gpt2 heads, f32: the headline shape


# ---------------------------------------------------------------------------
# GPT-2-small served through LLMEngine
# ---------------------------------------------------------------------------

def _serve(net, prompts, temps, nonces, impl, kv_dtype, label, first=0,
           draft=None, **knobs):
    """Serve the requests through an ``LLMEngine`` with its default
    knobs but ``knobs`` (and ``draft`` as its draft net): the first
    ``first`` one at a time, to completion, then the rest submitted at
    once. Timing (wall, tokens/s, TTFT) covers the burst; B4's launches
    and the engine's counters cover the whole run."""
    from paddle_tpu_torch.inference.llm import LLMEngine
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    eng = LLMEngine(net, page_size=PAGE_SIZE, num_pages=NUM_PAGES,
                    prefill_chunk=64, kv_dtype=kv_dtype,
                    attention_impl=impl, device="cuda", draft_net=draft,
                    **knobs)
    reqs = list(zip(prompts, temps, nonces))
    with eng:
        torch.cuda.synchronize()
        pa.launches = 0
        outs = [eng.submit(p, max_new_tokens=32, temperature=tp,
                           nonce=n).result(timeout=600)
                for p, tp, n in reqs[:first]]
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=32, temperature=tp, nonce=n)
                for p, tp, n in reqs[first:]]
        burst = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = pa.launches
    outs += burst
    n_tok = sum(len(o["output_ids"]) for o in burst)
    ttft = sorted(o["ttft_s"] for o in burst)
    run = {"phase": "serve", "run": label, "attention_impl": impl,
           "kv_dtype": kv_dtype, "knobs": knobs,
           "requests": len(outs), "timed_requests": len(burst),
           "output_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_p50_s": float(np.median(ttft)),
           "prefix_cache": eng._cache is not None,
           "mixed_tick": eng.mixed_tick,
           "decode_ticks_per_dispatch": eng.decode_ticks_per_dispatch,
           "lookahead": eng.lookahead,
           "prefill_chunks": eng.n_prefill_ticks,
           "decode_ticks_realized": eng.n_decode_ticks,
           "dispatched_ticks": eng.n_dispatched_ticks,
           "mixed_slabs": eng.n_mixed_slabs,
           "prompt_tokens": eng.n_prompt_tokens,
           "cached_tokens": eng.n_cached_tokens,
           "kernel_launches": launches,
           "draft_layers": draft.cfg.num_layers if draft else 0,
           "draft_passes": eng.n_draft_passes,
           "truncated": sum(o["truncated"] for o in outs)}
    if eng.spec_k:
        # K - 1 proposals per slot and round: slot-rounds
        slot_rounds = eng.n_spec_proposed / (eng.spec_k - 1)
        run.update({
            "spec_tokens": eng.spec_k, "spec_slab": eng.spec_slab,
            "spec_rounds": eng.n_spec_rounds,
            "spec_proposed": eng.n_spec_proposed,
            "spec_accepted": eng.n_spec_accepted,
            "acceptance_rate": eng.n_spec_accepted / eng.n_spec_proposed,
            "tokens_per_slot_round":
                1 + eng.n_spec_accepted / slot_rounds})
    emit(run)
    return outs, run


def _launches_ok(run, cfg) -> bool:
    """B4 launched once a layer per paged forward pass the engine issued:
    the target's and the draft's."""
    return run["kernel_launches"] == cfg.num_layers * \
        run["dispatched_ticks"] + run["draft_layers"] * run["draft_passes"]


def _streams(outs):
    return [o["output_ids"] for o in outs]


LEGACY = dict(prefix_cache=False, mixed_tick=False)


def _shared_prefix_traffic(cfg):
    """Chat traffic with a fixed system prompt: one request of a
    512-token prefix plus 64 tokens of its own, then 7 of the same
    prefix plus 17..200 tokens of their own, half greedy and half
    temperature 0.8, nonces pinned. Returns (prompts, temps, nonces,
    own lengths)."""
    rng = np.random.RandomState(2)
    prefix = rng.randint(0, cfg.vocab_size, 512).tolist()
    own = [64] + np.linspace(17, 200, 7).astype(int).tolist()
    prompts = [prefix + rng.randint(0, cfg.vocab_size, n).tolist()
               for n in own]
    temps = [0.0] + [0.0, 0.8] * 3 + [0.0]
    nonces = [2000 + i for i in range(8)]
    return prompts, temps, nonces, own


def _shared_prefix_runs(net, cfg) -> dict:
    """The shared-prefix traffic (:func:`_shared_prefix_traffic`), the
    first request served alone, then the 7 at once, 32 new tokens each.
    On the default engine, on 4-tick slabs, and with the cache and the
    mixed tick off: streams identical, 7 x 512 prompt tokens served from
    the cache where it is on, B4 launched once a layer per dispatched
    tick."""
    prompts, temps, nonces, own = _shared_prefix_traffic(cfg)
    runs = {}
    for label, knobs in (("default", {}),
                         ("slab 4", dict(decode_ticks_per_dispatch=4)),
                         ("cache off, mixed off", LEGACY)):
        outs, run = _serve(net, prompts, temps, nonces, "kernel", "f32",
                           f"shared prefix, {label}", first=1, **knobs)
        runs[label] = (_streams(outs), run)
    want = runs["default"][0]
    checks = {
        "streams_identical_across_runs":
            all(s == want for s, _ in runs.values()),
        "all_full_length": all(len(x) == 32 for x in want),
        **{f"cached_tokens_{k}": r["cached_tokens"] ==
           (0 if k == "cache off, mixed off" else 7 * 512)
           for k, (_, r) in runs.items()},
        **{f"launches_{k}": r["kernel_launches"] ==
           cfg.num_layers * r["dispatched_ticks"]
           for k, (_, r) in runs.items()},
    }
    emit({"phase": "shared_prefix_checks", "prefix_tokens": 512,
          "own_tokens": own, "checks": checks})
    return checks


def _distil_draft(net):
    """A draft of Hugging Face distilgpt2's shape (n_layer 6, n_embd 768,
    n_head 12) that carries the target's embeddings, final norm and first
    6 layers, so that it agrees with the target often but not always."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    draft = GPTForCausalLM(gpt_config("gpt2-small", num_layers=6),
                           device="cuda")
    own = draft.state_dict()
    draft.load_state_dict({k: v for k, v in net.state_dict().items()
                           if k in own})
    return draft.eval()


def _spec_runs(net, cfg, prompts, temps, nonces, streams_k, greedy_prompts,
               outs_q) -> dict:
    """Speculative decoding (K = SPEC_K) on the main serve traffic: the
    spec slab at N 1 and 4 with the distilgpt2-shaped draft, on the plain
    twin, with the target as its own draft (greedy rows), the legacy
    inline round (greedy rows), then 32 greedy streams on an int8 pool
    against the target-only int8 run; one run of the distil draft again
    under torch.profiler. Greedy streams must equal the main run's, the
    kernel run's equal the plain twin's, and B4 must launch once a layer
    per paged forward pass of either model."""
    draft = _distil_draft(net)
    greedy = [i for i, t in enumerate(temps) if t == 0.0]
    g_prompts = [prompts[i] for i in greedy]
    g_nonces = [nonces[i] for i in greedy]
    g_zeros = [0.0] * len(greedy)
    spec = dict(spec_tokens=SPEC_K)
    runs = {}
    for label, kw in (("N 1", dict(decode_ticks_per_dispatch=1)),
                      ("N 4", dict(decode_ticks_per_dispatch=4))):
        runs[label] = _serve(net, prompts, temps, nonces, "kernel", "f32",
                             f"spec slab {label}, distil draft",
                             draft=draft, **spec, **kw)
    runs["plain"] = _serve(net, prompts, temps, nonces, "plain", "f32",
                           "spec slab N 1, distil draft, plain twin",
                           draft=draft, **spec)
    runs["self"] = _serve(net, g_prompts, g_zeros, g_nonces, "kernel", "f32",
                          "spec slab N 1, self draft, greedy rows",
                          draft=net, **spec)
    runs["legacy"] = _serve(net, g_prompts, g_zeros, g_nonces, "kernel",
                            "f32", "spec legacy, distil draft, greedy rows",
                            draft=draft, spec_slab=False, **spec)
    zeros, seq = [0.0] * len(greedy_prompts), list(range(len(greedy_prompts)))
    runs["int8"] = _serve(net, greedy_prompts, zeros, seq, "kernel", "int8",
                          "spec slab N 1, distil draft, greedy int8 pool",
                          draft=draft, **spec)
    emit(_profile(lambda: _serve(net, prompts, temps, nonces, "kernel",
                                 "f32", "spec profiled", draft=draft,
                                 **spec),
                  1, "run", phase="spec", run="profile",
                  requests=len(prompts)))
    want_greedy = [streams_k[i] for i in greedy]
    # with every proposal accepted a request of n tokens commits its
    # first from the prompt and the rest in ceil((n - 1) / K) rounds,
    # each round's last token the target's own: the most a draft can
    # have committed, whatever the budgets cut
    n_new = 32
    best = len(greedy) * (n_new - 1 - math.ceil((n_new - 1) / SPEC_K))
    self_rate = runs["self"][1]["spec_accepted"] / best
    agree = _agreement(_streams(runs["int8"][0]), _streams(outs_q))
    checks = {
        **{f"spec_greedy_eq_main_{k}": [
            _streams(o)[i] for i in greedy] == want_greedy
           for k, (o, _) in runs.items() if k not in ("self", "legacy",
                                                      "int8")},
        "spec_greedy_eq_main_self": _streams(runs["self"][0]) ==
        want_greedy,
        "spec_greedy_eq_main_legacy": _streams(runs["legacy"][0]) ==
        want_greedy,
        "spec_kernel_eq_plain": _streams(runs["N 1"][0]) ==
        _streams(runs["plain"][0]),
        "spec_all_full_length": all(
            len(x) == n_new for o, _ in runs.values() for x in _streams(o)),
        "spec_self_draft_acceptance_ge_0.99": self_rate >= 0.99,
        "spec_int8_greedy_agreement_ge_0.9": float(np.mean(agree)) >= 0.9,
        "spec_plain_run_no_launches": runs["plain"][1]["kernel_launches"]
        == 0,
        **{f"spec_launches_{k}": _launches_ok(r, cfg)
           for k, (_, r) in runs.items() if k != "plain"},
        "spec_slab_rides_mixed_tick_and_cache": runs["N 1"][1][
            "mixed_tick"] and runs["N 1"][1]["prefix_cache"],
    }
    emit({"phase": "spec_checks", "spec_tokens": SPEC_K,
          "draft": "gpt2-small widths, 6 layers (distilgpt2's shape), the "
                   "target's embeddings, ln_f and layers 0-5",
          "self_draft_accepted": runs["self"][1]["spec_accepted"],
          "self_draft_accepted_best": best,
          "self_draft_acceptance_of_best": self_rate,
          "int8_greedy_agreement": float(np.mean(agree)),
          "int8_agreement_per_request": agree, "checks": checks})
    return checks


def _agreement(a, b):
    """Per-request fraction of positions where two token streams agree
    (the JAX package's engine-level int8 measure)."""
    return [float(np.mean([x == y for x, y in zip(s, t)]))
            for s, t in zip(a, b)]


def phase_serve() -> int:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-small")
    pt.seed(0)
    net = GPTForCausalLM(cfg, device="cuda")
    rng = np.random.RandomState(0)
    lens = np.linspace(17, 900, 8).astype(int)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    temps = [0.0, 0.8] * 4
    nonces = [1000 + i for i in range(8)]
    # warm-up (cuBLAS handles, the kernel library); not measured
    _serve(net, prompts[:1], [0.0], [0], "kernel", "f32", "warm-up")

    outs_k, run_k = _serve(net, prompts, temps, nonces, "kernel", "f32",
                           "main")
    outs_p, run_p = _serve(net, prompts, temps, nonces, "plain", "f32",
                           "plain twin")
    # the main run again under torch.profiler: where serving's device
    # time goes, by kernel
    emit(_profile(lambda: _serve(net, prompts, temps, nonces, "kernel",
                                 "f32", "profiled"),
                  1, "run", phase="serve", run="profile",
                  requests=len(prompts)))
    # the alternating prefill-chunk / decode-step loop, and the same
    # with decode steps issued two ahead of the fetch
    outs_l, run_l = _serve(net, prompts, temps, nonces, "kernel", "f32",
                           "legacy loop", **LEGACY)
    outs_a, run_a = _serve(net, prompts, temps, nonces, "kernel", "f32",
                           "legacy loop, lookahead 2", lookahead=2,
                           **LEGACY)
    # int8 pool against the f32 pool: greedy streams of the 8 serve
    # prompts and 24 more (a flipped argmax derails the rest of its
    # stream, so the floor is held over 32 streams, not 4)
    rng = np.random.RandomState(1)
    more = [rng.randint(0, cfg.vocab_size, n).tolist()
            for n in rng.randint(17, 901, 24)]
    greedy_prompts = prompts + more
    zeros, seq = [0.0] * 32, list(range(32))
    outs_g, _ = _serve(net, greedy_prompts, zeros, seq, "kernel", "f32",
                       "greedy f32 pool")
    outs_q, run_q = _serve(net, greedy_prompts, zeros, seq, "kernel",
                           "int8", "greedy int8 pool")

    streams_k = _streams(outs_k)
    per_request = _agreement(_streams(outs_q), _streams(outs_g))
    agree = float(np.mean(per_request))
    # the dense-cache path as reference for the first greedy request
    dense = net.generate(torch.tensor([prompts[0]], device="cuda"),
                         max_new_tokens=32)[0, lens[0]:].tolist()
    checks = {
        **{f"launches_{k}_run": r["kernel_launches"] ==
           cfg.num_layers * r["dispatched_ticks"]
           for k, r in (("kernel", run_k), ("int8", run_q),
                        ("legacy", run_l), ("lookahead", run_a))},
        "launches_plain_run": run_p["kernel_launches"] == 0,
        "main_run_mixed_tick_and_cache": run_k["mixed_tick"] and
        run_k["prefix_cache"] and run_k["mixed_slabs"] > 0,
        "streams_kernel_eq_plain": streams_k == _streams(outs_p),
        "streams_legacy_eq_main": _streams(outs_l) == streams_k,
        "streams_lookahead_eq_legacy": _streams(outs_a) ==
        _streams(outs_l),
        "all_full_length": all(len(s) == 32 for s in streams_k) and
        not run_k["truncated"],
        "tokens_in_vocab": all(0 <= x < cfg.vocab_size
                               for s in streams_k for x in s),
        "greedy_eq_dense_generate": streams_k[0] == dense,
        "int8_greedy_agreement_ge_0.9": agree >= 0.9,
    }
    emit({"phase": "serve_checks", "model": "gpt2-small",
          "layers": cfg.num_layers, "hidden": cfg.hidden_size,
          "vocab": cfg.vocab_size, "prompt_lens": lens.tolist(),
          "expected_launches": cfg.num_layers * run_k["dispatched_ticks"],
          "int8_greedy_agreement": agree,
          "int8_agreement_per_request": per_request, "checks": checks})
    checks.update({f"shared_prefix_{k}": v
                   for k, v in _shared_prefix_runs(net, cfg).items()})
    checks.update(_spec_runs(net, cfg, prompts, temps, nonces, streams_k,
                             greedy_prompts, outs_q))
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"serve checks failed: {failed}")
    return run_k["kernel_launches"], {
        "net": net, "cfg": cfg, "prompts": prompts, "temps": temps,
        "nonces": nonces, "streams": streams_k, "main_run": run_k}


# ---------------------------------------------------------------------------
# the same engine behind serve_llm: HTTP, the error map, the device
# retry, KV-page migration, the debug server's scrapes
# ---------------------------------------------------------------------------

def _post(base, path, body, timeout=900):
    """(status, headers, JSON body) of one POST."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen
    req = Request(base + path, data=json.dumps(body).encode(),
                  headers={"Content-Type": "application/json"})
    try:
        with urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(base, path):
    from urllib.request import urlopen
    with urlopen(base + path, timeout=120) as r:
        return r.read().decode()


def _scrape(base) -> dict:
    """``/metrics`` parsed into {series with labels: value}; a line
    that does not parse raises."""
    vals = {}
    for line in _get(base, "/metrics").splitlines():
        if line and not line.startswith("#"):
            key, v = line.rsplit(" ", 1)
            vals[key] = float(v)
    return vals


def _delta(after, before, key):
    return after.get(key, 0.0) - before.get(key, 0.0)


def _engine(net, **knobs):
    from paddle_tpu_torch.inference.llm import LLMEngine
    return LLMEngine(net, page_size=PAGE_SIZE, num_pages=NUM_PAGES,
                     prefill_chunk=64, device="cuda", **knobs)


def _http_engine(net, **knobs):
    """A default engine behind ``serve_llm`` on 127.0.0.1: (engine,
    server, base URL)."""
    from paddle_tpu_torch.inference.llm import serve_llm
    eng = _engine(net, **knobs)
    srv = serve_llm(eng, host="127.0.0.1", port=0)
    return eng, srv, "http://127.0.0.1:%d" % srv.server_address[1]


def _close_http(eng, srv):
    srv.shutdown()
    srv.server_close()
    eng.close()


def _http_traffic(base, prompts, temps, nonces, n_new=32):
    """The requests as concurrent ``POST /generate``, one client thread
    each; returns (responses in request order, wall seconds)."""
    import threading
    res = [None] * len(prompts)

    def client(i):
        res[i] = _post(base, "/generate", {
            "prompt_ids": prompts[i], "max_new_tokens": n_new,
            "temperature": temps[i], "nonce": nonces[i]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return res, time.perf_counter() - t0


def _serve_http_run(net, ctx, label, dbase=None):
    """The main traffic as 8 concurrent POSTs to a fresh default engine
    behind ``serve_llm``: streams, digests, knobs, B4's launches against
    the engine's dispatched ticks, and (given the debug server's base)
    the ``/metrics`` token count against the tokens delivered."""
    from paddle_tpu_torch.observability import audit
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    eng, srv, base = _http_engine(net)
    try:
        before = _scrape(dbase) if dbase else None
        torch.cuda.synchronize()
        pa.launches = 0
        res, wall = _http_traffic(base, ctx["prompts"], ctx["temps"],
                                  ctx["nonces"])
        launches, ticks = pa.launches, eng.n_dispatched_ticks
        after = _scrape(dbase) if dbase else None
    finally:
        _close_http(eng, srv)
    ok = all(r is not None and r[0] == 200 for r in res)
    outs = [r[2] for r in res] if ok else []
    n_tok = sum(len(o["output_ids"]) for o in outs)
    run = {"phase": "serve_http", "run": label,
           "requests": len(res), "all_200": ok,
           "output_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall if ok else None,
           "ttft_p50_s": float(np.median([o["ttft_s"] for o in outs]))
           if ok else None,
           "latency_p50_s": float(np.median([o["latency_s"]
                                             for o in outs]))
           if ok else None,
           "dispatched_ticks": ticks, "kernel_launches": launches}
    run["checks"] = {
        "all_200": ok,
        "streams_eq_direct": ok and [o["output_ids"] for o in outs] ==
        ctx["streams"],
        "digest_header_eq_chain": ok and all(
            r[1].get("X-Stream-Digest") == o["stream_digest"] ==
            audit.chain_of(n, o["output_ids"]).hex()
            for r, o, n in zip(res, outs, ctx["nonces"])),
        "knobs_header_eq_body": ok and all(
            json.loads(r[1]["X-Engine-Knobs"]) == o["knobs"]
            for r, o in zip(res, outs)),
        "launches": launches == ctx["cfg"].num_layers * ticks,
    }
    if before is not None:
        run["metrics_tokens_generated"] = _delta(
            after, before, "llm_tokens_generated")
        run["checks"]["metrics_tokens_eq_delivered"] = \
            run["metrics_tokens_generated"] == n_tok
    emit(run)
    return run


def _error_map(net, ctx, dbase) -> dict:
    """429 / 503 / 504 / 499 / 400 on the card, the matching
    ``/metrics`` counters, the engine healthy and serving afterwards,
    then ``/memz``, ``/perfz``, ``/healthz`` and ``/statusz`` with the
    engine alive."""
    import threading
    eng, srv, base = _http_engine(net)
    got, checks = {}, {}
    try:
        # warm: the engine has served, so /perfz has its programs
        assert _post(base, "/generate", {"prompt_ids": ctx["prompts"][1],
                                         "max_new_tokens": 8})[0] == 200
        before = _scrape(dbase)
        saved, eng.max_pending = eng.max_pending, 0
        try:
            got[429] = _post(base, "/generate", {"prompt_ids": [1, 2]})
        finally:
            eng.max_pending = saved
        eng._health = "draining"
        try:
            got[503] = _post(base, "/generate", {"prompt_ids": [1, 2]})
        finally:
            eng.reset_health()
        got[504] = _post(base, "/generate", {"prompt_ids": [1, 2, 3],
                                             "deadline_s": -1.0})
        res = {}
        n0 = eng.n_tokens

        def client():
            res["r"] = _post(base, "/generate", {
                "prompt_ids": ctx["prompts"][0], "max_new_tokens": 512})

        t = threading.Thread(target=client)
        t.start()
        t_end = time.monotonic() + 300
        while eng.n_tokens < n0 + 16 and time.monotonic() < t_end:
            time.sleep(0.005)   # cancel in the middle of the decode
        rid = max(eng._by_id) if eng._by_id else -1
        cancel = _post(base, "/cancel", {"request_id": rid})
        t.join(timeout=600)
        got[499] = res.get("r", (None, {}, {}))
        got[400] = _post(base, "/generate", {"prompt_ids": []})
        after = _scrape(dbase)
        ok_after = _post(base, "/generate", {"prompt_ids": [5, 6, 7],
                                             "max_new_tokens": 4})
        memz = json.loads(_get(dbase, "/memz"))
        perfz = json.loads(_get(dbase, "/perfz"))
        healthz = json.loads(_get(dbase, "/healthz"))
        statusz = json.loads(_get(dbase, "/statusz"))
        name, mem_scope, perf_scope = eng._status_name, eng._mem_scope, \
            eng._perf_scope
        pbk, n_pages = eng._tgt_page_bytes, eng.num_pages
        health = eng.health
    finally:
        _close_http(eng, srv)
    for code, (c, hdrs, out) in got.items():
        checks[f"status_{code}"] = c == code
        if code in (429, 503):
            checks[f"retry_after_{code}"] = hdrs.get("Retry-After") == \
                "1.0"
    checks["cancel_accepted"] = cancel[0] == 200 and \
        cancel[2].get("cancelled") is True
    checks["outcomes"] = [got[c][2].get("outcome") for c in
                          (429, 503, 504, 499)] == \
        ["shed", "shed", "deadline", "cancelled"]
    checks["metrics_shed"] = _delta(after, before, "llm_shed_total") == 2
    checks["metrics_deadline"] = _delta(
        after, before, "llm_deadline_exceeded_total") == 1
    checks["metrics_cancelled"] = _delta(
        after, before, "llm_cancelled_total") == 1
    checks["healthy_after"] = health == "healthy"
    checks["serves_after"] = ok_after[0] == 200 and \
        len(ok_after[2]["output_ids"]) == 4
    rows = [r for r in memz["owners"]
            if r["owner"] == "kv_pool" and r.get("scope") == mem_scope]
    checks["memz_pool_rows_tile_the_pool"] = \
        sum(r["bytes"] for r in rows) == n_pages * pbk
    checks["memz_unattributed_is_a_number"] = isinstance(
        memz["unattributed_bytes"], (int, float))
    progs = [p for p in perfz["programs"] if p["scope"] == perf_scope]
    checks["perfz_programs_resolved"] = bool(progs) and all(
        p["cost_resolved"] and p["cost_source"] == "analytic" and
        p["flops"] > 0 for p in progs)
    checks["perfz_mfu_positive_vs_h100"] = perfz["mfu"] > 0 and \
        perfz["peaks"]["source"] == "table" and \
        "H100" in perfz["peaks"]["device_kind"]
    checks["healthz_names_engine"] = \
        healthz["components"].get(name) == "healthy"
    checks["statusz_names_engine"] = name in statusz["providers"]
    emit({"phase": "serve_http", "run": "error map and scrapes",
          "status": {str(c): got[c][0] for c in got},
          "outcomes": {str(c): got[c][2].get("outcome") for c in got},
          "cancel_error": got[499][2].get("error"),
          "metrics_deltas": {k: _delta(after, before, k) for k in (
              "llm_shed_total", "llm_deadline_exceeded_total",
              "llm_cancelled_total")},
          "memz_unattributed_bytes": memz["unattributed_bytes"],
          "memz_device": memz.get("device"),
          "perfz": {"mfu": perfz["mfu"], "peaks": perfz["peaks"],
                    "programs": [{k: p[k] for k in (
                        "kind", "sig", "dispatches", "seconds", "flops",
                        "bytes_accessed", "flops_per_second")}
                        for p in progs]},
          "checks": checks})
    return checks


def _device_retry_run(net, ctx) -> dict:
    """The main traffic, all 8 at once, on an engine with
    ``device_retry_budget=1`` and one seeded fault at ``device.dispatch``
    in the middle of the run: the streams equal the fault-free run's,
    ``llm_device_retries_total`` grows by the requests re-admitted, and
    every failover verdict of the stream auditor is clean."""
    from paddle_tpu_torch.observability import audit, default_registry
    from paddle_tpu_torch.reliability import faults
    nth = max(2, ctx["main_run"]["dispatched_ticks"] // 2)
    eng = _engine(net, device_retry_budget=1)
    slotted = []

    def fault():
        slotted.extend(s.req_id for s in eng._slots
                       if s is not None and not s.closing)
        return RuntimeError("injected device error")

    retries = default_registry().counter("llm_device_retries_total")
    r0, v0 = retries.value, audit.instance().counts()
    faults.reset()
    faults.inject("device.dispatch", nth=nth, times=1, exc=fault)
    faults.enable(seed=0)
    try:
        with eng:
            futs = [eng.submit(p, max_new_tokens=32, temperature=t,
                               nonce=n)
                    for p, t, n in zip(ctx["prompts"], ctx["temps"],
                                       ctx["nonces"])]
            outs = [f.result(timeout=600) for f in futs]
        log = faults.injected_log()
    finally:
        faults.reset()
    v1 = audit.instance().counts()
    run = {"phase": "serve_http", "run": "device retry", "fault_nth": nth,
           "injected": log, "readmitted": len(slotted),
           "device_retries": retries.value - r0,
           "failover_verified": v1["verified"] - v0["verified"],
           "failover_diverged": v1["diverged"] - v0["diverged"]}
    run["checks"] = {
        "fault_fired_once": log == [("device.dispatch", nth)],
        "streams_eq_fault_free": _streams(outs) == ctx["streams"],
        "retries_eq_readmitted": run["device_retries"] == len(slotted) > 0,
        "failover_verdicts_clean": run["failover_diverged"] == 0,
        "not_truncated": not any(o["truncated"] for o in outs),
    }
    emit(run)
    return run["checks"]


def _migration_run(net, cfg) -> dict:
    """Engine A serves the shared-prefix seed request; its 32 prefix
    pages go to a fresh engine B through ``export_pages`` /
    ``import_pages``; B serves the 7-request burst from them (7 x 512
    cached prompt tokens) with A's own streams."""
    from paddle_tpu_torch.inference.prefix_cache import page_digests
    prompts, temps, nonces, _ = _shared_prefix_traffic(cfg)
    digests = page_digests(prompts[0], PAGE_SIZE)[:512 // PAGE_SIZE]
    a, b = _engine(net), _engine(net)
    with a, b:
        a.submit(prompts[0], max_new_tokens=32, temperature=temps[0],
                 nonce=nonces[0]).result(timeout=600)
        t0 = time.perf_counter()
        payload = a.export_pages(digests)
        t1 = time.perf_counter()
        res = b.import_pages(payload)
        t2 = time.perf_counter()

        def burst(eng):
            futs = [eng.submit(p, max_new_tokens=32, temperature=t,
                               nonce=n)
                    for p, t, n in zip(prompts[1:], temps[1:], nonces[1:])]
            return _streams([f.result(timeout=600) for f in futs])

        got, want = burst(b), burst(a)
        cached_b = b.n_cached_tokens
    n_bytes = sum(len(p["k"]) + len(p["v"]) for p in payload["pages"])
    run = {"phase": "serve_http", "run": "kv migration",
           "pages": len(payload["pages"]), "imported": res["imported"],
           "rejected": res["rejected"], "payload_b64_bytes": n_bytes,
           "export_s": t1 - t0, "import_s": t2 - t1,
           "importer_cached_tokens": cached_b}
    run["checks"] = {
        "all_pages_imported": res["imported"] == len(digests) and
        not res["rejected"],
        "importer_cached_7x512": cached_b == 7 * 512,
        "importer_streams_eq_exporter": got == want,
    }
    emit(run)
    return run["checks"]


def _control_plane_cost(net, ctx) -> dict:
    """Main-run tokens/s (direct submit) with the observability flags
    at their defaults (A) against the stream audit, goodput, memory and
    perf ledgers all disabled (B), in turns A, B, B, A twice (a run is
    host-bound, and its rate moves by ~10% from run to run)."""
    from paddle_tpu_torch.observability import audit, goodput, memory, perf
    mods = (audit, goodput, memory, perf)
    saved = [m.enabled() for m in mods]
    runs = []
    try:
        for turn in "ABBAABBA":
            for m, on in zip(mods, saved):
                (m.enable if turn == "A" and on else m.disable)()
            outs, run = _serve(net, ctx["prompts"], ctx["temps"],
                               ctx["nonces"], "kernel", "f32",
                               f"control plane {turn}")
            runs.append((turn, run["tokens_per_s"], run["ttft_p50_s"],
                         _streams(outs) == ctx["streams"]))
    finally:
        for m, on in zip(mods, saved):
            (m.enable if on else m.disable)()
    a = [r[1] for r in runs if r[0] == "A"]
    b = [r[1] for r in runs if r[0] == "B"]
    out = {"phase": "serve_http", "run": "control plane cost",
           "turns": [{"turn": t, "tokens_per_s": s, "ttft_p50_s": f}
                     for t, s, f, _ in runs],
           "tokens_per_s_on": float(np.mean(a)),
           "tokens_per_s_off": float(np.mean(b)),
           "fall": 1 - float(np.mean(a)) / float(np.mean(b)),
           "checks": {"streams_eq_main": all(r[3] for r in runs)}}
    emit(out)
    return out["checks"]


def _worker_profile(net, ctx):
    """cProfile of the engine's worker thread over one main run: the
    host functions that pace a host-bound run."""
    import cProfile
    import io
    import pstats
    from paddle_tpu_torch.inference.llm import LLMEngine
    loop, profs = LLMEngine._loop, []

    def profiled(self):
        pr = cProfile.Profile()
        pr.enable()
        try:
            loop(self)
        finally:
            pr.disable()
            profs.append(pr)

    LLMEngine._loop = profiled
    try:
        _serve(net, ctx["prompts"], ctx["temps"], ctx["nonces"], "kernel",
               "f32", "worker cProfile")
    finally:
        LLMEngine._loop = loop
    buf = io.StringIO()
    st = pstats.Stats(profs[0], stream=buf)
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:15]
    emit({"phase": "serve_http", "run": "worker cProfile",
          "total_s": st.total_tt,
          "top_tottime": [{"function": f"{k[0].split('/')[-1]}:{k[1]}"
                                       f"({k[2]})",
                           "calls": v[1], "tottime_s": v[2],
                           "cumtime_s": v[3]} for k, v in top]})


def phase_serve_http(ctx) -> None:
    """GPT-2-small's main serve cell behind ``serve_llm`` with the debug
    server up: the main traffic over HTTP in turns with direct submit
    (direct, HTTP, HTTP, direct, twice),
    the error map, the scrapes, the device retry, KV-page migration,
    the control plane's cost and a profiled HTTP run."""
    from paddle_tpu_torch.observability import start_debug_server
    net, cfg = ctx["net"], ctx["cfg"]
    dbg = start_debug_server(port=0)
    dbase = f"http://127.0.0.1:{dbg.port}"
    checks = {}
    try:
        direct, http = [], []
        for turn in ("direct", "http", "http", "direct") * 2:
            if turn == "direct":
                outs, run = _serve(net, ctx["prompts"], ctx["temps"],
                                   ctx["nonces"], "kernel", "f32",
                                   "direct (paired with http)")
                direct.append(run)
                checks[f"direct_{len(direct)}_streams_eq_main"] = \
                    _streams(outs) == ctx["streams"]
            else:
                run = _serve_http_run(net, ctx, f"http {len(http) + 1}",
                                      dbase)
                http.append(run)
                checks.update({f"http_{len(http)}_{k}": v
                               for k, v in run["checks"].items()})
        pair = {f"{k}_{w}": [r[k] for r in runs]
                for w, runs in (("http", http), ("direct", direct))
                for k in ("tokens_per_s", "ttft_p50_s")}
        emit({"phase": "serve_http", "run": "http vs direct", **pair,
              **{f"mean_{k}": float(np.mean(v)) for k, v in pair.items()},
              "http_over_direct_tokens_per_s": float(
                  np.mean(pair["tokens_per_s_http"]) /
                  np.mean(pair["tokens_per_s_direct"]))})
        checks.update({f"errors_{k}": v
                       for k, v in _error_map(net, ctx, dbase).items()})
        checks.update({f"retry_{k}": v
                       for k, v in _device_retry_run(net, ctx).items()})
        checks.update({f"migration_{k}": v
                       for k, v in _migration_run(net, cfg).items()})
        checks.update({f"control_plane_{k}": v for k, v in
                       _control_plane_cost(net, ctx).items()})
        emit(_profile(lambda: _serve_http_run(net, ctx, "profiled"), 1,
                      "run", phase="serve_http", run="profile",
                      requests=len(ctx["prompts"])))
        _worker_profile(net, ctx)
    finally:
        dbg.stop()
    emit({"phase": "serve_http_checks", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"serve_http checks failed: {failed}")


# ---------------------------------------------------------------------------
# the serving fleet: a Router over replica processes on the card
# ---------------------------------------------------------------------------

# gpt2-small at full width as a replica spec, with the serve cell's engine
# knobs; every process draws the same random weights from model_seed 0
FLEET_SPEC = {"vocab": 50304, "layers": 12, "hidden": 768, "heads": 12,
              "max_pos": 1024, "model_seed": 0,
              "engine": {"page_size": PAGE_SIZE, "num_pages": NUM_PAGES,
                         "prefill_chunk": 64, "max_seqs": 8, "seed": 0,
                         "kv_dtype": "f32", "device_retry_budget": 2,
                         "prefill_buckets": [64, 256, 1024]}}
FLEET_SPAWN_TIMEOUT_S = 300


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise SystemExit(f"fleet: {what} not within {timeout} s")
        time.sleep(0.02)


def _debug_base(info) -> str:
    """The base URL of a replica process's debug server."""
    return info["healthz"].rsplit("/healthz", 1)[0]


def _kernel_status(info) -> dict:
    """A replica process's ``kernels`` status provider (its device, B4's
    launches there and its engine's paged passes), from its
    ``/statusz``."""
    return json.loads(_get(_debug_base(info), "/statusz"))[
        "providers"]["kernels"]


def _launches_match(k) -> bool:
    return k["paged_attention_launches"] > 0 and \
        k["paged_attention_launches"] == k["layers"] * \
        k["dispatched_ticks"] + k["draft_layers"] * k["draft_passes"]


def _spawn(specs, procs) -> dict:
    """Spawn the replica processes of ``specs`` at once, one thread each;
    each process that starts joins ``procs`` (the caller kills them).
    Returns {name: (process, READY info, spawn-to-READY seconds)}."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.serving import spawn_replica

    def one(spec):
        t0 = time.perf_counter()
        proc, info = spawn_replica(spec, timeout=FLEET_SPAWN_TIMEOUT_S)
        procs.append(proc)
        return proc, info, time.perf_counter() - t0

    with ThreadPoolExecutor(len(specs)) as ex:
        futs = {s["name"]: ex.submit(one, s) for s in specs}
    return {n: f.result() for n, f in futs.items()}


def _fleet_run(submit, prompts, temps, label, during=None):
    """``submit(prompt, temperature, i)`` for every request at once (then
    ``during()``, if given), and wait for all: the outputs, each with
    its latency from the first submission, and the run's numbers
    (tokens/s, the engine's TTFT p50, latency p50)."""
    from concurrent.futures import as_completed
    t0 = time.perf_counter()
    futs = {submit(p, t, i): i
            for i, (p, t) in enumerate(zip(prompts, temps))}
    if during is not None:
        during()
    lat = {}
    for f in as_completed(futs, timeout=900):
        lat[futs[f]] = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    outs = [None] * len(futs)
    for f, i in futs.items():
        outs[i] = dict(f.result(), client_latency_s=lat[i])
    n_tok = sum(len(o["output_ids"]) for o in outs)
    return outs, {"run": label, "requests": len(outs),
                  "output_tokens": n_tok, "wall_s": wall,
                  "tokens_per_s": n_tok / wall,
                  "ttft_p50_s": float(np.median([o["ttft_s"]
                                                 for o in outs])),
                  "latency_p50_s": float(np.median(list(lat.values())))}


def _direct(eng, prompts, temps, nonces, label):
    """The requests straight into an in-process engine under pinned
    nonces."""
    return _fleet_run(lambda p, t, i: eng.submit(
        p, max_new_tokens=32, temperature=t, nonce=nonces[i]),
        prompts, temps, label)


def _routed(router, prompts, temps, label, during=None):
    return _fleet_run(lambda p, t, i: router.submit(
        p, max_new_tokens=32, temperature=t), prompts, temps, label,
        during)


def _first_divergence(net, prompt, got, want):
    """Where a fleet stream leaves the reference's: the index, both
    tokens and the reference row's top-2 logit gap there."""
    i = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
    with torch.no_grad():
        ids = torch.tensor([prompt + want[:i]],
                           device=net.gpt.ln_f.weight.device)
        top = torch.topk(net(ids)[0, -1].float(), 2).values
    return {"index": i, "got": got[i], "want": want[i],
            "top2_gap": float(top[0] - top[1])}


def _same_streams(outs, want, prompts, net, label, diverged):
    """True when every fleet stream equals the reference's; else the
    first divergence of each differing stream joins ``diverged``."""
    ok = True
    for o, w, p in zip(outs, want, prompts):
        if o["output_ids"] != w["output_ids"]:
            ok = False
            diverged.append(dict(_first_divergence(
                net, p, o["output_ids"], w["output_ids"]), run=label,
                request_id=o["request_id"]))
    return ok


def _thread_cpu_s(prefixes) -> float:
    """CPU seconds (user + system) spent so far by this process's live
    threads whose names start with one of ``prefixes``."""
    import threading
    tick = os.sysconf("SC_CLK_TCK")
    total = 0.0
    for t in threading.enumerate():
        if not t.name.startswith(prefixes) or not t.native_id:
            continue
        try:
            with open(f"/proc/self/task/{t.native_id}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        total += (int(fields[11]) + int(fields[12])) / tick
    return total


class _TamperedPrefill:
    """A prefill replica's client that records each KV-page export (pages,
    base64 bytes, seconds) and, in mode ``corrupt``, flips one byte of
    page 1's K in flight."""

    def __init__(self, inner):
        self.inner, self.mode, self.exports = inner, None, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def export_pages(self, digests, trace_context=None):
        from paddle_tpu_torch.inference import kv_transfer as kvt
        t0 = time.perf_counter()
        payload = self.inner.export_pages(digests,
                                          trace_context=trace_context)
        self.exports.append({
            "pages": len(payload["pages"]),
            "b64_bytes": sum(len(p["k"]) + len(p["v"])
                             for p in payload["pages"]),
            "export_s": time.perf_counter() - t0})
        if self.mode == "corrupt" and len(payload["pages"]) > 1:
            rec = payload["pages"][1]
            k = bytearray(kvt._unb64(rec["k"]))
            k[0] ^= 0x40
            rec["k"] = kvt._b64(bytes(k))
        return payload


def phase_fleet(dev, ctx) -> None:
    """The serve traffic through ``paddle_tpu_torch.serving``: a
    ``Router`` over replica processes on the card, each an
    ``LLMEngine`` on kernel B4 behind ``serve_llm``. Streams are held to
    an in-process engine of the same spec under each request's pinned
    nonce, and each replica's ``kernels`` status to B4's launch count.

    1. r0 and r1 join through TCPStore membership; the main traffic in
       turns with that in-process engine (D F F D), then the
       shared-prefix burst, all on its affinity replica with 7 x 512
       cached tokens there;
    2. the main traffic again, SIGKILLing the replica that holds most of
       it with requests in flight: none lost, failed over under their
       nonces, its breaker open; respawned from the same spec, it goes
       half-open, closed and up on ``/fleetz``, and serves again;
    3. the router's federated ``/metrics``: replicas scraped, tokens
       generated (== the tokens those processes delivered), MFU;
    4. a prefill replica fills KV pages that cross ``/kv_pages`` into
       the in-process engine as the decode replica; one page corrupted
       in flight is rejected by its digest and recomputed, and the
       decode pool leaks no page."""
    import shutil
    import signal
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.distributed import TCPStoreServer
    from paddle_tpu_torch.observability import DebugServer
    from paddle_tpu_torch.serving import (HTTPReplica, LocalReplica,
                                          Router, make_engine_from_spec)
    from paddle_tpu_torch.serving.replica import state_digest
    from paddle_tpu_torch.serving.router import (affinity_key,
                                                 rendezvous_pick)
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    spec = FLEET_SPEC
    ps, layers, vocab = spec["engine"]["page_size"], spec["layers"], \
        spec["vocab"]
    prompts, temps = ctx["prompts"], ctx["temps"]
    sp_prompts, sp_temps, _, _ = _shared_prefix_traffic(ctx["cfg"])
    t_phase = time.perf_counter()
    checks, nums, diverged, procs, refs, routers = {}, {}, [], [], [], []
    obs_dir = tempfile.mkdtemp(prefix="fleet_obs_")
    store = TCPStoreServer("127.0.0.1", 0)
    endpoint = f"127.0.0.1:{store.port}"
    # the phase's own debug server (the process-wide one may have been
    # stopped by an earlier phase): /fleetz and the federated /metrics
    dbg = DebugServer(host="127.0.0.1", port=0).start()
    dbase = f"http://127.0.0.1:{dbg.port}"

    def child(name, **kw):
        return dict(spec, name=name, tracing=True, obs_dir=obs_dir, **kw)

    def pick(p, names=("r0", "r1")):
        return rendezvous_pick(affinity_key(p, ps, 2), list(names))

    try:
        torch.cuda.synchronize()
        pa.launches = 0
        ref = make_engine_from_spec(spec)
        refs.append(ref)
        digest = state_digest(ref.net)
        spawned = _spawn([child("r0", store=endpoint),
                          child("r1", store=endpoint)], procs)
        nums["spawn_to_ready_s"] = {n: s for n, (_, _, s) in
                                    spawned.items()}
        infos = {n: i for n, (_, i, _) in spawned.items()}
        checks["replica_weights_eq_parent"] = all(
            i["state_digest"] == digest for i in infos.values())
        checks["replicas_ready_on_h100"] = all(
            "H100" in i["device"] for i in infos.values())
        router = Router(store_endpoint=endpoint, page_size=ps)
        routers.append(router)
        _wait(lambda: router.fleet_load()["ready"] == 2, 120,
              "r0 and r1 ready at the router")
        # warm-up: the main traffic's lengths with other tokens, straight
        # into every process at once (cuBLAS handles, the kernel
        # library, the engine's tick shapes); not timed
        wrng = np.random.RandomState(4)
        warm = [wrng.randint(0, vocab, len(p)).tolist() for p in prompts]
        with ThreadPoolExecutor(len(infos) * len(warm)) as ex:
            futs = {n: [ex.submit(HTTPReplica(
                i["generate"], i["healthz"]).submit, p, 32, t)
                for p, t in zip(warm, temps)] for n, i in infos.items()}
            _direct(ref, warm, temps, list(range(len(warm))), "warm-up")
            delivered = {n: sum(len(f.result()["output_ids"]) for f in fs)
                         for n, fs in futs.items()}

        # 1. the main traffic, D F F D, then the shared-prefix burst.
        # The router pins nonces 0, 1, ... in submission order; each D
        # turn runs the in-process engine under the nonces of the F turn
        # beside it, idle while the fleet is timed
        # The router threads' CPU, the process's CPU and the wall clock
        # are summed over the two F turns only
        n, base = len(prompts), router.n_submitted
        turns = []
        cpu = {"router_cpu_s": 0.0, "process_cpu_s": 0.0, "wall_s": 0.0}
        for kind, b in (("D", base), ("F", base), ("F", base + n),
                        ("D", base + n)):
            label = f"{'fleet' if kind == 'F' else 'direct'}_" \
                f"{len(turns) + 1}"
            if kind == "D":
                outs, run = _direct(ref, prompts, temps,
                                    list(range(b, b + n)), label)
            else:
                c0 = (_thread_cpu_s(("router-",)), time.process_time(),
                      time.perf_counter())
                outs, run = _routed(router, prompts, temps, label)
                c1 = (_thread_cpu_s(("router-",)), time.process_time(),
                      time.perf_counter())
                for k, a, z in zip(cpu, c0, c1):
                    cpu[k] += z - a
                run["replicas"] = [o["replica"] for o in outs]
                checks[f"{label}_nonces_pinned"] = [
                    o["request_id"] for o in outs] == list(range(b, b + n))
                for o in outs:
                    delivered[o["replica"]] += len(o["output_ids"])
            turns.append((outs, run))
        for (f, fr), (d, _) in ((turns[1], turns[0]),
                                (turns[2], turns[3])):
            checks[f"{fr['run']}_streams_eq_reference"] = _same_streams(
                f, d, prompts, ref.net, fr["run"], diverged)
        main_picks = [pick(p) for p in prompts]
        checks["main_traffic_on_affinity_replicas"] = all(
            t[1]["replicas"] == main_picks for t in turns[1:3])
        nums["main_traffic"] = [t[1] for t in turns]
        rate = {k: float(np.mean([turns[i][1]["tokens_per_s"]
                                  for i in idx]))
                for k, idx in (("fleet", (1, 2)), ("direct", (0, 3)))}
        nums["fleet_over_direct_tokens_per_s"] = \
            rate["fleet"] / rate["direct"]
        # turns 1-2 find the prompts uncached, turns 3-4 cached
        nums["fleet_over_direct_by_pair"] = [
            turns[f][1]["tokens_per_s"] / turns[d][1]["tokens_per_s"]
            for f, d in ((1, 0), (2, 3))]
        nums["router_threads"] = dict(
            cpu, share_of_process_cpu=cpu["router_cpu_s"] /
            cpu["process_cpu_s"],
            share_of_wall=cpu["router_cpu_s"] / cpu["wall_s"])

        sp_pick = pick(sp_prompts[0])
        hit_key = "llm_prefix_cache_hit_tokens"
        hits0 = _scrape(_debug_base(infos[sp_pick])).get(hit_key, 0.0)
        first, _ = _routed(router, sp_prompts[:1], sp_temps[:1],
                           "prefix seed")
        burst, run7 = _routed(router, sp_prompts[1:], sp_temps[1:],
                              "prefix burst")
        hits = _scrape(_debug_base(infos[sp_pick]))[hit_key] - hits0
        sp_outs = first + burst
        for o in sp_outs:
            delivered[o["replica"]] += len(o["output_ids"])
        want, _ = _direct(ref, sp_prompts, sp_temps,
                          [o["request_id"] for o in sp_outs],
                          "prefix reference")
        checks["prefix_streams_eq_reference"] = _same_streams(
            sp_outs, want, sp_prompts, ref.net, "prefix", diverged)
        checks["prefix_on_affinity_replica"] = all(
            o["replica"] == sp_pick for o in sp_outs)
        checks["prefix_cache_hit_tokens_7x512"] = hits == 7 * 512
        nums["prefix_burst"] = dict(run7, replica=sp_pick,
                                    cache_hit_tokens=hits)
        status = {n: _kernel_status(i) for n, i in infos.items()}
        for n, k in status.items():
            checks[f"{n}_launches_eq_layers_x_passes"] = _launches_match(k)
            checks[f"{n}_device_h100"] = "H100" in k["device"]
        nums["kernels_step1"] = status

        # 2. failover: SIGKILL the replica holding most of the traffic
        victim = max(("r0", "r1"), key=main_picks.count)
        vproc = spawned[victim][0]
        killed = {}

        def kill():
            _wait(lambda: (router.inflight_of(victim) or 0) >= 2, 120,
                  f"two requests in flight on {victim}")
            time.sleep(0.2)
            killed["inflight"] = router.inflight_of(victim)
            os.kill(vproc.pid, signal.SIGKILL)
            killed["rc"] = vproc.wait(timeout=60)

        outs, run = _routed(router, prompts, temps, "failover", kill)
        rerouted = [i for i, o in enumerate(outs)
                    if main_picks[i] == victim and o["replica"] != victim]
        want, _ = _direct(ref, prompts, temps,
                          [o["request_id"] for o in outs],
                          "failover reference")
        checks["failover_no_request_lost"] = all(
            len(o["output_ids"]) == 32 for o in outs)
        checks["failover_killed_with_2_in_flight"] = \
            killed["inflight"] >= 2 and killed["rc"] == -signal.SIGKILL
        checks["failover_rerouted_ge_2_with_failovers"] = \
            len(rerouted) >= 2 and all(outs[i]["failovers"] >= 1
                                       for i in rerouted)
        checks["failover_streams_eq_reference"] = _same_streams(
            outs, want, prompts, ref.net, "failover", diverged)
        vstate = router._replicas[victim]
        checks["failover_breaker_opened"] = vstate.breaker.n_opens >= 1
        for o in outs:
            if o["replica"] != victim:
                delivered[o["replica"]] += len(o["output_ids"])
        delivered[victim] = 0           # its process is gone
        f1 = turns[1][0]
        nums["failover"] = dict(
            run, victim=victim, inflight_at_kill=killed["inflight"],
            rerouted=rerouted, router_failovers=router.n_failovers,
            added_latency_s=[outs[i]["client_latency_s"] -
                             f1[i]["client_latency_s"] for i in rerouted])

        # respawn the victim from the same spec (and the prefill replica
        # of step 4 beside it); its breaker must go half-open, closed
        br = vstate.breaker
        seen = []
        record_success = br.record_success

        def logged_success():
            before = br.state
            record_success()
            seen.append((before, br.state))

        br.record_success = logged_success
        again = _spawn([child(victim, store=endpoint),
                        child("pre0", role="prefill")], procs)
        nums["spawn_to_ready_s"].update(
            {f"{victim} respawn": again[victim][2],
             "pre0": again["pre0"][2]})
        infos[victim] = again[victim][1]
        pinfo = again["pre0"][1]

        def up_again():
            fz = json.loads(_get(dbase, "/fleetz"))["fleets"][
                router._status_name]["replicas"][victim]
            return fz["breaker"] == "closed" and \
                fz["health"] == "healthy" and \
                (fz["metrics"] or {}).get("up") is True

        _wait(up_again, 120, f"{victim} up again on /fleetz")
        checks["respawn_breaker_half_open_then_closed"] = \
            ("half_open", "closed") in seen
        checks["respawn_up_on_fleetz"] = True
        mine = [i for i, p in enumerate(main_picks) if p == victim][:2]
        outs, _ = _routed(router, [prompts[i] for i in mine],
                          [temps[i] for i in mine], "after respawn")
        want, _ = _direct(ref, [prompts[i] for i in mine],
                          [temps[i] for i in mine],
                          [o["request_id"] for o in outs],
                          "after respawn reference")
        checks["respawned_serves_eq_reference"] = all(
            o["replica"] == victim for o in outs) and _same_streams(
            outs, want, [prompts[i] for i in mine], ref.net,
            "after respawn", diverged)
        for o in outs:
            delivered[o["replica"]] += len(o["output_ids"])

        # 3. the router's federated metrics over the live replicas
        time.sleep(4 * router.health_poll_interval)   # a fresh scrape
        fz = json.loads(_get(dbase, "/fleetz"))["fleets"][
            router._status_name]
        series = _scrape(dbase)
        fleet_m = {k: series.get(k) for k in (
            "fleet_replicas_scraped", "fleet_tokens_generated",
            "fleet_mfu", "fleet_requests_completed")}
        checks["fleet_replicas_scraped_eq_live"] = \
            fleet_m["fleet_replicas_scraped"] == len(infos) == \
            fz["aggregates"]["replicas_scraped"]
        checks["fleet_tokens_eq_delivered"] = \
            fleet_m["fleet_tokens_generated"] == sum(delivered.values())
        checks["fleet_mfu_positive"] = (fleet_m["fleet_mfu"] or 0) > 0
        checks["federated_replica_series"] = all(
            any(k.startswith("fleet_llm_") and f'replica="{n}"' in k
                for k in series) for n in infos)
        nums["fleet_metrics"] = dict(fleet_m, delivered=delivered,
                                     failovers=fz["failovers"])

        # 4. disaggregated prefill/decode: pre0 fills, the in-process
        # engine decodes from pages migrated over HTTP
        ref2 = make_engine_from_spec(spec)
        refs.append(ref2)
        tampered = _TamperedPrefill(HTTPReplica(
            pinfo["generate"], pinfo["healthz"],
            metrics_url=pinfo["metrics"]))
        router2 = Router(page_size=ps, disagg_threshold_tokens=64,
                         name="disagg")
        routers.append(router2)
        router2.attach("pre0", tampered, role="prefill")
        router2.attach("dec0", LocalReplica(ref), role="decode")
        rng = np.random.RandomState(3)
        dprompts = [rng.randint(0, vocab, n).tolist()
                    for n in np.linspace(256, 900, 4).astype(int)]
        dtemps = [0.0, 0.8, 0.0, 0.8]
        outs, run = _routed(router2, dprompts, dtemps, "disaggregated")
        want, _ = _direct(ref2, dprompts, dtemps,
                          [o["request_id"] for o in outs],
                          "unified reference")
        checks["disagg_decoded_on_dec0_from_pre0"] = all(
            o["replica"] == "dec0" and o.get("prefill_replica") == "pre0"
            for o in outs)
        checks["disagg_all_prefix_pages_migrated"] = [
            o.get("migrated_pages") for o in outs] == [
            (len(p) - 1) // ps for p in dprompts]
        checks["disagg_pages_migrated_gt_0"] = router2.n_pages_migrated > 0
        checks["disagg_streams_eq_unified"] = _same_streams(
            outs, want, dprompts, ref.net, "disaggregated", diverged)
        exports = list(tampered.exports)
        tampered.mode = "corrupt"
        bad = rng.randint(0, vocab, 300).tolist()
        rejected0 = router2.n_pages_rejected
        o, _ = _routed(router2, [bad], [0.8], "corrupted page")
        tampered.mode = None
        w, _ = _direct(ref2, [bad], [0.8], [o[0]["request_id"]],
                       "corrupted page reference")
        checks["corrupt_page_rejected"] = \
            router2.n_pages_rejected - rejected0 == (len(bad) - 1) // ps - 1
        checks["corrupt_only_page_0_installed"] = \
            o[0].get("migrated_pages") == 1
        checks["corrupt_stream_eq_unified"] = _same_streams(
            o, w, [bad], ref.net, "corrupted page", diverged)

        def no_leak():
            return len(ref._free_pages) + ref._cache.shared_page_count \
                + 1 == ref.num_pages

        _wait(no_leak, 30, "dec0's pool back to free + shared")
        checks["dec0_pool_leaks_no_page"] = True
        nums["migration"] = dict(
            run, migrate_s=[x.get("migrate_s") for x in outs],
            migrated_pages=[x.get("migrated_pages") for x in outs],
            page_bytes=ref._tgt_page_bytes, exports=exports,
            corrupted={"rejected": router2.n_pages_rejected - rejected0,
                       "migrated_pages": o[0].get("migrated_pages")})

        status = {n: _kernel_status(i) for n, i in
                  dict(infos, pre0=pinfo).items()}
        for n, k in status.items():
            checks[f"{n}_end_launches_eq_layers_x_passes"] = \
                _launches_match(k)
            checks[f"{n}_end_device_h100"] = "H100" in k["device"]
        torch.cuda.synchronize()
        parent = pa.launches
        checks["parent_launches_eq_layers_x_passes"] = parent > 0 and \
            parent == layers * sum(e.n_dispatched_ticks for e in refs)
        nums["kernels_end"] = dict(status, parent={
            "paged_attention_launches": parent,
            "dispatched_ticks": [e.n_dispatched_ticks for e in refs]})
    finally:
        for r in routers:
            r.close()
        for e in refs:
            e.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        store.close()
        dbg.stop()
        shutil.rmtree(obs_dir, ignore_errors=True)
    emit({"phase": "fleet", "card": dev["nvidia_smi"], **nums,
          "diverged": diverged, "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "fleet_checks", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"fleet checks failed: {failed}")


# ---------------------------------------------------------------------------
# kernels B1, B2, B3 against their plain twins
# ---------------------------------------------------------------------------

def _device_ms(fn, reps, attempts=3) -> float:
    """Device ms of one call of ``fn``: the time its kernels run on the
    card over ``reps`` calls, from ``torch.profiler``. CUDA events around
    the calls would also count the gaps in which the card waits for the
    host: SDPA's autograd backward takes more host time to launch than
    its kernels take on the card. Now and then a profiler window comes
    back without device events; such a window is run again, up to
    ``attempts`` windows in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy > 0:
            return busy / 1e3 / reps
    raise SystemExit(f"torch.profiler recorded no device time in "
                     f"{attempts} windows")


def _time_interleaved(fns, reps=FLASH_REPS, windows=FLASH_WINDOWS):
    """Median device ms of one call of each function in ``fns`` over
    ``windows`` windows of ``reps`` calls, the windows taken in turns
    (a, b, c, a, b, c, ...) after two warm-up calls each, so that a drift
    of the card's clock moves every function alike."""
    for fn in fns.values():
        fn()
        fn()
    torch.cuda.synchronize()
    ms = {name: [] for name in fns}
    for _ in range(windows):
        for name, fn in fns.items():
            ms[name].append(_device_ms(fn, reps))
    return {name: float(np.median(v)) for name, v in ms.items()}


def _visible_pairs(sq, sk, causal):
    """(query, key) pairs the bottom-right causal mask leaves visible."""
    if not causal:
        return sq * sk
    offset = sk - sq
    return sq * (offset + 1) + sq * (sq - 1) // 2


def _flash_bound(kernel, b, sq, sk, hq, hkv, d, causal, dtype):
    """The least time the card could take for one launch: every input
    read once and every output written once over HBM bandwidth, or
    c * b * hq * d * (visible pairs) operations over the input type's
    peak (c = 4 for B1, 6 for B2, 8 for B3)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    q_b = b * sq * hq * d * elt
    kv_b = b * sk * hkv * d * elt
    lse_b = b * hq * sq * 4
    nbytes = {"flash_attention_fwd": 2 * q_b + 2 * kv_b + lse_b,
              "flash_attention_bwd_dq": 4 * q_b + 2 * kv_b + lse_b,
              "flash_attention_bwd_dkv": 3 * q_b + 4 * kv_b + lse_b}[kernel]
    c = {"flash_attention_fwd": 4, "flash_attention_bwd_dq": 6,
         "flash_attention_bwd_dkv": 8}[kernel]
    ops = c * b * hq * d * _visible_pairs(sq, sk, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _sdpa_calls(q, k, v, do, causal):
    """The one-call yardstick: torch's scaled_dot_product_attention on
    the same tensors (forward, and its autograd backward for dQ, dK, dV
    together)."""
    import torch.nn.functional as TF
    from torch.nn.attention.bias import causal_lower_right
    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = [x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v)]
    kw = {"enable_gqa": q.shape[2] != k.shape[2]}
    if causal and sq == sk:
        kw["is_causal"] = True
    elif causal:
        kw["attn_mask"] = causal_lower_right(sq, sk)
    out = TF.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return TF.scaled_dot_product_attention(qt, kt, vt, **kw)

    def bwd():
        return torch.autograd.grad(out, (qt, kt, vt), dot,
                                   retain_graph=True)
    return fwd, bwd


def phase_flash_kernels() -> dict:
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = [  # name, b, sq, sk, hq, hkv, d, dtype[, causal]
        ("train gpt2 bf16", 8, 1024, 1024, 12, 12, 64, torch.bfloat16),
        ("train gpt2 f32", 8, 1024, 1024, 12, 12, 64, torch.float32),
        ("gqa llama bf16", 2, 2048, 2048, 16, 4, 128, torch.bfloat16),
        ("cross 512x1024 bf16", 8, 512, 1024, 12, 12, 64, torch.bfloat16),
        # head dim 80 (hidden 640, 8 heads), run padded to 128
        ("d80 bf16", 8, 1024, 1024, 8, 8, 80, torch.bfloat16),
        # split d: the SIMT kernels summing over 64-column slices
        ("d256 f32 split", 2, 1024, 1024, 8, 8, 256, torch.float32),
        ("d320 bf16 split", 2, 1024, 1024, 8, 8, 320, torch.bfloat16),
        ("gqa d264 f16 split", 1, 1024, 1024, 8, 2, 264, torch.float16),
        # lengths that end in a partial 64-row tile
        ("s97 gqa bf16", 8, 97, 97, 12, 4, 64, torch.bfloat16),
        ("q200 k136 f32", 8, 200, 136, 12, 12, 64, torch.float32, False),
    ]
    cases, heads = [], {}
    for name, b, sq, sk, hq, hkv, d, dt, *causal in shapes:
        causal = causal[0] if causal else True
        scale = 1.0 / math.sqrt(d)
        q = torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dt)
        k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
        v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dt)
        do = torch.randn(b, sq, hq, d, generator=g, device="cuda").to(dt)
        o, lse = fa.flash_attention_fwd_kernel(q, k, v, scale, causal)
        want_o, want_lse = fa.flash_attention_fwd_torch(q, k, v, scale,
                                                        causal)
        dq = fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, scale,
                                              causal)
        dk, dv = fa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do,
                                                   scale, causal)
        want_dq, want_dk, want_dv = fa.flash_attention_bwd_torch(
            q, k, v, o, lse, do, scale, causal)
        torch.cuda.synchronize()

        def err(got, want):
            """(max |got - want|, max |got - want| / (atol + rtol |want|))
            at the limits of got's dtype."""
            rtol, atol = FLASH_TOL[got.dtype]
            d = (got.float() - want.float()).abs()
            return d.max().item(), \
                (d / (atol + rtol * want.float().abs())).max().item()
        checks = {
            "flash_attention_fwd": [err(o, want_o), err(lse, want_lse)],
            "flash_attention_bwd_dq": [err(dq, want_dq)],
            "flash_attention_bwd_dkv": [err(dk, want_dk),
                                        err(dv, want_dv)]}
        lib_fwd, lib_bwd = _sdpa_calls(q, k, v, do, causal)
        # every kernel in turns with its twin and SDPA; the backward twin
        # and SDPA's backward compute dQ, dK and dV together, so one time
        # of each stands in the B2 and the B3 row
        ms = _time_interleaved({
            "flash_attention_fwd": lambda: fa.flash_attention_fwd_kernel(
                q, k, v, scale, causal),
            "fwd_plain": lambda: fa.flash_attention_fwd_torch(
                q, k, v, scale, causal),
            "fwd_library": lib_fwd,
            "flash_attention_bwd_dq":
                lambda: fa.flash_attention_bwd_dq_kernel(
                    q, k, v, o, lse, do, scale, causal),
            "flash_attention_bwd_dkv":
                lambda: fa.flash_attention_bwd_dkv_kernel(
                    q, k, v, o, lse, do, scale, causal),
            "bwd_plain": lambda: fa.flash_attention_bwd_torch(
                q, k, v, o, lse, do, scale, causal),
            "bwd_library": lib_bwd})
        for kernel in checks:
            errs = checks[kernel]
            side = "fwd" if kernel == "flash_attention_fwd" else "bwd"
            bound_ms, bound_by, nbytes, ops = _flash_bound(
                kernel, b, sq, sk, hq, hkv, d, causal, dt)
            case = {"phase": "kernel_case", "kernel": kernel, "case": name,
                    "b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv,
                    "head_dim": d, "causal": causal, "dtype": str(dt),
                    "max_abs_err": max(e for e, _ in errs),
                    "rtol_atol": FLASH_TOL[dt],
                    "lse_rtol_atol": FLASH_TOL[torch.float32],
                    "err_over_limit": [r for _, r in errs],
                    "ok": all(math.isfinite(r) and r <= 1.0
                              for _, r in errs),
                    "ms": ms[kernel], "plain_ms": ms[f"{side}_plain"],
                    "library_ms": ms[f"{side}_library"],
                    "timing": f"device time, median of {FLASH_WINDOWS} "
                              f"windows of {FLASH_REPS} calls, in turns",
                    "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": ops}
            emit(case)
            cases.append(case)
            heads.setdefault(kernel, case)   # the gpt2 bf16 train shape
        del q, k, v, do, o, lse, want_o, want_lse, dq, dk, dv
        del want_dq, want_dk, want_dv, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    bad = [(c["kernel"], c["case"], c["max_abs_err"]) for c in cases
           if not c["ok"]]
    if bad:
        raise SystemExit(f"flash kernels disagree with their twins: {bad}")
    return heads


# ---------------------------------------------------------------------------
# GPT-2-small trained through Model.train_batch
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024
WARMUP_STEPS, TIMED_STEPS, PARITY_STEPS, PROFILE_STEPS = 3, 10, 3, 2


def _train_model(net):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=1e-4, parameters=net,
                                     weight_decay=0.01),
                  GPTFusedPretrainingCriterion(), amp_configs="O1")
    return model


def _flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    return dict(fa.launches)


def _reset_flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    for k in fa.launches:
        fa.launches[k] = 0


def _parity_losses(net, init, ids, impl):
    """PARITY_STEPS train steps from the initial weights with the flash
    kernels (impl "kernel") or their plain twins ("plain"); the losses
    and the launch counts of the run."""
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    model = _train_model(net)
    fa.impl = impl
    try:
        _reset_flash_counts()
        losses = [model.train_batch([ids], [ids])["loss"]
                  for _ in range(PARITY_STEPS)]
        torch.cuda.synchronize()
        counts = _flash_counts()
    finally:
        fa.impl = "kernel"
    return [float(x) for x in losses], counts


def _qkv_grad(net, init, ids, impl):
    """The gradient of every layer's qkv projection (weights and biases,
    flattened) after one fwd+bwd under AMP O1 from the initial weights,
    on the flash kernels or on their twins. It flows through dQ, dK and
    dV, so it holds B1-B3 where the loss cannot: at random init the loss
    is about ln V whatever attention does."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    net.train()
    net.zero_grad(set_to_none=True)
    fa.impl = impl
    try:
        with amp.auto_cast(level="O1"):
            hidden, w = net(ids)
        GPTFusedPretrainingCriterion()(hidden, w, ids).float().backward()
    finally:
        fa.impl = "kernel"
    g = torch.cat([p.grad.flatten() for n, p in net.named_parameters()
                   if "qkv_proj" in n])
    net.zero_grad(set_to_none=True)
    return g


def _profile(work, per, unit, **fields):
    """Device time by kernel of ``work()``, per ``unit`` (``per`` of them
    in the window), from ``torch.profiler``: the kernels' own device time
    (the host ops that launched them carry the same time and are left
    out), against the host wall of the same window (profiling inflates
    the wall, so the idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / per * 1e3
    rows = sorted(((e.self_device_time_total / 1e3 / per, e.count / per,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and
                   e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)

    def share(*words):
        return sum(r[0] for r in rows
                   if any(w in r[2].lower() for w in words)) / busy \
            if busy else None
    return {**fields, f"wall_ms_per_{unit}": wall,
            f"device_busy_ms_per_{unit}": busy if busy else "not measured",
            "idle_share": 1 - busy / wall if busy else None,
            "flash_share": share("flash_"),
            "paged_attention_share": share("paged_attention"),
            "gemm_share": share("gemm", "xmma", "cutlass", "nvjet"),
            "gemm_f32_share": share("f32f32", "sgemm"),
            "top": [{"kernel": k[:120], f"ms_per_{unit}": ms,
                     f"calls_per_{unit}": n} for ms, n, k in rows[:15]]}


def _profile_steps(model, ids, steps=PROFILE_STEPS):
    """Device time by kernel over ``steps`` train steps."""
    def work():
        for _ in range(steps):
            model.train_batch([ids], [ids])
    return _profile(work, steps, "step", phase="train", run="profile",
                    steps=steps)


def _peak_fwd_bwd(net, crit, ids):
    """Peak device bytes of one forward + backward under AMP O1."""
    from paddle_tpu_torch import amp
    net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with amp.auto_cast(level="O1"):
        out = net(ids)
    loss = crit(*(out if isinstance(out, tuple) else (out,)), ids)
    loss.float().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    net.zero_grad(set_to_none=True)
    return peak, float(loss.detach())


def phase_train() -> dict:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             GPTFusedPretrainingCriterion,
                                             gpt_config)
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True)
    pt.seed(0)
    net = GPTForCausalLM(cfg, device="cuda")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    n_params = sum(p.numel() for p in net.parameters())
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    ids = torch.as_tensor(ids_np, device="cuda")

    # the repair: use_flash=True on the card with a 17-token input runs
    # the eager math (flash_attention_available says no), launching
    # nothing, and gives what use_flash=False gives
    _reset_flash_counts()
    with torch.no_grad():
        net.eval()
        short = ids[:1, :17]
        lg_flash = net(short)
        cfg.use_flash = False
        lg_eager = net(short)
        cfg.use_flash = True
    torch.cuda.synchronize()
    repair = {"eager_for_17_tokens": torch.equal(lg_flash, lg_eager),
              "no_launches": sum(_flash_counts().values()) == 0,
              "finite": bool(torch.isfinite(lg_flash).all()),
              "shape": list(lg_flash.shape) == [1, 17, cfg.vocab_size]}

    # main path: warm-up, then the timed steps with the counts from 0
    model = _train_model(net)
    for _ in range(WARMUP_STEPS):
        model.train_batch([ids_np], [ids_np])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    losses = [model.train_batch([ids_np], [ids_np])["loss"]
              for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _flash_counts()
    peak_train = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ * TIMED_STEPS / wall
    flops_per_token = 6 * n_params + \
        6 * cfg.num_layers * TRAIN_SEQ * cfg.hidden_size
    emit({"phase": "train", "run": "main", "model": "gpt2-small",
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "params": n_params,
          "amp": "O1", "fused_loss": True, "optimizer": "AdamW",
          "steps": TIMED_STEPS, "wall_s": wall,
          "step_ms": wall / TIMED_STEPS * 1e3, "tokens_per_s": tokens_per_s,
          "mfu": tokens_per_s * flops_per_token / 989e12,
          "losses": losses, "max_memory_allocated": peak_train,
          "launches": launches})
    emit(_profile_steps(model, ids_np))

    # kernels against twins from the same initial weights
    k_losses, k_counts = _parity_losses(net, init, ids_np, "kernel")
    p_losses, p_counts = _parity_losses(net, init, ids_np, "plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
    g_k = _qkv_grad(net, init, ids, "kernel")
    g_p = _qkv_grad(net, init, ids, "plain")
    qkv_rel = float((g_k - g_p).norm() / g_p.norm())
    emit({"phase": "train", "run": "kernels vs twins",
          "steps": PARITY_STEPS, "kernel_losses": k_losses,
          "plain_losses": p_losses, "rel_diff": rel,
          "rtol": TRAIN_LOSS_RTOL, "kernel_launches": k_counts,
          "plain_launches": p_counts, "qkv_grad_rel_diff": qkv_rel,
          "qkv_grad_rtol": QKV_GRAD_RTOL,
          "qkv_grad_norm": float(g_p.norm())})
    del g_k, g_p

    # fused vocab loss against the dense head: one fwd+bwd each
    net.load_state_dict(init)
    net.train()
    dense_cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                           hidden_dropout=0.0, attention_dropout=0.0,
                           fused_loss=False)
    dense = GPTForCausalLM(dense_cfg, device="cuda")
    dense.load_state_dict(init)
    dense.train()
    peak_fused, loss_fused = _peak_fwd_bwd(
        net, GPTFusedPretrainingCriterion(), ids)
    peak_dense, loss_dense = _peak_fwd_bwd(
        dense, GPTPretrainingCriterion(), ids)
    tv_f32 = TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size * 4
    emit({"phase": "train", "run": "fused vs dense head",
          "peak_fused": peak_fused, "peak_dense": peak_dense,
          "saved": peak_dense - peak_fused, "one_TV_f32": tv_f32,
          "loss_fused": loss_fused, "loss_dense": loss_dense})
    del dense

    want = cfg.num_layers * TIMED_STEPS
    want_p = cfg.num_layers * PARITY_STEPS
    checks = {
        "launches_main_run": all(v == want for v in launches.values()),
        "launches_kernel_parity_run": all(v == want_p
                                          for v in k_counts.values()),
        "launches_plain_run": all(v == 0 for v in p_counts.values()),
        "losses_finite": all(math.isfinite(x)
                             for x in losses + k_losses + p_losses),
        "last_loss_below_first": losses[-1] < losses[0],
        "kernel_losses_match_twins": max(rel) <= TRAIN_LOSS_RTOL,
        "kernel_qkv_grad_matches_twins": qkv_rel <= QKV_GRAD_RTOL,
        "fused_peak_below_dense_by_one_TV_f32":
            peak_dense - peak_fused >= tv_f32,
        "fused_loss_eq_dense_loss": abs(loss_fused - loss_dense) <=
            1e-2 * abs(loss_dense),
        **{f"repair_{k}": v for k, v in repair.items()},
    }
    emit({"phase": "train_checks", "expected_launches": want,
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"train checks failed: {failed}")
    return launches


def _summary(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}


def main() -> None:
    info = phase_device()
    # float32 products in full float32, bf16 products with float32
    # reductions: the JAX package's numerics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    phase_build()
    head = phase_kernels()
    flash_heads = phase_flash_kernels()
    launches, serve_ctx = phase_serve()
    phase_serve_http(serve_ctx)
    phase_fleet(info, serve_ctx)
    del serve_ctx
    train_launches = phase_train()
    flash_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    emit({"kernels": [
        _summary("paged_attention",
                 "paddle_tpu_torch/csrc/paged_attention.cu",
                 "paddle_tpu/ops/paged_attention.py:216", launches, head),
        _summary("flash_attention_fwd", flash_src,
                 "paddle_tpu/ops/flash_attention.py:129",
                 train_launches["flash_attention_fwd"],
                 flash_heads["flash_attention_fwd"]),
        _summary("flash_attention_bwd_dq", flash_src,
                 "paddle_tpu/ops/flash_attention.py:256",
                 train_launches["flash_attention_bwd_dq"],
                 flash_heads["flash_attention_bwd_dq"]),
        _summary("flash_attention_bwd_dkv", flash_src,
                 "paddle_tpu/ops/flash_attention.py:256",
                 train_launches["flash_attention_bwd_dkv"],
                 flash_heads["flash_attention_bwd_dkv"])]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
