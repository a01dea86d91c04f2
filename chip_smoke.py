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
   path's shapes and dtypes, with its time beside the plain twin's, a
   one-call PyTorch yardstick's and the least time the card could take;
4. flash kernels: B1, B2 and B3 the same way at the training path's
   shapes (gpt2-small bf16 and f32, llama-style GQA, cross-length, head
   dim 80), each kernel's device time (``torch.profiler``) taken in
   turns with its twin's and SDPA's (median of 3 windows of 20 calls);
5. serve: GPT-2-small at full width (random weights from ``seed(0)``)
   serving eight requests through ``LLMEngine`` on kernel B4, then on
   the plain twin (token streams must be identical), then 32 greedy
   streams on an int8 KV pool against an f32 pool (agreement >= 0.9);
6. train: GPT-2-small at full width as ``bench.py bench_gpt`` configures
   it (seq 1024, batch 8, fused loss, AdamW 1e-4 / wd 0.01, AMP O1)
   through ``Model.train_batch`` on kernels B1-B3: 3 warm-up and 10
   timed steps, a 2-step ``torch.profiler`` window (device time by
   kernel), then 3 steps on the kernels against 3 on the plain twins
   from the same weights (losses) and one fwd+bwd each (the qkv
   projections' gradient), the fused loss's peak memory against the
   dense head's, and the flash dispatch's eager path for a short input;
7. a ``{"kernels": [...]}`` summary line, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

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
    """``flash_fwd_mma<__nv_bfloat16,64>`` from a mangled kernel name."""
    m = re.search(r"\d+((?:flash|paged)_[a-z_]+?)I(?:\d+(__nv_bfloat16|"
                  r"__half)|([fa]))Li(\d+)E", mangled)
    if m:
        dtype = m.group(2) or {"f": "float", "a": "int8"}[m.group(3)]
        return f"{m.group(1)}<{dtype},{m.group(4)}>"
    m = re.search(r"\d+((?:flash|paged)_\w+?)(?:I|Ev|$)", mangled)
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
    # the half-type B1 and B2 are tensor-core kernels: their SASS must
    # hold mma instructions
    flash = sass.get("flash_attention")
    if flash is not None:
        mma = {k: v for k, v in flash.items() if "_mma<" in k}
        if len(mma) < 4 or not all(mma.values()):
            raise SystemExit(f"tensor-core flash kernels without mma "
                             f"instructions in their SASS: {mma}")


# ---------------------------------------------------------------------------
# kernel B4 against its plain twin
# ---------------------------------------------------------------------------

def _case_inputs(g, t, heads, kv_heads, d, kv_dtype, q_dtype, lens_list,
                 seqs):
    """Layer-stacked pools and the rows of one launch. ``seqs[t]`` names
    the sequence of row t: rows of one sequence share a table."""
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    dev = "cuda"
    shape = (LAYERS, NUM_PAGES, PAGE_SIZE, kv_heads, d)
    k = torch.randn(shape, generator=g, device=dev)
    v = torch.randn(shape, generator=g, device=dev)
    if kv_dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        pools = (kq, vq, ks, vs)
    else:
        pools = (k.to(kv_dtype), v.to(kv_dtype), None, None)
    del k, v
    P = PAGES_PER_SEQ
    perm = torch.randperm(NUM_PAGES - 1, generator=g, device=dev) + 1
    n_seq = max(seqs) + 1
    seq_tables = perm[:n_seq * P].reshape(n_seq, P).to(torch.int32)
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    tables = seq_tables[torch.tensor(seqs, device=dev)].clone()
    used = (lens + PAGE_SIZE - 1) // PAGE_SIZE
    cols = torch.arange(P, device=dev)[None, :]
    tables[cols >= used[:, None]] = -1           # -1 tails
    q = torch.randn((t, heads, d), generator=g, device=dev).to(q_dtype)
    return pools, tables.contiguous(), lens, q


def _layer_args(pools, i):
    kp, vp, ks, vs = pools
    return (kp[i], vp[i], None if ks is None else ks[i],
            None if vs is None else vs[i])


def _time_ms(fn) -> float:
    """Mean ms of one call, over LAYERS calls on the LAYERS pools (so
    L2 holds no layer's pages when its turn comes), after warm-up."""
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
    return start.elapsed_time(end) / (REPS * LAYERS)


def _bound(lens, seqs, t, heads, kv_heads, d, pages_per_seq, kv_dtype,
           q_dtype):
    """The least time the card could take for one launch: bytes moved
    (each live page of K and V once, even when several rows of one
    sequence attend it; int8 scales, q, out, tables, lens) over HBM
    bandwidth, or operations (QK and PV, 2 each per head, attended
    position and dim) over the peak rate of the pool's type."""
    live = {}
    for n, s in zip(lens, seqs):
        live[s] = max(live.get(s, 0), -(-n // PAGE_SIZE))
    pages = sum(live.values())
    kv_elt = torch.tensor([], dtype=kv_dtype).element_size()
    q_elt = torch.tensor([], dtype=q_dtype).element_size()
    nbytes = pages * PAGE_SIZE * kv_heads * d * 2 * kv_elt
    if kv_dtype == torch.int8:
        nbytes += pages * PAGE_SIZE * 4 * 2
    nbytes += 2 * t * heads * d * q_elt + t * pages_per_seq * 4 + t * 4
    ops = 4 * sum(lens) * heads * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kv_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _library_fn(pools, tables, lens, q, heads, kv_heads):
    """One torch call computing the same attention: SDPA over each
    layer's pages pre-gathered contiguously (gathering not timed)."""
    import torch.nn.functional as TF
    t, _, d = q.shape
    L = tables.shape[1] * PAGE_SIZE
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
    from paddle_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.RandomState(0)
    decode_lens = [0, 17, 143, 269, 400, 647, 773, 932]
    # a prefill chunk: the last 40 prompt rows of one sequence, the
    # first 20 of another, 4 padding rows
    chunk_lens = list(range(861, 901)) + list(range(1, 21)) + [0] * 4
    chunk_seqs = [0] * 40 + [1] * 20 + [2] * 4
    shapes = [
        ("decode gpt2", 8, 12, 12, 64, decode_lens, list(range(8))),
        ("chunk gpt2", 64, 12, 12, 64, chunk_lens, chunk_seqs),
        ("decode llama-gqa", 8, 16, 4, 128,
         [int(n) for n in rng.permutation(decode_lens)], list(range(8))),
    ]
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16,
                                               torch.float32),
              (torch.bfloat16, torch.bfloat16), (torch.int8,
                                                 torch.float32)]
    cases = []
    for name, t, heads, kv_heads, d, lens_list, seqs in shapes:
        for kv_dtype, q_dtype in dtypes:
            pools, tables, lens, q = _case_inputs(
                g, t, heads, kv_heads, d, kv_dtype, q_dtype, lens_list,
                seqs)
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
            ms = _time_ms(kern)
            plain_ms = _time_ms(plain)
            library_ms = _time_ms(_library_fn(pools, tables, lens, q,
                                              heads, kv_heads))
            bound_ms, bound_by, nbytes, ops = _bound(
                lens_list, seqs, t, heads, kv_heads, d, tables.shape[1],
                kv_dtype, q_dtype)
            case = {"phase": "kernel_case", "kernel": "paged_attention",
                    "case": name, "T": t, "heads": heads,
                    "kv_heads": kv_heads, "head_dim": d,
                    "page_size": PAGE_SIZE,
                    "pages_per_seq": tables.shape[1],
                    "kv_dtype": str(kv_dtype), "q_dtype": str(q_dtype),
                    "lens": lens_list, "max_abs_err": err, "tol": tol,
                    "ok": ok, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": ops}
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

def _serve(net, prompts, temps, nonces, impl, kv_dtype, label):
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.ops import paged_attention as pa
    eng = LLMEngine(net, max_seqs=8, page_size=PAGE_SIZE,
                    num_pages=NUM_PAGES, prefill_chunk=64,
                    kv_dtype=kv_dtype, attention_impl=impl, device="cuda")
    with eng:
        torch.cuda.synchronize()
        pa.launches = 0
        t0 = time.perf_counter()
        futs = [eng.submit(p, max_new_tokens=32, temperature=tp, nonce=n)
                for p, tp, n in zip(prompts, temps, nonces)]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = pa.launches
    n_tok = sum(len(o["output_ids"]) for o in outs)
    ttft = sorted(o["ttft_s"] for o in outs)
    run = {"phase": "serve", "run": label, "attention_impl": impl,
           "kv_dtype": kv_dtype,
           "requests": len(outs), "output_tokens": n_tok,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_p50_s": float(np.median(ttft)),
           "prefill_chunks": eng.n_prefill_ticks,
           "decode_ticks": eng.n_decode_ticks,
           "kernel_launches": launches,
           "truncated": sum(o["truncated"] for o in outs)}
    emit(run)
    return outs, run


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

    want = cfg.num_layers * (run_k["prefill_chunks"] +
                             run_k["decode_ticks"])
    want_q = cfg.num_layers * (run_q["prefill_chunks"] +
                               run_q["decode_ticks"])
    streams_k = [o["output_ids"] for o in outs_k]
    per_request = _agreement([o["output_ids"] for o in outs_q],
                             [o["output_ids"] for o in outs_g])
    agree = float(np.mean(per_request))
    # the dense-cache path as reference for the first greedy request
    dense = net.generate(torch.tensor([prompts[0]], device="cuda"),
                         max_new_tokens=32)[0, lens[0]:].tolist()
    checks = {
        "launches_kernel_run": run_k["kernel_launches"] == want,
        "launches_int8_run": run_q["kernel_launches"] == want_q,
        "launches_plain_run": run_p["kernel_launches"] == 0,
        "streams_kernel_eq_plain": streams_k ==
        [o["output_ids"] for o in outs_p],
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
          "expected_launches": want, "int8_greedy_agreement": agree,
          "int8_agreement_per_request": per_request, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"serve checks failed: {failed}")
    return run_k["kernel_launches"]


# ---------------------------------------------------------------------------
# kernels B1, B2, B3 against their plain twins
# ---------------------------------------------------------------------------

def _device_ms(fn, reps) -> float:
    """Device ms of one call of ``fn``: the time its kernels run on the
    card over ``reps`` calls, from ``torch.profiler``. CUDA events around
    the calls would also count the gaps in which the card waits for the
    host: SDPA's autograd backward takes more host time to launch than
    its kernels take on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    if busy <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return busy / 1e3 / reps


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
    shapes = [  # name, b, sq, sk, hq, hkv, d, dtype
        ("train gpt2 bf16", 8, 1024, 1024, 12, 12, 64, torch.bfloat16),
        ("train gpt2 f32", 8, 1024, 1024, 12, 12, 64, torch.float32),
        ("gqa llama bf16", 2, 2048, 2048, 16, 4, 128, torch.bfloat16),
        ("cross 512x1024 bf16", 8, 512, 1024, 12, 12, 64, torch.bfloat16),
        # head dim 80 (hidden 640, 8 heads), run padded to 128
        ("d80 bf16", 8, 1024, 1024, 8, 8, 80, torch.bfloat16),
    ]
    cases, heads = [], {}
    for name, b, sq, sk, hq, hkv, d, dt in shapes:
        causal = True
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


def _profile_steps(model, ids, steps=PROFILE_STEPS):
    """Device time by kernel over ``steps`` train steps, from
    ``torch.profiler``: the kernels' own device time (the host ops that
    launched them carry the same time and are left out), against the
    host wall of the same window (profiling inflates the wall, so the
    idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_batch([ids], [ids])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and
                   e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)

    def share(*words):
        return sum(r[0] for r in rows
                   if any(w in r[2].lower() for w in words)) / busy \
            if busy else None
    return {"phase": "train", "run": "profile", "steps": steps,
            "wall_ms_per_step": wall / steps * 1e3,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1 - busy / (wall / steps * 1e3) if busy else None,
            "flash_share": share("flash_"),
            "gemm_share": share("gemm", "xmma", "cutlass", "nvjet"),
            "gemm_f32_share": share("f32f32", "sgemm"),
            "top": [{"kernel": k[:120], "ms_per_step": ms,
                     "calls_per_step": n} for ms, n, k in rows[:15]]}


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
    launches = phase_serve()
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
