#!/usr/bin/env python3
"""Smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, compiled from ``csrc/`` by
   ``nvcc`` for sm_90a (with the ptxas register report);
3. kernels: each kernel against its plain PyTorch twin at the serving
   path's shapes and dtypes, with its time beside the plain twin's, a
   one-call PyTorch yardstick's and the least time the card could take;
4. serve: GPT-2-small at full width (random weights from ``seed(0)``)
   serving eight requests through ``LLMEngine`` on kernel B4, then on
   the plain twin (token streams must be identical), then 32 greedy
   streams on an int8 KV pool against an f32 pool (agreement >= 0.9);
5. a ``{"kernels": [...]}`` summary line, then the result line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
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
PAGE_SIZE = 16
NUM_PAGES = 1024
PAGES_PER_SEQ = 64   # max_len 1024 over 16-token pages
LAYERS = 12          # one launch per layer, as in one engine step
REPS = 5


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


def phase_build() -> None:
    from paddle_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    per_kernel = _kernels.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _kernels.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": per_kernel, "nvcc": _kernels.nvcc_path(),
          "flags": list(_kernels.NVCC_FLAGS), "ptxas": ptxas})


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


def main() -> None:
    info = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    head = phase_kernels()
    launches = phase_serve()
    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:216",
        "launches": launches, "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})


if __name__ == "__main__":
    main()
