#!/usr/bin/env python3
"""How far kernel B1 of the PyTorch port lands from its plain twin in
the half types, and how much of that the algorithm itself explains.

Run from the repository root on one CUDA card:

    python3 tools/torch_flash_rounding.py [--seeds 3]

At the gpt2-small train shape (b 8, s 1024, 12 heads, d 64, causal) and
for each seed and half type it prints one JSON line with the worst
``|a - b| / (atol + rtol |b|)`` (the card tests' element-wise limit, so
1 is the limit) and the count of elements above 1 for three pairs:

- ``kernel_vs_twin``: B1 against ``flash_attention_fwd_torch``, the
  check ``chip_smoke.py`` and the card tests make;
- ``online_vs_twin``: B1's algorithm written in PyTorch (64-key tiles, P
  rounded to the input dtype against the running max, float32 sums)
  against the twin, which rounds P against the row's final max;
- ``kernel_vs_online``: B1 against that emulation before its output is
  rounded.

The card's name and power limit come first. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch.ops import flash_attention as fa  # noqa: E402

# (rtol, atol) of tests/test_torch_flash_attention.py CARD_TOL
LIMITS = {torch.bfloat16: (2 ** -6, 2 ** -9), torch.float16: (2 ** -9, 2 ** -12)}
SHAPE = (8, 1024, 12, 64)   # b, s, heads, d
TILE = 64


def online_softmax(q, k, v, scale):
    """B1's algorithm in float32 on [1, s, h, d] inputs (causal)."""
    s_len = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    seen = torch.ones(s_len, s_len, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~seen, fa.DEFAULT_MASK_VALUE)
    m = torch.full(s.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[0], q.shape[2], s_len, q.shape[3],
                    device=q.device)
    for k0 in range(0, s_len, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bkhd->bhqd",
                                     p.to(v.dtype).float(),
                                     v[:, k0:k0 + TILE].float())
        m = m_new
    return (o / l).permute(0, 2, 1, 3)


def worst(a, b, rtol, atol):
    r = (a.float() - b.float()).abs() / (atol + rtol * b.float().abs())
    return r.max().item(), int((r > 1).sum())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_flash_rounding: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    b, s, h, d = SHAPE
    scale = 1.0 / math.sqrt(d)
    for seed in range(args.seeds):
        for dt, (rtol, atol) in LIMITS.items():
            g = torch.Generator(device="cuda").manual_seed(seed)
            q, k, v = [torch.randn(SHAPE, generator=g, device="cuda").to(dt)
                       for _ in range(3)]
            o, _ = fa.flash_attention_fwd_kernel(q, k, v, scale, True)
            twin, _ = fa.flash_attention_fwd_torch(q, k, v, scale, True)
            pairs = {"kernel_vs_twin": [], "online_vs_twin": [],
                     "kernel_vs_online": []}
            for i in range(b):      # one batch row at a time: memory
                sl = slice(i, i + 1)
                online = online_softmax(q[sl], k[sl], v[sl], scale)
                pairs["kernel_vs_twin"].append(
                    worst(o[sl], twin[sl], rtol, atol))
                pairs["online_vs_twin"].append(
                    worst(online.to(dt), twin[sl], rtol, atol))
                pairs["kernel_vs_online"].append(
                    worst(o[sl], online, rtol, atol))
            row = {"seed": seed, "dtype": str(dt), "shape": SHAPE,
                   "causal": True, "rtol_atol": (rtol, atol)}
            for name, vals in pairs.items():
                row[name] = {"worst_err_over_limit": max(x for x, _ in vals),
                             "elements_over_limit": sum(n for _, n in vals)}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
