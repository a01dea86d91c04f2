#!/usr/bin/env python3
"""Time one family of the port's kernels in two checkouts on one card, in
turns.

    python3 tools/torch_kernel_pair.py flash|paged PARENT_ROOT CHANGE_ROOT

Each root is a directory holding ``paddle_tpu_torch/`` and
``chip_smoke.py`` (unpack one with ``git archive <commit> | tar -x -C
build/parent``). The two libraries build at once (one ``nvcc`` each);
then each timing runs in its own process, which imports that root's
package, with device time from ``torch.profiler`` as ``chip_smoke.py``
takes it:

- ``flash``: B1, B2 and B3 causal at the gpt2-small train shape (b 8, s
  1024, 12 heads, d 64) in bf16 and f32 (median of 3 windows of 20
  calls, in turns), trees in turns A, B, B, A;
- ``paged``: B4 at ``chip_smoke.py``'s serving shapes (gpt2 decode in
  f32 and int8 pages, a gpt2 prefill chunk, llama-style GQA decode, a
  verify window) on its 12 layer pools, with the same inputs in every
  process (seeded generator), 60 calls over the 12 pools and CUDA events
  beside the profiler, trees in turns A, B, B, A, B, A, A, B.

Prints the card and its power limit, each tree's ptxas registers and
spills (of the tensor-core kernels for ``flash``), and one JSON line per
timing."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

# library built, ptxas kernels kept, turns of the trees
KERNELS = {"flash": ("flash_attention", "_mma<", "ABBA"),
           "paged": ("paged_attention", "", "ABBABAAB")}


def _paged_shapes(c):
    """(name, T, heads, kv heads, d, lens, seqs, kv dtype name) of
    chip_smoke.py's phase_kernels cases."""
    import numpy as np
    decode = [0, 17, 143, 269, 400, 647, 773, 932]
    chunk = list(range(861, 901)) + list(range(1, 21)) + [0] * 4
    bases = np.linspace(16, 928, 8).astype(int)
    k = c.SPEC_K
    verify = [int(b) + j + 1 for b in bases for j in range(k)]
    gqa = [int(n) for n in np.random.RandomState(0).permutation(decode)]
    return (("decode gpt2", 8, 12, 12, 64, decode, list(range(8)),
             "float32"),
            ("decode gpt2", 8, 12, 12, 64, decode, list(range(8)), "int8"),
            ("chunk gpt2", 64, 12, 12, 64, chunk,
             [0] * 40 + [1] * 20 + [2] * 4, "float32"),
            ("decode llama-gqa", 8, 16, 4, 128, gqa, list(range(8)),
             "bfloat16"),
            ("verify gpt2 (8 x K 4)", 8 * k, 12, 12, 64, verify,
             [s for s in range(8) for _ in range(k)], "float32"))


def _time_flash(c, out):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, dtype in (("gpt2 bf16", "bfloat16"), ("gpt2 f32", "float32")):
        dt = getattr(torch, dtype)
        q, k, v, do = [torch.randn(8, 1024, 12, 64, generator=g,
                                   device="cuda").to(dt) for _ in range(4)]
        sc = 64 ** -0.5
        o, lse = fa.flash_attention_fwd_kernel(q, k, v, sc, True)
        out[name] = c._time_interleaved({
            "B1": lambda: fa.flash_attention_fwd_kernel(q, k, v, sc, True),
            "B2": lambda: fa.flash_attention_bwd_dq_kernel(
                q, k, v, o, lse, do, sc, True),
            "B3": lambda: fa.flash_attention_bwd_dkv_kernel(
                q, k, v, o, lse, do, sc, True)})


def _time_paged(c, out):
    import torch
    # the module; the package re-exports a function under its name
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    for name, t, heads, kvh, d, lens, seqs, kv in _paged_shapes(c):
        g = torch.Generator(device="cuda").manual_seed(0)
        pools, tables, lt, q = c._case_inputs(
            g, t, heads, kvh, d, getattr(torch, kv), torch.float32
            if kv != "bfloat16" else torch.bfloat16, lens, seqs)

        def kern(i):
            a = c._layer_args(pools, i)
            return pa.paged_attention_kernel(q, a[0], a[1], tables, lt,
                                             k_scales=a[2], v_scales=a[3])
        ms, events = c._time_ms(kern)
        out[f"{name} {kv}"] = {"ms": ms, "ms_events": events}
        del pools
        torch.cuda.empty_cache()


def _child(kernel: str, root: str, label: str, build: bool) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as c
    from paddle_tpu_torch.ops import _kernels
    lib, keep, _ = KERNELS[kernel]
    if build:
        _kernels.build_all([lib])
        # no log where the library was built before, by an earlier run
        rep = c._ptxas_report(_kernels.build_logs.get(lib, ""))
        print(json.dumps({"tree": label, "ptxas": {
            k: v for k, v in rep.items() if keep in k}}), flush=True)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": label, "root": root}
    (_time_flash if kernel == "flash" else _time_paged)(c, out)
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) == 5:      # a child: KERNEL ROOT LABEL build|time
        _child(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4] == "build")
        return
    if len(sys.argv) != 4 or sys.argv[1] not in KERNELS:
        raise SystemExit(__doc__)
    kernel, a, b = sys.argv[1:4]
    roots = {"A": a, "B": b}
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, kernel, root, label,
                                "build"])
              for label, root in roots.items()]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for label in KERNELS[kernel][2]:
        subprocess.run([sys.executable, me, kernel, roots[label], label,
                        "time"], check=True)


if __name__ == "__main__":
    main()
