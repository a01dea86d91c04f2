#!/usr/bin/env python3
"""Time flash kernels B1-B3 of two checkouts of the port on one card, in
turns: A, B, B, A.

    python3 tools/torch_flash_pair.py PARENT_ROOT CHANGE_ROOT

Each root is a directory holding ``paddle_tpu_torch/`` and
``chip_smoke.py`` (unpack one with ``git archive <commit> | tar -x -C
build/parent``). The two libraries build at once (one ``nvcc`` each);
then each timing runs in its own process, which imports that root's
package: B1, B2 and B3 causal at the gpt2-small train shape (b 8, s
1024, 12 heads, d 64) in bf16 and f32, device time from
``torch.profiler`` as ``chip_smoke.py`` takes it (median of 3 windows of
20 calls, in turns). Prints the card and its power limit, each tree's
ptxas registers and spills of the tensor-core kernels, and one JSON line
per timing."""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = (("gpt2 bf16", "bfloat16"), ("gpt2 f32", "float32"))


def _child(root: str, label: str, build: bool) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as c
    from paddle_tpu_torch.ops import _kernels
    from paddle_tpu_torch.ops import flash_attention as fa
    if build:
        _kernels.build_all(["flash_attention"])
        # no log where the library was built before, by an earlier run
        rep = c._ptxas_report(_kernels.build_logs.get("flash_attention",
                                                      ""))
        print(json.dumps({"tree": label, "ptxas": {
            k: v for k, v in rep.items() if "_mma<" in k}}), flush=True)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    out = {"tree": label, "root": root}
    for name, dtype in SHAPES:
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
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) == 4:          # a child: ROOT LABEL build|time
        _child(sys.argv[1], sys.argv[2], sys.argv[3] == "build")
        return
    a, b = sys.argv[1:3]
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, root, label, "build"])
              for root, label in ((a, "A"), (b, "B"))]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for root, label in ((a, "A"), (b, "B"), (b, "B"), (a, "A")):
        subprocess.run([sys.executable, me, root, label, "time"],
                       check=True)


if __name__ == "__main__":
    main()
