#!/usr/bin/env python3
"""Time the checkpoint digests of gpt2-small's training state hashed on
one thread and on the writer's pool, in turns, on one host.

    python3 tools/torch_ckpt_hash_pair.py [--device cuda|cpu] [--preset NAME]

The tree is the one ``Model.fit`` checkpoints (``Model._state_tree``)
for gpt2-small trained by AdamW under O1: the float32 parameters and
AdamW's m and v moments (random, from seed 0) and the step counter,
snapshot to the host as an async save does it (pinned copies from the
card). ``paddle_tpu_torch.io.checkpoint.digest_tree`` hashes it with
``_HASH_THREADS`` set to 1 (S) and to its default (P), in turns S P P S
P S S P; every turn's digests must equal the first's. Prints the card
and its power limit, the host's CPU count, and one JSON line with each
turn's seconds and the medians."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

TURNS = "SPPSPSSP"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="gpt2-small")
    args = ap.parse_args()
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu to "
                             "rehearse on the CPU)")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import checkpoint as ck
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTFusedPretrainingCriterion,
                                             gpt_config)
    pt.seed(0)
    net = GPTForCausalLM(gpt_config(args.preset, fused_loss=True),
                         device=args.device)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=1e-4, parameters=net,
                                     weight_decay=0.01),
                  GPTFusedPretrainingCriterion(), amp_configs="O1")
    tree = model._state_tree()
    gen = torch.Generator(device=args.device).manual_seed(0)
    with torch.no_grad():
        for _, leaf in ck._flatten(tree["opt"]):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                leaf.normal_(0.0, 1e-3, generator=gen)
    host = ck._snapshot(tree)
    nbytes = ck._tree_bytes(host)
    pool = ck._HASH_THREADS
    seconds = {"S": [], "P": []}
    first = None
    try:
        for turn in TURNS:
            ck._HASH_THREADS = 1 if turn == "S" else pool
            t0 = time.perf_counter()
            digests = ck.digest_tree(host)
            seconds[turn].append(time.perf_counter() - t0)
            if first is None:
                first = digests
            elif digests != first:
                raise SystemExit(f"turn {turn}: digests differ")
    finally:
        ck._HASH_THREADS = pool
    med = {k: statistics.median(v) for k, v in seconds.items()}
    print(json.dumps({
        "tool": "torch_ckpt_hash_pair", "preset": args.preset,
        "device": args.device, "cpu_count": os.cpu_count(),
        "pool_threads": pool, "leaves": len(first), "bytes": nbytes,
        "turns": TURNS, "serial_s": seconds["S"], "pool_s": seconds["P"],
        "median_serial_s": med["S"], "median_pool_s": med["P"],
        "pool_over_serial": med["P"] / med["S"],
        "serial_gb_per_s": nbytes / med["S"] / 1e9,
        "pool_gb_per_s": nbytes / med["P"] / 1e9}))


if __name__ == "__main__":
    main()
