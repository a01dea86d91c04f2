#!/usr/bin/env python3
"""The engine control plane's cost on one card: the main serve cell of
``chip_smoke.py`` (gpt2-small, seed 0, 8 requests of 17..900 prompt
tokens x 32 new tokens, half greedy, direct ``submit``) with the
observability ledgers at their defaults (A: stream audit, goodput,
memory and perf on) against all four off (B), in turns A, B, B, A,
``PAIRS`` times; then each ledger alone turned off against all on, in
turns; then the host time the control plane's functions take in one A
run of the engine's worker thread (``cProfile``).

    python3 tools/torch_control_plane_cost.py

Run from the repository root with one CUDA card. Prints the card and
its power limit, one JSON line per run and a summary line per
comparison: medians, the spread of each side between its quartiles,
and how many of the runs of each side beat every run of the other.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

PAIRS = 5            # A B B A turns: 10 runs a side
SINGLE_PAIRS = 2     # A B B A turns for each ledger alone
# the control plane's own functions (engine side and ledgers), whose
# cumulative worker time the profile sums
CONTROL_PLANE = ("_perf_attribute", "_perf_program", "_slab_cost",
                 "_pass_cost", "_observe_step", "_update_kv_gauge",
                 "_police_slots", "_count_dispatch", "_note_queue_wait",
                 "_first_token_span", "_end_request_spans")
LEDGER_FILES = ("observability", "reliability")


def _summary(label, on, off):
    on, off = np.array(on), np.array(off)
    q = lambda x: float(np.percentile(x, 75) - np.percentile(x, 25))
    return {"comparison": label, "runs_a_side": len(on),
            "median_tokens_per_s_on": float(np.median(on)),
            "median_tokens_per_s_off": float(np.median(off)),
            "fall_of_medians": 1 - float(np.median(on) / np.median(off)),
            "iqr_on": q(on), "iqr_off": q(off),
            "on_runs_above_every_off": int((on > off.max()).sum()),
            "off_runs_above_every_on": int((off > on.max()).sum())}


def main() -> None:
    import chip_smoke as c
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.inference.llm import LLMEngine
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.observability import audit, goodput, memory, perf
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt_config("gpt2-small")
    pt.seed(0)
    net = GPTForCausalLM(cfg, device="cuda")
    rng = np.random.RandomState(0)
    lens = np.linspace(17, 900, 8).astype(int)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    temps = [0.0, 0.8] * 4
    nonces = [1000 + i for i in range(8)]
    ledgers = {"audit": audit, "goodput": goodput, "memory": memory,
               "perf": perf}
    default = {k: m.enabled() for k, m in ledgers.items()}

    def run(label, off=()):
        for k, m in ledgers.items():
            (m.disable if k in off or not default[k] else m.enable)()
        try:
            _, r = c._serve(net, prompts, temps, nonces, "kernel", "f32",
                            label)
        finally:
            for k, m in ledgers.items():
                (m.enable if default[k] else m.disable)()
        return r["tokens_per_s"]

    run("warm-up")
    on, off = [], []
    for _ in range(PAIRS):
        for turn in "ABBA":
            (on if turn == "A" else off).append(
                run(f"control plane {turn}",
                    () if turn == "A" else tuple(ledgers)))
    print(json.dumps(_summary("all four ledgers", on, off)), flush=True)
    for name in ledgers:
        on, off = [], []
        for _ in range(SINGLE_PAIRS):
            for turn in "ABBA":
                (on if turn == "A" else off).append(
                    run(f"{name} {turn}", () if turn == "A" else (name,)))
        print(json.dumps(_summary(f"{name} alone", on, off)), flush=True)
    # host time of the control plane's functions in one A run
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
        run("cProfile A")
    finally:
        LLMEngine._loop = loop
    st = pstats.Stats(profs[0])
    own = {f"{k[0].split('/')[-1]}:{k[2]}": v[3]
           for k, v in st.stats.items()
           if k[2] in CONTROL_PLANE and k[0].endswith("llm.py")}
    ledger_self = sum(v[2] for k, v in st.stats.items()
                      if any(f"/{d}/" in k[0] for d in LEDGER_FILES))
    print(json.dumps({"profile": "control plane, one A run",
                      "worker_total_s": st.total_tt,
                      "engine_functions_cum_s": own,
                      "ledger_modules_self_s": ledger_self}), flush=True)


if __name__ == "__main__":
    main()
