#!/usr/bin/env python3
"""Time one family of the port's kernels in two checkouts on one card, in
turns.

    python3 tools/torch_kernel_pair.py flash|paged PARENT_ROOT CHANGE_ROOT
    python3 tools/torch_kernel_pair.py routes ROOT

Each root is a directory holding ``paddle_tpu_torch/`` and
``chip_smoke.py`` (unpack one with ``git archive <commit> | tar -x -C
build/parent``). The two libraries build at once (one ``nvcc`` each);
then each timing runs in its own process, which imports that root's
package, with device time from ``torch.profiler`` as ``chip_smoke.py``
takes it:

- ``flash``: B1, B2 and B3 causal at the gpt2-small train shape (b 8, s
  1024, 12 heads, d 64) in bf16, f16 and f32, and at ``chip_smoke.py``'s
  GQA llama case (b 2, s 2048, 16 / 4 heads, d 128, bf16); median of 3
  windows of 20 calls, in turns; B2 and B3 each with its own delta pass,
  as ``chip_smoke.py`` times them; trees in turns A, B, B, A;
- ``paged``: B4 at ``chip_smoke.py``'s serving shapes (gpt2 decode in
  f32 and int8 pages, decode batches of 32, 64 and 128 rows in f32 and
  bf16, a gpt2 prefill chunk and the mixed tick of 64 chunk rows and 8
  decode rows sharing 32 pages in f32 and bf16, a verify window in f32
  and bf16, llama-style GQA decode) on its 12 layer pools, with the
  same inputs in every process (seeded generator), 60 calls over the
  12 pools and CUDA events beside the profiler, trees in turns A, B,
  B, A, B, A, A, B; each call passes the rows the case's sequences hold
  on average (``rows_per_run``) where the tree's wrapper takes them.

``routes`` times B4's two designs against each other in one checkout,
on the ``paged`` shapes and on launches that set the route's rule:
prefill chunks of 64 rows in runs of 4, 8, 16 and 32 rows, a verify
window of 32 slots and mixed ticks of 64 chunk rows and 16 or 56
decode rows; each shape on the "tile" and the "simt" route (median of
3 windows of 20 calls, in turns), the route ``paged_route`` names, and
for decode batches the simt kernel without the caller's one-row hint
(its blocks then compare tables) and whether the two give the same
bits.

Prints the card and its power limit, each tree's ptxas registers and
spills (of the tensor-core kernels for ``flash``: ``mma.sync`` and
``wgmma``), one JSON line per timing, and last a ``summary`` line: each
timing's median over each tree's turns and B's over A's."""

from __future__ import annotations

import importlib
import inspect
import json
import os
import subprocess
import sys

# library built, ptxas kernels kept, turns of the trees
KERNELS = {"flash": ("flash_attention", "mma<", "ABBA"),
           "paged": ("paged_attention", "", "ABBABAAB"),
           "routes": ("paged_attention", "", "")}


def _paged_shapes(c):
    """(name, T, heads, kv heads, d, lens, seqs, kv dtype name, q dtype
    name, extra) of chip_smoke.py's phase_kernels cases."""
    import numpy as np
    decode = [0, 17, 143, 269, 400, 647, 773, 932]
    chunk = list(range(861, 901)) + list(range(1, 21)) + [0] * 4
    chunk_seqs = [0] * 40 + [1] * 20 + [2] * 4
    mixed = list(range(513, 577)) + [530, 560, 600, 650, 690, 700, 720,
                                     740]
    mixed_seqs = [0] * 64 + list(range(1, 9))
    bases = np.linspace(16, 928, 8).astype(int)
    k = c.SPEC_K
    verify = [int(b) + j + 1 for b in bases for j in range(k)]
    verify_seqs = [s for s in range(8) for _ in range(k)]
    gqa = [int(n) for n in np.random.RandomState(0).permutation(decode)]
    seqs8 = list(range(8))
    return (("decode gpt2", 8, 12, 12, 64, decode, seqs8, "float32",
             "float32", {}),
            ("decode gpt2", 8, 12, 12, 64, decode, seqs8, "int8",
             "float32", {}),
            ("chunk gpt2", 64, 12, 12, 64, chunk, chunk_seqs, "float32",
             "float32", {}),
            ("chunk gpt2", 64, 12, 12, 64, chunk, chunk_seqs, "bfloat16",
             "bfloat16", {}),
            ("mixed chunk+decode shared", 72, 12, 12, 64, mixed,
             mixed_seqs, "float32", "float32", {"shared": 32}),
            ("mixed chunk+decode shared", 72, 12, 12, 64, mixed,
             mixed_seqs, "bfloat16", "bfloat16", {"shared": 32}),
            ("verify gpt2 (8 x K 4)", 8 * k, 12, 12, 64, verify,
             verify_seqs, "float32", "float32", {}),
            ("verify gpt2 (8 x K 4)", 8 * k, 12, 12, 64, verify,
             verify_seqs, "bfloat16", "bfloat16", {}),
            ("decode llama-gqa", 8, 16, 4, 128, gqa, seqs8, "bfloat16",
             "bfloat16", {}),
            # chip_smoke.py's decode batches of 32, 64 and 128 slots
            *[(f"decode gpt2 x{n}", n, 12, 12, 64,
               [int(x) for x in np.random.RandomState(n).randint(1, 1025,
                                                                 n)],
               list(range(n)), dt, dt,
               {"num_pages": (n + 1) * c.PAGES_PER_SEQ})
              for n in (32, 64, 128) for dt in ("float32", "bfloat16")])


def _route_shapes(c):
    """The ``paged`` shapes and the launches that set the route's rule:
    64-row chunks in runs of 4, 8, 16 and 32 rows, a 32-slot verify
    window, mixed ticks of 64 chunk rows and 16 or 56 decode rows."""
    import numpy as np
    out = list(_paged_shapes(c))
    for run in (4, 8, 16, 32):
        n = 64 // run
        lens = [17 + 60 * s + j for s in range(n) for j in range(run)]
        seqs = [s for s in range(n) for _ in range(run)]
        for dt, qd in (("float32", "float32"), ("bfloat16", "bfloat16"),
                       ("int8", "float32")):
            out.append((f"chunk runs of {run}", 64, 12, 12, 64, lens, seqs,
                        dt, qd, {"num_pages": (n + 1) * c.PAGES_PER_SEQ}))
    k = c.SPEC_K
    bases = np.linspace(16, 928, 32).astype(int)
    verify = [int(b) + j + 1 for b in bases for j in range(k)]
    vseqs = [s for s in range(32) for _ in range(k)]
    for dt in ("float32", "bfloat16"):
        out.append(("verify gpt2 (32 x K 4)", 32 * k, 12, 12, 64, verify,
                    vseqs, dt, dt, {"num_pages": 33 * c.PAGES_PER_SEQ}))
        for n in (16, 56):
            mixed = list(range(513, 577)) + [
                int(x) for x in np.random.RandomState(n).randint(513, 1025,
                                                                 n)]
            out.append((f"mixed chunk 64 + decode {n}", 64 + n, 12, 12, 64,
                        mixed, [0] * 64 + list(range(1, n + 1)), dt, dt,
                        {"shared": 32,
                         "num_pages": (n + 2) * c.PAGES_PER_SEQ}))
    return out


def _time_flash(c, out):
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, b, s, hq, hkv, d, dtype in (
            ("gpt2 bf16", 8, 1024, 12, 12, 64, "bfloat16"),
            ("gpt2 f16", 8, 1024, 12, 12, 64, "float16"),
            ("gpt2 f32", 8, 1024, 12, 12, 64, "float32"),
            ("gqa llama bf16", 2, 2048, 16, 4, 128, "bfloat16")):
        dt = getattr(torch, dtype)
        q, do = [torch.randn(b, s, hq, d, generator=g, device="cuda").to(dt)
                 for _ in range(2)]
        k, v = [torch.randn(b, s, hkv, d, generator=g, device="cuda").to(dt)
                for _ in range(2)]
        sc = d ** -0.5
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
    # a wrapper that takes the rows the caller's sequences hold
    hint = "seq_rows" in inspect.signature(
        pa.paged_attention_kernel).parameters
    for name, t, heads, kvh, d, lens, seqs, kv, qd, extra in \
            _paged_shapes(c):
        g = torch.Generator(device="cuda").manual_seed(0)
        pools, tables, lt, q = c._case_inputs(
            g, t, heads, kvh, d, getattr(torch, kv), getattr(torch, qd),
            lens, seqs, **extra)
        ps = extra.get("page_size", c.PAGE_SIZE)
        kw = {"seq_rows": pa.rows_per_run(lens, tables.cpu(), ps)} \
            if hint else {}

        def kern(i):
            a = c._layer_args(pools, i)
            return pa.paged_attention_kernel(q, a[0], a[1], tables, lt,
                                             k_scales=a[2], v_scales=a[3],
                                             **kw)
        ms, events = c._time_ms(kern)
        out[f"{name} {kv} {qd}"] = {"ms": ms, "ms_events": events}
        del pools
        torch.cuda.empty_cache()


def _time_routes(c, out):
    import itertools
    import torch
    pa = importlib.import_module("paddle_tpu_torch.ops.paged_attention")
    for name, t, heads, kvh, d, lens, seqs, kv, qd, extra in \
            _route_shapes(c):
        g = torch.Generator(device="cuda").manual_seed(0)
        pools, tables, lt, q = c._case_inputs(
            g, t, heads, kvh, d, getattr(torch, kv), getattr(torch, qd),
            lens, seqs, **extra)
        run = pa.rows_per_run(lens, tables.cpu(),
                              extra.get("page_size", c.PAGE_SIZE))
        kp, vp, ks, vs = c._layer_args(pools, 0)
        chosen = pa.launch_route(q, kp, vp, ks, vs, run)

        def timed(route, seq_rows):
            layer = itertools.cycle(range(c.LAYERS))

            def call():
                a = c._layer_args(pools, next(layer))
                return pa.paged_attention_kernel(
                    q, a[0], a[1], tables, lt, k_scales=a[2],
                    v_scales=a[3], seq_rows=seq_rows, route=route)
            return call
        fns = {"tile": timed("tile", run), "simt": timed("simt", run)}
        if run == 1:
            fns["simt_no_hint"] = timed("simt", 0)
        ms = c._time_interleaved(fns)
        res = {"route": chosen, "seq_rows": run,
               **{f"{k}_ms": v for k, v in ms.items()},
               "tile_over_simt": ms["tile"] / ms["simt"]}
        if run == 1:
            hinted = pa.paged_attention_kernel(
                q, kp, vp, tables, lt, k_scales=ks, v_scales=vs,
                seq_rows=1, route="simt")
            plain = pa.paged_attention_kernel(
                q, kp, vp, tables, lt, k_scales=ks, v_scales=vs,
                seq_rows=0, route="simt")
            res["hint_same_bits"] = bool(torch.equal(hinted, plain))
            res["hint_over_no_hint"] = ms["simt"] / ms["simt_no_hint"]
        out[f"{name} {kv} {qd}"] = res
        print(json.dumps({"case": f"{name} {kv} {qd}", **res}), flush=True)
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
    {"flash": _time_flash, "paged": _time_paged,
     "routes": _time_routes}[kernel](c, out)
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) == 5:      # a child: KERNEL ROOT LABEL build|time
        _child(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4] == "build")
        return
    if len(sys.argv) == 3 and sys.argv[1] == "routes":
        root = sys.argv[2]
        me = os.path.abspath(__file__)
        subprocess.run([sys.executable, me, "routes", root, "A", "build"],
                       check=True)
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True)
        _child("routes", root, "A", False)
        return
    if len(sys.argv) != 4 or sys.argv[1] not in KERNELS or \
            sys.argv[1] == "routes":
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
    runs = {"A": [], "B": []}
    for label in KERNELS[kernel][2]:
        res = subprocess.run([sys.executable, me, kernel, roots[label],
                              label, "time"], check=True,
                             capture_output=True, text=True)
        sys.stderr.write(res.stderr)
        print(res.stdout, end="", flush=True)
        runs[label].append(json.loads(res.stdout.strip().splitlines()[-1]))
    # each timing's median over the turns of each tree, and B over A
    summary = {}
    for key, first in runs["A"][0].items():
        if not isinstance(first, dict):
            continue
        med = {}
        for label, outs in runs.items():
            for field in first:
                vals = sorted(o[key][field] for o in outs)
                med[f"{label}_{field}"] = vals[len(vals) // 2] if \
                    len(vals) % 2 else sum(vals[len(vals) // 2 - 1:
                                                len(vals) // 2 + 1]) / 2
        for field in first:
            if isinstance(first[field], (int, float)):
                med[f"B_over_A_{field}"] = med[f"B_{field}"] / \
                    med[f"A_{field}"]
        summary[key] = med
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
