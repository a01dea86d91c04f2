#!/usr/bin/env python3
"""Smoke test of the PyTorch port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with one CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before
the result line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, compiled from ``csrc/`` by
   ``nvcc`` for sm_90a (with the ptxas register report, ptxas's notes
   where it serializes wgmma and, where the toolkit has ``cuobjdump``,
   each kernel's count of HMMA, HGMMA and TMA-load instructions in its
   SASS: the ``mma.sync`` flash kernels must hold HMMA, the Hopper B1,
   B2 and B3 HGMMA and UTMALDG);
3. kernels: kernel B4 against its plain PyTorch twin at the serving
   path's shapes and dtypes (decode, a prefill chunk of two sequences
   and padding, GQA, one 1024-token row, head dims 80 and 256, a mixed
   tick of 64 chunk rows and 8 decode rows sharing a 32-page prefix,
   pages of 128 and 256 tokens, 40 and 64 q heads on one kv head, head
   dim 320, head dims 20 and 100 (not a multiple of 8), a speculative
   verify window of 8 slots x 4 rows with rising
   limits, f32 and int8, the same rows reversed within each slot, and
   head dims 16384 and 32768, the latter past a block's shared memory
   (the streamed kernel)),
   with its device time (``torch.profiler``; CUDA events
   beside it) beside the plain twin's, a one-call PyTorch yardstick's
   and the least time the card could take;
4. flash kernels: B1, B2 and B3 the same way at the training path's
   shapes (gpt2-small bf16 and f32, llama-style GQA, cross-length, head
   dim 80, head dims 256 f32, 320 bf16 and 264 f16 in the split-d
   kernels, the train shape in f16 (GradScaler's training), head dim
   192 (B1, B2 and B3 on ``mma.sync``), lengths 97 and 200 / 136 that
   end in a partial tile, the ring blocks of the sequence_parallel
   phase, and the nn phase's 8-head shapes: encoder 512, causal decoder
   256, cross 256 over 512), each case naming the route of each kernel
   and holding two launches of B1, of B2 and of B3 bit-identical, each
   kernel's device time (``torch.profiler``) taken in turns with its
   twin's and SDPA's (median of 3 windows of 20 calls; a window in
   which the profiler records no device time is taken again; after three
   such in a row this and every later window is timed by CUDA events,
   counted in the case's ``event_timed_windows``);
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
   perf ledgers on against off, in turns A B B A), a turn of its own
   with ``POST /profilez`` arming a 5 s profiler window over the main
   traffic (200, then 409 for a second arm; streams equal to the
   unprofiled run's; the window's trace names B4; the window disarms on
   its own), a profiled HTTP run and a cProfile of the engine's worker
   thread;
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
9. fit: the same model and trainer (under CosineAnnealingDecay) through
   ``Model.fit`` over ``io.DataLoader``: 64 sequences of 1024 tokens, 2
   shuffled epochs of 8 steps with an eval pass each, the callbacks
   (LRScheduler, EarlyStopping, CSVLogger, ModelCheckpoint, a recorder),
   then ``evaluate`` and ``predict`` with the kernel counts read just
   after (B1 once a layer per forward, B2 and B3 once a layer per train
   step); the losses equal to a manual ``train_batch`` loop's over the
   same batches, the checkpoint reloaded into a fresh Model, the
   learning rate, the CSV, the event order, fork workers' batches, a
   fit on the twins launching nothing; fit against the manual loop in
   turns (M F F M) and the synchronizing calls a step makes; a dense
   head run with ``Accuracy(topk=(1, 5))`` against a host recount over
   ``predict``'s logits;
10. checkpoint: the fit cell with full-state checkpoints: stopped after
   step 6, resumed in a fresh Model at K 4, preempted at step 10 by a
   ``PreemptionGuard`` (flush, exit 67), resumed at K 1; every loss
   equal to the fit phase's uninterrupted run bit for bit, B1-B3 12
   launches a resumed step, every manifest verified; the numeric
   guard's rollback over a non-finite step; the stall per save beside
   ``Model.save``'s, the commit, barrier, read and digest-check seconds;
11. train_loop: the rest of the training path at the same width on
   B1-B3: two K-4 ``train_loop_batch`` slabs against 8 ``train_batch``
   calls (residual dropout 0.1; losses and parameters bit-identical, no
   synchronizing call in the slab) and ``fit(steps_per_loop=4)`` with a
   ragged tail against K 1; the numeric guard (a ``grad.nonfinite``
   step skipped inside a slab equals the stream minus that batch, bit
   for bit; abort; rollback escalating with no checkpoint directory;
   step time armed and not); ``amp.GradScaler`` under float16 on B1-B3
   against the twins, two NaN steps skipped and the scale halved;
   ``remat``, ``scan_layers`` and both against the plain model (B1 twice
   a layer a step under remat, its fwd+bwd peak 1 GiB lower, step time
   in turns); ``GPTGreedyDecoder`` against ``generate``; the eight
   other optimizers on the card against the CPU, over the embeddings
   and the first two blocks;
12. distributed: multi-rank training of the train cell through the
   port's launcher, ranks of this script (``--dist-rank``; the NCCL job
   and the first gloo job run at once, and so do each later phase's two
   jobs: their step times are reported, never checked): a dp=1 mesh
   on NCCL against no mesh (A B B A, bit for bit, B1-B3 12 launches a
   step), dp=2 and fsdp=2 with two gloo ranks sharing the card (4 rows a
   rank; the ranks' losses and parameter digests equal, within
   ``TRAIN_LOSS_RTOL`` of one process, B1-B3 12 a step in each rank,
   fsdp's shards half of each sharded weight and at most 0.55x dp's
   resident parameter + optimizer bytes), then a checkpointed 2-block
   fit on the two ranks, and the same fit as a 2-node job (``--nnodes 2
   --rdzv_backend tcp``) whose node 1 is preempted once and rejoins,
   its losses equal to the uninterrupted fit's; the step walls, the
   gradient reduction's seconds, spawn-to-first-step and a profile of a
   dp=2 step on rank 0;
13. model_parallel: the train cell (12 layers, full width, batch 8,
   fused loss, O1, AdamW, dropout 0, weights from ``seed(0)``) on tp, pp
   and pp x tp meshes of ranks of this script (``--dist-rank mp2`` /
   ``mp4``) sharing the card over gloo: tp=2 (3 steps; the local shapes
   of the split weights), pp=2 with 4 microbatches at
   ``virtual_pp_degree`` 1 and 2 (3 steps each; a profiled step a rank
   for the bubble), pp=2 x tp=2 on four ranks (2 steps) and the planner
   (``distributed_model(global_batch=8)`` on two ranks, its predicted
   bytes beside ``verify_plan``'s measured peak): the ranks' losses
   equal and within ``TRAIN_LOSS_RTOL`` of the distributed phase's one
   process, gathered parameter digests equal across the ranks, B1-B3
   launches a rank a step exactly the design's (12 under tp; 6 blocks x
   4 microbatches under pp, B1 twice for the recomputed chunks), and a
   ``Model.save`` of the tp=2 and pp=2 meshes reloaded here into one
   process giving the gathered digest; each mesh's step wall over one
   process's and the tp all-reduce seconds a step;
14. sequence_parallel: the train cell with ``sequence_parallel=True``
   on sp meshes of ranks of this script (``--dist-rank sp2`` / ``sp4``)
   sharing the card over gloo: sp=2 (3 steps) and sp=2 x dp=2 (2
   steps), each rank's losses equal and within ``TRAIN_LOSS_RTOL`` of
   the distributed phase's one process, the gathered digests equal,
   B1, B2 and B3 launched exactly 12 x (r + 1) times a step on sp rank
   r (it computes r + 1 ring blocks a layer), the sp=2 save reloaded
   here with the same digest; the ring op alone at the train shape
   against flash attention over the whole sequence (o, dq, dk, dv
   within the bound of ``SP_BLOCK_ROUND``, two launches bit-identical),
   one ring fwd + bwd's peak bytes at 4096 and 8192 tokens (ratio at
   most 2.6), and a step with attention dropout 0.1 over a padded tail
   (finite, equal on the ranks, another loss than the unmasked
   step's); each mesh's step wall over one process's and the ring's
   exchange seconds a step;
15. nn: transformer-base (``nn.Transformer`` at its defaults, dropout 0:
   d_model 512, 8 heads, 6 + 6 layers, FFN 2048) in a seq2seq wrapper
   (a shared 37000-token embedding, a vocabulary head,
   ``nn.CrossEntropyLoss``; batch 8, source 512 and target 256 tokens,
   AMP O1, AdamW 1e-4) through ``Model.fit``, 2 epochs of 4 steps and
   one eval pass: B1, B2 and B3 launched 18 times a train step (6
   encoder self-attentions, 6 causal decoder self-attentions, 6
   cross-attentions of 256 queries over 512 keys) and B1 18 times an
   eval step, counted over the fit and for one step of each alone; the
   step time, tokens/s and B1-B3's device-time share
   (``torch.profiler``); 3 steps on B1-B3 against 3 on the twins
   (losses, and the attention projections' gradient); a step at the
   defaults' dropout 0.1 (finite, B1-B3 not launched: attention dropout
   takes the plain path); then one forward and backward of every layer
   and function ported in the nn slice on the card against the port on
   the CPU (f32, TF32 off; within 1e-5 + 1e-4 |cpu|, BatchNorm's
   running statistics and spectral norm's ``u`` bit for bit), and a
   Switch MoE at d_model 768, FFN 3072, 8 experts over 8 x 512 tokens
   (dispatch positions and dropped tokens equal);
16. moe_ep and ctr (PR 18): a Switch-Base-8 encoder on two ranks of
   this script sharing the card (``--dist-rank ep2``), and the CTR
   embeddings and WideDeep / DeepFM card against CPU (``--dist-rank
   ctr2`` for the key-sharded table);
17. tensor (run while the kernels build in phase 2: it launches none of
   them): the tensor and math API (``tensor``, ``linalg``, ``fft``,
   ``signal``, ``sparse``, ``distribution``, ``autograd``,
   ``regularizer``, ``device``) on the card against the port on the
   CPU, every ported function at the CPU tests' sizes (within 1e-5 +
   1e-4 |cpu|; integer, index and sort results and the closed-form
   draws bit for bit); then at users' sizes, each timed with CUDA
   events: float32 linalg at 4096 x 4096 (cholesky + cholesky_solve,
   solve, qr, svd, eigh, lstsq, lu + lu_unpack; relative residual at
   most 1e-3), rfft / irfft of 2^24 samples and fft2 of 4096^2,
   Whisper's log-mel front end on 8 x 30 s clips and its istft round
   trip, a graph with ogbn-arxiv's counts through SpMM, segment_sum, the
   row softmax and an SpMM gradient (against ``torch.segment_reduce``
   over the edges sorted by row), 10^7 draws of each closed-form
   sampler (row 0 bit-equal to the CPU's draw, moments within 5 sigma;
   Beta, Dirichlet and Poisson: the share of equal draws) and a 2-layer
   MLP's Jacobian and Hessian; the phase within 60 s;
18. models: BERT-base pretraining at ``bench.py``'s
   configuration (batch 64 x 128, fused loss, AdamW, O1) through
   ``Model.train_batch``: B1-B3 exactly 12 a step over 10 timed steps,
   samples/s, MFU, B1-B3's share and the idle share (2 profiled steps),
   3 steps on the kernels against 3 on the twins (5e-4), the attention
   projections' gradient (the nn phase's O1 rule; the twins in float32),
   the fused loss's peak against the dense head's, an eval batch (12 B1,
   no B2 / B3); BERT classification in eval (a padded batch: no launch,
   card against CPU; unpadded: 12 B1); ResNet-50 (batch 128 at 224^2,
   Momentum, O1): 10 steps on the in-memory batch (finite, the 10th loss
   below the first, BatchNorm statistics moved), the first float32 step
   at batch 4 against the CPU, ``Model.fit`` for 8 steps over a
   ``DatasetFolder`` of 256^2 ``.npy`` images through the ImageNet
   training transforms on 4 fork workers (images/s, MFU,
   ``io.next_wait``); every vision zoo constructor's eval forward card
   against CPU and a squeezenet step; nms over 5000 boxes (kept indices
   equal), roi_align, roi_pool and deform_conv2d at an FPN level-2 map,
   viterbi over [64, 128, 50] (paths equal), each timed by CUDA events;
   the three HF converters; the phase within 90 s;
19. tooling (last): the train cell's model and trainer through the
   tooling: ``Model.fit`` of 6 steps under ``profiler.Profiler`` with
   ``make_scheduler(closed=1, ready=1, record=3)`` (summary rows
   TrainStep 6, Callbacks 6, Dataloader 7; the RECORD window's trace
   names B1, B2 and B3 36 times each, a window without device events
   taken again; ``export_chrome_tracing`` inside the window; B1-B3 12 a
   step); ``cost_model.CostModel.profile_measure`` of a train step on the
   kernels against ``profile`` on the twins (FLOPs within 1%), FLOPs over
   6 N T + 6 L s H T within [1.0, 1.30], ``memory_profile`` beside
   ``max_memory_allocated``, ``flops`` card against CPU; ``jit.save`` of
   the eval forward with ``InputSpec([None, None], "int64")`` and
   ``jit.load`` on the card (logits at [8, 1024] and [2, 100] within
   ``1e-5 + 1e-4 |eager|``, B1 12 a loaded forward), weight-only
   ``quantize_post_training`` (48 Linears as on the CPU, B1 12 a
   forward) saved encrypted (loads with its key, refused without, its
   state smaller than the f32 one's); a static program,
   ``testing.OpSpec`` cases and the int8 activation paths card against
   CPU (int32 sums equal); the phase within 60 s;
20. a ``{"phase": "timing"}`` line with each phase's wall seconds, a
   ``{"kernels": [...]}`` summary line, then the result line
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
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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


_EMIT = threading.Lock()


def emit(obj) -> None:
    line = json.dumps(obj)
    with _EMIT:       # the build thread emits beside the tensor phase
        print(line, flush=True)


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
    """``flash_fwd_mma<__nv_bfloat16,64>`` or ``paged_attention<int8,1>``
    from a mangled kernel name."""
    m = re.search(r"\d+((?:flash|paged)_[a-z_]+?)I(?:\d+(__nv_bfloat16|"
                  r"__half)|([fa]))(?:L[ib](\d+)E)?E", mangled)
    if m:
        dtype = m.group(2) or {"f": "float", "a": "int8"}[m.group(3)]
        d = f",{m.group(4)}" if m.group(4) else ""
        return f"{m.group(1)}<{dtype}{d}>"
    m = re.search(r"\d+((?:flash|paged)_[a-z_]+?)[IE]", mangled)
    return m.group(1) if m else mangled[:80]


def _ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel, from
    ``-Xptxas=-v``."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            report[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes stack frame", line)
            if m:
                report[name]["stack_frame_bytes"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                report[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                report[name]["registers"] = int(m.group(1))
    return report


def _sass_counts(lib_path: str, nvcc: str):
    """Tensor-core instructions (HMMA: mma.sync; HGMMA: wgmma) and TMA
    loads (UTMALDG: cp.async.bulk.tensor) in each kernel's SASS, by
    ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = _kernel_name(part.split("\n", 1)[0].strip())
        c = counts.setdefault(name, {"HMMA": 0, "HGMMA": 0, "UTMALDG": 0})
        for op in c:
            c[op] += len(re.findall(rf"\b{op}\b", part))
    return counts


# the flash kernels by design: the mma.sync ones (B1, B2 and B3 above d
# 128) and the Hopper B1, B2 and B3 (wgmma, TMA)
FLASH_MMA_KERNELS = {"flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma"}
FLASH_WGMMA_KERNELS = {"flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                       "flash_bwd_dkv_wgmma"}
# registers a thread each Hopper kernel launches with (csrc/
# flash_attention.cu: B1's FwdShape<D>::kEntryRegs, B2 / B3 one block of
# three warpgroups an SM): setmaxnreg.inc hands the consumers registers
# out of that share, so a build that ptxas gives fewer lets more blocks
# onto an SM and its consumers wait in setmaxnreg forever
FLASH_WGMMA_REGISTERS = {"flash_fwd_wgmma": {64: 64, 128: 128},
                         "flash_bwd_dq_wgmma": {64: 168, 128: 168},
                         "flash_bwd_dkv_wgmma": {64: 168, 128: 168}}


def phase_build() -> None:
    from paddle_tpu_torch.ops import _kernels
    t0 = time.perf_counter()
    per_kernel = _kernels.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: _ptxas_report(log) for n, log in _kernels.build_logs.items()}
    # ptxas's notes where it serializes wgmma (register pressure, a
    # register written inside a wgmma pipeline stage)
    serialized = [line.strip() for log in _kernels.build_logs.values()
                  for line in log.splitlines()
                  if "Performance Loss" in line]
    nvcc = _kernels.nvcc_path()
    sass = {n: _sass_counts(str(_kernels._library_path(n)), nvcc)
            for n in _kernels.SOURCES}
    flash_ptxas = ptxas.get("flash_attention", {})
    tensor_core = {k: dict(v, **flash_ptxas.get(k, {}))
                   for k, v in (sass.get("flash_attention") or {}).items()
                   if k.split("<")[0] in FLASH_MMA_KERNELS |
                   FLASH_WGMMA_KERNELS}
    emit({"phase": "build", "seconds": seconds,
          "per_kernel_s": per_kernel, "nvcc": nvcc,
          "flags": list(_kernels.NVCC_FLAGS), "ptxas": ptxas,
          "sass_counts": sass, "flash_tensor_core_kernels": tensor_core,
          "wgmma_serialized": serialized})
    # each Hopper kernel this run built, at each dtype and D, holds
    # exactly its launch share of registers
    if "flash_attention" in _kernels.build_logs:
        regs = {(kind, dt, d): flash_ptxas.get(f"{kind}<{dt},{d}>", {})
                .get("registers")
                for kind, want in FLASH_WGMMA_REGISTERS.items()
                for d in want for dt in ("__nv_bfloat16", "__half")}
        wrong = {f"{k}<{dt},{d}>": {"registers": r,
                                     "launch_share":
                                         FLASH_WGMMA_REGISTERS[k][d]}
                 for (k, dt, d), r in regs.items()
                 if r != FLASH_WGMMA_REGISTERS[k][d]}
        if wrong:
            raise SystemExit(f"Hopper flash kernels whose registers are "
                             f"not their launch share (setmaxnreg would "
                             f"wait forever): {wrong}")
    # the half-type B1, B2 and B3 are tensor-core kernels: mma.sync ones
    # must hold HMMA in their SASS, the Hopper ones HGMMA and TMA loads
    if sass.get("flash_attention") is not None:
        kinds = {k.split("<")[0] for k in tensor_core}
        bad = {k: v for k, v in tensor_core.items()
               if (k.split("<")[0] in FLASH_MMA_KERNELS and not v["HMMA"])
               or (k.split("<")[0] in FLASH_WGMMA_KERNELS and
                   not (v["HGMMA"] and v["UTMALDG"]))}
        if kinds != FLASH_MMA_KERNELS | FLASH_WGMMA_KERNELS or bad:
            raise SystemExit(f"flash tensor-core kernels without their "
                             f"instructions in SASS: {bad or tensor_core}")


# ---------------------------------------------------------------------------
# kernel B4 against its plain twin
# ---------------------------------------------------------------------------

def _case_inputs(g, t, heads, kv_heads, d, kv_dtype, q_dtype, lens_list,
                 seqs, page_size=PAGE_SIZE, shared=0, num_pages=None,
                 pages_per_seq=None):
    """Layer-stacked pools and the rows of one launch. ``seqs[t]`` names
    the sequence of row t: rows of one sequence share a table, and every
    sequence's first ``shared`` table entries are sequence 0's (a cached
    prefix). The pool holds NUM_PAGES x PAGE_SIZE tokens at any page
    size, unless ``num_pages`` / ``pages_per_seq`` cut it (the very
    large head dims)."""
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    dev = "cuda"
    if num_pages is None:
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
    P = pages_per_seq or PAGES_PER_SEQ * PAGE_SIZE // page_size
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
    big_d_lens = [0, 5, 16, 17, 40, 64, 100, 128]
    big_d_pool = dict(num_pages=72, pages_per_seq=8)
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
        # head dims that are not a multiple of 8: the last d % 8 columns
        # read one at a time, rows staged in 16-, 8-, 4- or 2-byte copies
        ("decode d20", 8, 8, 8, 20, decode_lens, list(range(8)),
         [(f32, f32), (bf16, f32), (i8, f32)]),
        ("chunk d20", 64, 8, 8, 20, chunk_lens, chunk_seqs,
         [(f32, f32), (i8, f32)]),
        ("decode d100 gqa", 8, 8, 2, 100, decode_lens, list(range(8)),
         [(f32, f32), (bf16, bf16), (i8, f32)]),
        ("verify gpt2 (8 x K 4)", 8 * SPEC_K, 12, 12, 64, verify_lens,
         verify_seqs, [(f32, f32), (i8, f32)]),
        ("verify gpt2, rows reversed", 8 * SPEC_K, 12, 12, 64, verify_rev,
         verify_seqs, [(f32, f32)]),
        # head dims whose staged K row, V column slice and q vectors pass
        # a block's shared memory at 32768 (f32 and bf16; the streamed
        # kernel), and 16384 f32 beside them; a few 16-token pages a row
        ("decode d16384", 8, 2, 1, 16384, big_d_lens, list(range(8)),
         [(f32, f32)], big_d_pool),
        ("decode d32768 (streamed)", 8, 2, 1, 32768, big_d_lens,
         list(range(8)), [(f32, f32), (bf16, bf16)], big_d_pool),
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
            fell_back = PROFILER_MISSES["fallbacks"]
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
                    "event_timed_windows":
                        PROFILER_MISSES["fallbacks"] - fell_back,
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
    perf ledgers all disabled (B), in turns A, B, B, A (a run is
    host-bound, and its rate moves by ~10% from run to run: ten pairs
    are ``tools/torch_control_plane_cost.py``'s work)."""
    from paddle_tpu_torch.observability import audit, goodput, memory, perf
    mods = (audit, goodput, memory, perf)
    saved = [m.enabled() for m in mods]
    runs = []
    try:
        for turn in "ABBA":
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


def _profilez_turn(net, ctx, dbase) -> dict:
    """A turn of its own: POST /profilez arms a timed profiler window
    over the main traffic; a second arm answers 409; the streams equal
    the unprofiled run's; the window's trace names B4; the window
    disarms on its own."""
    import glob
    import shutil
    log_dir = _tooling_dir("profilez")
    try:
        st1, _, body1 = _post(dbase, "/profilez",
                              {"duration_s": PROFILEZ_WINDOW_S,
                               "log_dir": log_dir})
        st2, _, _ = _post(dbase, "/profilez",
                          {"duration_s": 1.0, "log_dir": log_dir})
        run = _serve_http_run(net, ctx, "profilez window", dbase)
        t0 = time.monotonic()
        while json.loads(_get(dbase, "/profilez"))["armed"] is not None:
            if time.monotonic() - t0 > PROFILEZ_WINDOW_S + 120:
                break
            time.sleep(0.05)
        disarmed = json.loads(_get(dbase, "/profilez"))["armed"] is None
        files = sorted(glob.glob(os.path.join(log_dir, "trace_*.json")))
        kernels = _trace_kernels(files[0]) if files else {}
        b4 = _count_named(kernels, "paged_attention")
        emit({"phase": "serve_http", "run": "profilez",
              "arm_status": st1, "second_arm_status": st2,
              "window_s": PROFILEZ_WINDOW_S, "trace_files": len(files),
              "window_b4_kernels": b4,
              "window_kernel_kinds": len(kernels),
              "disarm_wait_s": time.monotonic() - t0})
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return {"armed_200": st1 == 200 and body1.get("armed") is not None,
            "second_arm_409": st2 == 409,
            "streams_eq_unprofiled": run["checks"]["streams_eq_direct"],
            "window_names_b4": b4 > 0, "one_trace": len(files) == 1,
            "disarmed": disarmed}


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
        checks.update({f"profilez_{k}": v for k, v in
                       _profilez_turn(net, ctx, dbase).items()})
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

# torch.profiler windows that came back without device time, and the
# calls of ``_device_ms`` that fell back to CUDA events (``timing`` line)
PROFILER_MISSES = {"windows": 0, "fallbacks": 0}


def _device_ms(fn, reps, attempts=3) -> float:
    """Device ms of one call of ``fn``: the time its kernels run on the
    card over ``reps`` calls, from ``torch.profiler``. CUDA events around
    the calls would also count the gaps in which the card waits for the
    host: SDPA's autograd backward takes more host time to launch than
    its kernels take on the card. Now and then a profiler window comes
    back without device events; such a window is run again, up to
    ``attempts`` windows in all. If no window has device time, CUDA
    events around ``reps`` calls time them instead (an upper bound: they
    count the host's gaps too), here and in every later call, so that a
    profiler that stays empty costs no more windows. ``PROFILER_MISSES``
    counts the empty windows and the calls timed by events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(0 if PROFILER_MISSES["fallbacks"] else attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = sum(ms for ms, _ in
                   _device_totals(prof, DeviceType.CUDA).values())
        if busy > 0:
            return busy / reps
        PROFILER_MISSES["windows"] += 1
    PROFILER_MISSES["fallbacks"] += 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def _ring_merged_cases(fa, g) -> list:
    """B1-B3 as sp rank 1 of the sequence_parallel phase's ring runs them
    (gpt2 bf16, s 1024 at sp=2: 512 queries, two key blocks of 512): B1
    on the diagonal block (causal) and the earlier block (not), the
    blocks merged in f32 as ``ops.ring_attention._merge`` merges them,
    then B2 and B3 on each block with the merged o and lse, the diagonal
    block's B2 writing the shared delta and the earlier block's B2
    reading it (``delta_ready``). Each launch is held against its plain
    twin on the same inputs (the merged o against the twins' blocks
    merged alike, the merged lse against the twin's over the whole key
    range: the same natural-log base), and the earlier block's B2 / B3
    are launched twice
    on the same inputs, which must give the same bits."""
    from paddle_tpu_torch.ops.ring_attention import _merge
    b, sq, h, d, dt = 8, 512, 12, 64, torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    q, do = (torch.randn(b, sq, h, d, generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn(b, 2 * sq, h, d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    blocks = {"earlier": (k[:, :sq], v[:, :sq], False),
              "diagonal": (k[:, sq:], v[:, sq:], True)}
    def merged(fwd):
        (o0, l0), (o1, l1) = (fwd(q, kb, vb, scale, c)
                              for kb, vb, c in blocks.values())
        o, lse = _merge(o0.float(), l0, o1.float(), l1)
        return o.to(dt), lse.contiguous()
    o, lse = merged(fa.flash_attention_fwd_kernel)
    want_o = merged(fa.flash_attention_fwd_torch)[0]
    want_lse = fa.flash_attention_fwd_torch(q, k, v, scale, True)[1]

    def err(got, want):
        rtol, atol = FLASH_TOL[got.dtype]
        e = (got.float() - want.float()).abs()
        return e.max().item(), \
            (e / (atol + rtol * want.float().abs())).max().item()

    def case(kernel, name, errs, same=True):
        c = {"phase": "kernel_case", "kernel": kernel, "case": name,
             "b": b, "sq": sq, "sk": sq, "hq": h, "hkv": h, "head_dim": d,
             "dtype": str(dt), "route": fa.kernel_route(d, dt),
             "max_abs_err": max(e for e, _ in errs),
             "rtol_atol": FLASH_TOL[dt],
             "lse_rtol_atol": FLASH_TOL[torch.float32],
             "err_over_limit": [r for _, r in errs], "deterministic": same,
             "ok": all(math.isfinite(r) and r <= 1.0 for _, r in errs)
             and same}
        emit(c)
        return c
    out = [case("flash_attention_fwd", "sp ring merged o/lse of two blocks "
                "bf16", [err(o, want_o), err(lse, want_lse)])]
    delta = torch.empty_like(lse)
    ready = False
    for name in ("diagonal", "earlier"):   # the ring's order on rank 1
        kb, vb, c = blocks[name]
        dq = fa.flash_attention_bwd_dq_kernel(q, kb, vb, o, lse, do, scale,
                                              c, delta=delta,
                                              delta_ready=ready)
        dk, dv = fa.flash_attention_bwd_dkv_kernel(q, kb, vb, o, lse, do,
                                                   scale, c, delta=delta)
        same_dq = same_dkv = True
        if ready:
            dq2 = fa.flash_attention_bwd_dq_kernel(
                q, kb, vb, o, lse, do, scale, c, delta=delta,
                delta_ready=True)
            dk2, dv2 = fa.flash_attention_bwd_dkv_kernel(
                q, kb, vb, o, lse, do, scale, c, delta=delta)
            same_dq = torch.equal(dq, dq2)
            same_dkv = torch.equal(dk, dk2) and torch.equal(dv, dv2)
        ready = True
        want = fa.flash_attention_bwd_torch(q, kb, vb, o, lse, do, scale, c)
        label = (f"sp ring {name} block on the merged o/lse bf16, delta "
                 + ("read" if name == "earlier" else "written"))
        out.append(case("flash_attention_bwd_dq", label,
                        [err(dq, want[0])], same_dq))
        out.append(case("flash_attention_bwd_dkv", label,
                        [err(dk, want[1]), err(dv, want[2])], same_dkv))
    torch.cuda.synchronize()
    return out


def phase_flash_kernels() -> dict:
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(1)
    shapes = [  # name, b, sq, sk, hq, hkv, d, dtype[, causal]
        ("train gpt2 bf16", 8, 1024, 1024, 12, 12, 64, torch.bfloat16),
        ("train gpt2 f32", 8, 1024, 1024, 12, 12, 64, torch.float32),
        # GradScaler's float16 training (train_loop phase)
        ("train gpt2 f16", 8, 1024, 1024, 12, 12, 64, torch.float16),
        ("gqa llama bf16", 2, 2048, 2048, 16, 4, 128, torch.bfloat16),
        ("cross 512x1024 bf16", 8, 512, 1024, 12, 12, 64, torch.bfloat16),
        # head dim 80 (hidden 640, 8 heads), run padded to 128
        ("d80 bf16", 8, 1024, 1024, 8, 8, 80, torch.bfloat16),
        # above d 128 B1, B2 and B3 stay on mma.sync (D 256)
        ("d192 f16 mma", 2, 1024, 1024, 8, 8, 192, torch.float16),
        # split d: the SIMT kernels summing over 64-column slices
        ("d256 f32 split", 2, 1024, 1024, 8, 8, 256, torch.float32),
        ("d320 bf16 split", 2, 1024, 1024, 8, 8, 320, torch.bfloat16),
        ("gqa d264 f16 split", 1, 1024, 1024, 8, 2, 264, torch.float16),
        # lengths that end in a partial 64-row tile
        ("s97 gqa bf16", 8, 97, 97, 12, 4, 64, torch.bfloat16),
        ("q200 k136 f32", 8, 200, 136, 12, 12, 64, torch.float32, False),
        # the sequence_parallel phase's ring blocks at sp=2: an earlier
        # block (not causal) and the diagonal block (causal)
        ("sp ring block bf16", 8, 512, 512, 12, 12, 64, torch.bfloat16,
         False),
        ("sp ring diagonal bf16", 8, 512, 512, 12, 12, 64, torch.bfloat16),
        # the nn phase's transformer-base at 8 heads: the encoder's
        # self-attention, the decoder's (causal) and the cross-attention
        ("nn encoder bf16", 8, 512, 512, 8, 8, 64, torch.bfloat16, False),
        ("nn decoder causal bf16", 8, 256, 256, 8, 8, 64, torch.bfloat16),
        ("nn cross q256 k512 bf16", 8, 256, 512, 8, 8, 64, torch.bfloat16,
         False),
        # the models phase's BERT-base pretraining (bench.py's batch 64 x
        # 128, 12 heads), not causal
        ("bert-base bf16", 64, 128, 128, 12, 12, 64, torch.bfloat16, False),
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
        # B1, B2 and B3 sum in a fixed order, without atomics: a second
        # launch on the same inputs gives the same bits
        o2, lse2 = fa.flash_attention_fwd_kernel(q, k, v, scale, causal)
        dq2 = fa.flash_attention_bwd_dq_kernel(q, k, v, o, lse, do, scale,
                                               causal)
        dk2, dv2 = fa.flash_attention_bwd_dkv_kernel(q, k, v, o, lse, do,
                                                     scale, causal)
        torch.cuda.synchronize()
        same = {"flash_attention_fwd": torch.equal(o, o2) and
                torch.equal(lse, lse2),
                "flash_attention_bwd_dq": torch.equal(dq, dq2),
                "flash_attention_bwd_dkv": torch.equal(dk, dk2) and
                torch.equal(dv, dv2)}
        del o2, lse2, dq2, dk2, dv2

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
        fell_back = PROFILER_MISSES["fallbacks"]
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
        fell_back = PROFILER_MISSES["fallbacks"] - fell_back
        for kernel in checks:
            errs = checks[kernel]
            side = "fwd" if kernel == "flash_attention_fwd" else "bwd"
            bound_ms, bound_by, nbytes, ops = _flash_bound(
                kernel, b, sq, sk, hq, hkv, d, causal, dt)
            case = {"phase": "kernel_case", "kernel": kernel, "case": name,
                    "b": b, "sq": sq, "sk": sk, "hq": hq, "hkv": hkv,
                    "head_dim": d, "causal": causal, "dtype": str(dt),
                    "route": fa.kernel_route(d, dt),
                    "max_abs_err": max(e for e, _ in errs),
                    "rtol_atol": FLASH_TOL[dt],
                    "lse_rtol_atol": FLASH_TOL[torch.float32],
                    "err_over_limit": [r for _, r in errs],
                    "deterministic": same[kernel],
                    "ok": all(math.isfinite(r) and r <= 1.0
                              for _, r in errs) and same[kernel],
                    "ms": ms[kernel], "plain_ms": ms[f"{side}_plain"],
                    "library_ms": ms[f"{side}_library"],
                    "timing": f"device time, median of {FLASH_WINDOWS} "
                              f"windows of {FLASH_REPS} calls, in turns",
                    "event_timed_windows": fell_back,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": ops}
            emit(case)
            cases.append(case)
            heads.setdefault(kernel, case)   # the gpt2 bf16 train shape
        del q, k, v, do, o, lse, want_o, want_lse, dq, dk, dv
        del want_dq, want_dk, want_dv, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    cases += _ring_merged_cases(fa, g)
    bad = [(c["kernel"], c["case"], c["max_abs_err"], c["deterministic"])
           for c in cases if not c["ok"]]
    if bad:
        raise SystemExit(f"flash kernels disagree with their twins or "
                         f"with themselves: {bad}")
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


def _device_totals(prof, device_type):
    """{kernel name: (device ms, launches)} over the profiler's device
    events: what ``key_averages()`` gives for them, summed straight from
    the profiler's raw (kineto) events. ``key_averages`` first builds
    the host-side call tree of every event (~14 s a profiled serve run)
    and ``events()`` the event list itself (~3.5 s); neither is needed
    for the card's own kernels."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != device_type:
            continue
        ms, n = out.get(e.name(), (0.0, 0))
        out[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return out


def _profile(work, per, unit, **fields):
    """Device time by kernel of ``work()``, per ``unit`` (``per`` of them
    in the window), from ``torch.profiler``: the kernels' own device time,
    against the host wall of the same window (profiling inflates the
    wall, so the idle share is an upper bound). Only the card's activity
    is recorded: nothing here reads the host ops' events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / per * 1e3
    rows = sorted(((ms / per, n / per, k) for k, (ms, n) in
                   _device_totals(prof, DeviceType.CUDA).items()
                   if ms > 0), reverse=True)
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


# ---------------------------------------------------------------------------
# GPT-2-small trained through Model.fit over io.DataLoader
# ---------------------------------------------------------------------------

FIT_TRAIN, FIT_EVAL, FIT_BATCH, FIT_EPOCHS, FIT_SEED = 64, 16, 8, 2, 5
FIT_T_MAX = 32        # CosineAnnealingDecay horizon: lr 5e-5 at step 16
METRIC_BATCH, METRIC_STEPS = 4, 4


def _fit_model(net, loss=None, metrics=None, amp_configs="O1",
               numeric_guard=None):
    """The train phase's trainer (AdamW lr 1e-4, wd 0.01, AMP O1, fused
    loss) with its rate under CosineAnnealingDecay."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    sched = pt.optimizer.lr.CosineAnnealingDecay(1e-4, T_max=FIT_T_MAX)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=sched, parameters=net,
                                     weight_decay=0.01),
                  loss or GPTFusedPretrainingCriterion(), metrics=metrics,
                  amp_configs=amp_configs, numeric_guard=numeric_guard)
    return model


def _fit_order(n, epochs):
    """The sample order of ``epochs`` shuffled passes, drawn as the JAX
    package's RandomSampler draws it: RandomState(seed + epoch), where
    the seed is the thread-local one of the loader's prefetch thread,
    which no ``seed()`` call reaches (0)."""
    return [np.random.RandomState(e).permutation(n) for e in range(epochs)]


def _manual_losses(net, init, x, y):
    """The manual loop: train_batch over the fit's batches in the fit's
    order, from ``init``; the loss tensors and the wall seconds."""
    net.load_state_dict(init)
    model = _fit_model(net)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for perm in _fit_order(len(x), FIT_EPOCHS):
        for i in range(0, len(perm), FIT_BATCH):
            idx = perm[i:i + FIT_BATCH]
            losses.append(model.train_batch([x[idx]], [y[idx]])["loss"])
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def _is_sync_warning(w) -> bool:
    """A warning of ``set_sync_debug_mode("warn")`` for one synchronizing
    call (not its one-time notice that the mode is a prototype)."""
    return "called a synchronizing" in str(w.message)


def _timed_fit(net, init, ds, sync_debug=False, epochs=FIT_EPOCHS):
    """fit from ``init`` with the default callbacks (verbose 0, no
    eval): wall seconds, and with ``sync_debug`` the synchronizing CUDA
    calls ``torch.cuda.set_sync_debug_mode("warn")`` reported."""
    import paddle_tpu_torch as pt
    import warnings
    net.load_state_dict(init)
    model = _fit_model(net)
    pt.seed(FIT_SEED)
    torch.cuda.synchronize()
    syncs = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        try:
            model.fit(ds, batch_size=FIT_BATCH, epochs=epochs,
                      shuffle=True, verbose=0)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
    if sync_debug:
        syncs = [str(w.message)[:160] for w in caught
                 if _is_sync_warning(w)]
    return wall, syncs


def _fit_recorder():
    """A callback keeping each step's loss tensor (no host read) and the
    order of the events fit issues."""
    from paddle_tpu_torch.callbacks import Callback

    class Recorder(Callback):
        def __init__(self):
            super().__init__()
            self.events, self.losses = [], []

        def on_train_begin(self, logs=None):
            self.events.append("train_begin")

        def on_train_end(self, logs=None):
            self.events.append("train_end")

        def on_epoch_begin(self, epoch, logs=None):
            self.events.append(f"epoch_begin {epoch}")

        def on_epoch_end(self, epoch, logs=None):
            self.events.append(f"epoch_end {epoch}")

        def on_train_batch_begin(self, step, logs=None):
            self.events.append(f"batch_begin {step}")

        def on_train_batch_end(self, step, logs=None):
            self.events.append(f"batch_end {step}")
            self.losses.append(logs["loss"])

        def on_eval_begin(self, logs=None):
            self.events.append("eval_begin")

        def on_eval_end(self, logs=None):
            self.events.append("eval_end")

        def on_eval_batch_begin(self, step, logs=None):
            self.events.append(f"eval_batch_begin {step}")

        def on_eval_batch_end(self, step, logs=None):
            self.events.append(f"eval_batch_end {step}")
    return Recorder()


def _expected_fit_events(steps, eval_steps, epochs):
    """The events the JAX package's fit issues, in order."""
    ev = ["train_begin"]
    for e in range(epochs):
        ev.append(f"epoch_begin {e}")
        for i in range(steps):
            ev += [f"batch_begin {i}", f"batch_end {i}"]
        ev.append("eval_begin")
        for j in range(eval_steps):
            ev += [f"eval_batch_begin {j}", f"eval_batch_end {j}"]
        ev += ["eval_end", f"epoch_end {e}"]
    return ev + ["train_end"]


def _timed_checkpoint(save_dir, save_freq, seconds):
    """ModelCheckpoint timing each save into ``seconds``."""
    from paddle_tpu_torch.callbacks import ModelCheckpoint

    class Timed(ModelCheckpoint):
        def _timed(self, fn, *a):
            t0 = time.perf_counter()
            fn(*a)
            seconds.append(time.perf_counter() - t0)

        def on_epoch_end(self, epoch, logs=None):
            if epoch % self.save_freq == 0:
                self._timed(super().on_epoch_end, epoch, logs)

        def on_train_end(self, logs=None):
            self._timed(super().on_train_end, logs)
    return Timed(save_freq=save_freq, save_dir=save_dir)


def _drain_count():
    from paddle_tpu_torch.observability import metrics as obs
    fam = obs.default_registry().get("train_loop_drain_seconds")
    return (fam.count, fam.sum) if fam is not None else (0, 0.0)


def _numpy_topk_counts(logits, labels, topk):
    """Top-k hits recounted on the host: the label's position in a
    stable descending sort of its row (greater scores, then equal ones
    at a lower index, go first)."""
    hits = np.zeros(len(topk), np.int64)
    flat = logits.reshape(-1, logits.shape[-1])
    lab = labels.reshape(-1)
    cols = np.arange(flat.shape[1])
    for i in range(0, len(flat), 1024):
        x, lb = flat[i:i + 1024], lab[i:i + 1024]
        v = x[np.arange(len(x)), lb][:, None]
        rank = (x > v).sum(1) + ((x == v) & (cols[None, :] < lb[:, None])
                                 ).sum(1)
        hits += np.array([(rank < k).sum() for k in topk])
    return hits, len(flat)


def _metric_run(net_init, x, y, ex, ey):
    """The dense head with Accuracy(topk=(1, 5)): METRIC_STEPS steps of
    METRIC_BATCH, then evaluate; its accuracies against a host recount
    over predict's logits of the same eval batches. Both forwards run
    in float32 (amp O0), so evaluate and predict see the same logits."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                             GPTPretrainingCriterion,
                                             gpt_config)
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=False)
    dense = GPTForCausalLM(cfg, device="cuda")
    dense.load_state_dict(net_init)
    acc = pt.metric.Accuracy(topk=(1, 5))
    model = _fit_model(dense, loss=GPTPretrainingCriterion(),
                       metrics=[acc], amp_configs=None)
    n = METRIC_BATCH * METRIC_STEPS
    drains0 = _drain_count()
    pt.seed(FIT_SEED)
    model.fit(pt.io.TensorDataset([x[:n], y[:n]]), batch_size=METRIC_BATCH,
              epochs=1, shuffle=True, verbose=0)
    eval_ds = pt.io.TensorDataset([ex, ey])
    ev = model.evaluate(eval_ds, batch_size=METRIC_BATCH, verbose=0)
    drains1 = _drain_count()
    logits = model.predict(pt.io.TensorDataset([ex]),
                           batch_size=METRIC_BATCH, stack_outputs=True)
    hits, count = _numpy_topk_counts(logits, ey, (1, 5))
    recount = {"acc_top1": float(hits[0] / count),
               "acc_top5": float(hits[1] / count)}
    # Accuracy.compute's device time on one eval batch's logits
    lg = torch.as_tensor(logits[:METRIC_BATCH], device="cuda")
    lb = torch.as_tensor(ey[:METRIC_BATCH], device="cuda")
    for _ in range(3):
        acc.compute(lg, lb)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        acc.compute(lg, lb)
    end.record()
    torch.cuda.synchronize()
    compute_ms = start.elapsed_time(end) / 10
    del lg, lb, logits, dense, model
    torch.cuda.empty_cache()
    return {"phase": "fit", "run": "metric", "amp": "O0",
            "head": "dense", "batch": METRIC_BATCH, "steps": METRIC_STEPS,
            "evaluate": ev, "recount": recount, "eval_tokens": count,
            "drains": drains1[0] - drains0[0],
            "train_loop_drain_seconds": drains1[1] - drains0[1],
            "accuracy_compute_ms": compute_ms,
            "accuracy_compute_shape": [METRIC_BATCH, TRAIN_SEQ,
                                       cfg.vocab_size],
            "timing": "CUDA events, mean of 10 calls"}


def phase_fit() -> dict:
    """GPT-2-small at full width (the train phase's configuration under
    CosineAnnealingDecay) through ``Model.fit`` over ``io.DataLoader``
    with callbacks, then ``evaluate`` and ``predict``, on kernels B1-B3;
    its losses against a manual ``train_batch`` loop's, the launches,
    a checkpoint reloaded, the metric run and the timings."""
    import shutil
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.callbacks import (CSVLogger, EarlyStopping,
                                            LRScheduler)
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True)
    pt.seed(0)
    net = GPTForCausalLM(cfg, device="cuda")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (FIT_TRAIN, TRAIN_SEQ + 1))
    eids = rs.randint(0, cfg.vocab_size, (FIT_EVAL, TRAIN_SEQ + 1))
    x, y = ids[:, :-1], ids[:, 1:]
    ex, ey = eids[:, :-1], eids[:, 1:]
    train_ds = pt.io.TensorDataset([x, y])
    eval_ds = pt.io.TensorDataset([ex, ey])
    steps = FIT_TRAIN // FIT_BATCH
    eval_steps = FIT_EVAL // FIT_BATCH
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fit_", dir=out_dir)
    try:
        # workers: fork after CUDA is initialised, NumPy only
        loaders = [pt.io.DataLoader(train_ds, batch_size=FIT_BATCH,
                                    shuffle=True, num_workers=w,
                                    device="cuda") for w in (0, 2)]
        pt.seed(FIT_SEED)
        serial = [b for b in loaders[0]]
        pt.seed(FIT_SEED)
        forked = [b for b in loaders[1]]
        workers_equal = len(serial) == len(forked) == steps and all(
            torch.equal(a, b) for s, f in zip(serial, forked)
            for a, b in zip(s, f))
        del serial, forked, loaders

        # the main run: counts from 0, fit + evaluate + predict
        model = _fit_model(net)
        rec = _fit_recorder()
        save_s = []
        csv_path = os.path.join(tmp, "fit.csv")
        cbks = [rec, LRScheduler(by_step=True),
                EarlyStopping(monitor="eval_loss", patience=5),
                CSVLogger(csv_path),
                _timed_checkpoint(tmp, 2, save_s)]
        tracing.clear()
        tracing.enable()
        pt.seed(FIT_SEED)
        _reset_flash_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(train_ds, eval_data=eval_ds, batch_size=FIT_BATCH,
                  epochs=FIT_EPOCHS, eval_freq=1, shuffle=True, verbose=0,
                  callbacks=cbks)
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev = model.evaluate(eval_ds, batch_size=FIT_BATCH, verbose=0)
        eval_wall = time.perf_counter() - t0
        pred = model.predict(pt.io.TensorDataset([ex[:2]]),
                             batch_size=FIT_BATCH)
        torch.cuda.synchronize()
        launches = _flash_counts()
        spans = {**tracing.rollup("train."), **tracing.rollup("io.")}
        tracing.disable()
        fit_losses = [float(v) for v in rec.losses]
        lr_after = model._optimizer.get_lr()
        with open(csv_path) as f:
            csv_rows = f.read().strip().splitlines()

        # a fresh Model of another init loads final.pdparams (and .pdopt)
        pt.seed(1)
        other = GPTForCausalLM(cfg, device="cuda")
        fresh = _fit_model(other)
        t0 = time.perf_counter()
        fresh.load(os.path.join(tmp, "final"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ev_loaded = fresh.evaluate(eval_ds, batch_size=FIT_BATCH, verbose=0)
        loaded_step = fresh._step_count
        del other, fresh
        torch.cuda.empty_cache()

        # the same batches by hand (M), and timed fits (F): M F F M
        manual, m_wall1 = _manual_losses(net, init, x, y)
        manual = [float(v) for v in manual]
        f_wall1, _ = _timed_fit(net, init, train_ds)
        f_wall2, _ = _timed_fit(net, init, train_ds)
        _, m_wall2 = _manual_losses(net, init, x, y)
        _, syncs = _timed_fit(net, init, train_ds, sync_debug=True,
                              epochs=1)

        # the twins: a shortened fit launches nothing
        net.load_state_dict(init)
        fa.impl = "plain"
        try:
            _reset_flash_counts()
            twin = _fit_model(net)
            rec_twin = _fit_recorder()
            pt.seed(FIT_SEED)
            twin.fit(pt.io.TensorDataset([x[:FIT_BATCH], y[:FIT_BATCH]]),
                     eval_data=pt.io.TensorDataset(
                         [ex[:FIT_BATCH], ey[:FIT_BATCH]]),
                     batch_size=FIT_BATCH, epochs=1, verbose=0,
                     callbacks=[rec_twin])
            torch.cuda.synchronize()
            twin_counts = _flash_counts()
            twin_losses = [float(v) for v in rec_twin.losses]
        finally:
            fa.impl = "kernel"
        del twin

        metric = _metric_run(init, x, y, ex, ey)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    tokens = FIT_TRAIN * TRAIN_SEQ * FIT_EPOCHS
    want_cos = 0.5 * 1e-4 * (1 + math.cos(math.pi * steps * FIT_EPOCHS /
                                          FIT_T_MAX))
    n_fwd = steps * FIT_EPOCHS + eval_steps * FIT_EPOCHS + eval_steps + 1
    want = {"flash_attention_fwd": cfg.num_layers * n_fwd,
            "flash_attention_bwd_dq": cfg.num_layers * steps * FIT_EPOCHS,
            "flash_attention_bwd_dkv": cfg.num_layers * steps * FIT_EPOCHS}
    epoch_mean = [float(np.mean(fit_losses[e * steps:(e + 1) * steps]))
                  for e in range(FIT_EPOCHS)]
    emit({"phase": "fit", "run": "main", "model": "gpt2-small",
          "train_sequences": FIT_TRAIN, "eval_sequences": FIT_EVAL,
          "batch": FIT_BATCH, "seq": TRAIN_SEQ, "epochs": FIT_EPOCHS,
          "amp": "O1", "fused_loss": True,
          "optimizer": f"AdamW(CosineAnnealingDecay(1e-4, T_max="
                       f"{FIT_T_MAX}), wd 0.01)",
          "fit_wall_s": fit_wall, "losses": fit_losses,
          "manual_losses": manual,
          "max_rel_diff_vs_manual": max(
              abs(a - b) / abs(b) for a, b in zip(fit_losses, manual)),
          "epoch_mean_loss": epoch_mean, "evaluate": ev,
          "eval_tokens_per_s": FIT_EVAL * TRAIN_SEQ / eval_wall,
          "evaluate_after_load": ev_loaded, "loaded_step": loaded_step,
          "lr_after": lr_after, "lr_schedule_at_16": want_cos,
          "csv_lines": len(csv_rows), "launches": launches,
          "expected_launches": want, "spans": spans,
          "save_s": save_s, "load_s": load_s,
          "workers_equal": workers_equal,
          "predict_shape": list(pred[0].shape)})
    tps = {"M1": tokens / m_wall1, "F1": tokens / f_wall1,
           "F2": tokens / f_wall2, "M2": tokens / m_wall2}
    emit({"phase": "fit", "run": "fit vs manual loop (M F F M)",
          "tokens_per_s": tps,
          "fit_over_manual": (tps["F1"] + tps["F2"]) /
          (tps["M1"] + tps["M2"]),
          "sync_debug_steps": steps, "syncs": len(syncs),
          "syncs_per_step": len(syncs) / steps, "sync_calls": syncs[:8]})
    emit(metric)
    checks = {
        "launches_fit_evaluate_predict": launches == want,
        "twin_fit_launches_nothing": all(v == 0
                                         for v in twin_counts.values()),
        "twin_losses_finite": all(math.isfinite(v) for v in twin_losses),
        "losses_equal_manual_loop": fit_losses == manual,
        "losses_finite": all(math.isfinite(v) for v in fit_losses),
        "epoch2_mean_below_epoch1": epoch_mean[1] < epoch_mean[0],
        "loaded_final_evaluates_same": ev_loaded == ev,
        "loaded_step": loaded_step == steps * FIT_EPOCHS,
        "lr_is_schedule_at_16": lr_after == want_cos,
        "csv_two_rows": len(csv_rows) == 1 + FIT_EPOCHS,
        "callback_order": rec.events == _expected_fit_events(
            steps, eval_steps, FIT_EPOCHS),
        "checkpoints_written": len(save_s) == 2,
        "evaluate_finite": math.isfinite(ev["loss"]),
        "predict_finite": bool(np.isfinite(pred[0]).all()) and
        list(pred[0].shape) == [2, TRAIN_SEQ, cfg.vocab_size],
        "workers_equal_serial": workers_equal,
        "metric_top1_equals_recount": metric["evaluate"]["acc_top1"] ==
        metric["recount"]["acc_top1"],
        "metric_top5_equals_recount": metric["evaluate"]["acc_top5"] ==
        metric["recount"]["acc_top5"],
        "metric_drained": metric["drains"] > 0,
        "io_next_wait_spans": spans.get("io.next_wait", {}).get(
            "count", 0) > 0,
    }
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "fit_checks", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"fit checks failed: {failed}")
    return {"launches": launches, "losses": fit_losses, "save_s": save_s}


# ---------------------------------------------------------------------------
# full-state checkpoints: resume, preemption and the guard's rollback
# ---------------------------------------------------------------------------

CKPT_FREQ, CKPT_KEEP = 4, 2     # the interrupted run: a save every 4 steps
CKPT_STOP, CKPT_PREEMPT = 6, 10  # the stop and the preemption, global steps
CKPT_RESUME_FREQ = 8            # resumed runs: saves at 12 and 16 only
# grad.nonfinite's 6th check poisons step 5 (data.poison NaNs floating
# inputs only, and the GPT's inputs are token ids)
CKPT_POISON_NTH = 6


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _ckpt_hist(name):
    from paddle_tpu_torch.observability import metrics as obs
    fam = obs.default_registry().get(name)
    return (0, 0.0) if fam is None else (fam.count, fam.sum)


def _hist_delta(before, name):
    n, s = _ckpt_hist(name)
    return {"count": n - before[name][0], "seconds": s - before[name][1]}


def _timed_manager_class(ck, waits):
    """A CheckpointManager recording the wall of each barrier the train
    loop waits on (``close`` at fit exit, ``flush``, ``wait_until_
    finished``) and of each restore, by stage, into ``waits``."""

    class Timed(ck.CheckpointManager):
        def _timed(self, what, fn, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                waits.setdefault(what, []).append(
                    time.perf_counter() - t0)

        def close(self):
            return self._timed("close", super().close)

        def flush(self, deadline=None):
            return self._timed("flush", super().flush, deadline)

        def wait_until_finished(self):
            return self._timed("wait_until_finished",
                               super().wait_until_finished)

        def restore_with_state(self, step=None, like=None, verify=True):
            return self._timed("restore", super().restore_with_state,
                               step, like=like, verify=verify)
    return Timed


def _loss_tap():
    """A callback keeping (global step, loss) in call order; losses stay
    on the device until the run ends."""
    from paddle_tpu_torch.callbacks import Callback

    class Tap(Callback):
        def __init__(self):
            super().__init__()
            self.rows = []

        def on_epoch_begin(self, epoch, logs=None):
            self.epoch = epoch

        def on_train_batch_end(self, step, logs=None):
            self.rows.append((self.epoch * (FIT_TRAIN // FIT_BATCH)
                              + step, logs["loss"]))

        def losses(self):
            return [(g, float(v)) for g, v in self.rows]
    return Tap()


def _at_step(tap, n, fn):
    """A callback calling ``fn`` once ``tap`` has seen ``n`` steps."""
    from paddle_tpu_torch.callbacks import Callback

    class At(Callback):
        def on_train_batch_end(self, step, logs=None):
            if len(tap.rows) >= n:
                fn()
    return At()


def _stop():
    raise RuntimeError("stopped by the checkpoint phase")


def phase_checkpoint(fit=None, dev="cuda") -> dict:
    """GPT-2-small at full width (the fit phase's configuration and
    data) trained by ``Model.fit`` on B1-B3 with full-state checkpoints:
    stopped after step 6 and resumed in a fresh Model at K 4, preempted
    there by a ``PreemptionGuard`` at step 10 (flush, exit 67) and
    resumed at K 1 to the end; every resumed loss against the fit
    phase's uninterrupted losses, bit for bit. Then the numeric guard's
    rollback over a poisoned batch, and every committed manifest
    restored and verified. Reports the snapshot stall per save beside
    ``Model.save``'s, commit, barrier, restore and verify seconds."""
    import shutil
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (RESTART_EXIT_CODE,
                                              PreemptionGuard)
    from paddle_tpu_torch.io import checkpoint as ck
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    from paddle_tpu_torch.reliability import faults
    from paddle_tpu_torch.reliability import guard as nguard
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True)
    pt.seed(0)
    net = GPTForCausalLM(cfg, device=dev)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    ids = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (FIT_TRAIN, TRAIN_SEQ + 1))
    ds = pt.io.TensorDataset([ids[:, :-1], ids[:, 1:]])
    steps = FIT_TRAIN // FIT_BATCH
    total = steps * FIT_EPOCHS
    fit_kw = dict(batch_size=FIT_BATCH, epochs=FIT_EPOCHS, shuffle=True,
                  verbose=0)

    def scramble():
        # resumed runs start from other weights: the restore must
        # overwrite every parameter
        with torch.no_grad():
            for p in net.parameters():
                p.normal_(0.0, 0.02)

    if fit is None:   # the phase alone: its own uninterrupted baseline
        net.load_state_dict(init)
        tap = _loss_tap()
        pt.seed(FIT_SEED)
        _fit_model(net).fit(ds, callbacks=[tap], **fit_kw)
        base = [v for _, v in tap.losses()]
        model_save_s = None
    else:
        base = list(fit["losses"])
        model_save_s = fit["save_s"]

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=out_dir)
    waits, stalls = {}, []
    names = ("ckpt_snapshot_seconds", "checkpoint_save_seconds",
             "checkpoint_restore_seconds")
    before = {n: _ckpt_hist(n) for n in names}
    real_manager = ck.CheckpointManager
    ck.CheckpointManager = _timed_manager_class(ck, waits)
    # every restore's read and digest check, timed apart
    split = {"read_s": [], "verify_s": []}
    real_read, real_diff = ck._read_step_dir, ck._digest_diff

    def timed(fn, key):
        def call(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                split[key].append(time.perf_counter() - t0)
        return call
    ck._read_step_dir = timed(real_read, "read_s")
    ck._digest_diff = timed(real_diff, "verify_s")

    def timed_saves(model):
        real = model._save_training_state

        def save(*a, **kw):
            t0 = time.perf_counter()
            real(*a, **kw)
            stalls.append(time.perf_counter() - t0)
        model._save_training_state = save
        return model

    d = os.path.join(tmp, "resume")
    try:
        # 1. K 1, a save every 4 steps, stopped by a callback after step 6
        net.load_state_dict(init)
        tap1 = _loss_tap()
        pt.seed(FIT_SEED)
        stopped = False
        try:
            timed_saves(_fit_model(net)).fit(
                ds, callbacks=[tap1, _at_step(tap1, CKPT_STOP, _stop)],
                checkpoint_dir=d, checkpoint_freq=CKPT_FREQ,
                keep_checkpoints=CKPT_KEEP, async_checkpoint=True,
                **fit_kw)
        except RuntimeError as e:
            stopped = "checkpoint phase" in str(e)
        with real_manager(d, async_save=False) as mgr:
            after_stop = mgr.verified_steps()

        # 2. a fresh Model resumes at K 4; preempted at step 10
        scramble()
        tap2 = _loss_tap()
        guard = PreemptionGuard(install=False)
        pt.seed(FIT_SEED)
        _reset_flash_counts()
        _sync(dev)
        t0 = time.perf_counter()
        exit_code = None
        try:
            timed_saves(_fit_model(net)).fit(
                ds, callbacks=[tap2, _at_step(tap2, CKPT_PREEMPT - 4,
                                              guard.trigger)],
                checkpoint_dir=d, checkpoint_freq=CKPT_RESUME_FREQ,
                keep_checkpoints=CKPT_KEEP, resume="auto",
                steps_per_loop=4, preemption_guard=guard, **fit_kw)
        except SystemExit as e:
            exit_code = e.code
        _sync(dev)
        wall2 = time.perf_counter() - t0
        launches_k4 = _flash_counts()
        with real_manager(d, async_save=False) as mgr:
            after_preempt = mgr.verified_steps()

        # 3. a fresh Model resumes at K 1 and runs to the end
        scramble()
        tap3 = _loss_tap()
        pt.seed(FIT_SEED)
        _reset_flash_counts()
        _sync(dev)
        t0 = time.perf_counter()
        timed_saves(_fit_model(net)).fit(
            ds, callbacks=[tap3], checkpoint_dir=d,
            checkpoint_freq=CKPT_RESUME_FREQ, keep_checkpoints=CKPT_KEEP,
            resume="auto", **fit_kw)
        _sync(dev)
        wall3 = time.perf_counter() - t0
        launches_k1 = _flash_counts()

        # every committed manifest restores and verifies
        verified, manifest_s = {}, []
        with real_manager(d, async_save=False) as mgr:
            for s in mgr.verified_steps():
                t0 = time.perf_counter()
                tree, state = mgr.restore_with_state(s)
                manifest_s.append(time.perf_counter() - t0)
                verified[s] = {k: state[k] for k in
                               ("step", "epoch", "loader", "rng")}
                state_bytes = ck._tree_bytes(tree)
                del tree
        step_dir = os.path.join(d, str(max(verified)))
        disk_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        shutil.rmtree(d, ignore_errors=True)

        # 4. the guard's rollback over a poisoned batch (one epoch)
        net.load_state_dict(init)
        tap4 = _loss_tap()
        d4 = os.path.join(tmp, "rollback")
        faults.reset()
        faults.enable(seed=7)
        faults.inject("grad.nonfinite", nth=(CKPT_POISON_NTH,))
        pt.seed(FIT_SEED)
        try:
            rb_model = _fit_model(net, numeric_guard=nguard.GuardPolicy(
                on_nonfinite="rollback", max_rollbacks=2))
            rb_model.fit(ds, callbacks=[tap4], checkpoint_dir=d4,
                         checkpoint_freq=CKPT_FREQ,
                         keep_checkpoints=CKPT_KEEP,
                         **dict(fit_kw, epochs=1))
        finally:
            faults.reset()
        with real_manager(d4, async_save=False) as mgr:
            rb_steps = mgr.verified_steps()
            for s in rb_steps:
                mgr.restore(s)   # raises CheckpointCorrupt on a mismatch
        rb_losses = tap4.losses()
    finally:
        ck.CheckpointManager = real_manager
        ck._read_step_dir, ck._digest_diff = real_read, real_diff
        shutil.rmtree(tmp, ignore_errors=True)
    del net
    if dev == "cuda":
        torch.cuda.empty_cache()

    l1, l2, l3 = tap1.losses(), tap2.losses(), tap3.losses()
    per_step = {k: cfg.num_layers for k in
                ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")}
    want_k4 = {k: v * (CKPT_PREEMPT + 2 - CKPT_FREQ)
               for k, v in per_step.items()}
    want_k1 = {k: v * (total - CKPT_PREEMPT - 2)
               for k, v in per_step.items()}
    snap = _hist_delta(before, "ckpt_snapshot_seconds")
    commit = _hist_delta(before, "checkpoint_save_seconds")
    restore = _hist_delta(before, "checkpoint_restore_seconds")
    emit({"phase": "checkpoint", "run": "resume and preemption",
          "model": "gpt2-small", "batch": FIT_BATCH, "seq": TRAIN_SEQ,
          "steps": total, "checkpoint_freq": CKPT_FREQ,
          "resumed_checkpoint_freq": CKPT_RESUME_FREQ,
          "stopped_after": CKPT_STOP, "preempted_at": CKPT_PREEMPT,
          "steps_run": {"stopped": [g for g, _ in l1],
                        "resumed_k4": [g for g, _ in l2],
                        "resumed_k1": [g for g, _ in l3]},
          "verified_after_stop": after_stop,
          "verified_after_preempt": after_preempt,
          "exit_code": exit_code, "verified": verified,
          "launches_resumed_k4": launches_k4,
          "launches_resumed_k1": launches_k1,
          "wall_s": {"resumed_k4": wall2, "resumed_k1": wall3},
          "state_bytes_per_step": state_bytes,
          "disk_bytes_per_step": disk_bytes,
          "stall_s_per_save": stalls,
          "snapshot": snap, "commit": commit, "restore": restore,
          "barrier_s": waits, "restore_with_state_s": manifest_s,
          "restore_read_s": split["read_s"],
          "restore_verify_s": split["verify_s"],
          "model_save_s": model_save_s})
    emit({"phase": "checkpoint", "run": "guard rollback",
          "poisoned_step": CKPT_POISON_NTH - 1,
          "losses": [[g, v if math.isfinite(v) else repr(v)]
                     for g, v in rb_losses],
          "rollbacks": rb_model._guard.n_rollbacks,
          "final_step": rb_model._step_count, "verified": rb_steps})
    checks = {
        "stopped_by_callback": stopped,
        "stop_left_step_4": after_stop == [CKPT_FREQ],
        "stopped_run_equals_baseline": [v for _, v in l1] ==
        base[:CKPT_STOP],
        "k4_resumed_at_4": [g for g, _ in l2] ==
        list(range(CKPT_FREQ, CKPT_PREEMPT + 2)),
        "k4_resume_equals_baseline": [v for _, v in l2] ==
        base[CKPT_FREQ:CKPT_PREEMPT + 2],
        "preemption_exit_67": exit_code == RESTART_EXIT_CODE,
        "preemption_committed_12": after_preempt[-1:] == [CKPT_PREEMPT + 2],
        "k1_resumed_at_12": [g for g, _ in l3] ==
        list(range(CKPT_PREEMPT + 2, total)),
        "k1_resume_equals_baseline": [v for _, v in l3] ==
        base[CKPT_PREEMPT + 2:],
        "launches_12_per_resumed_step_k4": launches_k4 == want_k4,
        "launches_12_per_resumed_step_k1": launches_k1 == want_k1,
        "every_manifest_verifies": sorted(verified) == [12, total],
        "final_state_bundle": verified.get(total, {}).get("loader") ==
        {"pass": FIT_EPOCHS, "batch": 0} and
        verified.get(total, {}).get("epoch") == FIT_EPOCHS,
        "rollback_once": rb_model._guard.n_rollbacks == 1,
        "rollback_final_step": rb_model._step_count == steps - 2,
        "rollback_restored_4": CKPT_FREQ in rb_steps,
        "rollback_ends_finite": all(math.isfinite(v)
                                    for _, v in rb_losses[-2:]),
        "rollback_poisoned_step_nonfinite": not math.isfinite(
            dict(rb_losses[:steps])[CKPT_POISON_NTH - 1]),
    }
    if dev == "cuda":
        checks["stall_measured"] = len(stalls) >= 3 and snap["count"] >= 3
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "checkpoint_checks", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"checkpoint checks failed: {failed}")
    return {"k4": launches_k4, "k1": launches_k1}


# ---------------------------------------------------------------------------
# the rest of the training path: the K-step loop, the numeric guard,
# GradScaler in float16, remat and scan_layers, the greedy decoder and
# the other optimizers
# ---------------------------------------------------------------------------

LOOP_K, LOOP_STEPS, LOOP_FIT_TRAIN = 4, 8, 80   # fit: slabs 4, 4, 2
GUARD_STEPS, SCALER_STEPS, REMAT_STEPS = 4, 3, 3
DECODE_NEW, DECODE_PROMPTS = 64, (17, 60, 128, 200)
# the 8 optimizers, card against CPU from the same float32 parameters
# and gradients: each parameter after OPT_STEPS updates,
# ||p_card - p_cpu|| / ||p_cpu|| within OPT_RTOL; and the updates,
# ||delta_card - delta_cpu|| / ||delta_cpu|| over all parameters, within
# OPT_DELTA_RTOL: a delta is read through the updated float32 parameter,
# so it carries the rounding of p + update (1 ulp of p, ~2e-9 at |p|
# 0.02), and where the update is that small (LarsMomentum's), an
# update that differs in its last bit (Lamb's and LARS's per-tensor
# norms sum up to 38.6M squares in another order on each device) flips
# that rounding now and then
OPT_STEPS, OPT_RTOL, OPT_DELTA_RTOL = 2, 1e-5, 1e-4
# the comparison's depth: the embeddings, the final norm and the first
# OPT_LAYERS of the 12 blocks, at full width (54M of 124M parameters)
OPT_LAYERS = 2
NEW_OPTIMIZERS = ("Momentum", "Adagrad", "RMSProp", "Adadelta", "Adamax",
                  "Lamb", "Adafactor", "LarsMomentum")


def _syncs(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing calls it made."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message)[:160] for w in caught
                 if _is_sync_warning(w)]


def _loop_net(init, dev, **cfg_kw):
    """gpt2-small at the train cell's shape on ``init``'s weights."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    kw = dict(max_position_embeddings=TRAIN_SEQ, hidden_dropout=0.0,
              attention_dropout=0.0, fused_loss=True)
    kw.update(cfg_kw)
    net = GPTForCausalLM(gpt_config("gpt2-small", **kw), device=dev)
    net.load_state_dict(init)
    return net


def _loop_model(net, guard=None, lr=1e-4):
    """The train cell's trainer (AdamW, wd 0.01, O1) at a constant
    rate, with the numeric guard ``guard``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=lr, parameters=net,
                                     weight_decay=0.01),
                  GPTFusedPretrainingCriterion(), amp_configs="O1",
                  numeric_guard=guard)
    return model


def _state_equal(a, b) -> bool:
    """Nested dicts of tensors (and ints) equal, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip(a.network.parameters(), b.network.parameters()))


def _timed_steps(fn, steps, dev):
    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps


def _k_loop_runs(init, ids, dev, vocab):
    """LOOP_STEPS train_batch calls against LOOP_STEPS // LOOP_K slabs
    from the same weights (dropout 0.1 in the residual paths, attention
    dropout 0 so that B1-B3 run), fit at K 4 against K 1, and the
    tokens/s of both in turns (1 4 4 1)."""
    import paddle_tpu_torch as pt
    xs, ys = ids[:, :, :-1], ids[:, :, 1:]
    net = _loop_net(init, dev, hidden_dropout=0.1)
    one = _loop_model(net)
    pt.seed(0)
    want = [one.train_batch([xs[i]], [ys[i]])["loss"]
            for i in range(LOOP_STEPS)]
    want_params = [p.detach().clone() for p in net.parameters()]
    del one
    net.load_state_dict(init)
    loop = _loop_model(net)
    pt.seed(0)
    _reset_flash_counts()

    def slabs():
        return [lg["loss"] for s in range(0, LOOP_STEPS, LOOP_K)
                for lg in loop.train_loop_batch([xs[s:s + LOOP_K]],
                                                [ys[s:s + LOOP_K]])]
    got, syncs = _syncs(slabs)
    if dev == "cuda":
        torch.cuda.synchronize()
    launches = _flash_counts()
    got = [float(v) for v in got]
    want = [float(v) for v in want]
    params_equal = all(torch.equal(a, b) for a, b in
                       zip(want_params, net.parameters()))
    del want_params

    # fit(steps_per_loop=4) against fit(steps_per_loop=1): 10 steps, the
    # last slab ragged (4, 4, 2)
    rs = np.random.RandomState(0)
    data = rs.randint(0, vocab, (LOOP_FIT_TRAIN, TRAIN_SEQ + 1))
    ds = pt.io.TensorDataset([data[:, :-1], data[:, 1:]])
    fits = {}
    for k in (LOOP_K, 1):
        net.load_state_dict(init)
        model = _loop_model(net)
        rec = _fit_recorder()
        pt.seed(FIT_SEED)
        model.fit(ds, batch_size=FIT_BATCH, epochs=1, shuffle=True,
                  verbose=0, callbacks=[rec], steps_per_loop=k)
        fits[k] = ([float(v) for v in rec.losses], rec.events)
    # tokens/s of K 1 (train_batch) against K 4 (slabs), in turns
    net.load_state_dict(init)
    model = _loop_model(net)
    runs = {1: lambda: [model.train_batch([xs[i]], [ys[i]])
                        for i in range(LOOP_K)],
            LOOP_K: lambda: model.train_loop_batch([xs[:LOOP_K]],
                                                   [ys[:LOOP_K]])}
    runs[1]()  # warm-up
    step_s = {f"K{k}_{i}": _timed_steps(runs[k], LOOP_K, dev)
              for i, k in enumerate((1, LOOP_K, LOOP_K, 1))}
    # device time by kernel of a 2-step slab (dropout 0.1: the threefry
    # masks); a short window, since the profiler's cost grows with the
    # thousands of small kernels a step launches
    profile = _profile(lambda: model.train_loop_batch([xs[:2]], [ys[:2]]),
                       2, "step", phase="train_loop", run="profile",
                       steps=2) if dev == "cuda" else None
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tps = {name: tokens / s for name, s in step_s.items()}
    del model, loop, net
    return {"losses": got, "train_batch_losses": want,
            "params_equal": params_equal, "launches": launches,
            "syncs": len(syncs), "sync_calls": syncs[:8],
            "fit_k4_losses": fits[LOOP_K][0], "fit_k1_losses": fits[1][0],
            "fit_events_equal": fits[LOOP_K][1] == fits[1][1],
            "fit_steps": len(fits[LOOP_K][0]),
            "tokens_per_s": tps,
            "k4_over_k1": (tps["K4_1"] + tps["K4_2"]) /
            (tps["K1_0"] + tps["K1_3"]), "profile": profile}


def _guard_runs(init, ids, dev):
    """The numeric guard on a K-4 slab with a grad.nonfinite fault on
    its step 2 (0-based), against a clean guarded run with that batch
    removed; abort and rollback escalation; step time and peak memory
    armed against not armed."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.reliability import faults, guard
    xs, ys = ids[:GUARD_STEPS, :, :-1], ids[:GUARD_STEPS, :, 1:]
    net = _loop_net(init, dev)
    out = {}
    try:
        faults.reset()
        faults.enable(seed=1)
        faults.inject("grad.nonfinite", nth=(3,))
        model = _loop_model(net, guard.GuardPolicy(on_nonfinite="skip"))
        _, syncs = _syncs(lambda: model.train_loop_batch([xs], [ys]))
        verdicts = model._guard_pending[-1][0].tolist()
        model.drain_metrics()
        faults.reset()
        poisoned = ([p.detach().clone() for p in net.parameters()],
                    model._opt_state)
        out.update(verdicts=verdicts, skipped=model._guard.n_skipped,
                   syncs=len(syncs), sync_calls=syncs[:8])
        del model
        net.load_state_dict(init)
        clean = _loop_model(net, guard.GuardPolicy(on_nonfinite="skip"))
        for i in (0, 1, 3):
            clean.train_batch([xs[i]], [ys[i]])
        clean.drain_metrics()
        out["params_equal_minus_batch"] = all(
            torch.equal(a, b) for a, b in zip(poisoned[0],
                                              net.parameters()))
        out["opt_state_equal_minus_batch"] = _state_equal(
            poisoned[1], clean._opt_state)
        del clean, poisoned

        # abort: GuardAbort with the per-tensor report
        net.load_state_dict(init)
        model = _loop_model(net, guard.GuardPolicy(on_nonfinite="abort"))
        faults.enable(seed=1)
        faults.inject("grad.nonfinite", nth=(1,))
        try:
            model.train_batch([xs[0]], [ys[0]])
            model.drain_metrics()
            out["abort"] = None
        except guard.GuardAbort as e:
            out["abort"] = str(e)[:240]
        faults.reset()
        # rollback with no checkpoint_dir escalates
        net.load_state_dict(init)
        model = _loop_model(net, guard.GuardPolicy(on_nonfinite="rollback"))
        faults.enable(seed=1)
        faults.inject("grad.nonfinite", nth=(1,))
        try:
            model.fit(pt.io.TensorDataset(
                [np.asarray(xs[:2].reshape(-1, TRAIN_SEQ).cpu()),
                 np.asarray(ys[:2].reshape(-1, TRAIN_SEQ).cpu())]),
                      batch_size=TRAIN_BATCH, epochs=1, verbose=0,
                      shuffle=False)
            out["rollback"] = None
        except guard.GuardAbort as e:
            out["rollback"] = str(e)[:240]
        faults.reset()
        del model
    finally:
        faults.reset()

    # step wall time and peak memory, guard off (U) and armed (G): U G G U
    steps = {}
    for i, armed in enumerate((False, True, True, False)):
        net.load_state_dict(init)
        model = _loop_model(net, guard.GuardPolicy() if armed else None)
        model.train_batch([xs[0]], [ys[0]])
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        steps[f"{'G' if armed else 'U'}{i}"] = _timed_steps(
            lambda: [model.train_batch([xs[j]], [ys[j]])
                     for j in range(GUARD_STEPS)], GUARD_STEPS, dev)
        if dev == "cuda":
            steps[f"peak_{'G' if armed else 'U'}{i}"] = \
                torch.cuda.max_memory_allocated()
        model.drain_metrics()
        del model
    out["step_s"] = steps
    out["guard_over_plain"] = (steps["G1"] + steps["G2"]) / \
        (steps["U0"] + steps["U3"])
    del net
    return out


def _scaler_runs(init, ids, dev):
    """The eager GradScaler loop under auto_cast float16: SCALER_STEPS
    steps on B1-B3 and on their twins from the same weights, then two
    steps whose loss is NaN (a poisoned record): parameters untouched,
    the scale halved after the second."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    from paddle_tpu_torch.observability import metrics as obs
    from paddle_tpu_torch.ops import flash_attention as fa
    crit = GPTFusedPretrainingCriterion()
    xs, ys = ids[:, :, :-1], ids[:, :, 1:]
    seen = set()
    real_flash = fa.flash_attention

    def spy(q, k, v, **kw):
        seen.add(str(q.dtype))
        return real_flash(q, k, v, **kw)

    def run(impl, poison_steps=0):
        net = _loop_net(init, dev)
        opt = pt.optimizer.AdamW(1e-4, parameters=net, weight_decay=0.01)
        scaler = amp.GradScaler(decr_every_n_nan_or_inf=2)
        losses, scales, unchanged = [], [], []
        fa.impl = impl
        fa.flash_attention = spy
        try:
            _reset_flash_counts()
            for step in range(SCALER_STEPS + poison_steps):
                before = [p.detach().clone() for p in net.parameters()] \
                    if step >= SCALER_STEPS else None
                with rng.key_guard(rng.split_for_step(step)), \
                        amp.auto_cast(dtype="float16"):
                    hidden, w = net(xs[step])
                loss = crit(hidden, w, ys[step]).float()
                if before is not None:
                    loss = loss * float("nan")
                scaler.scale(loss).backward()
                scaler.step(opt, {k: p.grad for k, p in
                                  net.named_parameters()})
                opt.clear_grad()
                losses.append(loss.detach())
                scales.append(scaler.state_dict()["scale"])
                if before is not None:
                    unchanged.append(all(torch.equal(a, b) for a, b in
                                         zip(before, net.parameters())))
            if dev == "cuda":
                torch.cuda.synchronize()
            counts = _flash_counts()
        finally:
            fa.impl = "kernel"
            fa.flash_attention = real_flash
        gauge = obs.default_registry().get("amp_loss_scale").value
        return ([float(v) for v in losses], scales, unchanged, counts,
                gauge == scaler.state_dict()["scale"])

    k_losses, scales, unchanged, k_counts, gauge_ok = run("kernel", 2)
    p_losses, _, _, p_counts, _ = run("plain")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(k_losses[:SCALER_STEPS], p_losses)]
    return {"kernel_losses": k_losses[:SCALER_STEPS],
            "plain_losses": p_losses, "rel_diff": rel,
            "poisoned_losses": k_losses[SCALER_STEPS:], "scales": scales,
            "poisoned_steps_left_params": unchanged,
            "kernel_launches": k_counts, "plain_launches": p_counts,
            "attention_dtypes": sorted(seen), "gauge_equals_scale": gauge_ok}


def _remat_runs(init, ids, dev):
    """REMAT_STEPS train steps of remat, scan_layers and both against
    the plain model from the same weights (dropout 0), with B1-B3's
    launches; the peak of one fwd+bwd with remat against without."""
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    xs, ys = ids[:, :, :-1], ids[:, :, 1:]
    runs = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("scan", {"scan_layers": True}),
                     ("scan+remat", {"scan_layers": True, "remat": True})):
        net = _loop_net(init, dev, **kw)
        model = _loop_model(net)
        _reset_flash_counts()
        losses = [model.train_batch([xs[i]], [ys[i]])["loss"]
                  for i in range(REMAT_STEPS)]
        if dev == "cuda":
            torch.cuda.synchronize()
        counts = _flash_counts()
        del model
        peak = None
        if dev == "cuda" and name in ("plain", "remat"):
            net.load_state_dict(init)
            net.train()
            peak, _ = _peak_fwd_bwd(net, GPTFusedPretrainingCriterion(),
                                    xs[0])
        runs[name] = {"losses": [float(v) for v in losses],
                      "launches": counts, "peak_fwd_bwd": peak}
        del net
        if dev == "cuda":
            torch.cuda.empty_cache()
    # step wall time, plain (P) and remat (R) in turns: P R R P
    nets = {"P": _loop_net(init, dev), "R": _loop_net(init, dev, remat=True)}
    models = {k: _loop_model(n) for k, n in nets.items()}
    for m in models.values():
        m.train_batch([xs[0]], [ys[0]])
    step_s = {f"{k}{i}": _timed_steps(
        lambda: [models[k].train_batch([xs[j]], [ys[j]])
                 for j in range(REMAT_STEPS)], REMAT_STEPS, dev)
        for i, k in enumerate("PRRP")}
    del models, nets
    runs["step_s"] = step_s
    runs["remat_over_plain"] = (step_s["R1"] + step_s["R2"]) / \
        (step_s["P0"] + step_s["P3"])
    base = runs["plain"]["losses"]
    for name, r in runs.items():
        if name in ("step_s", "remat_over_plain"):
            continue
        r["rel_diff"] = max(abs(a - b) / abs(b)
                            for a, b in zip(r["losses"], base))
        r["bit_identical"] = r["losses"] == base
    return runs


def _decoder_runs(init, ids, dev):
    """GPTGreedyDecoder against generate's greedy stream, one prompt at
    a time (DECODE_PROMPTS tokens, DECODE_NEW new tokens each)."""
    from paddle_tpu_torch.models.gpt import GPTGreedyDecoder
    net = _loop_net(init, dev, fused_loss=False).eval()
    dec = GPTGreedyDecoder(net, DECODE_NEW)
    flat = ids.reshape(-1)
    out = []
    _reset_flash_counts()
    t0 = time.perf_counter()
    for i, n in enumerate(DECODE_PROMPTS):
        prompt = flat[i * 300:i * 300 + n][None]
        got = dec(prompt)
        want = net.generate(prompt, max_new_tokens=DECODE_NEW)
        out.append(torch.equal(got.long(), want.long()))
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    del dec, net
    return {"prompts": list(DECODE_PROMPTS), "new_tokens": DECODE_NEW,
            "equal_to_generate": out, "launches": counts,
            "wall_s_decoder_and_generate": wall}


def _optimizer_runs(init, ids, dev):
    """The gradients of one O1 fwd+bwd on B1-B3; each new optimizer's
    OPT_STEPS updates on ``dev`` and on the CPU from the same
    parameters and gradients (float32), over the parameters outside the
    blocks and those of the first OPT_LAYERS blocks: ||delta_dev -
    delta_cpu|| / ||delta_cpu|| over those parameters, and the state
    bytes."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPTFusedPretrainingCriterion
    net = _loop_net(init, dev)
    net.train()
    with amp.auto_cast(level="O1"):
        hidden, w = net(ids[0, :, :-1])
    GPTFusedPretrainingCriterion()(hidden, w, ids[0, :, 1:]).float(
    ).backward()
    kept = [(k, p) for k, p in net.named_parameters()
            if not re.match(r"gpt\.layers\.(\d+)\.", k) or
            int(k.split(".")[2]) < OPT_LAYERS]
    grads = {k: p.grad.detach() for k, p in kept}
    params = {k: p.detach() for k, p in kept}
    cpu_p = {k: v.cpu() for k, v in params.items()}
    cpu_g = {k: v.cpu() for k, v in grads.items()}
    out = {}
    for name in NEW_OPTIMIZERS:
        res, final = {}, {}
        for where, p0, g in (("dev", params, grads),
                             ("cpu", cpu_p, cpu_g)):
            opt = getattr(pt.optimizer, name)()
            p, st = dict(p0), opt.init_state(p0)
            for step in range(OPT_STEPS):
                p, st = opt.apply_gradients(p, g, st, step)
            res[where] = ({k: (p[k] - p0[k]).cpu() for k in p0}, st)
            final[where] = {k: v.cpu() for k, v in p.items()}
        params_close = all(
            float((final["dev"][k] - final["cpu"][k]).norm()) <=
            OPT_RTOL * float(final["cpu"][k].norm()) for k in cpu_p)
        del final
        dd, dc = res["dev"][0], res["cpu"][0]
        num = math.sqrt(sum(float((dd[k] - dc[k]).double().square().sum())
                            for k in dc))
        den = math.sqrt(sum(float(dc[k].double().square().sum())
                            for k in dc))
        state_bytes = sum(t.numel() * t.element_size() for t in
                          _tensors(res["dev"][1]))
        out[name] = {"params_within_rtol": params_close,
                     "delta_rel_err": num / den if den else None,
                     "max_abs_delta_diff": max(
                         float((dd[k] - dc[k]).abs().max()) for k in dc),
                     "state_bytes": state_bytes}
        del res, dd, dc
    del net, grads, params, cpu_p, cpu_g
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def phase_train_loop(dev="cuda") -> dict:
    """The rest of the training path at gpt2-small's full width on
    B1-B3: the K-step loop, the numeric guard, GradScaler in float16,
    remat and scan_layers, GPTGreedyDecoder and the other optimizers,
    each against its reference on the same weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True)
    pt.seed(0)
    net = GPTForCausalLM(cfg, device=dev)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    del net
    rs = np.random.RandomState(7)
    ids = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                     (LOOP_STEPS, TRAIN_BATCH,
                                      TRAIN_SEQ + 1)), device=dev)
    t0 = time.perf_counter()
    loop = _k_loop_runs(init, ids, dev, cfg.vocab_size)
    t_loop = time.perf_counter() - t0
    profile = loop.pop("profile")
    emit({"phase": "train_loop", "run": "K-step loop", "k": LOOP_K,
          "steps": LOOP_STEPS, "dropout": "hidden 0.1, attention 0",
          "seconds": t_loop, **loop})
    if profile is not None:
        emit(profile)
    t0 = time.perf_counter()
    grd = _guard_runs(init, ids, dev)
    emit({"phase": "train_loop", "run": "numeric guard",
          "seconds": time.perf_counter() - t0, **grd})
    t0 = time.perf_counter()
    scl = _scaler_runs(init, ids, dev)
    emit({"phase": "train_loop", "run": "GradScaler float16",
          "seconds": time.perf_counter() - t0, **scl})
    t0 = time.perf_counter()
    rem = _remat_runs(init, ids, dev)
    emit({"phase": "train_loop", "run": "remat and scan_layers",
          "seconds": time.perf_counter() - t0, **rem})
    t0 = time.perf_counter()
    dec = _decoder_runs(init, ids, dev)
    emit({"phase": "train_loop", "run": "GPTGreedyDecoder",
          "seconds": time.perf_counter() - t0, **dec})
    t0 = time.perf_counter()
    opt = _optimizer_runs(init, ids, dev)
    emit({"phase": "train_loop", "run": "optimizers", "steps": OPT_STEPS,
          "layers": OPT_LAYERS, "seconds": time.perf_counter() - t0,
          "rtol": OPT_RTOL,
          "delta_rtol": OPT_DELTA_RTOL, "optimizers": opt})

    layers = cfg.num_layers
    per_step = {k: layers for k in ("flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")}
    remat_want = {k: v * REMAT_STEPS for k, v in per_step.items()}
    remat_want["flash_attention_fwd"] *= 2
    one_gib = 1 << 30
    checks = {
        "k_loop_losses_equal_train_batch": loop["losses"] ==
        loop["train_batch_losses"],
        "k_loop_params_equal_train_batch": loop["params_equal"],
        "k_loop_launches": loop["launches"] ==
        {k: v * LOOP_STEPS for k, v in per_step.items()},
        "k_loop_no_syncs": loop["syncs"] == 0,
        "fit_k4_losses_equal_k1": loop["fit_k4_losses"] ==
        loop["fit_k1_losses"] and loop["fit_steps"] == 10,
        "fit_k4_events_equal_k1": loop["fit_events_equal"],
        "losses_finite": all(math.isfinite(v) for v in loop["losses"]),
        "guard_verdicts": grd["verdicts"] == [0, 0, 1, 0],
        "guard_skipped_one": grd["skipped"] == 1,
        "guard_no_syncs": grd["syncs"] == 0,
        "guard_params_equal_minus_batch": grd["params_equal_minus_batch"],
        "guard_opt_state_equal_minus_batch":
            grd["opt_state_equal_minus_batch"],
        "guard_abort_report": grd["abort"] is not None and
        "non-finite tensors" in grd["abort"],
        "guard_rollback_escalates": grd["rollback"] is not None and
        "no checkpoint_dir" in grd["rollback"],
        "scaler_losses_match_twins": max(scl["rel_diff"]) <=
        TRAIN_LOSS_RTOL,
        "scaler_launches": scl["kernel_launches"] ==
        {k: v * (SCALER_STEPS + 2) for k, v in per_step.items()} and
        all(v == 0 for v in scl["plain_launches"].values()),
        "scaler_attention_f16": scl["attention_dtypes"] ==
        ["torch.float16"],
        "scaler_poison_leaves_params": scl["poisoned_steps_left_params"]
        == [True, True],
        "scaler_halved_after_two_bad_steps":
            scl["scales"][SCALER_STEPS] == scl["scales"][0] and
            scl["scales"][-1] == scl["scales"][0] / 2,
        "scaler_gauge_equals_scale": scl["gauge_equals_scale"],
        "remat_scan_losses_match_plain": all(
            rem[n]["rel_diff"] <= TRAIN_LOSS_RTOL
            for n in ("remat", "scan", "scan+remat")),
        "remat_launches": rem["remat"]["launches"] == remat_want and
        rem["scan+remat"]["launches"] == remat_want,
        "scan_launches": rem["scan"]["launches"] ==
        {k: v * REMAT_STEPS for k, v in per_step.items()},
        "remat_peak_1GiB_lower": dev != "cuda" or
        rem["plain"]["peak_fwd_bwd"] - rem["remat"]["peak_fwd_bwd"] >=
        one_gib,
        "decoder_equals_generate": all(dec["equal_to_generate"]),
        "decoder_launches_nothing": all(
            v == 0 for v in dec["launches"].values()),
        "optimizers_params_match_cpu": all(
            o["params_within_rtol"] for o in opt.values()),
        "optimizers_updates_match_cpu": all(
            o["delta_rel_err"] is not None and
            o["delta_rel_err"] <= OPT_DELTA_RTOL for o in opt.values()),
    }
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "train_loop_checks", "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"train_loop checks failed: {failed}")
    return loop["launches"]


# ---------------------------------------------------------------------------
# distributed: multi-rank training on torch.distributed
# ---------------------------------------------------------------------------

DIST_STEPS = 3                   # train steps of each dp / fsdp / nccl run
DIST_FIT_LAYERS, DIST_FIT_STEPS, DIST_FIT_CKPT = 2, 8, 4
DIST_PREEMPT = "5@0"             # node 1 preempted after step 5, gen 0
DIST_TIMEOUT_S = 300


def _dist_net(layers=None):
    """The train cell's gpt2-small (full width, seq 1024, fused loss,
    dropout 0, weights from ``seed(0)``) on this process's card; with
    ``layers``, that many blocks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    kw = {"num_layers": layers} if layers else {}
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True, **kw)
    pt.seed(0)
    return GPTForCausalLM(cfg, device=f"cuda:{torch.cuda.current_device()}")


def _dist_ids(n):
    """``n`` global batches (TRAIN_BATCH x TRAIN_SEQ ids), drawn from a
    seed: every rank passes the same global batch."""
    return np.random.RandomState(0).randint(0, 50304,
                                            (n, TRAIN_BATCH, TRAIN_SEQ))


def _param_digest(model) -> str:
    """An exact digest of every trainable parameter's bits (integer sums
    on the card, order-free), of the whole tensors on a mesh (fsdp
    shards, tp slices and pp stages gathered: a collective)."""
    import hashlib
    sums = []
    with model._unsharded():
        params = {k: p.detach() for k, p in
                  sorted(model._trainable().items())}
        if model._sync is not None:
            params = model._sync.full_tree(params, fsdp=False)
        for k, p in sorted(params.items()):
            bits = p.contiguous().view(torch.int32).reshape(-1)
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            sums.append(int((bits.long() * w).sum()))
    return hashlib.sha256(str(sums).encode()).hexdigest()[:16]


def _dist_steps(model, ids, n, digest=True):
    losses, digests, walls = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.train_batch([ids[i]], [ids[i]])["loss"]
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if digest:
            digests.append(_param_digest(model))
    return losses, digests, walls


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _resident_bytes(model) -> dict:
    """Parameter and optimizer-state bytes this rank holds between
    steps (fsdp: its shards; freed full parameters hold none)."""
    params = {k: p for k, p in model.network.named_parameters()}
    if model._sync is not None:
        params.update(model._sync.shards)
    return {"params": _tree_bytes(params),
            "opt_state": _tree_bytes(model._opt_state),
            "memory_allocated": torch.cuda.memory_allocated()}


def _gloo_cuda_probe() -> dict:
    """Which collectives gloo carries on CUDA tensors here (the port
    stages every gloo collective of a CUDA tensor through pinned host
    memory whatever this says)."""
    import torch.distributed as dist
    out = {}
    x = torch.ones(8, device="cuda")
    for name, call in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(8 * dist.get_world_size(), device="cuda"), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // dist.get_world_size(), device="cuda"),
                x))):
        try:
            call()
            torch.cuda.synchronize()
            out[name] = True
        except Exception as e:  # noqa: BLE001 — the probe's answer
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def dist_rank(scenario: str, outdir: str, t_launch: float) -> None:
    """The body of one rank of the distributed phase (run by the port's
    launcher as ``python3 chip_smoke.py --dist-rank <scenario> <dir>
    <launch time>``); writes ``rank<r>.json`` into ``dir``."""
    import torch.distributed as dist

    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import fleet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    res = {"scenario": scenario}
    if scenario == "nccl1":
        fleet.init(is_collective=True)      # NCCL on cuda:{local rank}
    else:
        # two ranks share the one card: gloo, backend and device given
        fleet.init(is_collective=True, backend="gloo", device="cuda:0")
    rank = dist.get_rank()
    res.update(rank=rank, world=dist.get_world_size(),
               backend=dist.get_backend())
    if scenario == "fit":
        _dist_fit(outdir, rank, res, t_launch)
    elif scenario in ("mp2", "mp4"):
        _mp_rank(scenario, outdir, rank, res, t_launch)
    elif scenario in ("sp2", "sp4"):
        _sp_rank(scenario, outdir, rank, res, t_launch)
    elif scenario == "ep2":
        _moe_rank(outdir, rank, res, t_launch)
    elif scenario == "ctr2":
        _ctr_rank(outdir, rank, res)
    else:
        net = _dist_net()
        init = {k: v.detach().clone() for k, v in net.state_dict().items()}
        ids = _dist_ids(DIST_STEPS)
        runs = (("plain", None), ("mesh", "dp"), ("mesh", "dp"),
                ("plain", None)) if scenario == "nccl1" else \
            (("dp2", "dp"), ("fsdp2", "fsdp"))
        res["runs"] = []
        for label, axis in runs:
            with torch.no_grad():
                for k, v in net.state_dict().items():
                    v.copy_(init[k])
            model = _train_model(net)
            if axis == "dp" and scenario == "nccl1":
                fleet.distributed_model(model)   # a dp=1 mesh
            elif axis:
                parallel.distributed_model(
                    model, mesh=parallel.DeviceMesh(**{axis: 2}))
            _reset_flash_counts()
            if "first_step_s" not in res:
                res["first_step_s"] = time.time() - t_launch
            losses, digests, walls = _dist_steps(
                model, ids, DIST_STEPS, digest=scenario != "nccl1")
            run = {"label": label, "losses": losses, "digests": digests,
                   "step_s": walls, "launches": _flash_counts()}
            if model._sync is not None:
                run["reduce_s_per_step"] = \
                    model._sync.reduce_seconds / DIST_STEPS
                run["mesh"] = repr(model._mesh)
            run.update(_resident_bytes(model))
            name = "gpt.layers.0.mlp.fc_in.weight"
            local = (model._sync.shards.get(name) if model._sync else None)
            run["fc_in_local_shape"] = list(
                local.shape if local is not None
                else net.get_parameter(name).shape)
            if scenario != "nccl1" and label == "dp2":
                prof = _profile_steps_dist(model, ids, rank)
                if prof is not None:
                    run["profile"] = prof
            res["runs"].append(run)
            del model
            torch.cuda.empty_cache()
        if scenario != "nccl1":
            res["gloo_cuda"] = _gloo_cuda_probe()
            # the uninterrupted 2-rank fit the 2-node job is held to
            fit_dir = os.path.join(outdir, "fit")
            os.makedirs(fit_dir, exist_ok=True)
            fit = {}
            _dist_fit(fit_dir, rank, fit, t_launch)
            res["fit"] = fit
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    parallel.barrier()


def _profile_steps_dist(model, ids, rank):
    """Rank 0 profiles two more dp=2 steps (the other rank steps with
    it, unprofiled): device time by kernel and the host's share."""
    red0 = model._sync.reduce_seconds
    if rank != 0:
        for i in range(2):
            model.train_batch([ids[i]], [ids[i]])
        torch.cuda.synchronize()
        return None

    def work():
        for i in range(2):
            model.train_batch([ids[i]], [ids[i]])
    out = _profile(work, 2, "step", phase="distributed", run="dp2 rank 0")
    out["grad_reduce_ms_per_step"] = \
        (model._sync.reduce_seconds - red0) / 2 * 1e3
    return out


def _dist_fit(outdir, rank, res, t_launch):
    """A checkpointed ``fit`` of DIST_FIT_LAYERS blocks at full width,
    data-parallel over the ranks; rank 0 logs each step's loss. With
    ``MN_PREEMPT`` "s@g" the last rank exits 67 after step s in
    generation g (a PreemptionGuard), and the job resumes from the
    newest checkpoint."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.callbacks import Callback
    from paddle_tpu_torch.distributed import elastic
    from paddle_tpu_torch.io import Dataset
    world = parallel.get_world_size()
    gen = elastic.restart_count()
    preempt = set()
    for part in filter(None, os.environ.get("MN_PREEMPT", "").split(",")):
        a, b = part.split("@")
        preempt.add((int(a), int(b)))
    model = _train_model(_dist_net(DIST_FIT_LAYERS))
    parallel.distributed_model(model, mesh=parallel.DeviceMesh(dp=world))
    rows = _dist_ids(DIST_FIT_STEPS).reshape(-1, TRAIN_SEQ)

    class Rows(Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i], rows[i]

    guard = None
    if rank == world - 1 and preempt:
        from paddle_tpu_torch.distributed import PreemptionGuard
        guard = PreemptionGuard(install=False)

    class Log(Callback):
        def on_train_batch_end(self, step, logs=None):
            s = model._step_count - 1
            if "first_step_s" not in res:
                res["first_step_s"] = time.time() - t_launch
            if rank == 0:
                with open(os.path.join(outdir, "losses.txt"), "a") as f:
                    f.write(f"{s} {float(logs['loss'])!r} {gen}\n")
            if guard is not None and (s, gen) in preempt:
                guard.trigger()

    _reset_flash_counts()
    model.fit(Rows(), batch_size=TRAIN_BATCH, epochs=1, shuffle=False,
              verbose=0, callbacks=[Log()],
              checkpoint_dir=os.path.join(outdir, "ckpt"),
              checkpoint_freq=DIST_FIT_CKPT, resume="auto",
              async_checkpoint=False, preemption_guard=guard)
    res["generation"] = gen
    res["launches"] = _flash_counts()


def _launch(args, logdir, env_extra=None, nnodes_rank=None):
    """Start the port's launcher on ``args`` (its own session, so the
    whole group can be killed)."""
    os.makedirs(logdir, exist_ok=True)
    env = dict(os.environ, PADDLE_MASTER_HOST="127.0.0.1")
    env.update(env_extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--log_dir", logdir, *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def _finish(procs, what, logdir):
    """Wait for launcher processes; on a failure or a timeout, kill the
    groups and fail with the ranks' logs."""
    import signal
    deadline = time.time() + DIST_TIMEOUT_S
    outs, bad = [], []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            out, bad = b"(timed out)", bad + [p]
        outs.append(out.decode(errors="replace"))
        if p.returncode != 0:
            bad.append(p)
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if bad:
        logs = ""
        for name in sorted(os.listdir(logdir)) if os.path.isdir(logdir) \
                else []:
            with open(os.path.join(logdir, name), errors="replace") as f:
                logs += f"--- {name}\n{f.read()[-3000:]}\n"
        raise SystemExit(f"distributed {what} failed: "
                         f"{[o[-2000:] for o in outs]}\n{logs}")


def _finish_together(jobs):
    """Wait for launcher jobs started at once, ``[(tag, outdir, t0,
    proc)]``, in order: each one's ``(outdir, seconds)``. A job that fails
    kills the groups of those not yet waited for before its error."""
    import signal
    out = []
    for i, (tag, outdir, t0, proc) in enumerate(jobs):
        try:
            _finish([proc], tag, os.path.join(outdir, "logs"))
        except BaseException:
            for *_, other in jobs[i + 1:]:
                if other.poll() is None:
                    os.killpg(other.pid, signal.SIGKILL)
                    other.wait()
            raise
        out.append((outdir, time.time() - t0))
    return out


def _read_ranks(outdir, n):
    out = []
    for r in range(n):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _read_losses(path):
    got = {}
    for line in open(path):
        s, v, _ = line.split()
        got[int(s)] = float(v)
    return [got[s] for s in sorted(got)]


def phase_distributed(info) -> dict:
    """Multi-rank training of the train cell on the one card: the dp=1
    mesh on NCCL against no mesh (A B B A), dp=2 and fsdp=2 with two gloo
    ranks sharing the card against this process's single-process run,
    then (in the same ``launch --nproc_per_node 2`` job) an uninterrupted
    checkpointed fit that a 2-node job (``launch --nnodes 2
    --rdzv_backend tcp``), preempted once, is held to. Returns the B1-B3
    launches the ranks counted in the dp / fsdp runs."""
    import shutil
    import paddle_tpu_torch  # noqa: F401 — the launcher's package
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "distributed")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    me = os.path.basename(os.path.abspath(__file__))

    # the single-process reference: the same 3 steps, no mesh, here
    net = _dist_net()
    model = _train_model(net)
    ids = _dist_ids(DIST_STEPS)
    base_losses, _, base_walls = _dist_steps(model, ids, DIST_STEPS,
                                             digest=False)
    _SINGLE.update(losses=base_losses, step_s=base_walls)
    del model, net
    torch.cuda.empty_cache()

    def start(tag, nproc, scenario):
        outdir = os.path.join(root, tag)
        os.makedirs(outdir)
        t0 = time.time()
        p = _launch(["--nproc_per_node", str(nproc), me, "--dist-rank",
                     scenario, outdir, repr(t0)], os.path.join(outdir,
                                                               "logs"))
        return tag, outdir, t0, p

    # the NCCL job and the two gloo ranks run at once, sharing the card
    # and the host's cores (their step times are reported, not checked)
    (d_nccl, s_nccl), (d_two, s_two) = _finish_together(
        [start("nccl1", 1, "nccl1"), start("dp_fsdp", 2, "dpfsdp")])
    nccl = _read_ranks(d_nccl, 1)[0]
    two = _read_ranks(d_two, 2)
    ref_losses = _read_losses(os.path.join(d_two, "fit", "losses.txt"))
    # the 2-node job: one agent a node, the leader hosting the tcp store
    d_mn = os.path.join(root, "multinode")
    os.makedirs(d_mn)
    from paddle_tpu_torch.distributed.launch import find_free_port
    ep = f"127.0.0.1:{find_free_port()}"
    t0 = time.time()
    agents = [_launch(["--nnodes", "2", "--node_rank", str(n),
                       "--nproc_per_node", "1", "--rdzv_backend", "tcp",
                       "--rdzv_endpoint", ep, "--max_restarts", "0",
                       "--node_timeout", "10", me, "--dist-rank", "fit",
                       d_mn, repr(t0)], os.path.join(d_mn, f"logs{n}"),
                      {"MN_PREEMPT": DIST_PREEMPT}) for n in (0, 1)]
    _finish(agents, "multinode", os.path.join(d_mn, "logs1"))
    s_mn = time.time() - t0
    mn_losses = _read_losses(os.path.join(d_mn, "losses.txt"))
    mn_lines = open(os.path.join(d_mn, "losses.txt")).read().split("\n")
    generations = sorted({int(x.split()[2]) for x in mn_lines if x})

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def mean(xs):   # the steps after the first (which warms up)
        return sum(xs[1:]) / len(xs[1:])
    n_layers = 12
    per_step = {k: n_layers for k in ("flash_attention_fwd",
                                      "flash_attention_bwd_dq",
                                      "flash_attention_bwd_dkv")}
    a1, b1, b2, a2 = nccl["runs"]
    dp = [r["runs"][0] for r in two]
    fs = [r["runs"][1] for r in two]
    checks = {
        "nccl_backend": nccl["backend"] == "nccl" and nccl["world"] == 1,
        "nccl_dp1_equals_no_mesh": a1["losses"] == b1["losses"] ==
        b2["losses"] == a2["losses"],
        "nccl_dp1_launches_12_a_step": all(
            v == per_step[k] * DIST_STEPS for r in (b1, b2)
            for k, v in r["launches"].items()),
        "gloo_two_ranks": all(r["backend"] == "gloo" and r["world"] == 2
                              for r in two),
        "dp2_ranks_equal": dp[0]["losses"] == dp[1]["losses"] and
        dp[0]["digests"] == dp[1]["digests"],
        "fsdp2_ranks_equal": fs[0]["losses"] == fs[1]["losses"] and
        fs[0]["digests"] == fs[1]["digests"],
        "dp2_within_rtol": rel(dp[0]["losses"], base_losses) <=
        TRAIN_LOSS_RTOL,
        "fsdp2_within_rtol": rel(fs[0]["losses"], base_losses) <=
        TRAIN_LOSS_RTOL,
        "ranks_launch_12_a_step": all(
            v == per_step[k] * DIST_STEPS for r in dp + fs
            for k, v in r["launches"].items()),
        "fsdp_holds_half": all(r["fc_in_local_shape"] == [384, 3072]
                               for r in fs) and
        all(r["fc_in_local_shape"] == [768, 3072] for r in dp),
        "fsdp_state_bytes_le_055_dp": all(
            f["params"] + f["opt_state"] <=
            0.55 * (d["params"] + d["opt_state"])
            for f, d in zip(fs, dp)),
        "multinode_preempted_and_resumed": generations == [0, 1],
        "multinode_losses_equal_uninterrupted": len(ref_losses) ==
        DIST_FIT_STEPS and mn_losses == ref_losses,
    }
    base_step = mean(base_walls)
    out = {
        "phase": "distributed", "card": info["nvidia_smi"],
        "single_losses": base_losses, "single_step_s": base_walls,
        "nccl_dp1": {"runs_ABBA_step_s": [mean(r["step_s"]) for r in
                                          (a1, b1, b2, a2)],
                     "losses": b1["losses"], "launches": b1["launches"],
                     "mesh_over_plain": (mean(b1["step_s"]) +
                                         mean(b2["step_s"])) /
                     (mean(a1["step_s"]) + mean(a2["step_s"]))},
        "dp2": dp, "fsdp2": fs,
        "dp2_step_over_single": mean(dp[0]["step_s"]) / base_step,
        "fsdp2_step_over_single": mean(fs[0]["step_s"]) / base_step,
        "grad_reduce_s_per_step": {"dp2": dp[0]["reduce_s_per_step"],
                                   "fsdp2": fs[0]["reduce_s_per_step"]},
        "fsdp_over_dp_state_bytes": (fs[0]["params"] + fs[0]["opt_state"])
        / (dp[0]["params"] + dp[0]["opt_state"]),
        "spawn_to_first_step_s": {"nccl1": nccl["first_step_s"],
                                  "dp_fsdp": [r["first_step_s"]
                                              for r in two]},
        "gloo_cuda": two[0]["gloo_cuda"],
        "profile_dp2_rank0": dp[0].get("profile"),
        "fit": {"uninterrupted": ref_losses, "multinode": mn_losses,
                "generations": generations, "layers": DIST_FIT_LAYERS,
                "checkpoint_freq": DIST_FIT_CKPT, "preempt": DIST_PREEMPT},
        "job_s": {"nccl1": s_nccl, "dp_fsdp_fit": s_two,
                  "multinode": s_mn},
        "phase_s": time.perf_counter() - t_phase}
    emit(out)
    emit({"phase": "distributed_checks", **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"distributed phase failed: {bad}")
    launches = {k: 0 for k in per_step}
    for r in [b1, b2] + dp + fs:
        for k, v in r["launches"].items():
            launches[k] += v
    return launches


# ---------------------------------------------------------------------------
# model_parallel: tensor and pipeline parallelism on torch.distributed
# ---------------------------------------------------------------------------

MP_STEPS, MP_PPTP_STEPS, MP_MICRO = 3, 1, 4
MP_TP_SHAPES = {   # the tp=2 rank's slices of the split weights
    "gpt.layers.0.attn.qkv_proj.weight": [768, 1152],
    "gpt.layers.0.attn.out_proj.weight": [384, 768],
    "gpt.layers.0.mlp.fc_in.weight": [768, 1536],
    "gpt.layers.0.mlp.fc_out.weight": [1536, 768],
    "gpt.embeddings.word_embeddings.weight": [25152, 768]}
_SINGLE: dict = {}   # the distributed phase's one-process run


def _pipe_state(dense, layers, pp, v):
    """The state of a ``GPTForCausalLMPipe`` (pp x v chunks) holding the
    weights of a dense ``GPTForCausalLM`` state dict: the blocks' tensors
    stacked in the pipeline's round-robin chunk order."""
    S, out = pp * v, {}
    per = layers // S
    order = [c * pp + r for r in range(pp) for c in range(v)]
    for k, t in dense.items():
        if k.startswith(("gpt.embeddings.", "gpt.ln_f.")):
            out[k[len("gpt."):]] = t
    for sfx in sorted({k.split(".", 3)[3] for k in dense
                       if k.startswith("gpt.layers.")}):
        name = sfx.replace(".", "__")
        if per > 1:
            out[f"pipe.{name}"] = torch.stack([torch.stack(
                [dense[f"gpt.layers.{c * per + j}.{sfx}"]
                 for j in range(per)]) for c in order])
        else:
            out[f"pipe.0__{name}"] = torch.stack(
                [dense[f"gpt.layers.{c}.{sfx}"] for c in order])
    return out


def _pipe_net(v, mesh):
    """The train cell's weights (``_dist_net``) in a pipelined net."""
    from paddle_tpu_torch.interop import load_reference_state
    from paddle_tpu_torch.models.gpt import GPTForCausalLMPipe
    dense = _dist_net()
    sd = {k: t.detach().cpu() for k, t in dense.state_dict().items()}
    cfg = dense.cfg
    del dense
    net = GPTForCausalLMPipe(cfg, MP_MICRO, v, mesh=mesh,
                             device=f"cuda:{torch.cuda.current_device()}")
    load_reference_state(net, {k: t.numpy() for k, t in _pipe_state(
        sd, cfg.num_layers, mesh.axis_size("pp") if mesh else 1,
        v).items()})
    return net


def _mp_run(label, model, ids, n):
    """``n`` steps of a Model on its mesh: losses, walls, B1-B3
    launches, the tp all-reduce and gradient-reduction seconds, and the
    gathered parameter digest after the last step."""
    from paddle_tpu_torch.parallel import collective as coll
    _reset_flash_counts()
    coll.tp_seconds = 0.0
    losses, _, walls = _dist_steps(model, ids, n, digest=False)
    run = {"label": label, "losses": losses, "step_s": walls,
           "launches": _flash_counts(),
           "tp_allreduce_s_per_step": coll.tp_seconds / n,
           "mesh": repr(model._mesh)}
    if model._sync is not None:
        run["reduce_s_per_step"] = model._sync.reduce_seconds / n
    run["digest"] = _param_digest(model)
    return run


def _mp_rank(scenario, outdir, rank, res, t_launch):
    """The model_parallel phase's rank body: ``mp2`` (tp=2, pp=2 at v 1
    and 2, the planner) or ``mp4`` (pp=2 x tp=2)."""
    from paddle_tpu_torch import parallel
    ids = _dist_ids(MP_STEPS)
    res["runs"] = []
    res["first_step_s"] = time.time() - t_launch
    if scenario == "mp4":
        mesh = parallel.DeviceMesh(pp=2, tp=2)
        model = _train_model(_pipe_net(1, mesh))
        parallel.distributed_model(model, mesh=mesh)
        res["runs"].append(_mp_run("pp2xtp2", model, ids, MP_PPTP_STEPS))
        return
    mesh = parallel.DeviceMesh(tp=2)
    model = _train_model(_dist_net())
    parallel.distributed_model(model, mesh=mesh)
    run = _mp_run("tp2", model, ids, MP_STEPS)
    run["local_shapes"] = {k: list(model.network.get_parameter(k).shape)
                           for k in MP_TP_SHAPES}
    model.save(os.path.join(outdir, "tp2_saved"), training=False)
    res["runs"].append(run)
    del model
    torch.cuda.empty_cache()
    pp_mesh = parallel.DeviceMesh(pp=2)
    for v in (1, 2):
        model = _train_model(_pipe_net(v, pp_mesh))
        parallel.distributed_model(model, mesh=pp_mesh)
        run = _mp_run(f"pp2_v{v}", model, ids, MP_STEPS)
        if v == 1:
            model.save(os.path.join(outdir, "pp2_saved"), training=False)

            def work():
                model.train_batch([ids[0]], [ids[0]])
            try:   # this rank's device idle share: the bubble
                run["profile"] = _profile(work, 1, "step",
                                          phase="model_parallel",
                                          run=f"pp2 v1 rank {rank}")
            except Exception as e:  # noqa: BLE001 — reported, not fatal
                run["profile"] = {"error": f"{type(e).__name__}: {e}"}
        res["runs"].append(run)
        del model
        torch.cuda.empty_cache()
    # the planner: distributed_model(global_batch=...) picks the mesh
    from paddle_tpu_torch.parallel import planner
    model = _train_model(_dist_net())
    parallel.set_mesh(None)
    parallel.distributed_model(model, global_batch=TRAIN_BATCH)
    run = _mp_run("planner", model, ids, 1)
    report, used = planner.verify_plan(model, [ids[1]], [ids[1]],
                                       replan=False)
    run.update(plan=model._plan.describe(), axes=dict(used.axes),
               breakdown=used.breakdown, **report)
    parallel.set_mesh(None)
    res["runs"].append(run)


def phase_model_parallel(info) -> dict:
    """tp, pp and pp x tp meshes of the train cell on the card, against
    the distributed phase's one-process run (see the module docstring).
    Returns the B1-B3 launches the ranks counted."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "model_parallel")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    me = os.path.basename(os.path.abspath(__file__))
    if not _SINGLE:   # run alone: the one-process reference here
        model = _train_model(_dist_net())
        losses, _, walls = _dist_steps(model, _dist_ids(DIST_STEPS),
                                       DIST_STEPS, digest=False)
        _SINGLE.update(losses=losses, step_s=walls)
        del model
        torch.cuda.empty_cache()

    def start(tag, nproc):
        outdir = os.path.join(root, tag)
        os.makedirs(outdir)
        t0 = time.time()
        p = _launch(["--nproc_per_node", str(nproc), me, "--dist-rank",
                     tag, outdir, repr(t0)], os.path.join(outdir, "logs"))
        return tag, outdir, t0, p

    # both jobs at once, sharing the card and the host's cores (their
    # step times are reported, not checked)
    (d2, s2), (d4, s4) = _finish_together([start("mp2", 2),
                                           start("mp4", 4)])
    two, four = _read_ranks(d2, 2), _read_ranks(d4, 4)

    def runs(ranks, label):
        return [next(x for x in r["runs"] if x["label"] == label)
                for r in ranks]

    # the saved meshes reloaded into one process (this one)
    from paddle_tpu_torch import parallel
    reloaded = {}
    for label, path in (("tp2", "tp2_saved"), ("pp2_v1", "pp2_saved")):
        net = _dist_net() if label == "tp2" else _pipe_net(
            1, parallel.DeviceMesh(devices=2, pp=2))
        model = _train_model(net)
        model.load(os.path.join(d2, path), reset_optimizer=True)
        reloaded[label] = _param_digest(model)
        del model, net
        torch.cuda.empty_cache()

    base = _SINGLE["losses"]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def mean(xs):   # the steps after the first (which warms up)
        return sum(xs[1:]) / len(xs[1:]) if len(xs) > 1 else xs[0]
    blocks, n_layers = 6, 12
    want = {"tp2": {"flash_attention_fwd": n_layers,
                    "flash_attention_bwd_dq": n_layers,
                    "flash_attention_bwd_dkv": n_layers}}
    pp_step = {"flash_attention_fwd": 2 * blocks * MP_MICRO,
               "flash_attention_bwd_dq": blocks * MP_MICRO,
               "flash_attention_bwd_dkv": blocks * MP_MICRO}
    for label in ("pp2_v1", "pp2_v2", "pp2xtp2"):
        want[label] = pp_step
    meshes = {"tp2": (two, MP_STEPS), "pp2_v1": (two, MP_STEPS),
              "pp2_v2": (two, MP_STEPS), "pp2xtp2": (four, MP_PPTP_STEPS)}
    checks, report = {}, {}
    base_step = mean(_SINGLE["step_s"])
    for label, (ranks, n) in meshes.items():
        rs = runs(ranks, label)
        checks[f"{label}_ranks_equal"] = all(
            r["losses"] == rs[0]["losses"] and r["digest"] == rs[0]["digest"]
            for r in rs)
        checks[f"{label}_within_rtol"] = rel(rs[0]["losses"], base[:n]) \
            <= TRAIN_LOSS_RTOL
        checks[f"{label}_launches_exact"] = all(
            r["launches"].get(k) == per * n for r in rs
            for k, per in want[label].items())
        report[label] = {
            "losses": rs[0]["losses"], "step_s": [r["step_s"] for r in rs],
            "step_over_single": mean(rs[0]["step_s"]) / base_step,
            "tp_allreduce_s_per_step": [r["tp_allreduce_s_per_step"]
                                        for r in rs],
            "reduce_s_per_step": [r.get("reduce_s_per_step") for r in rs],
            "launches_per_rank": rs[0]["launches"], "mesh": rs[0]["mesh"],
            "max_rel_vs_single": rel(rs[0]["losses"], base[:n])}
    tp = runs(two, "tp2")
    checks["tp2_local_shapes"] = all(r["local_shapes"] == MP_TP_SHAPES
                                     for r in tp)
    checks["tp2_save_reload_digest"] = reloaded["tp2"] == tp[0]["digest"]
    checks["pp2_save_reload_digest"] = \
        reloaded["pp2_v1"] == runs(two, "pp2_v1")[0]["digest"]
    plan = runs(two, "planner")
    checks["planner_ranks_equal"] = all(
        r["losses"] == plan[0]["losses"] and math.isfinite(r["losses"][0])
        for r in plan)
    report["pp2_v1"]["profile"] = [r.get("profile")
                                   for r in runs(two, "pp2_v1")]
    report["planner"] = {k: plan[0].get(k) for k in (
        "plan", "axes", "breakdown", "predicted_bytes", "measured_bytes",
        "ratio", "losses", "launches")}
    report["planner"]["measured_bytes_per_rank"] = [
        r["measured_bytes"] for r in plan]
    out = {"phase": "model_parallel", "card": info["nvidia_smi"],
           "single_losses": base, "single_step_s": _SINGLE["step_s"],
           **report, "job_s": {"mp2": s2, "mp4": s4},
           "spawn_to_first_step_s": [r["first_step_s"] for r in two + four],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    emit({"phase": "model_parallel_checks", **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"model_parallel phase failed: {bad}")
    launches = {k: 0 for k in want["tp2"]}
    for r in two + four:
        for run in r["runs"]:
            for k, v in run["launches"].items():
                launches[k] += v
    return launches


# ---------------------------------------------------------------------------
# sequence_parallel: ring attention and the sp mesh on torch.distributed
# ---------------------------------------------------------------------------

SP_STEPS, SP_DP_STEPS = 3, 1
SP_MEM_SEQS = (4096, 8192)      # one ring fwd + bwd's peak at each length
SP_MEM_RATIO = 2.6              # the JAX package's test's bound
SP_PAD_FROM = 960               # the padded tail of the dropout step's rows
# the ring op on the kernels against flash attention over the whole
# sequence on the kernels, element by element: the whole is within
# FLASH_TOL (rtol, atol) of the exact values, and the ring runs the same
# kernels on each block, then rounds each block's output (and each
# block's dQ, dK, dV) to bf16 once before the f32 merge: sp roundings
# of 2^-9 of a block's share, which is at most about the largest
# magnitude in its row (the head dim of one position and head):
# |ring - whole| <= atol + rtol |whole| + sp 2^-9 rowmax |whole|
SP_BLOCK_ROUND = 2 ** -9


def _sp_net(dropout=0.0):
    """The train cell's gpt2-small (``_dist_net``) with
    ``sequence_parallel=True`` (and attention dropout ``dropout``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=dropout,
                     fused_loss=True, sequence_parallel=True)
    pt.seed(0)
    return GPTForCausalLM(cfg, device=f"cuda:{torch.cuda.current_device()}")


def _sp_run(label, model, ids, n):
    """``n`` steps of a Model on its sp mesh (``_mp_run``'s record) with
    the ring's exchange seconds a step."""
    from paddle_tpu_torch.ops import ring_attention as ra
    ra.exchange_seconds = 0.0
    run = _mp_run(label, model, ids, n)
    run["exchange_s_per_step"] = ra.exchange_seconds / n
    return run


def _ring_vs_whole(mesh):
    """The ring op alone at the train shape (bf16, causal) against flash
    attention of the whole sequence, both on the kernels: the gathered
    o, dq, dk, dv, their largest error against the stated bound, and two
    ring launches on the same inputs bit-identical. Reported beside it,
    not checked: the same ring on the kernels' plain twins (every block
    the twins, the same merges) against the kernels' ring, under the
    same bound."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops.flash_attention import flash_attention
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    from paddle_tpu_torch.parallel import collective as coll
    sp, r = mesh.axis_size("sp"), mesh.local_rank("sp")
    g = torch.Generator().manual_seed(0)
    shape = (TRAIN_BATCH, TRAIN_SEQ, 12, 64)
    q, k, v, do = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
                   for _ in range(4))
    n = TRAIN_SEQ // sp

    def ring():
        xs = [t[:, r * n:(r + 1) * n].clone().requires_grad_()
              for t in (q, k, v)]
        o = ring_attention(*xs, causal=True, mesh=mesh)
        o.backward(do[:, r * n:(r + 1) * n])
        return [coll.all_gather(t, "sp", gather_dim=1, mesh=mesh)
                for t in (o.detach(), *(x.grad for x in xs))]
    first, second = ring(), ring()
    fa.impl = "plain"
    try:
        plain = ring()
    finally:
        fa.impl = "kernel"
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*xs, causal=True)
    o.backward(do)
    whole = [o.detach(), *(x.grad for x in xs)]
    rtol, atol = FLASH_TOL[torch.bfloat16]
    out = {"bit_identical": all(torch.equal(a, b)
                                for a, b in zip(first, second)),
           "bound": "atol + rtol |ref| + sp 2^-9 rowmax |ref|",
           "vs_plain_ring": {}}

    def reading(a, b):
        a, b = a.float(), b.float()
        bound = atol + rtol * b.abs() + \
            sp * SP_BLOCK_ROUND * b.abs().amax(dim=-1, keepdim=True)
        err = (a - b).abs()
        return {"max_abs_err": float(err.max()),
                "max_err_over_bound": float((err / bound).max()),
                "within": bool((err <= bound).all())}
    for name, a, b, p in zip(("o", "dq", "dk", "dv"), first, whole, plain):
        out[name] = reading(a, b)
        out["vs_plain_ring"][name] = reading(a, p)
    return out


def _ring_peak_bytes(mesh, s):
    """Bytes the allocator held above the inputs in one ring fwd + bwd
    at sequence ``s`` (batch 8, 12 heads of 64, bf16, causal)."""
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    n = s // mesh.axis_size("sp")
    g = torch.Generator().manual_seed(1)
    xs = [torch.randn((TRAIN_BATCH, n, 12, 64), generator=g).to(
        "cuda", torch.bfloat16).requires_grad_() for _ in range(3)]
    do = torch.randn((TRAIN_BATCH, n, 12, 64), generator=g).to(
        "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ring_attention(*xs, causal=True, mesh=mesh).backward(do)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _sp_rank(scenario, outdir, rank, res, t_launch):
    """The sequence_parallel phase's rank body: ``sp2`` (sp=2: 3 steps
    and a save, the ring op against whole-sequence flash, the memory at
    two lengths, a step with attention dropout and a padded tail) or
    ``sp4`` (sp=2 x dp=2, 2 steps)."""
    from paddle_tpu_torch import parallel
    ids = _dist_ids(SP_STEPS)
    res["runs"] = []
    res["first_step_s"] = time.time() - t_launch
    if scenario == "sp4":
        mesh = parallel.DeviceMesh(sp=2, dp=2)
        model = _train_model(_sp_net())
        parallel.distributed_model(model, mesh=mesh)
        res["sp_index"] = mesh.local_rank("sp")
        res["runs"].append(_sp_run("sp2xdp2", model, ids, SP_DP_STEPS))
        return
    mesh = parallel.DeviceMesh(sp=2)
    res["sp_index"] = mesh.local_rank("sp")
    model = _train_model(_sp_net())
    parallel.distributed_model(model, mesh=mesh)
    run = _sp_run("sp2", model, ids, SP_STEPS)
    model.save(os.path.join(outdir, "sp2_saved"), training=False)
    res["runs"].append(run)
    del model
    torch.cuda.empty_cache()
    res["ring_op"] = _ring_vs_whole(mesh)
    res["peak_bytes"] = {s: _ring_peak_bytes(mesh, s) for s in SP_MEM_SEQS}
    torch.cuda.empty_cache()
    # attention dropout 0.1 over a padded tail: the plain ring blocks
    model = _train_model(_sp_net(dropout=0.1))
    parallel.distributed_model(model, mesh=mesh)
    kpm = np.ones((TRAIN_BATCH, TRAIN_SEQ), bool)
    kpm[:, SP_PAD_FROM:] = False
    pos = np.broadcast_to(np.arange(TRAIN_SEQ), (TRAIN_BATCH, TRAIN_SEQ))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(model.train_batch([ids[0], pos, kpm], [ids[0]])["loss"])
    torch.cuda.synchronize()
    res["dropout_mask"] = {"loss": loss,
                           "step_s": time.perf_counter() - t0}


def phase_sequence_parallel(info) -> dict:
    """The train cell on sp meshes of ranks of this script (``--dist-rank
    sp2`` / ``sp4``) sharing the card over gloo, against the distributed
    phase's one-process run (see the module docstring). Returns the
    B1-B3 launches the ranks counted."""
    import shutil
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "sequence_parallel")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    me = os.path.basename(os.path.abspath(__file__))
    if not _SINGLE:   # run alone: the one-process reference here
        model = _train_model(_dist_net())
        losses, _, walls = _dist_steps(model, _dist_ids(DIST_STEPS),
                                       DIST_STEPS, digest=False)
        _SINGLE.update(losses=losses, step_s=walls)
        del model
        torch.cuda.empty_cache()

    def start(tag, nproc):
        outdir = os.path.join(root, tag)
        os.makedirs(outdir)
        t0 = time.time()
        p = _launch(["--nproc_per_node", str(nproc), me, "--dist-rank",
                     tag, outdir, repr(t0)], os.path.join(outdir, "logs"))
        return tag, outdir, t0, p

    # both jobs at once, sharing the card and the host's cores (their
    # step times are reported, not checked)
    (d2, s2), (d4, s4) = _finish_together([start("sp2", 2),
                                           start("sp4", 4)])
    two, four = _read_ranks(d2, 2), _read_ranks(d4, 4)

    # the sp=2 save reloaded into one process (this one)
    model = _train_model(_dist_net())
    model.load(os.path.join(d2, "sp2_saved"), reset_optimizer=True)
    reloaded = _param_digest(model)
    del model
    torch.cuda.empty_cache()

    base = _SINGLE["losses"]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def mean(xs):   # the steps after the first (which warms up)
        return sum(xs[1:]) / len(xs[1:]) if len(xs) > 1 else xs[0]
    checks, report = {}, {}
    base_step = mean(_SINGLE["step_s"])
    for label, ranks, n in (("sp2", two, SP_STEPS),
                            ("sp2xdp2", four, SP_DP_STEPS)):
        rs = [r["runs"][0] for r in ranks]
        checks[f"{label}_ranks_equal"] = all(
            x["losses"] == rs[0]["losses"] and x["digest"] == rs[0]["digest"]
            for x in rs)
        checks[f"{label}_within_rtol"] = rel(rs[0]["losses"], base[:n]) \
            <= TRAIN_LOSS_RTOL
        checks[f"{label}_launches_exact"] = all(
            x["launches"].get(k) == 12 * (r["sp_index"] + 1) * n
            for r, x in zip(ranks, rs)
            for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
                      "flash_attention_bwd_dkv"))
        report[label] = {
            "losses": rs[0]["losses"], "step_s": [x["step_s"] for x in rs],
            "step_over_single": mean(rs[0]["step_s"]) / base_step,
            "exchange_s_per_step": [x["exchange_s_per_step"] for x in rs],
            "reduce_s_per_step": [x.get("reduce_s_per_step") for x in rs],
            "launches_per_rank": [x["launches"] for x in rs],
            "mesh": rs[0]["mesh"],
            "max_rel_vs_single": rel(rs[0]["losses"], base[:n])}
    checks["sp2_save_reload_digest"] = \
        reloaded == two[0]["runs"][0]["digest"]
    ring = [r["ring_op"] for r in two]
    checks["ring_op_within_bound"] = all(
        x[t]["within"] for x in ring for t in ("o", "dq", "dk", "dv"))
    checks["ring_op_bit_identical"] = all(x["bit_identical"] for x in ring)
    ratios = [r["peak_bytes"][str(SP_MEM_SEQS[1])]
              / r["peak_bytes"][str(SP_MEM_SEQS[0])] for r in two]
    checks["ring_memory_ratio"] = max(ratios) <= SP_MEM_RATIO
    drop = [r["dropout_mask"]["loss"] for r in two]
    checks["dropout_mask_finite_equal"] = all(
        math.isfinite(x) and x == drop[0] for x in drop)
    checks["dropout_mask_differs"] = drop[0] != report["sp2"]["losses"][0]
    out = {"phase": "sequence_parallel", "card": info["nvidia_smi"],
           "single_losses": base, "single_step_s": _SINGLE["step_s"],
           **report, "ring_op": ring,
           "peak_bytes": [r["peak_bytes"] for r in two],
           "memory_ratio": ratios,
           "dropout_mask": [r["dropout_mask"] for r in two],
           "job_s": {"sp2": s2, "sp4": s4},
           "spawn_to_first_step_s": [r["first_step_s"] for r in two + four],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    emit({"phase": "sequence_parallel_checks", **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"sequence_parallel phase failed: {bad}")
    launches = {k: 0 for k in ("flash_attention_fwd",
                               "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv")}
    for r in two + four:
        for k, v in r["runs"][0]["launches"].items():
            launches[k] += v
    return launches


def _summary(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}



# ---------------------------------------------------------------------------
# transformer-base through nn.Transformer; the nn layers on the card
# ---------------------------------------------------------------------------

NN_VOCAB, NN_BATCH, NN_SRC, NN_TGT = 37000, 8, 512, 256
NN_STEPS, NN_EPOCHS, NN_PARITY_STEPS, NN_TIMED_STEPS = 4, 2, 3, 5
NN_TRANSFORMER = {}     # nn.Transformer's defaults: transformer-base
NN_MOE = dict(d_model=768, d_hidden=3072, num_experts=8, gate="switch",
              capacity_factor=1.25)
NN_MOE_TOKENS = (8, 512)
NN_LAYER_ATOL, NN_LAYER_RTOL = 1e-5, 1e-4
# transformer-base's attention gradient at init under O1 is ~5% from the
# float32 one on the twins and on the kernels alike (bf16 GEMMs through
# 12 post-LN layers): under O1 the kernels are held to the twins'
# distance from float32 (within 10%), and in float32 to the twins
# within QKV_GRAD_RTOL
NN_GRAD_ERR_RATIO = 1.1


def _nn_seq2seq(dropout, dev):
    """transformer-base (Vaswani et al. 2017, Table 3: d_model 512, 8
    heads, 6 + 6 layers, FFN 2048, ReLU, post-LN) in a seq2seq wrapper:
    one embedding of a shared ~37000-token vocabulary (§3.4, §5.1) for
    source and target, the transformer, a vocabulary head. No position
    encoding: the run checks the path's numbers, not translation."""
    import paddle_tpu_torch as pt
    nn = pt.nn

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(NN_VOCAB, 512)
            self.transformer = nn.Transformer(
                **{**NN_TRANSFORMER, "dropout": dropout})
            self.head = nn.Linear(512, NN_VOCAB)

        def forward(self, src, tgt):
            return self.head(self.transformer(self.embed(src),
                                              self.embed(tgt)))
    pt.seed(0)
    return Seq2Seq().to(dev)


def _nn_data(n, seed):
    """``n`` rows of (source ids, target input ids, target labels): the
    labels are the target shifted by one."""
    rs = np.random.RandomState(seed)
    src = rs.randint(0, NN_VOCAB, (n, NN_SRC))
    y = rs.randint(0, NN_VOCAB, (n, NN_TGT + 1))
    return src, y[:, :-1], y[:, 1:]


def _nn_model(net):
    import paddle_tpu_torch as pt
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=1e-4, parameters=net,
                                     weight_decay=0.01),
                  pt.nn.CrossEntropyLoss(), amp_configs="O1")
    return model


def _nn_attn_grad(net, init, batch, impl, o1=True):
    """The gradient of every attention projection (q, k and v of the
    encoder's, the decoder's and the cross attentions) after one fwd+bwd
    from the initial weights, under O1 (or in float32), on B1-B3 or on
    their twins: it flows through dQ, dK and dV."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    net.train()
    net.zero_grad(set_to_none=True)
    dev = next(net.parameters()).device
    src, tgt, lab = (torch.as_tensor(a, device=dev) for a in batch)
    fa.impl = impl
    try:
        with amp.auto_cast(enable=o1, level="O1"):
            logits = net(src, tgt)
        torch.nn.functional.cross_entropy(
            logits.float().flatten(0, 1), lab.flatten()).backward()
    finally:
        fa.impl = "kernel"
    g = torch.cat([p.grad.flatten() for n, p in net.named_parameters()
                   if n.endswith(("q_proj.weight", "k_proj.weight",
                                  "v_proj.weight"))])
    net.zero_grad(set_to_none=True)
    return g


def _nn_flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _nn_flat(o)]
    return [out]


def _nn_cases(nn, F, IF, U):
    """(label, build() -> module, inputs as numpy arrays) of every class
    and function ported to nn in this slice, at the JAX tests' sizes."""
    rs = np.random.RandomState(0)

    def x(*s, scale=1.0):
        return (rs.randn(*s) * scale).astype(np.float32)

    def ints(hi, *s):
        return rs.randint(0, hi, s)

    class Fn(nn.Layer):
        """A function of the inputs and of its own parameters."""

        def __init__(self, fn, **params):
            super().__init__()
            self.fn = fn
            for k, v in params.items():
                setattr(self, k, nn.Parameter(v))

        def forward(self, *xs):
            return self.fn(self, *xs)

    def wn(layer):
        U.weight_norm(layer)
        return layer

    def sn(layer):
        U.spectral_norm(layer)
        return layer

    img = (2, 3, 8, 8)
    acts = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "SiLU", "Swish",
            "Mish", "Hardswish", "Hardsigmoid", "Softplus", "Softsign",
            "ELU", "SELU", "LeakyReLU", "Softmax", "LogSoftmax",
            "Identity", "Flatten", "CELU", "ThresholdedReLU",
            "Tanhshrink", "Hardshrink", "Softshrink", "Hardtanh", "GLU",
            "LocalResponseNorm"]
    cases = [(a, lambda a=a: getattr(nn, a)(), [x(*img, scale=2)])
             for a in acts]
    cases += [
        ("PReLU", lambda: nn.PReLU(3), [x(*img)]),
        ("Pad2D", lambda: nn.Pad2D([1, 2, 2, 1], "reflect"), [x(*img)]),
        ("Pad1D", lambda: nn.Pad1D([2, 1], "replicate"), [x(2, 3, 6)]),
        ("Pad3D", lambda: nn.Pad3D([1] * 6, "circular"),
         [x(1, 2, 3, 4, 5)]),
        ("ZeroPad2D", lambda: nn.ZeroPad2D([1, 1, 2, 2]), [x(*img)]),
        ("Upsample", lambda: nn.Upsample((13, 6), mode="bicubic"),
         [x(*img)]),
        ("UpsamplingBilinear2D", lambda: nn.UpsamplingBilinear2D(
            scale_factor=2), [x(*img)]),
        ("UpsamplingNearest2D", lambda: nn.UpsamplingNearest2D((5, 11)),
         [x(*img)]),
        ("Conv1D", lambda: nn.Conv1D(3, 4, 3, stride=2, padding=1),
         [x(2, 3, 11)]),
        ("Conv2D", lambda: nn.Conv2D(3, 8, 3, stride=2, padding=1),
         [x(2, 3, 16, 16)]),
        ("Conv2D groups NHWC", lambda: nn.Conv2D(
            4, 6, 3, groups=2, data_format="NHWC"), [x(2, 9, 9, 4)]),
        ("Conv3D", lambda: nn.Conv3D(2, 4, 3, padding=1),
         [x(1, 2, 5, 6, 5)]),
        ("Conv2DTranspose", lambda: nn.Conv2DTranspose(
            4, 6, 3, stride=2, padding=1, output_padding=1),
         [x(2, 4, 8, 8)]),
        ("MaxPool1D", lambda: nn.MaxPool1D(3, 2, 1), [x(2, 3, 10)]),
        ("AvgPool1D", lambda: nn.AvgPool1D(3, 2, 1), [x(2, 3, 10)]),
        ("MaxPool2D", lambda: nn.MaxPool2D(3, 2, 1), [x(*img)]),
        ("AvgPool2D", lambda: nn.AvgPool2D(3, 2, 1, False), [x(*img)]),
        ("MaxPool3D", lambda: nn.MaxPool3D(2), [x(1, 2, 4, 8, 8)]),
        ("AvgPool3D", lambda: nn.AvgPool3D(2), [x(1, 2, 4, 8, 8)]),
        ("AdaptiveAvgPool1D", lambda: nn.AdaptiveAvgPool1D(4),
         [x(2, 3, 12)]),
        ("AdaptiveMaxPool1D", lambda: nn.AdaptiveMaxPool1D(3),
         [x(2, 3, 12)]),
        ("AdaptiveAvgPool2D", lambda: nn.AdaptiveAvgPool2D((3, 5)),
         [x(2, 3, 7, 9)]),
        ("AdaptiveMaxPool2D", lambda: nn.AdaptiveMaxPool2D(2), [x(*img)]),
        ("AdaptiveAvgPool3D", lambda: nn.AdaptiveAvgPool3D(2),
         [x(1, 2, 4, 8, 8)]),
        ("BatchNorm1D", lambda: nn.BatchNorm1D(5), [x(16, 5) * 3 + 1]),
        ("BatchNorm2D", lambda: nn.BatchNorm2D(4),
         [x(8, 4, 5, 5) * 3 + 1]),
        ("BatchNorm3D", lambda: nn.BatchNorm3D(2),
         [x(2, 2, 3, 4, 3) * 3 + 1]),
        ("SyncBatchNorm", lambda: nn.SyncBatchNorm(3), [x(*img) * 2 + 1]),
        ("GroupNorm", lambda: nn.GroupNorm(2, 4), [x(2, 4, 5, 5)]),
        ("InstanceNorm2D", lambda: nn.InstanceNorm2D(3), [x(*img)]),
        ("CrossEntropyLoss", lambda: nn.CrossEntropyLoss(),
         [x(6, 10), ints(10, 6)]),
        ("NLLLoss", lambda: nn.NLLLoss(),
         [np.log(np.full((6, 5), 0.2, np.float32)) + x(6, 5) * 0.1,
          ints(5, 6)]),
        ("MSELoss", lambda: nn.MSELoss(), [x(6, 5), x(6, 5)]),
        ("L1Loss", lambda: nn.L1Loss(), [x(6, 5), x(6, 5)]),
        ("SmoothL1Loss", lambda: nn.SmoothL1Loss(), [x(6, 5), x(6, 5)]),
        ("KLDivLoss", lambda: nn.KLDivLoss(),
         [x(6, 5), np.full((6, 5), 0.2, np.float32)]),
        ("BCELoss", lambda: nn.BCELoss(),
         [1 / (1 + np.exp(-x(6, 5))), (x(6, 5) > 0).astype(np.float32)]),
        ("BCEWithLogitsLoss", lambda: nn.BCEWithLogitsLoss(),
         [x(6, 5), (x(6, 5) > 0).astype(np.float32)]),
        ("RReLU", lambda: nn.RReLU(0.1, 0.3), [x(64)]),
        ("AlphaDropout", lambda: nn.AlphaDropout(0.3), [x(2000)]),
        ("Maxout", lambda: nn.Maxout(3), [x(2, 6, 4, 4)]),
        ("PixelShuffle", lambda: nn.PixelShuffle(2), [x(2, 8, 3, 3)]),
        ("PixelUnshuffle", lambda: nn.PixelUnshuffle(2), [x(2, 2, 6, 4)]),
        ("Unfold", lambda: nn.Unfold(3, 2, 1), [x(2, 3, 7, 7)]),
        ("Fold", lambda: nn.Fold((7, 7), 2, 2, 0, 2), [x(1, 8, 9)]),
        ("Bilinear", lambda: nn.Bilinear(5, 6, 7), [x(8, 5), x(8, 6)]),
        ("CosineSimilarity", lambda: nn.CosineSimilarity(1),
         [x(6, 5), x(6, 5)]),
        ("PairwiseDistance", lambda: nn.PairwiseDistance(),
         [x(6, 5), x(6, 5)]),
        ("SimpleRNNCell", lambda: nn.SimpleRNNCell(4, 6), [x(3, 4)]),
        ("LSTMCell", lambda: nn.LSTMCell(4, 6), [x(3, 4)]),
        ("GRUCell", lambda: nn.GRUCell(4, 6), [x(3, 4)]),
        ("RNN", lambda: nn.RNN(nn.GRUCell(4, 6), is_reverse=True),
         [x(3, 5, 4)]),
        ("BiRNN", lambda: nn.BiRNN(nn.LSTMCell(4, 6), nn.LSTMCell(4, 6)),
         [x(3, 5, 4)]),
        ("SimpleRNN", lambda: nn.SimpleRNN(4, 6, num_layers=2),
         [x(3, 5, 4)]),
        ("LSTM", lambda: nn.LSTM(4, 6, 2, "bidirect"), [x(3, 5, 4)]),
        ("GRU", lambda: nn.GRU(4, 6, 2, "bidirect"), [x(3, 5, 4)]),
        ("MultiHeadAttention", lambda: nn.MultiHeadAttention(32, 4),
         [x(2, 9, 32), x(2, 12, 32)]),
        ("TransformerEncoderLayer", lambda: nn.TransformerEncoderLayer(
            32, 4, 64, 0.0), [x(2, 9, 32)]),
        ("TransformerEncoder", lambda: nn.TransformerEncoder(
            nn.TransformerEncoderLayer(32, 4, 64, 0.0), 2), [x(2, 9, 32)]),
        ("TransformerDecoderLayer", lambda: nn.TransformerDecoderLayer(
            32, 4, 64, 0.0), [x(2, 7, 32), x(2, 9, 32)]),
        ("TransformerDecoder", lambda: nn.TransformerDecoder(
            nn.TransformerDecoderLayer(32, 4, 64, 0.0), 2),
         [x(2, 7, 32), x(2, 9, 32)]),
        ("Transformer", lambda: nn.Transformer(32, 4, 2, 2, 64, 0.1),
         [x(2, 9, 32), x(2, 7, 32)]),
        ("NaiveGate", lambda: nn.NaiveGate(8, 4), [x(2, 16, 8)]),
        ("GShardGate", lambda: nn.GShardGate(8, 4), [x(2, 16, 8)]),
        ("SwitchGate", lambda: nn.SwitchGate(8, 4), [x(2, 16, 8)]),
        ("MoELayer gshard", lambda: nn.MoELayer(8, 16, 4),
         [x(2, 16, 8)]),
        ("weight_norm", lambda: wn(nn.Linear(6, 4)), [x(3, 6)]),
        ("spectral_norm", lambda: sn(nn.Linear(5, 7)), [x(4, 5)]),
        ("parameters_to_vector", lambda: Fn(
            lambda m, v: U.parameters_to_vector([m.w, v]) * 2,
            w=x(3, 4)), [x(5)]),
        ("fused_linear", lambda: Fn(
            lambda m, v: IF.fused_linear(v, m.w, m.b), w=x(4, 3),
            b=x(3)), [x(2, 4)]),
        ("fused_feedforward", lambda: Fn(
            lambda m, v: IF.fused_feedforward(
                v, m.w1, m.w2, dropout1_rate=0.1, dropout2_rate=0.1,
                training=True), w1=x(8, 16), w2=x(16, 8)), [x(2, 4, 8)]),
        ("fused_multi_head_attention", lambda: Fn(
            lambda m, v: IF.fused_multi_head_attention(
                v, m.qkv, m.wo, dropout_rate=0.0, attn_dropout_rate=0.0,
                qkv_bias=m.bias), qkv=x(3, 2, 4, 8, scale=0.3),
            wo=x(8, 8, scale=0.3), bias=x(3, 2, 4, scale=0.1)),
         [x(2, 6, 8)]),
        ("gumbel_softmax", lambda: Fn(
            lambda m, v: F.gumbel_softmax(v * m.s, 0.5, True), s=x(7)),
         [x(4, 7)]),
        ("grid_sample", lambda: Fn(
            lambda m, v, g: F.grid_sample(v * m.s, g), s=x(1)),
         [x(2, 3, 6, 7), np.clip(x(2, 5, 4, 2), -1.2, 1.2)]),
    ]
    return cases


def _nn_fill_cases(nn, F):
    """(label, build, inputs) of every function of
    ``nn/functional_fill.py`` with a float output and every class of
    ``nn/layers/fill_r4.py``, at the JAX tests' sizes (as ``_nn_cases``;
    a function's module scales its first input by a parameter, so the
    backward runs)."""
    rs = np.random.RandomState(1)

    def x(*s, scale=1.0):
        return (rs.randn(*s) * scale).astype(np.float32)

    def ints(lo, hi, *s):
        return rs.randint(lo, hi, s)

    def pm1(*s):
        return np.where(rs.rand(*s) > 0.5, 1.0, -1.0).astype(np.float32)

    class Fn(nn.Layer):
        def __init__(self, fn):
            super().__init__()
            self.fn = fn
            self.s = nn.Parameter(torch.ones(1) * 1.1)

        def forward(self, v, *rest):
            return self.fn(v * self.s, *rest)

    def fn(label, f, inputs):
        return (label, lambda: Fn(f), inputs)

    offs = np.array([[[0, 2, 3, 5, 6, 8]] * 2] * 2, np.int32)
    cols = np.array([[[0, 1, 1, 0, 2, 3, 0, 4]] * 2] * 2, np.int32)
    return [
        fn("conv1d_transpose", lambda v, w, b: F.conv1d_transpose(
            v, w, b, stride=2, padding=1, output_padding=1),
           [x(2, 3, 7), x(3, 4, 3), x(4)]),
        fn("diag_embed", lambda v: F.diag_embed(v, 1, 0, 2), [x(2, 3, 4)]),
        fn("zeropad2d", lambda v: F.zeropad2d(v, [1, 2, 0, 3]),
           [x(1, 2, 3, 4)]),
        fn("bilinear", lambda v, b, w: F.bilinear(v, b, w),
           [x(6, 3), x(6, 4), x(5, 3, 4)]),
        fn("dropout3d", lambda v: F.dropout3d(v, 0.4), [x(4, 6, 2, 3, 3)]),
        fn("rrelu", lambda v: F.rrelu(v, 0.1, 0.3), [x(4, 64)]),
        fn("adaptive_max_pool3d", lambda v: F.adaptive_max_pool3d(
            v, (2, 2, 3)), [x(2, 3, 4, 4, 6)]),
        fn("max_pool2d mask values", lambda v: F.max_pool2d(
            v, 3, 2, 1, return_mask=True)[0], [x(2, 2, 7, 5)]),
        fn("cosine_embedding_loss", lambda v, b, y:
           F.cosine_embedding_loss(v, b, y, 0.2), [x(8, 5), x(8, 5),
                                                   pm1(8)]),
        fn("hinge_embedding_loss", lambda v, y: F.hinge_embedding_loss(
            v, y, 0.5), [x(4, 6), pm1(4, 6)]),
        fn("margin_ranking_loss", lambda v, b, y: F.margin_ranking_loss(
            v, b, y, 0.1, "sum"), [x(10), x(10), pm1(10)]),
        fn("multi_label_soft_margin_loss", lambda v, y:
           F.multi_label_soft_margin_loss(v, y),
           [x(4, 6), (x(4, 6) > 0).astype(np.float32)]),
        fn("triplet_margin_loss", lambda v, p, n: F.triplet_margin_loss(
            v, p, n, p=1.5, swap=True), [x(6, 4), x(6, 4), x(6, 4)]),
        fn("triplet_margin_with_distance_loss", lambda v, p, n:
           F.triplet_margin_with_distance_loss(v, p, n, swap=True),
           [x(6, 4), x(6, 4), x(6, 4)]),
        fn("dice_loss", lambda v, y: F.dice_loss(torch.softmax(v, -1), y),
           [x(4, 5, 3), ints(0, 3, 4, 5, 1)]),
        fn("npair_loss", lambda v, p, y: F.npair_loss(v, p, y),
           [x(6, 4), x(6, 4), np.array([0, 1, 0, 2, 1, 2])]),
        fn("sigmoid_focal_loss", lambda v, y: F.sigmoid_focal_loss(v, y),
           [x(5, 3), (x(5, 3) > 0).astype(np.float32)]),
        fn("hsigmoid_loss", lambda v, y, w, b: F.hsigmoid_loss(
            v, y, 7, w, b), [x(5, 4), ints(0, 7, 5), x(6, 4), x(6)]),
        fn("margin_cross_entropy", lambda v, y: F.margin_cross_entropy(
            torch.tanh(v), y, scale=8.0, return_softmax=True),
           [x(4, 6), ints(0, 6, 4)]),
        fn("ctc_loss", lambda v, lab, il, ll: F.ctc_loss(v, lab, il, ll),
           [x(9, 3, 5), ints(1, 5, 3, 4), np.array([9, 7, 8]),
            np.array([4, 2, 3])]),
        fn("sparse_attention", lambda q, k, v, o, c: F.sparse_attention(
            q, k, v, o, c), [x(2, 2, 5, 4), x(2, 2, 5, 4), x(2, 2, 5, 4),
                             offs, cols]),
        fn("relu_ elu_ softmax_ tanh_", lambda v: (
            F.relu_(v), F.elu_(v, 0.7), F.softmax_(v, 0), F.tanh_(v)),
           [x(3, 4)]),
        ("LogSigmoid", lambda: nn.LogSigmoid(), [x(2, 5)]),
        ("Silu", lambda: nn.Silu(), [x(2, 5)]),
        ("Softmax2D", lambda: nn.Softmax2D(), [x(2, 3, 4, 4)]),
        ("ChannelShuffle", lambda: nn.ChannelShuffle(3, "NHWC"),
         [x(2, 3, 3, 6)]),
        ("Dropout3D", lambda: nn.Dropout3D(0.4), [x(4, 6, 2, 3, 3)]),
        ("Conv1DTranspose", lambda: nn.Conv1DTranspose(3, 4, 3, 2, 1, 1),
         [x(2, 3, 6)]),
        ("Conv3DTranspose", lambda: nn.Conv3DTranspose(2, 4, 3, 1, 1),
         [x(1, 2, 4, 3, 3)]),
        ("InstanceNorm1D", lambda: nn.InstanceNorm1D(3), [x(2, 3, 7)]),
        ("InstanceNorm3D", lambda: nn.InstanceNorm3D(2),
         [x(2, 2, 3, 4, 5)]),
        ("AdaptiveMaxPool3D", lambda: nn.AdaptiveMaxPool3D(2),
         [x(1, 2, 4, 4, 4)]),
        ("CosineEmbeddingLoss", lambda: nn.CosineEmbeddingLoss(0.1),
         [x(6, 4), x(6, 4), pm1(6)]),
        ("HingeEmbeddingLoss", lambda: nn.HingeEmbeddingLoss(0.7, "sum"),
         [x(5), pm1(5)]),
        ("MarginRankingLoss", lambda: nn.MarginRankingLoss(0.2),
         [x(5), x(5), pm1(5)]),
        ("MultiLabelSoftMarginLoss", lambda: nn.MultiLabelSoftMarginLoss(),
         [x(3, 4), (x(3, 4) > 0).astype(np.float32)]),
        ("TripletMarginLoss", lambda: nn.TripletMarginLoss(0.5, 3.0),
         [x(4, 3), x(4, 3), x(4, 3)]),
        ("TripletMarginWithDistanceLoss",
         lambda: nn.TripletMarginWithDistanceLoss(None, 0.3, True),
         [x(4, 3), x(4, 3), x(4, 3)]),
        ("HSigmoidLoss", lambda: nn.HSigmoidLoss(4, 6),
         [x(5, 4), ints(0, 6, 5)]),
        ("CTCLoss", lambda: nn.CTCLoss(0, "sum"),
         [x(7, 2, 4), np.array([[1, 2, 2], [3, 1, 0]]), np.array([7, 6]),
          np.array([3, 2])]),
        ("SpectralNorm", lambda: nn.SpectralNorm((3, 4, 5), 1, 3),
         [x(3, 4, 5)]),
    ]


def _nn_fill_exact(nn, F, dev):
    """The integer results of the fill on the card against the CPU,
    exactly: max-pool masks and the unpooled maps (1-D, 2-D, 3-D, with
    overlapping windows), ``gather_tree``, ``class_center_sample`` and
    beam search (``dynamic_decode`` over a GRU cell: ids and lengths)."""
    import copy
    import paddle_tpu_torch as pt
    rs = np.random.RandomState(2)
    out = {}
    for nd, shape in ((1, (2, 3, 9)), (2, (2, 2, 7, 5)),
                      (3, (1, 2, 5, 4, 6))):
        x = rs.randn(*shape).astype(np.float32)
        pool = getattr(F, f"max_pool{nd}d")
        unpool = getattr(F, f"max_unpool{nd}d")
        got = []
        for d in ("cpu", dev):
            v, m = pool(torch.as_tensor(x, device=d), 3, 2, 1,
                        return_mask=True)
            u = unpool(v, m, 3, 2, 1, output_size=shape)
            unp = getattr(nn, f"MaxUnPool{nd}D")(3, 2, 1,
                                                 output_size=shape)(v, m)
            got.append([t.cpu() for t in (v, m, u, unp)])
        out[f"max_pool{nd}d mask, unpool"] = all(
            torch.equal(a, b) for a, b in zip(*got))
    ids = rs.randint(0, 9, (5, 2, 3))
    par = rs.randint(0, 3, (5, 2, 3))
    out["gather_tree"] = torch.equal(
        F.gather_tree(torch.as_tensor(ids), torch.as_tensor(par)),
        F.gather_tree(torch.as_tensor(ids, device=dev),
                      torch.as_tensor(par, device=dev)).cpu())
    y = np.array([3, 17, 3, 42, 8, 17])
    got = []
    for d in ("cpu", dev):
        pt.seed(7)
        got.append([t.cpu() for t in F.class_center_sample(
            torch.as_tensor(y, device=d), 64, 12)])
    out["class_center_sample"] = all(torch.equal(a, b)
                                     for a, b in zip(*got))
    pt.seed(0)
    cell, emb, head = nn.GRUCell(6, 8), nn.Embedding(7, 6), \
        nn.Linear(8, 7)
    with torch.no_grad():
        head.weight.mul_(4.0)
    got = []
    for d in ("cpu", dev):
        c, e, h = (copy.deepcopy(m).to(d) for m in (cell, emb, head))
        dec = nn.BeamSearchDecoder(c, 1, 2, 3, embedding_fn=e, output_fn=h)
        with torch.no_grad():
            ids, lengths = nn.dynamic_decode(
                dec, inits=c.get_initial_states(2, device=d),
                max_step_num=8)
        got.append((ids.cpu(), lengths.cpu()))
    out["beam_search ids, lengths"] = all(
        torch.equal(a, b) for a, b in zip(*got))
    return out


# buffers a card and the CPU must hold bit for bit
_NN_EXACT_BUFFERS = ("_mean", "_variance", "weight_u")


def _nn_layer_check(build, inputs, dev):
    """One forward (and backward, where there are parameters) of
    ``build()`` on the card and on the CPU from the same weights and
    draws: the largest output / gradient error over the limit, and
    whether the exact buffers are equal."""
    import copy
    import paddle_tpu_torch as pt
    pt.seed(0)
    cpu = build()
    card = copy.deepcopy(cpu).to(dev)
    outs = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        xs = [torch.as_tensor(a, device=d) for a in inputs]
        pt.seed(1)
        out = [o for o in _nn_flat(m(*xs)) if o.is_floating_point()]
        params = [p for p in m.parameters() if p.requires_grad]
        if params:
            g = torch.Generator().manual_seed(2)
            sum((o * torch.randn(o.shape, generator=g).to(d)).sum()
                for o in out).backward()
        outs.append(([o.detach().cpu() for o in out],
                     [p.grad.cpu() if p.grad is not None else None
                      for p in params],
                     {k: b.cpu() for k, b in m.named_buffers()}))
    worst, exact = 0.0, True
    (oc, gc, bc), (og, gg, bg) = outs
    for a, b in zip(oc + [g for g in gc if g is not None],
                    og + [g for g in gg if g is not None]):
        lim = NN_LAYER_ATOL + NN_LAYER_RTOL * a.abs()
        worst = max(worst, float(((b - a).abs() / lim).max())
                    if a.numel() else 0.0)
    for k, v in bc.items():
        if k.split(".")[-1] in _NN_EXACT_BUFFERS:
            exact = exact and torch.equal(v, bg[k])
        else:
            lim = NN_LAYER_ATOL + NN_LAYER_RTOL * v.abs()
            worst = max(worst, float(((bg[k] - v).abs() / lim).max()))
    return worst, exact, len(oc), sum(g is not None for g in gc)


def _nn_moe_check(dev):
    """The Switch MoE at its paper's widths on 8 x 512 tokens: dispatch
    positions and dropped tokens equal on the card and the CPU, the
    output, the aux loss and the gradients within the layer limit."""
    import copy
    import paddle_tpu_torch as pt
    pt.seed(0)
    cpu = pt.nn.MoELayer(**NN_MOE)
    card = copy.deepcopy(cpu).to(dev)
    x = np.random.RandomState(3).randn(*NN_MOE_TOKENS, NN_MOE["d_model"]) \
        .astype(np.float32)
    res = []
    for m, d in ((cpu, "cpu"), (card, dev)):
        xs = torch.as_tensor(x, device=d)
        dispatch, _, _ = m.route(xs)
        out, aux = m.forward_with_aux(xs)
        (out.square().mean() + aux).backward()
        res.append((dispatch.cpu(), out.detach().cpu(), aux.detach().cpu(),
                    [p.grad.cpu() for p in m.parameters()]))
    (dc, oc, ac, gc), (dg, og, ag, gg) = res
    worst = 0.0
    for a, b in zip([oc, ac] + gc, [og, ag] + gg):
        lim = NN_LAYER_ATOL + NN_LAYER_RTOL * a.abs()
        worst = max(worst, float(((b - a).abs() / lim).max()))
    tokens = NN_MOE_TOKENS[0] * NN_MOE_TOKENS[1] * cpu.top_k
    return {"dispatch_equal": torch.equal(dc, dg),
            "dropped_cpu": tokens - int(dc.sum()),
            "dropped_card": tokens - int(dg.sum()),
            "capacity": cpu._capacity(NN_MOE_TOKENS[1]),
            "aux_cpu": float(ac), "aux_card": float(ag),
            "err_over_limit": worst}


def phase_nn(info, dev="cuda") -> dict:
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.io import Dataset
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import utils as U
    from paddle_tpu_torch.ops import flash_attention as fa
    t_phase = time.perf_counter()
    layers = (NN_TRANSFORMER.get("num_encoder_layers", 6),
              NN_TRANSFORMER.get("num_decoder_layers", 6))
    per_train = layers[0] + 2 * layers[1]     # B1, B2, B3 a train step
    net = _nn_seq2seq(0.0, dev)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    n_params = sum(p.numel() for p in net.parameters())
    n_train = NN_BATCH * NN_STEPS
    src, tgt, lab = _nn_data(n_train + NN_BATCH, 0)

    class Rows(Dataset):
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi

        def __len__(self):
            return self.hi - self.lo

        def __getitem__(self, i):
            i += self.lo
            return src[i], tgt[i], lab[i]

    losses = []

    class Tap(pt.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])

    # the main path: Model.fit, 2 epochs of 4 steps and one eval pass,
    # with the counts from 0
    model = _nn_model(net)
    _reset_flash_counts()
    t0 = time.perf_counter()
    model.fit(Rows(0, n_train), Rows(n_train, n_train + NN_BATCH),
              batch_size=NN_BATCH, epochs=NN_EPOCHS, eval_freq=NN_EPOCHS,
              shuffle=False, verbose=0, callbacks=[Tap()])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = _flash_counts()
    losses = [float(v) for v in losses]
    one_batch = (src[:NN_BATCH], tgt[:NN_BATCH], lab[:NN_BATCH])

    # one train step and one eval step, each counted alone; then the
    # timed steps and a profiled window
    _reset_flash_counts()
    model.train_batch(list(one_batch[:2]), [one_batch[2]])
    torch.cuda.synchronize()
    step_launches = _flash_counts()
    _reset_flash_counts()
    model.eval_batch(list(one_batch[:2]), [one_batch[2]])
    torch.cuda.synchronize()
    eval_launches = _flash_counts()
    t0 = time.perf_counter()
    for _ in range(NN_TIMED_STEPS):
        model.train_batch(list(one_batch[:2]), [one_batch[2]])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / NN_TIMED_STEPS * 1e3
    tokens = NN_BATCH * (NN_SRC + NN_TGT)

    def work():
        for _ in range(2):
            model.train_batch(list(one_batch[:2]), [one_batch[2]])
    prof = _profile(work, 2, "step", phase="nn", run="profile", steps=2)
    emit(prof)
    emit({"phase": "nn", "run": "main", "model": "transformer-base",
          "card": info["nvidia_smi"], "params": n_params,
          "batch": NN_BATCH, "src": NN_SRC, "tgt": NN_TGT,
          "vocab": NN_VOCAB, "amp": "O1", "optimizer": "AdamW 1e-4",
          "fit_s": fit_s, "fit_losses": losses,
          "fit_launches": fit_launches, "step_launches": step_launches,
          "eval_launches": eval_launches, "step_ms": step_ms,
          "tokens_per_s": tokens / step_ms * 1e3,
          "target_tokens_per_s": NN_BATCH * NN_TGT / step_ms * 1e3,
          "flash_share": prof["flash_share"],
          "idle_share": prof["idle_share"]})
    del model

    # B1-B3 against their twins from the same weights
    k_losses, k_counts = _nn_parity(net, init, one_batch, "kernel")
    p_losses, p_counts = _nn_parity(net, init, one_batch, "plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
    # the gradient under O1 on the kernels and on the twins, each held
    # against the twins in float32; and in float32 on the kernels (their
    # f32 route) against the twins
    g_k = _nn_attn_grad(net, init, one_batch, "kernel")
    g_p = _nn_attn_grad(net, init, one_batch, "plain")
    g_32 = _nn_attn_grad(net, init, one_batch, "plain", o1=False)
    g_k32 = _nn_attn_grad(net, init, one_batch, "kernel", o1=False)

    def rel_norm(a, b):
        return float((a - b).norm() / b.norm())
    grad_rel = rel_norm(g_k, g_p)
    grad_err_k, grad_err_p = rel_norm(g_k, g_32), rel_norm(g_p, g_32)
    grad_rel_f32 = rel_norm(g_k32, g_32)
    del g_k, g_p, g_32, g_k32

    # the defaults' dropout 0.1: attention dropout in training takes the
    # plain path, as in the JAX package
    drop = _nn_seq2seq(0.1, dev)
    drop.load_state_dict(init)
    drop_model = _nn_model(drop)
    _reset_flash_counts()
    drop_loss = float(drop_model.train_batch(list(one_batch[:2]),
                                             [one_batch[2]])["loss"])
    torch.cuda.synchronize()
    drop_launches = _flash_counts()
    del drop, drop_model, net
    torch.cuda.empty_cache()
    emit({"phase": "nn", "run": "kernels vs twins",
          "steps": NN_PARITY_STEPS, "kernel_losses": k_losses,
          "plain_losses": p_losses, "rel_diff": rel,
          "rtol": TRAIN_LOSS_RTOL, "kernel_launches": k_counts,
          "plain_launches": p_counts, "attn_grad_rel_diff_o1": grad_rel,
          "attn_grad_err_vs_f32_kernel_o1": grad_err_k,
          "attn_grad_err_vs_f32_plain_o1": grad_err_p,
          "attn_grad_rel_diff_f32": grad_rel_f32,
          "grad_rtol": QKV_GRAD_RTOL,
          "grad_err_ratio_limit": NN_GRAD_ERR_RATIO,
          "dropout_0.1_loss": drop_loss,
          "dropout_0.1_launches": drop_launches})

    # every ported layer on the card against the port on the CPU (f32,
    # TF32 off)
    t0 = time.perf_counter()
    layer_rows = []
    for label, build, inputs in _nn_cases(pt.nn, F, IF, U) + \
            _nn_fill_cases(pt.nn, F):
        worst, exact, n_out, n_grad = _nn_layer_check(build, inputs, dev)
        layer_rows.append({"layer": label, "err_over_limit": worst,
                           "exact_buffers": exact, "outputs": n_out,
                           "grads": n_grad})
    moe = _nn_moe_check(dev)
    exact = _nn_fill_exact(pt.nn, F, dev)
    emit({"phase": "nn", "run": "layers card vs cpu",
          "limit": f"|card - cpu| <= {NN_LAYER_ATOL} + {NN_LAYER_RTOL} "
                   f"|cpu|", "seconds": time.perf_counter() - t0,
          "cases": layer_rows, "moe_switch": moe, "fill_exact": exact})

    want = {k: per_train * NN_STEPS * NN_EPOCHS for k in fit_launches}
    want["flash_attention_fwd"] += per_train   # the eval pass's step
    bad_layers = [r["layer"] for r in layer_rows
                  if not (r["err_over_limit"] <= 1.0 and r["exact_buffers"])]
    checks = {
        "fit_launches": fit_launches == want,
        "train_step_launches": all(v == per_train
                                   for v in step_launches.values()),
        "eval_step_launches": eval_launches == {
            "flash_attention_fwd": per_train,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
        "parity_launches": all(v == per_train * NN_PARITY_STEPS
                               for v in k_counts.values()),
        "plain_launches": all(v == 0 for v in p_counts.values()),
        "dropout_0.1_launches": all(v == 0 for v in drop_launches.values()),
        "dropout_0.1_finite": math.isfinite(drop_loss),
        "losses_finite": all(math.isfinite(v) for v in
                             losses + k_losses + p_losses),
        "eighth_loss_below_first": losses[-1] < losses[0],
        "kernel_losses_match_twins": max(rel) <= TRAIN_LOSS_RTOL,
        "kernel_attn_grad_f32_matches_twins": grad_rel_f32 <= QKV_GRAD_RTOL,
        "kernel_attn_grad_o1_as_close_to_f32_as_twins":
            grad_err_k <= NN_GRAD_ERR_RATIO * grad_err_p,
        "layers_card_vs_cpu": not bad_layers,
        "moe_dispatch_equal": moe["dispatch_equal"],
        "moe_dropped_equal": moe["dropped_cpu"] == moe["dropped_card"],
        "moe_within_limit": moe["err_over_limit"] <= 1.0,
        "fill_exact": all(exact.values()),
    }
    emit({"phase": "nn_checks", "expected_fit_launches": want,
          "bad_layers": bad_layers, "seconds":
          time.perf_counter() - t_phase, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"nn checks failed: {failed}")
    return fit_launches


def _nn_parity(net, init, batch, impl):
    """NN_PARITY_STEPS train steps from the initial weights on B1-B3 or
    on their twins: the losses and the launch counts."""
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    model = _nn_model(net)
    fa.impl = impl
    try:
        _reset_flash_counts()
        losses = [model.train_batch(list(batch[:2]), [batch[2]])["loss"]
                  for _ in range(NN_PARITY_STEPS)]
        torch.cuda.synchronize()
        counts = _flash_counts()
    finally:
        fa.impl = "kernel"
    return [float(v) for v in losses], counts


# ---------------------------------------------------------------------------
# a Switch-Base-8 encoder on an ep=2 mesh
# ---------------------------------------------------------------------------

# Switch-Base (Fedus, Zoph and Shazeer 2021, arXiv:2101.03961): T5-Base
# widths, every other FFN a Switch layer; google/switch-base-8's 8
# experts and 32128-token vocabulary. Encoder only, no relative position
# bias, LayerNorm for T5's RMSNorm (PERF.md section 4).
SWITCH = dict(vocab=32128, layers=12, d_model=768, heads=12, d_ff=3072,
              experts=8, capacity_factor=1.25)
SWITCH_BATCH, SWITCH_SEQ, SWITCH_STEPS, SWITCH_PROFILE_STEPS = 8, 512, 3, 2
SWITCH_PARAM_RTOL = 1e-4        # gathered parameters vs one process, norm
SWITCH_EXPERT_BYTES_RATIO = 0.55  # a rank's expert bytes over one process's
SWITCH_TIMEOUT_S = 240


def _switch_net(dev):
    """The Switch-Base-8 encoder from the port's layers, its weights from
    ``seed(0)`` (built on the CPU, then moved to ``dev``)."""
    import paddle_tpu_torch as pt
    nn, F = pt.nn, pt.nn.functional
    c = SWITCH

    class Block(nn.Layer):
        def __init__(self, moe):
            super().__init__()
            self.norm1 = nn.LayerNorm(c["d_model"])
            self.attn = nn.MultiHeadAttention(c["d_model"], c["heads"])
            self.norm2 = nn.LayerNorm(c["d_model"])
            self.ffn = nn.MoELayer(
                c["d_model"], c["d_ff"], c["experts"], gate="switch",
                capacity_factor=c["capacity_factor"], activation="relu") \
                if moe else nn.Sequential(
                    nn.Linear(c["d_model"], c["d_ff"]), nn.ReLU(),
                    nn.Linear(c["d_ff"], c["d_model"]))

        def forward(self, x):
            h = self.norm1(x)
            x = x + self.attn(h, h, h)
            return x + self.ffn(self.norm2(x))

    class SwitchEncoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(c["vocab"], c["d_model"])
            self.blocks = nn.LayerList(
                [Block(i % 2 == 1) for i in range(c["layers"])])
            self.norm = nn.LayerNorm(c["d_model"])

        def forward(self, ids):
            with nn.collect_aux_losses() as get_aux:
                x = self.embed(ids)
                for b in self.blocks:
                    x = b(x)
                # the head tied to the embedding, its input scaled by
                # d_model^-0.5 as T5's is
                logits = F.linear(self.norm(x) * c["d_model"] ** -0.5,
                                  self.embed.weight.t())
            return logits, get_aux()
    pt.seed(0)
    return SwitchEncoder().to(dev)


def _switch_model(net):
    """Per-token cross-entropy plus the gates' aux losses; AdamW 1e-4,
    O1."""
    import paddle_tpu_torch as pt

    class Loss(pt.nn.Layer):
        def forward(self, logits, aux, labels):
            return torch.nn.functional.cross_entropy(
                logits.float().flatten(0, 1), labels.flatten()) + aux
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(learning_rate=1e-4, parameters=net),
                  Loss(), amp_configs="O1")
    return model


def _switch_data():
    rs = np.random.RandomState(7)
    shape = (SWITCH_STEPS, SWITCH_BATCH, SWITCH_SEQ)
    return rs.randint(0, SWITCH["vocab"], shape), \
        rs.randint(0, SWITCH["vocab"], shape)


def _switch_routing(net):
    """Record each MoE layer's routing on its next forward: a digest of
    every token's (expert, slot) or drop, the dropped count and the aux
    loss. Returns the list the records go into."""
    import hashlib
    from paddle_tpu_torch.nn import MoELayer
    out = []
    for name, m in net.named_modules():
        if not isinstance(m, MoELayer):
            continue

        def route(x, m=m, name=name, inner=m.route):
            dispatch, combine, aux = inner(x)
            if len(out) < sum(isinstance(k, MoELayer)
                              for k in net.modules()):
                flat = dispatch.flatten(2)
                slot = torch.where(flat.sum(-1) > 0, flat.argmax(-1), -1)
                out.append({"layer": name, "digest": hashlib.sha256(
                    slot.cpu().numpy().tobytes()).hexdigest()[:16],
                    "dropped": int(x.shape[0] * x.shape[1] * m.top_k
                                   - dispatch.float().sum()),
                    "aux": float(aux.detach())})
            return dispatch, combine, aux
        m.route = route
    return out


def _switch_expert_bytes(model):
    """Bytes of the experts' parameters and their AdamW moments."""
    names = [k for k in model._trainable() if ".experts." in k]
    params = dict(model.network.named_parameters())
    opt = model._opt_state or {}
    return sum(_tree_bytes(params[k]) + sum(
        _tree_bytes(opt[s][k]) for s in ("m", "v") if k in opt.get(s, {}))
        for k in names)


def _switch_run(model, ids, labels):
    """SWITCH_STEPS train steps: losses, walls, the step-1 routing, B1-B3
    launches, the ep exchange's host seconds a step, expert bytes."""
    from paddle_tpu_torch.parallel import collective as coll
    routing = _switch_routing(model.network)
    _reset_flash_counts()
    coll.ep_seconds = 0.0
    losses, walls = [], []
    for i in range(SWITCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(model.train_batch([ids[i]], [labels[i]])["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    run = {"losses": losses, "step_s": walls, "launches": _flash_counts(),
           "routing_step1": routing,
           "ep_exchange_s_per_step": coll.ep_seconds / SWITCH_STEPS,
           "expert_bytes": _switch_expert_bytes(model),
           "params": sum(p.numel() for p in model.network.parameters())}
    if model._sync is not None:
        run["reduce_s_per_step"] = model._sync.reduce_seconds / SWITCH_STEPS
    # an evaluation of the trained weights, for the reload check
    run["eval_loss"] = float(model.eval_batch([ids[0]], [labels[0]])["loss"])
    return run


def _moe_rank(outdir, rank, res, t_launch):
    """The moe_ep phase's rank body (``--dist-rank ep2``): the encoder on
    an ep=2 mesh, 3 steps, the rank's expert shapes, a save."""
    from paddle_tpu_torch import parallel
    res["first_step_s"] = time.time() - t_launch
    mesh = parallel.DeviceMesh(ep=2)
    model = _switch_model(_switch_net(f"cuda:{torch.cuda.current_device()}"))
    parallel.distributed_model(model, mesh=mesh)
    res["ep_index"] = mesh.local_rank("ep")
    res["mesh"] = repr(mesh)
    ids, labels = _switch_data()
    res["run"] = _switch_run(model, ids, labels)
    net = model.network
    res["expert_shapes"] = {
        k: list(p.shape) for k, p in net.named_parameters()
        if k.startswith("blocks.1.ffn.experts.w_")}
    model.save(os.path.join(outdir, "ep2_saved"), training=False)


def phase_moe_ep(info, dev="cuda") -> dict:
    """The Switch-Base-8 encoder: 3 steps in this process, then 3 on an
    ep=2 mesh of two ranks of this script (``--dist-rank ep2``) sharing
    the card over gloo, both from the same weights; the save of the mesh
    reloaded here. Returns the B1-B3 launches of the two runs."""
    import shutil
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "moe_ep")
    shutil.rmtree(root, ignore_errors=True)
    outdir = os.path.join(root, "ep2")
    os.makedirs(outdir)
    me = os.path.basename(os.path.abspath(__file__))
    ids, labels = _switch_data()
    model = _switch_model(_switch_net(dev))
    one = _switch_run(model, ids, labels)
    trained = {k: v.detach().float().cpu().clone()
               for k, v in model.network.state_dict().items()}
    prof = _profile(lambda: [model.train_batch([ids[0]], [labels[0]])
                             for _ in range(SWITCH_PROFILE_STEPS)],
                    SWITCH_PROFILE_STEPS, "step", phase="moe_ep",
                    run="profile one process", steps=SWITCH_PROFILE_STEPS)
    emit(prof)
    del model
    torch.cuda.empty_cache()
    t0 = time.time()
    proc = _launch(["--nproc_per_node", "2", me, "--dist-rank", "ep2",
                    outdir, repr(t0)], os.path.join(outdir, "logs"))
    _finish([proc], "ep2", os.path.join(outdir, "logs"))
    job_s = time.time() - t0
    ranks = _read_ranks(outdir, 2)
    runs = [r["run"] for r in ranks]

    # the ep=2 save reloaded into one process: its parameters against the
    # one-process run's, and its evaluation against the ranks'
    net = _switch_net(dev)
    model = _switch_model(net)
    model.load(os.path.join(outdir, "ep2_saved"), reset_optimizer=True)
    reload_eval = float(model.eval_batch([ids[0]], [labels[0]])["loss"])
    param_rel = {}
    for k, v in net.state_dict().items():
        a, b = v.detach().float().cpu(), trained[k]
        param_rel[k] = float((a - b).norm() / b.norm()) if b.norm() else \
            float((a - b).norm())
    del model, net, trained
    torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    per_step = 12 * SWITCH_STEPS
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    n_exp, d, f = SWITCH["experts"] // 2, SWITCH["d_model"], SWITCH["d_ff"]
    checks = {
        "ranks_losses_bit_equal": runs[0]["losses"] == runs[1]["losses"],
        "ep_losses_within_rtol": rel(runs[0]["losses"], one["losses"])
        <= TRAIN_LOSS_RTOL,
        "params_within_rtol": max(param_rel.values()) <= SWITCH_PARAM_RTOL,
        "gate_params_within_rtol": max(
            v for k, v in param_rel.items() if ".gate." in k)
        <= SWITCH_PARAM_RTOL,
        "step1_routing_equal": all(r["routing_step1"] == one["routing_step1"]
                                   for r in runs),
        "launches_one_process": all(one["launches"][k] == per_step
                                    for k in flash),
        "launches_each_rank": all(r["launches"][k] == per_step
                                  for r in runs for k in flash),
        "expert_shapes": all(r["expert_shapes"] == {
            "blocks.1.ffn.experts.w_in": [n_exp, d, f],
            "blocks.1.ffn.experts.w_out": [n_exp, f, d]} for r in ranks),
        "expert_bytes_ratio": all(
            r["expert_bytes"] <= SWITCH_EXPERT_BYTES_RATIO
            * one["expert_bytes"] for r in runs),
        "reload_eval_within_rtol": abs(reload_eval - runs[0]["eval_loss"])
        <= TRAIN_LOSS_RTOL * abs(runs[0]["eval_loss"]),
        "losses_finite": all(math.isfinite(v) for r in runs + [one]
                             for v in r["losses"]),
    }

    def mean(xs):   # the steps after the first (which warms up)
        return sum(xs[1:]) / len(xs[1:])
    emit({"phase": "moe_ep", "model": "switch-base-8 encoder",
          "card": info["nvidia_smi"], "params": one["params"],
          "batch": SWITCH_BATCH, "seq": SWITCH_SEQ, "amp": "O1",
          "one_process": {k: one[k] for k in (
              "losses", "step_s", "launches", "expert_bytes", "eval_loss")},
          "ep2": [{k: r[k] for k in (
              "losses", "step_s", "launches", "expert_bytes",
              "ep_exchange_s_per_step", "reduce_s_per_step", "eval_loss")}
                  for r in runs],
          "routing_step1": one["routing_step1"],
          "ep2_step_over_one": mean(runs[0]["step_s"]) / mean(one["step_s"]),
          "flash_share_one_process": prof["flash_share"],
          "idle_share_one_process": prof["idle_share"],
          "max_param_rel": max(param_rel.values()),
          "reload_eval_loss": reload_eval, "job_s": job_s,
          "spawn_to_first_step_s": [r["first_step_s"] for r in ranks],
          "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "moe_ep_checks", **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"moe_ep phase failed: {bad}")
    launches = {k: one["launches"][k] + sum(r["launches"][k] for r in runs)
                for k in flash}
    return launches


# ---------------------------------------------------------------------------
# the CTR path: host-RAM tables, the device tables, the key-sharded table
# ---------------------------------------------------------------------------

CTR_N, CTR_BATCH, CTR_STEPS, CTR_VOCAB = 10240, 512, 20, 10 ** 8
CTR_DEVICE_VOCAB = 10 ** 6      # WideDeep / DeepFM's MultiSlotEmbedding
CTR_LOSS_RTOL = 1e-4            # card vs CPU, each step
CTR_ROW_ATOL, CTR_ROW_RTOL = 1e-5, 1e-4
CTR_PEAK_SLACK = 2 ** 20        # peak step bytes, 10^6 vs 10^8 ids
CTR_SHARD_STEPS, CTR_SHARD_BATCH, CTR_SHARD_TOL = 3, 64, 1e-6


def _ctr_batches(vocab=CTR_VOCAB):
    from paddle_tpu_torch.models.widedeep import synthetic_criteo
    d, s, y = synthetic_criteo(n=CTR_N, vocab_size=vocab, seed=0)
    return [(d[i:i + CTR_BATCH], s[i:i + CTR_BATCH], y[i:i + CTR_BATCH])
            for i in range(0, CTR_N, CTR_BATCH)][:CTR_STEPS]


def _ctr_model(net, lr):
    import paddle_tpu_torch as pt
    model = pt.Model(net)
    model.prepare(pt.optimizer.Adam(learning_rate=lr, parameters=net),
                  pt.nn.BCEWithLogitsLoss())
    return model


def _ctr_train(net, batches, dev, lr, timers=None):
    """Train steps over ``batches`` on ``dev``: the losses and the wall."""
    model = _ctr_model(net, lr)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for d, s, y in batches:
        out = model.train_batch(
            [torch.as_tensor(d, device=dev), torch.as_tensor(s)],
            [torch.as_tensor(y, device=dev)])
        losses.append(float(out["loss"]))
    _sync(dev)
    return losses, time.perf_counter() - t0


def _timed_tables(net):
    """Host seconds each table spends in its pull and push."""
    acc = {"pull": 0.0, "push": 0.0}
    for t in (net.wide, net.embedding):
        for kind in ("pull", "push"):
            inner = getattr(t, f"_{kind}")

            def timed(*a, inner=inner, kind=kind):
                t0 = time.perf_counter()
                out = inner(*a)
                acc[kind] += time.perf_counter() - t0
                return out
            setattr(t, f"_{kind}", timed)
    return acc


def _auc(net, batch, dev):
    from paddle_tpu_torch.metric import Auc
    d, s, y = batch
    net.eval()
    with torch.no_grad():
        p = torch.sigmoid(net(torch.as_tensor(d, device=dev),
                              torch.as_tensor(s))).cpu().numpy()
    net.train()
    a = Auc()
    a.update(p, y)
    return float(a.accumulate())


def _ctr_peak_bytes(vocab, batch, dev):
    """Peak device bytes above the model of one WideDeepHostTable train
    step at a ``vocab``-id space."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.widedeep import WideDeepHostTable
    pt.seed(0)
    net = WideDeepHostTable(vocab_size=vocab).to(dev)
    model = _ctr_model(net, 1e-3)
    d, s, y = batch
    args = ([torch.as_tensor(d, device=dev), torch.as_tensor(s)],
            [torch.as_tensor(y, device=dev)])
    model.train_batch(*args)        # the optimizer state exists now
    _sync(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model.train_batch(*args)
    _sync(dev)
    return torch.cuda.max_memory_allocated() - base


def _ctr_rank(outdir, rank, res):
    """The ctr phase's rank body (``--dist-rank ctr2``): a key-sharded
    table on a dp=2 mesh, CTR_SHARD_STEPS lookups of the rank's rows and
    pushes, then a shard snapshot."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.nn import ShardedHostEmbedding
    dev = f"cuda:{torch.cuda.current_device()}"
    parallel.init_mesh(dp=2)
    ids, r = _ctr_shard_data()
    n = CTR_SHARD_BATCH // 2
    mine = slice(rank * n, (rank + 1) * n)
    sh = ShardedHostEmbedding(CTR_VOCAB, 16, hash_ids=True).to(dev)
    weight = torch.as_tensor(r[mine], device=dev)
    pulled = []
    t0 = time.perf_counter()
    for _ in range(CTR_SHARD_STEPS):
        out = sh(torch.as_tensor(ids[mine]))
        pulled.append(out.detach().cpu().numpy())
        (out * weight).sum().backward()
    torch.cuda.synchronize()
    res["step_s"] = (time.perf_counter() - t0) / CTR_SHARD_STEPS
    np.save(os.path.join(outdir, f"pulled{rank}.npy"), np.stack(pulled))
    res["touched_local"] = sh.touched_rows_local
    res["shard"] = sh.snapshot_shard(os.path.join(outdir, "table"))
    parallel.set_mesh(None)


def _ctr_shard_data():
    rs = np.random.RandomState(5)
    ids = rs.randint(1, 2 ** 31 - 1, (CTR_SHARD_BATCH, 26))
    ids[:, :3] = ids[:1, :3]       # ids both ranks look up
    return ids, rs.randn(CTR_SHARD_BATCH, 16).astype(np.float32)


def phase_ctr(info, dev="cuda") -> None:
    """WideDeepHostTable at its defaults, card against CPU; WideDeep and
    DeepFM on their device tables, card against CPU; the key-sharded
    table on two ranks of this script (``--dist-rank ctr2``) sharing the
    card over gloo, against one process's table."""
    import shutil
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import widedeep as wd
    from paddle_tpu_torch.nn import HostOffloadedEmbedding
    from paddle_tpu_torch.nn.layers import native_accessor as na
    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "ctr")
    shutil.rmtree(root, ignore_errors=True)
    outdir = os.path.join(root, "ctr2")
    os.makedirs(outdir)
    me = os.path.basename(os.path.abspath(__file__))
    t_job = time.time()
    proc = _launch(["--nproc_per_node", "2", me, "--dist-rank", "ctr2",
                    outdir, repr(t_job)], os.path.join(outdir, "logs"))

    # WideDeepHostTable: the same dense weights (seed) and lazy rows
    batches = _ctr_batches()
    host = {}
    pushes = dict(na.counts)
    for where in (dev, "cpu"):
        pt.seed(0)
        net = wd.WideDeepHostTable().to(where)
        acc = _timed_tables(net)
        losses, wall = _ctr_train(net, batches, where, 1e-3)
        host[where] = {"net": net, "losses": losses, "wall": wall,
                       "pull_s_per_step": acc["pull"] / CTR_STEPS,
                       "push_s_per_step": acc["push"] / CTR_STEPS}
    native = {k: na.counts[k] - pushes[k] for k in pushes}
    card, cpu = host[dev], host["cpu"]
    row_worst, touched = 0.0, {}
    for t in ("wide", "embedding"):
        a, b = getattr(card["net"], t), getattr(cpu["net"], t)
        touched[t] = (a.touched_rows, b.touched_rows)
        ids = np.sort(np.asarray(list(b._rows)))
        ra, rb = a._pull(ids), b._pull(ids)
        lim = CTR_ROW_ATOL + CTR_ROW_RTOL * np.abs(rb)
        row_worst = max(row_worst, float((np.abs(ra - rb) / lim).max()))
    # a snapshot / restore round trip of the card run's table
    table = card["net"].embedding
    snap = os.path.join(root, "embedding.npz")
    table.snapshot(snap)
    fresh = HostOffloadedEmbedding(CTR_VOCAB, 16, hash_ids=True,
                                   learning_rate=0.05)
    fresh.restore(snap)
    probe = np.sort(np.asarray(list(table._rows)))
    snap_equal = bool(np.array_equal(fresh._pull(probe),
                                     table._pull(probe)))
    del host
    peak = {v: _ctr_peak_bytes(v, batches[0], dev)
            for v in (10 ** 6, CTR_VOCAB)}

    # WideDeep and DeepFM on their device tables
    dense_models = {}
    for name in ("WideDeep", "DeepFM"):
        dev_batches = _ctr_batches(CTR_DEVICE_VOCAB)
        runs = {}
        for where in (dev, "cpu"):
            pt.seed(0)
            net = getattr(wd, name)(vocab_size=CTR_DEVICE_VOCAB).to(where)
            first = _auc(net, dev_batches[0], where)
            losses, wall = _ctr_train(net, dev_batches, where, 1e-2)
            runs[where] = {"losses": losses, "wall": wall,
                           "auc_first": first,
                           "auc_last": _auc(net, dev_batches[0], where)}
            del net
        dense_models[name] = runs

    # the key-sharded table against one process's table on the card
    _finish([proc], "ctr2", os.path.join(outdir, "logs"))
    job_s = time.time() - t_job
    ranks = _read_ranks(outdir, 2)
    ids, r = _ctr_shard_data()
    one = HostOffloadedEmbedding(CTR_VOCAB, 16, hash_ids=True).to(dev)
    weight = torch.as_tensor(r, device=dev)
    one_pulled = []
    for _ in range(CTR_SHARD_STEPS):
        out = one(torch.as_tensor(ids))
        one_pulled.append(out.detach().cpu().numpy())
        (out * weight).sum().backward()
    one_pulled = np.stack(one_pulled)
    got = np.concatenate([np.load(os.path.join(outdir, f"pulled{k}.npy"))
                          for k in range(2)], axis=1)
    from paddle_tpu_torch.nn import ShardedHostEmbedding
    back = ShardedHostEmbedding(CTR_VOCAB, 16, hash_ids=True)
    back.restore_shards([k["shard"] for k in ranks])
    keys = np.sort(np.asarray(list(one._rows)))
    shard_err = float(np.abs(back._local._pull(keys) - one._pull(keys)).max())

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))
    checks = {
        "host_losses_within_rtol": rel(card["losses"], cpu["losses"])
        <= CTR_LOSS_RTOL,
        "host_touched_equal": all(a == b and a > 0
                                  for a, b in touched.values()),
        "host_rows_within_limit": row_worst <= 1.0,
        "native_rule_every_push": native == {"native": 4 * CTR_STEPS,
                                             "numpy": 0},
        "peak_independent_of_vocab": abs(peak[CTR_VOCAB] - peak[10 ** 6])
        < CTR_PEAK_SLACK,
        "snapshot_roundtrip_bit_equal": snap_equal,
        "sharded_step0_rows_bit_equal": bool(np.array_equal(
            got[0], one_pulled[0])),
        "sharded_rows_after_pushes": float(np.abs(
            got - one_pulled).max()) <= CTR_SHARD_TOL,
        "sharded_restore_rekeys_every_row":
            back.touched_rows_local == one.touched_rows
            and shard_err <= CTR_SHARD_TOL,
        "sharded_ranks_split_rows": sum(k["touched_local"] for k in ranks)
        == one.touched_rows,
    }
    for name, runs in dense_models.items():
        checks[f"{name}_losses_within_rtol"] = rel(
            runs[dev]["losses"], runs["cpu"]["losses"]) <= CTR_LOSS_RTOL
        checks[f"{name}_auc_improves"] = \
            runs[dev]["auc_last"] > runs[dev]["auc_first"]
    checks["losses_finite"] = all(
        math.isfinite(v) for v in card["losses"] + cpu["losses"])
    emit({"phase": "ctr", "card": info["nvidia_smi"],
          "host_table": {
              "vocab": CTR_VOCAB, "dim": 16, "slots": 26,
              "batch": CTR_BATCH, "steps": CTR_STEPS,
              "losses_card": card["losses"], "losses_cpu": cpu["losses"],
              "max_rel_loss": rel(card["losses"], cpu["losses"]),
              "touched": touched, "row_err_over_limit": row_worst,
              "steps_per_s_card": CTR_STEPS / card["wall"],
              "pull_s_per_step_card": card["pull_s_per_step"],
              "push_s_per_step_card": card["push_s_per_step"],
              "pull_s_per_step_cpu": cpu["pull_s_per_step"],
              "push_s_per_step_cpu": cpu["push_s_per_step"],
              "native_pushes": native, "peak_step_bytes": peak},
          "device_tables": {name: {w: {k: v for k, v in run.items()}
                                   for w, run in runs.items()}
                            for name, runs in dense_models.items()},
          "sharded": {"ranks": 2, "steps": CTR_SHARD_STEPS,
                      "step_s": [k["step_s"] for k in ranks],
                      "touched_local": [k["touched_local"] for k in ranks],
                      "one_process_rows": one.touched_rows,
                      "max_err_vs_one": float(np.abs(
                          got - one_pulled).max()),
                      "restore_max_err": shard_err, "job_s": job_s},
          "phase_s": time.perf_counter() - t_phase})
    emit({"phase": "ctr_checks", **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise SystemExit(f"ctr phase failed: {bad}")


# -- the tensor and math API (ROADMAP A7.2) -----------------------------------

TENSOR_ATOL, TENSOR_RTOL = 1e-5, 1e-4  # card vs CPU: the nn phase's limit
TENSOR_LINALG_N = 4096
TENSOR_LINALG_RESIDUAL = 1e-3          # relative residual of each factorization
TENSOR_RFFT_N = 2 ** 24
TENSOR_FFT2_N = 4096
TENSOR_FFT_REL = 1e-5                  # relative L2 error
# openai/whisper whisper/audio.py: SAMPLE_RATE, N_FFT, HOP_LENGTH, 80 mels,
# 30 s chunks; a batch of 8 clips
WHISPER = dict(rate=16000, n_fft=400, hop=160, n_mels=80, clips=8,
               seconds=30)
WHISPER_ROUNDTRIP_REL = 1e-5           # istft(stft(x)) against x, L2
WHISPER_LOGMEL_ATOL = 1e-3             # card vs CPU log-mel, absolute
# ogbn-arxiv's counts (OGB node property prediction); the graph is drawn
ARXIV = dict(nodes=169343, edges=1166243, features=128)
TENSOR_DRAWS = (100, 100000)           # 10^7 draws; row 0 checked on the CPU
TENSOR_REJECTION_DRAWS = 100000        # Beta / Dirichlet / Poisson, both sides
TENSOR_MOMENT_SIGMA = 5.0
# the JAX package's Laplace maps u = -0.5 of its uniform draw (one in
# 2^23, ~1.2 in 10^7) to -inf, and the port keeps its bits (ROADMAP
# Queue C); every other sampler draws none
TENSOR_NONFINITE_MAX = 10
TENSOR_PHASE_BUDGET_S = 60.0


def _tensor_cases():
    """``(name, fn(pt, *tensors), numpy inputs, is_draw)`` for every
    ported function of the slice at the CPU tests' sizes: ``fn`` runs
    after ``pt.seed(3)`` on the device ``set_device`` chose."""
    rs = np.random.RandomState(0)
    f32 = np.float32

    def u(*shape, lo=-1.0, hi=1.0):
        return rs.uniform(lo, hi, shape).astype(f32)

    def pos(*shape):
        return rs.uniform(1.1, 3.0, shape).astype(f32)

    def ints(*shape, hi=5):
        return rs.randint(0, hi, shape).astype(np.int64)

    def spd(n):
        a = u(n, n)
        return (a @ a.T + n * np.eye(n, dtype=f32)).astype(f32)

    ties = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 5, 0, 1]], f32)
    unary = ["exp", "expm1", "sin", "cos", "tan", "asin", "acos", "atan",
             "sinh", "cosh", "tanh", "asinh", "atanh", "abs", "sign",
             "floor", "ceil", "round", "trunc", "square", "erf",
             "reciprocal", "erfinv", "neg", "frac", "deg2rad", "rad2deg",
             "stanh", "rsqrt_", "exp_", "tanh_", "erfinv_", "round_",
             "ceil_", "floor_", "reciprocal_", "flatten_", "isnan",
             "isinf", "isfinite", "logit", "conj", "real", "imag",
             "angle", "clone", "assign", "numel", "shape", "t", "squeeze",
             "squeeze_", "median", "mean", "std", "var", "prod", "max",
             "min", "amax", "amin", "logsumexp", "cumsum", "logcumsumexp",
             "sum", "argmax", "argmin", "argsort", "sort", "mode",
             "unique", "nonzero", "flatten", "diag", "tril", "triu",
             "diagonal", "diag_embed", "diagflat", "nansum", "nanmean",
             "nanmedian", "norm", "frobenius_norm", "rank", "is_empty"]
    positive = ["log", "log2", "log10", "log1p", "sqrt", "rsqrt",
                "lgamma", "digamma", "acosh", "cumprod", "sqrt_"]
    binary = ["add", "subtract", "multiply", "divide", "maximum",
              "minimum", "fmax", "fmin", "logaddexp", "hypot", "atan2",
              "pow", "floor_divide", "mod", "remainder", "floor_mod",
              "equal", "not_equal", "greater_than", "greater_equal",
              "less_than", "less_equal", "matmul", "mm", "bmm", "dot",
              "kron", "inner", "dist", "isclose", "allclose", "equal_all",
              "add_", "subtract_", "cross"]
    cases = []
    for f in unary:
        cases.append((f, lambda pt, x, f=f: getattr(pt.tensor, f)(x),
                      [u(3, 3, lo=-0.9, hi=0.9)], False))
    for f in positive:
        cases.append((f, lambda pt, x, f=f: getattr(pt.tensor, f)(x),
                      [pos(3, 4)], False))
    for f in binary:
        cases.append((f, lambda pt, x, y, f=f: getattr(pt.tensor, f)(x, y),
                      [pos(3, 3), pos(3, 3)], False))
    for f in ("logical_and", "logical_or", "logical_xor", "bitwise_and",
              "bitwise_or", "bitwise_xor", "gcd", "lcm"):
        cases.append((f, lambda pt, x, y, f=f: getattr(pt.tensor, f)(x, y),
                      [ints(8, hi=16) + 1, ints(8, hi=16) + 1], False))
    cases += [
        ("creation", lambda pt: [
            pt.zeros([2, 3]), pt.ones([2], "int32"), pt.full([2], 1.5),
            pt.arange(2, 11, 3), pt.linspace(-1, 2, 7), pt.eye(3, 4),
            pt.empty([2]), pt.tril_indices(4, 5, 1), pt.triu_indices(4),
            pt.tensor.logspace(0, 2, 5), pt.to_tensor([[1.0, 2.0]]),
            pt.meshgrid(pt.arange(3), pt.arange(2)),
            pt.fft.fftfreq(8, 0.5), pt.fft.rfftfreq(9)], [], False),
        ("like", lambda pt, x: [pt.zeros_like(x), pt.ones_like(x, "int32"),
                                pt.full_like(x, 2.0), pt.empty_like(x),
                                pt.logical_not(x > 0),
                                pt.bitwise_not(pt.cast(x, "int32"))],
         [u(2, 3)], False),
        ("reductions", lambda pt, x: [
            pt.sum(x, [0, 2], keepdim=True), pt.mean(x, 1),
            pt.prod(x, [0, 2]), pt.max(x, 0), pt.std(x, 1, False),
            pt.var(x, 0, True, True), pt.median(x, 1),
            pt.quantile(x, 0.3, 1), pt.all(x > -2, 1), pt.any(x > 0.9, 0),
            pt.tensor.nanquantile(x, 0.25), pt.logsumexp(x, [1, 2])],
         [u(2, 3, 4)], False),
        ("manipulation", lambda pt, x: [
            pt.reshape(x, [8, -1]), pt.transpose(x, [1, 0]),
            pt.moveaxis(x, 0, 1), pt.swapaxes(x, 0, 1),
            pt.concat([x, x], 1), pt.stack([x, x], 2), pt.unstack(x, 1),
            pt.unbind(x), pt.split(x, 2, 1), pt.split(x, [1, 3], 1),
            pt.chunk(x, 3), pt.unsqueeze(x, [0, -1]), pt.unsqueeze_(x, 0),
            pt.reshape_(x, [2, 8]), pt.tile(x, [2, 1]),
            pt.expand(x[:1], [4, 4]), pt.broadcast_to(x[0], [2, 4]),
            pt.broadcast_tensors([x[:1], x]), pt.expand_as(x[:1], x),
            pt.flip(x, [0, 1]), pt.tensor.reverse(x, 1), pt.roll(x, 2, 1),
            pt.roll(x, 3), pt.rot90(x, 3), pt.repeat_interleave(x, 2, 1),
            pt.as_real(pt.as_complex(x[:, :2])), pt.increment(x, 2.0),
            pt.slice(x, [0, 1], [1, -3], [3, 100]),
            pt.strided_slice(x, [0, 1], [2, 3], [0, 0], [-1, -2]),
            pt.tensor.crop(x, [2, -1], [1, 2]), pt.clip(x, -0.3, 0.4),
            pt.clip_(x, -0.3, 0.4), pt.scale(x, 2.0, 0.5, False),
            pt.scale_(x, 2.0), pt.masked_select(x, x > 0),
            pt.masked_fill(x, x > 0, -1.0), pt.where(x > 0, x, -x),
            pt.where(x > 0), pt.nonzero(x > 0, True), pt.trace(x, 1),
            pt.diff(x, 2), pt.tensor.renorm(x, 2, 0, 0.5), pt.add_n([x, x]),
            pt.kthvalue(x, 2), pt.topk(x, 2), pt.topk(x, 2, 0, False),
            pt.einsum("ij,kj->ik", x, x), pt.outer(x[0], x[1]),
            pt.mv(x, x[0]), pt.addmm(x, x, pt.t(x)[:, :4] * 0 + 1),
            pt.tensor.tensordot(x, x, [[1], [1]]),
            pt.nan_to_num(pt.log(x)), pt.heaviside(x, 0.5),
            pt.lerp(x, x * 2, 0.25), pt.lerp_(x, -x, x),
            pt.clip_by_norm(x, 0.5)],
         [u(4, 4)], False),
        ("indexing", lambda pt, x, i, j: [
            pt.gather(x, i[:, 0], 0), pt.gather(x, j, 1), pt.gather_nd(x, j),
            pt.take_along_axis(x, j, 1), pt.put_along_axis(x, j, 9.0, 1),
            pt.put_along_axis_(x, j, 9.0, 1), pt.index_select(x, i[:, 0], 1),
            pt.index_sample(x, j), pt.scatter(x, i[:2, 0], x[:2] * 0),
            pt.scatter_(x, pt.arange(2), x[:2]),
            pt.scatter(x, i[:, 0], x, overwrite=False),
            pt.scatter_nd_add(x, j, x[:, 0]),
            pt.tensor.scatter_nd(j, x[:, 0], [4, 4]),
            pt.multiplex([x, -x], i[:, :1] % 2), pt.shard_index(i, 8, 2, 1),
            pt.searchsorted(pt.sort(x[0]), x[1]),
            pt.bincount(i[:, 0], minlength=8), pt.histogram(x, 7),
            pt.histogram(x, 5, -0.5, 0.5), pt.unique(i, True, True, True),
            pt.unique(j, return_index=True, axis=0),
            pt.unique_consecutive(pt.sort(i[:, 0]), True, True),
            pt.gather_tree(i[:, :2, None].expand(4, 2, 3) % 3,
                           j[:, :, None].expand(4, 2, 3) % 3)],
         [u(4, 4), ints(4, 2, hi=4), ints(4, 2, hi=4)], False),
        ("ties", lambda pt, x: [
            pt.argsort(x, descending=True), pt.sort(x, 0, True),
            pt.topk(x, 3), pt.topk(x, 3, largest=False), pt.kthvalue(x, 2),
            pt.mode(x), pt.mode(pt.t(x), 0, True), pt.argmax(x, 1),
            pt.argmax(x, keepdim=True)], [ties], False),
        ("segment", lambda pt, d, s: [
            pt.segment_sum(d, s), pt.segment_mean(d, s),
            pt.segment_max(d, s), pt.segment_min(d, s, 6)],
         [u(6, 3), np.array([0, 0, 1, 3, 3, 3])], False),
        ("draws", lambda pt: [
            pt.rand([64]), pt.randn([512]), pt.uniform([64], min=-2., max=3.),
            pt.normal(1.0, 2.0, [64]), pt.tensor.standard_normal([64]),
            pt.randint(-5, 17, [64]), pt.randperm(1000),
            pt.randperm(70000), pt.bernoulli(pt.full([64], 0.3)),
            pt.multinomial(pt.to_tensor(np.array([[.1, .2, .3, .4]], f32)),
                           50, True),
            pt.multinomial(pt.to_tensor(np.array([[.1, .2, .3, .4]] * 2,
                                                 f32)), 3),
            pt.multinomial(pt.to_tensor(np.array([[.1, .2, .7]], f32))),
            pt.tensor.exponential_(pt.zeros([64]), 2.0),
            pt.tensor.uniform_(pt.zeros([64]), -1.0, 4.0),
            pt.tensor.randint_like(pt.zeros([64]), 3, 9),
            pt.poisson(pt.to_tensor(np.array([0., .5, 9.9, 10., 250.] * 8,
                                             f32)))], [], True),
        ("linalg", lambda pt, a, b, m: [
            pt.linalg.cholesky(a), pt.linalg.cholesky(a, upper=True),
            pt.linalg.det(a), list(pt.linalg.slogdet(m)), pt.linalg.inv(a),
            pt.linalg.pinv(m[:, :3]), pt.linalg.matrix_power(m, 3),
            pt.linalg.matrix_rank(m), pt.linalg.multi_dot([m, a, m]),
            pt.linalg.solve(a, b), pt.linalg.cond(a),
            pt.linalg.norm(m, "fro"), pt.linalg.norm(m, 2, 1),
            pt.linalg.cov(m), pt.linalg.corrcoef(m),
            pt.linalg.cholesky_solve(b, pt.linalg.cholesky(a)),
            pt.linalg.triangular_solve(pt.triu(a), b),
            pt.linalg.eigvalsh(a), pt.linalg.svdvals(m),
            pt.abs(pt.linalg.qr(m)[1]), pt.linalg.lu(m),
            list(pt.linalg.lu_unpack(*pt.linalg.lu(m)[:2])),
            pt.linalg.lstsq(m, b), pt.linalg.householder_product(
                m[:, :3], b[:3, 0]), pt.linalg.pca_lowrank(a, 2)[1],
            pt.inverse(a), pt.p_norm(m, 1.5, 1)],
         [spd(4), u(4, 2), u(4, 4)], False),
        ("fft", lambda pt, x, z: [
            pt.fft.fft(z), pt.fft.ifft(z, norm="ortho"), pt.fft.fft2(z),
            pt.fft.ifft2(z), pt.fft.fftn(z), pt.fft.ifftn(z, norm="forward"),
            pt.fft.rfft(x), pt.fft.irfft(z), pt.fft.rfft2(x),
            pt.fft.irfft2(z), pt.fft.rfftn(x), pt.fft.irfftn(z),
            pt.fft.hfft(z), pt.fft.ihfft(x), pt.fft.hfft2(z),
            pt.fft.ihfft2(x), pt.fft.hfftn(z), pt.fft.ihfftn(x),
            pt.fft.fftshift(x), pt.fft.ifftshift(x, [1])],
         [u(4, 8), (u(4, 5) + 1j * u(4, 5)).astype(np.complex64)], False),
        ("signal", lambda pt, x: [
            pt.signal.frame(x, 6, 3), pt.signal.frame(pt.t(x), 6, 4, 0),
            pt.signal.stft(x, 16), pt.signal.stft(x, 16, 5, 10),
            pt.signal.istft(pt.signal.stft(x, 16, 4), 16, 4, length=70),
            pt.signal.istft(pt.signal.stft(x, 16, center=False,
                                           onesided=False), 16,
                            center=False, onesided=False)],
         [u(2, 80)], False),
        ("sparse", lambda pt, i, v, d: _tensor_sparse_case(pt, i, v, d),
         [np.array([[0, 1, 1, 3, 0], [2, 0, 4, 5, 2]]), u(5), u(6, 4)],
         False),
        ("distribution", lambda pt, v: _tensor_dist_case(pt, v),
         [u(3, lo=0.1, hi=0.9)], False),
        ("distribution_draws", lambda pt, v: [
            d.sample([64]) for d in _tensor_dists(pt, v)], [u(3, lo=0.1,
                                                              hi=0.9)],
         True),
        ("autograd", lambda pt, x: _tensor_autograd_case(pt, x),
         [u(6)], False),
    ]
    return cases


def _tensor_dists(pt, v):
    D = pt.distribution
    return [D.Normal(v, v + 1), D.Uniform(-v, v + 1),
            D.Categorical(logits=v), D.Bernoulli(v), D.Laplace(v, 1.5),
            D.Exponential(v + 0.5), D.Gumbel(v, 2.0),
            D.Multinomial(5, v / v.sum()), D.Beta(v, v + 1.0),
            D.Dirichlet(v + 0.2)]


def _tensor_dist_case(pt, v):
    D = pt.distribution
    out = []
    base = D.Distribution
    for d in _tensor_dists(pt, v):
        x = d.sample([4])
        out += [d.log_prob(x), d.prob(x)]
        # the moments and the entropy each class defines
        out += [getattr(d, a) for a in ("mean", "variance")
                if getattr(type(d), a) is not getattr(base, a)]
        if type(d).entropy is not base.entropy:
            out.append(d.entropy())
    n = D.Normal(v, v + 1)
    out += [D.kl_divergence(n, D.Normal(v * 2, v + 2)),
            D.kl_divergence(D.Uniform(-v, v + 1), n),
            D.kl_divergence(D.Categorical(logits=v),
                            D.Categorical(logits=-v))]
    y = pt.tanh(v)
    for t in (D.AbsTransform(), D.AffineTransform(0.5, 2.0),
              D.ExpTransform(), D.PowerTransform(3.0),
              D.SigmoidTransform(), D.TanhTransform(),
              D.StickBreakingTransform(), D.ReshapeTransform((3,), (3, 1)),
              D.ChainTransform([D.ExpTransform(), D.TanhTransform()]),
              D.IndependentTransform(D.ExpTransform(), 1),
              D.StackTransform([D.ExpTransform()] * 3)):
        out += [t.forward(y), t.inverse(t.forward(y)),
                t.forward_log_det_jacobian(y)]
    out += [D.SoftmaxTransform().forward(y),
            D.TransformedDistribution(n, [D.ExpTransform()]).log_prob(
                v + 1),
            D.Independent(n, 1).log_prob(v), D.Independent(n, 1).entropy()]
    return out


def _tensor_sparse_case(pt, i, v, d):
    S = pt.sparse
    a = S.sparse_coo_tensor(i, v, [5, 6])
    w = v.clone().requires_grad_(True)
    dd = d.clone().requires_grad_(True)
    y = S.matmul(S.sparse_coo_tensor(i, w, [5, 6]), dd)
    (y * y).sum().backward()
    out = [y, w.grad, dd.grad, S.coalesce(a).indices(),
           S.coalesce(a).values(), S.softmax(a).to_dense(),
           S.mv(a, d[:, 0]), S.addmm(d[:5, :3], a, d[:, :3], 0.5, 2.0),
           S.masked_matmul(d[:5], pt.t(d), a).to_dense(),
           (a + a).to_dense(), S.subtract(a, S.scale(a, 3.0)).to_dense(),
           S.multiply(a, 2.5).to_dense(),
           S.divide(a, 4.0).to_dense(), S.transpose(a, [1, 0]).to_dense(),
           S.to_sparse_coo(a.to_dense()).values(),
           list(S.to_sparse_csr(a.to_dense())), S.pow(a, 2).to_dense(),
           S.segment_softmax(v, i[0], 5)]
    for f in ("relu", "tanh", "sin", "square", "abs", "neg", "expm1",
              "cos", "atan", "sinh", "tan", "relu6", "leaky_relu", "asinh",
              "deg2rad", "rad2deg", "asin", "atanh", "acos"):
        out.append(getattr(S, f)(S.scale(a, 0.5)).to_dense())
    q = d[None, None, :, :].expand(2, 2, 6, 4).contiguous()
    rows, cols = np.nonzero(np.abs(np.subtract.outer(np.arange(6),
                                                     np.arange(6))) <= 1)
    mask = S.sparse_coo_tensor(pt.to_tensor(np.stack([rows, cols])),
                               pt.ones([len(rows)]), [6, 6])
    out.append(S.nn.functional.attention(q, q, q, mask))
    return out


def _tensor_autograd_case(pt, x):
    w = pt.tanh(pt.reshape(pt.arange(48, dtype="float32"), [6, 8]) / 10)

    def f(a):
        return pt.tanh(pt.matmul(a, w))

    def s(a):
        return pt.sum(f(a) ** 2)
    out = [pt.autograd.Jacobian(f, x)[:], pt.autograd.Hessian(s, x)[:],
           pt.grad(s)(x), list(pt.value_and_grad(s)(x)),
           list(pt.autograd.vjp(f, x)), list(pt.autograd.jvp(f, x))]
    tape_net = pt.nn.Linear(6, 3, weight_attr=pt.nn.initializer.Constant(
        0.1)).to(x.device)
    tape = pt.autograd.record(tape_net)
    tape.run(lambda: pt.sum(tape_net(x[None]) ** 2))
    out += [tape.grads["weight"], tape.grads["bias"],
            pt.regularizer.L2Decay(0.1).penalty(dict(
                tape_net.named_parameters()))]
    return out


def _flat_outputs(obj):
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _flat_outputs(o)]
    if hasattr(obj, "to_dense"):
        return [obj.to_dense().detach().cpu()]
    if isinstance(obj, torch.Tensor):
        return [obj.detach().cpu().resolve_conj()]
    return [torch.as_tensor(obj)]


def _tensor_sweep(pt, dev):
    """Every case on the card and on the CPU: the worst float error over
    the limit, the cases that broke an exact or a shape check."""
    worst, bad, n_out = 0.0, [], 0
    for name, fn, arrs, draw in _tensor_cases():
        outs = []
        for d in ("cpu", dev):
            pt.set_device(d)
            ts = [pt.to_tensor(a) for a in arrs]
            pt.seed(3)
            outs.append(_flat_outputs(fn(pt, *ts)))
        cpu, card = outs
        if len(cpu) != len(card):
            bad.append(name)
            continue
        for a, b in zip(cpu, card):
            n_out += 1
            if a.shape != b.shape or a.dtype != b.dtype:
                bad.append(name)
            elif (a.is_floating_point() or a.is_complex()) and not draw:
                err = ((b - a).abs() / (TENSOR_ATOL + TENSOR_RTOL
                                        * a.abs())).nan_to_num(0.0)
                ok = torch.equal(torch.isnan(a), torch.isnan(b))
                worst = max(worst, float(err.max()) if a.numel() else 0.0)
                if not ok:
                    bad.append(name)
            elif not torch.equal(a, b):
                bad.append(name)
    pt.set_device(dev)
    return worst, sorted(set(bad)), n_out


def _warm_timed(fn):
    """``fn()`` run once to set up (cuFFT plans, cuSOLVER workspaces,
    first kernel loads), then again timed: the second result and its
    milliseconds."""
    fn()
    torch.cuda.synchronize()
    return _cuda_timed(fn)


def _cuda_timed(fn):
    """``fn()`` and its milliseconds by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _tensor_linalg(pt):
    """The factorizations at 4096 x 4096 float32, each timed and held to a
    relative residual (``||A x - b|| / (||A|| ||x|| + ||b||)`` for a
    solve, ``||A - factors|| / ||A||`` for a factorization). ``A`` is a
    Gaussian matrix over sqrt(n) plus 2 I (singular values in about
    [1, 3], so full rank under numpy's tolerance; a plain Gaussian square
    matrix has singular values down to ~1 / sqrt(n), below it), the SPD
    matrix ``G G^T / n + I``."""
    n = TENSOR_LINALG_N
    pt.seed(0)
    g = pt.randn([n, n])
    a = g / math.sqrt(n) + 2 * pt.eye(n)
    spd = g @ pt.t(g) / n + pt.eye(n)
    b = pt.randn([n, 4])
    fro = torch.linalg.matrix_norm

    def solve_res(m, x):
        return float(fro(m @ x - b) / (fro(m) * fro(x) + fro(b)))

    def fact_res(m, r):
        return float(fro(m - r) / fro(m))
    res, ms = {}, {}

    def chol():
        low = pt.linalg.cholesky(spd)
        return low, pt.linalg.cholesky_solve(b, low)
    (lo, x), ms["cholesky_solve"] = _warm_timed(chol)
    res["cholesky_solve"] = solve_res(spd, x)
    res["cholesky"] = fact_res(spd, lo @ pt.t(lo))
    x, ms["solve"] = _warm_timed(lambda: pt.linalg.solve(a, b))
    res["solve"] = solve_res(a, x)
    (q, r), ms["qr"] = _warm_timed(lambda: pt.linalg.qr(a))
    res["qr"] = fact_res(a, q @ r)
    (uu, s, vt), ms["svd"] = _warm_timed(lambda: pt.linalg.svd(a))
    res["svd"] = fact_res(a, (uu * s) @ vt)
    (w, v), ms["eigh"] = _warm_timed(lambda: pt.linalg.eigh(spd))
    res["eigh"] = float(fro(spd @ v - v * w) / fro(spd))
    (x, _, rank, _), ms["lstsq"] = _warm_timed(
        lambda: pt.linalg.lstsq(a, b))
    res["lstsq"] = solve_res(a, x)
    (p, l, uu), ms["lu_lu_unpack"] = _warm_timed(
        lambda: pt.linalg.lu_unpack(*pt.linalg.lu(a)[:2]))
    res["lu_lu_unpack"] = fact_res(a, p @ l @ uu)
    del g, a, spd, q, r, uu, vt, v, p, l
    return res, ms, int(rank)


def _tensor_fft(pt):
    pt.seed(1)
    x = pt.randn([TENSOR_RFFT_N])
    y, ms_r = _warm_timed(lambda: pt.fft.irfft(pt.fft.rfft(x),
                                               n=TENSOR_RFFT_N))
    rt = float(torch.linalg.vector_norm(y - x) / torch.linalg.vector_norm(x))
    z = pt.randn([TENSOR_FFT2_N, TENSOR_FFT2_N])
    f, ms_2 = _warm_timed(lambda: pt.fft.fft2(z))
    fc = pt.fft.fft2(z.cpu())
    card_cpu = float(torch.linalg.vector_norm(f.cpu() - fc)
                     / torch.linalg.vector_norm(fc))
    return {"rfft_irfft_roundtrip_rel": rt, "fft2_card_vs_cpu_rel": card_cpu,
            "rfft_irfft_ms": ms_r, "fft2_ms": ms_2}


def _mel_filters(rate, n_fft, n_mels):
    """librosa.filters.mel(sr=rate, n_fft=n_fft, n_mels=n_mels) (Slaney
    scale and norm), the filterbank whisper ships in mel_filters.npz."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3)
        log = f >= 1000.0
        return np.where(log, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        log = m >= 15.0
        return np.where(log, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                             * (m - 15.0)), f)
    fftfreqs = np.linspace(0, rate / 2, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(rate / 2.0),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _log_mel(pt, spec, filters):
    """whisper.audio.log_mel_spectrogram after its stft."""
    mags = pt.abs(spec[..., :-1]) ** 2
    mel = pt.matmul(filters, mags)
    log_spec = pt.log10(pt.clip(mel, min=1e-10))
    log_spec = pt.maximum(log_spec, pt.amax(log_spec) - 8.0)
    return (log_spec + 4.0) / 4.0


def _tensor_whisper(pt, dev):
    w = WHISPER
    n = w["rate"] * w["seconds"]
    window = np.float32(0.5) - np.float32(0.5) * np.cos(
        2 * np.pi * np.arange(w["n_fft"]) / w["n_fft"]).astype(np.float32)
    filters = _mel_filters(w["rate"], w["n_fft"], w["n_mels"])
    out = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        pt.set_device(d)
        pt.seed(2)
        audio = pt.randn([w["clips"], n]) * 0.1
        win, fil = pt.to_tensor(window), pt.to_tensor(filters)

        def front():
            spec = pt.signal.stft(audio, w["n_fft"], w["hop"], window=win)
            return spec, _log_mel(pt, spec, fil)
        if side == "card":
            (spec, logmel), ms_stft = _warm_timed(front)
            back, ms_istft = _warm_timed(lambda: pt.signal.istft(
                spec, w["n_fft"], w["hop"], window=win, length=n))
            out["roundtrip_rel"] = float(
                torch.linalg.vector_norm(back - audio)
                / torch.linalg.vector_norm(audio))
            out["stft_logmel_ms"], out["istft_ms"] = ms_stft, ms_istft
            out["frames"] = int(spec.shape[-1])
            card = logmel.cpu()
        else:
            _, cpu = front()
    pt.set_device(dev)
    out["logmel_card_vs_cpu_max_abs"] = float((card - cpu).abs().max())
    out["logmel_shape"] = list(card.shape)
    return out


def _tensor_graph(pt):
    """SpMM, segment_sum, the row softmax and one SpMM gradient on a
    graph with ogbn-arxiv's counts, each against a recomputation through
    ``torch.segment_reduce`` over the edges sorted by row."""
    g = ARXIV
    n, e, f = g["nodes"], g["edges"], g["features"]
    pt.seed(4)
    src = pt.randint(0, n, [e])
    dst = pt.randint(0, n, [e])
    w = pt.rand([e]).requires_grad_(True)
    x = pt.randn([n, f]).requires_grad_(True)
    gout = pt.randn([n, f])
    idx = pt.stack([dst, src])
    a = pt.sparse.sparse_coo_tensor(idx, w, [n, n])

    def by_row(vals, rows):
        order = torch.argsort(rows, stable=True)
        return torch.segment_reduce(vals[order], "sum", lengths=torch.
                                    bincount(rows, minlength=n))

    def close(got, want):
        lim = TENSOR_ATOL + TENSOR_RTOL * want.abs()
        return float(((got - want).abs() / lim).max())
    y, ms = {}, {}
    out, ms["spmm"] = _warm_timed(lambda: pt.sparse.matmul(a, x))
    with torch.no_grad():
        msgs = w[:, None] * x[src]
        ref = by_row(msgs, dst)
        seg, ms["segment_sum"] = _warm_timed(
            lambda: pt.segment_sum(msgs, dst, n))
        y["spmm_err_over_limit"] = close(out.detach(), ref)
        y["segment_sum_err_over_limit"] = close(seg, ref)
        sm, ms["softmax"] = _warm_timed(lambda: pt.sparse.softmax(a))
        c = pt.sparse.coalesce(a)
        rows, v = c.indices()[0], c.values()
        lengths = torch.bincount(rows, minlength=n)
        mx = torch.segment_reduce(v, "max", lengths=lengths)
        ex = torch.exp(v - mx[rows])
        ref_sm = ex / torch.segment_reduce(ex, "sum", lengths=lengths)[rows]
        y["softmax_err_over_limit"] = close(sm.values(), ref_sm)
        y["softmax_same_pattern"] = bool(torch.equal(sm.indices(),
                                                     c.indices()))
    _, ms["spmm_backward"] = _cuda_timed(
        lambda: (out * gout).sum().backward())
    with torch.no_grad():
        y["spmm_grad_x_err_over_limit"] = close(
            x.grad, by_row(w[:, None] * gout[dst], src))
        y["spmm_grad_w_err_over_limit"] = close(
            w.grad, (gout[dst] * x[src]).sum(-1))
    y["ms"] = ms
    y["duplicate_edges"] = int(e - c.nnz())
    return y


def _moment_check(draws, mean, var):
    """How many standard errors the mean and variance of the finite
    ``draws`` (samples along the leading dims) are from the
    distribution's (the mean's error var / n, the variance's
    (m4 - var^2) / n with m4 the sample's fourth central moment), and the
    count of samples left out as not finite."""
    x = draws.double().reshape((-1,) + tuple(draws.shape[2:]))
    finite = torch.isfinite(x).reshape(x.shape[0], -1).all(1)
    x = x[finite]
    n = x.shape[0]
    m = x.mean(0)
    c = x - m
    v = (c * c).mean(0)
    m4 = (c ** 4).mean(0)
    mean = torch.as_tensor(mean, dtype=torch.float64, device=x.device)
    var = torch.as_tensor(var, dtype=torch.float64, device=x.device)
    z_mean = float(((m - mean).abs() / torch.sqrt(var / n)).max())
    z_var = float(((v - var).abs() / torch.sqrt((m4 - v * v) / n)).max())
    return max(z_mean, z_var), int((~finite).sum())


def _moments(draws, mean, var):
    sigmas, nonfinite = _moment_check(draws, mean, var)
    return {"moment_sigmas": sigmas, "nonfinite": nonfinite}


def _tensor_draws(pt, dev):
    """10^7 draws of each closed-form sampler on the card: row 0 of the
    ``[100, 10^5]`` draw against the CPU's ``[1, 10^5]`` draw from the
    same key (threefry hashes each element's flat index, so the rows are
    the same draw), and the moments of all 10^7. Beta, Dirichlet and
    Poisson draw 10^5 on both devices: the share of exactly equal draws
    and their moments."""
    D = pt.distribution
    p4 = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    gamma = 0.5772156649015329
    spec = {
        "Normal": (lambda: D.Normal(0.5, 2.0), 0.5, 4.0),
        "Uniform": (lambda: D.Uniform(-1.0, 3.0), 1.0, 16.0 / 12),
        "Laplace": (lambda: D.Laplace(0.5, 1.5), 0.5, 2 * 1.5 ** 2),
        "Exponential": (lambda: D.Exponential(2.0), 0.5, 0.25),
        "Gumbel": (lambda: D.Gumbel(0.0, 1.0), gamma, math.pi ** 2 / 6),
        "Bernoulli": (lambda: D.Bernoulli(0.3), 0.3, 0.21),
        "Categorical": (lambda: D.Categorical(probs=p4), 2.0, 1.0),
        "Multinomial": (lambda: D.Multinomial(4, p4), 4 * p4,
                        4 * p4 * (1 - p4)),
    }
    res, ms = {}, {}
    for name, (build, mean, var) in spec.items():
        rows, cols = TENSOR_DRAWS
        if name == "Multinomial":    # 4 categorical draws a sample
            cols //= 4
        pt.set_device(dev)
        pt.seed(5)
        card, ms[name] = _warm_timed(     # each call from the same key
            lambda: (pt.seed(5), build().sample([rows, cols]))[1])
        pt.set_device("cpu")
        pt.seed(5)
        cpu = build().sample([1, cols])
        res[name] = {"row0_bit_equal": bool(torch.equal(card[:1].cpu(),
                                                        cpu)),
                     **_moments(card, mean, var)}
    rej = {
        "Beta": (lambda: D.Beta(2.0, 3.0), 0.4, 6.0 / 150),
        "Dirichlet": (lambda: D.Dirichlet(np.array([0.3, 1.0, 4.0],
                                                   np.float32)),
                      np.array([0.3, 1.0, 4.0]) / 5.3,
                      np.array([0.3, 1.0, 4.0]) * (5.3 - np.array(
                          [0.3, 1.0, 4.0])) / (5.3 ** 2 * 6.3)),
    }
    for name, (build, mean, var) in rej.items():
        got = {}
        for side, d in (("card", dev), ("cpu", "cpu")):
            pt.set_device(d)
            pt.seed(6)
            got[side], t = _cuda_timed(lambda: build().sample(
                [1, TENSOR_REJECTION_DRAWS]))
            if side == "card":
                ms[name] = t
        res[name] = {"equal_share": float((got["card"].cpu() == got["cpu"])
                                          .double().mean()),
                     **_moments(got["card"], mean, var)}
    got = {}
    lam = np.full(TENSOR_REJECTION_DRAWS, 4.0, np.float32)
    lam[::2] = 30.0                    # Knuth below 10, rejection above
    for side, d in (("card", dev), ("cpu", "cpu")):
        pt.set_device(d)
        pt.seed(7)
        got[side], t = _cuda_timed(lambda: pt.poisson(pt.to_tensor(lam)))
        if side == "card":
            ms["poisson"] = t
    pt.set_device(dev)
    pois = got["card"].reshape(-1, 2)
    res["Poisson"] = {
        "equal_share": float((got["card"].cpu() == got["cpu"]).double()
                             .mean()),
        **_moments(pois[None], [30.0, 4.0], [30.0, 4.0])}
    return res, ms


def _tensor_autograd_mlp(pt, dev):
    """Jacobian and Hessian of a 2-layer MLP (64 -> 256 -> 16, tanh) with
    respect to its input, card against CPU."""
    rs = np.random.RandomState(8)
    w1 = rs.normal(0, 0.1, (64, 256)).astype(np.float32)
    w2 = rs.normal(0, 0.1, (256, 16)).astype(np.float32)
    x = rs.normal(0, 1, (64,)).astype(np.float32)
    outs, ms = [], 0.0
    for side, d in (("card", dev), ("cpu", "cpu")):
        pt.set_device(d)
        a, b, xx = pt.to_tensor(w1), pt.to_tensor(w2), pt.to_tensor(x)

        def f(v):
            return pt.tanh(pt.matmul(pt.tanh(pt.matmul(v, a)), b))

        def work():
            return (pt.autograd.Jacobian(f, xx)[:],
                    pt.autograd.Hessian(lambda v: pt.sum(f(v) ** 2), xx)[:])
        if side == "card":
            (jac, hes), ms = _cuda_timed(work)
        else:
            jac, hes = work()
        outs.append((jac.cpu(), hes.cpu()))
    pt.set_device(dev)
    worst = max(float(((c - g).abs() / (TENSOR_ATOL + TENSOR_RTOL
                                        * c.abs())).max())
                for g, c in zip(outs[0], outs[1]))
    return worst, ms, [list(t.shape) for t in outs[0]]


def phase_tensor(info, dev="cuda") -> None:
    """The tensor and math API on the card: every ported function against
    the port on the CPU at the CPU tests' sizes, then linalg at 4096,
    FFTs of 2^24 and 4096^2, Whisper's log-mel front end on 8 x 30 s
    clips, an ogbn-arxiv-sized graph through the sparse API, 10^7 draws
    of each closed-form sampler and an MLP's Jacobian and Hessian."""
    import paddle_tpu_torch as pt
    t_phase = time.perf_counter()
    pt.set_device(dev)
    worst, bad, n_out = _tensor_sweep(pt, dev)
    t_sweep = time.perf_counter() - t_phase
    lin_res, lin_ms, rank = _tensor_linalg(pt)
    fft = _tensor_fft(pt)
    whisper = _tensor_whisper(pt, dev)
    graph = _tensor_graph(pt)
    draws, draw_ms = _tensor_draws(pt, dev)
    ag_worst, ag_ms, ag_shapes = _tensor_autograd_mlp(pt, dev)
    phase_s = time.perf_counter() - t_phase
    checks = {
        "sweep_exact_and_shapes": not bad,
        "sweep_within_limit": worst <= 1.0,
        "linalg_residuals": all(r <= TENSOR_LINALG_RESIDUAL
                                for r in lin_res.values()),
        "lstsq_full_rank": rank == TENSOR_LINALG_N,
        "rfft_roundtrip": fft["rfft_irfft_roundtrip_rel"] <= TENSOR_FFT_REL,
        "fft2_card_vs_cpu": fft["fft2_card_vs_cpu_rel"] <= TENSOR_FFT_REL,
        "whisper_roundtrip": whisper["roundtrip_rel"]
        <= WHISPER_ROUNDTRIP_REL,
        "whisper_logmel_card_vs_cpu": whisper["logmel_card_vs_cpu_max_abs"]
        <= WHISPER_LOGMEL_ATOL,
        "graph_within_limit": all(
            graph[k] <= 1.0 for k in graph if k.endswith("over_limit")),
        "graph_softmax_pattern": graph["softmax_same_pattern"],
        "draws_row0_bit_equal": all(
            v["row0_bit_equal"] for v in draws.values()
            if "row0_bit_equal" in v),
        "draws_moments": all(v["moment_sigmas"] <= TENSOR_MOMENT_SIGMA
                             for v in draws.values()),
        "draws_nonfinite": all(v["nonfinite"] <= TENSOR_NONFINITE_MAX
                               for v in draws.values()),
        "autograd_mlp_within_limit": ag_worst <= 1.0,
        "phase_within_budget": phase_s <= TENSOR_PHASE_BUDGET_S,
    }
    emit({"phase": "tensor", "card": info["nvidia_smi"],
          "sweep": {"cases": len(_tensor_cases()), "outputs": n_out,
                    "worst_err_over_limit": worst, "failed": bad,
                    "s": t_sweep},
          "linalg": {"n": TENSOR_LINALG_N, "dtype": "float32",
                     "residuals": lin_res, "ms": lin_ms,
                     "lstsq_rank": rank},
          "fft": fft, "whisper": {**WHISPER, **whisper},
          "graph": {**ARXIV, **graph},
          "draws": {"shape": list(TENSOR_DRAWS), "samplers": draws,
                    "ms": draw_ms},
          "autograd_mlp": {"err_over_limit": ag_worst, "ms": ag_ms,
                           "shapes": ag_shapes},
          "phase_s": phase_s})
    emit({"phase": "tensor_checks", **checks})
    torch.cuda.empty_cache()          # the later phases' memory to them
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"tensor phase failed: {failed}")


# ---------------------------------------------------------------------------
# models and data: BERT-base pretraining on B1-B3, ResNet-50 training, the
# vision zoo, the detection ops and the converters on the card
# ---------------------------------------------------------------------------

MODELS_PHASE_BUDGET_S = 90.0
# bench.py:432-470 (the JAX package's configuration 3): BERT-base, batch
# 64 x 128, fused loss, AdamW 1e-4 / wd 0.01, O1
BERT_BATCH, BERT_SEQ = 64, 128
BERT_TIMED_STEPS = 10
# bench.py:398-425 (configuration 2): ResNet-50, batch 128 at 224^2,
# Momentum 0.1 / 0.9, cross entropy, O1
RESNET_BATCH, RESNET_SIZE, RESNET_STEPS = 128, 224, 10
RESNET_FIT_STEPS, RESNET_FIT_WORKERS, RESNET_FOLDER_SIZE = 8, 4, 256
RESNET50_FWD_FLOPS = 4.09e9    # bench.py: per 224^2 image, 2 x MACs
# the first float32 step at batch 4, card against CPU: the loss within
# 1e-4 relative; the gradient norm within 1e-3 (cuDNN's and oneDNN's
# float32 convolution algorithms through 53 layers of backward: 1.18e-4
# apart on an H100, the loss 8.3e-7)
RESNET_CPU_BATCH, RESNET_CPU_RTOL, RESNET_CPU_GRAD_RTOL = 4, 1e-4, 1e-3
MODELS_LAYER_ATOL, MODELS_LAYER_RTOL = 1e-5, 1e-4
# every constructor of tests/test_models_vision.py:106-118 and the
# resnet / vgg / mobilenet / LeNet tests, at their input sizes
ZOO = [("resnet18", {}, 64), ("resnet34", {}, 64), ("resnet50", {}, 64),
       ("vgg11", {}, 224), ("mobilenet_v1", {"scale": 0.25}, 64),
       ("mobilenet_v2", {"scale": 0.5}, 64), ("LeNet", {}, 28),
       ("alexnet", {}, 224), ("squeezenet1_1", {}, 64),
       ("densenet121", {}, 64), ("googlenet", {}, 64),
       ("shufflenet_v2_x0_5", {}, 64), ("resnext50_32x4d", {}, 64),
       ("wide_resnet50_2", {}, 64), ("mobilenet_v3_small", {}, 64),
       ("mobilenet_v3_large", {}, 64), ("shufflenet_v2_x0_25", {}, 64),
       ("shufflenet_v2_swish", {}, 64), ("densenet169", {}, 64),
       ("inception_v3", {}, 75)]
# detection sizes: FPN level 2 (stride 4) of an 800 x 1088 image, 512
# rois of 16-112 pixels; a detector's 5000 raw boxes over 80 classes
DET_FEATURE, DET_ROIS, DET_BOXES, DET_CLASSES = (2, 256, 50, 68), 512, 5000, 80
VITERBI_SHAPE = (64, 128, 50)


def _bert_batch(rs, n, seq, vocab):
    """Ids, 15% MLM labels and NSP labels, drawn as bench.py draws them."""
    ids = rs.randint(0, vocab, (n, seq))
    mlm = np.where(rs.rand(n, seq) < 0.15, ids, -100)
    nsp = rs.randint(0, 2, (n,))
    return ids, mlm, nsp


def _bert_model(net):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import BertFusedPretrainingCriterion
    model = pt.Model(net, labels=["mlm", "nsp"])
    model.prepare(pt.optimizer.AdamW(learning_rate=1e-4, parameters=net,
                                     weight_decay=0.01),
                  BertFusedPretrainingCriterion(), amp_configs="O1")
    return model


def _bert_parity(net, init, batch, impl):
    """PARITY_STEPS train steps from the initial weights on B1-B3 or on
    their twins: the losses and the launch counts."""
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    model = _bert_model(net)
    fa.impl = impl
    try:
        _reset_flash_counts()
        losses = [model.train_batch([batch[0]], list(batch[1:]))["loss"]
                  for _ in range(PARITY_STEPS)]
        torch.cuda.synchronize()
        counts = _flash_counts()
    finally:
        fa.impl = "kernel"
    return [float(v) for v in losses], counts


def _bert_attn_grad(net, init, batch, impl, o1=True):
    """The gradient of every attention projection (q, k, v) after one
    fwd+bwd of the fused pretraining loss from the initial weights, under
    O1 (or in float32), on B1-B3 or on their twins."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import BertFusedPretrainingCriterion
    from paddle_tpu_torch.ops import flash_attention as fa
    net.load_state_dict(init)
    net.train()
    net.zero_grad(set_to_none=True)
    ids, mlm, nsp = (torch.as_tensor(a, device="cuda") for a in batch)
    fa.impl = impl
    try:
        with amp.auto_cast(enable=o1, level="O1"):
            out = net(ids)
        BertFusedPretrainingCriterion()(*out, mlm, nsp).float().backward()
    finally:
        fa.impl = "kernel"
    g = torch.cat([p.grad.flatten() for n, p in net.named_parameters()
                   if n.endswith(("q_proj.weight", "k_proj.weight",
                                  "v_proj.weight"))])
    net.zero_grad(set_to_none=True)
    return g


def _bert_peak(net, batch, fused):
    """Peak device bytes of one O1 forward + backward with the fused
    vocab loss or the dense head."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.bert import (BertFusedPretrainingCriterion,
                                              BertPretrainingCriterion)
    ids, mlm, nsp = (torch.as_tensor(a, device="cuda") for a in batch)
    net.cfg.fused_loss = fused
    crit = BertFusedPretrainingCriterion() if fused else \
        BertPretrainingCriterion()
    net.train()
    net.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with amp.auto_cast(level="O1"):
            out = net(ids)
        crit(*out, mlm, nsp).float().backward()
        torch.cuda.synchronize()
    finally:
        net.cfg.fused_loss = True
    net.zero_grad(set_to_none=True)
    return torch.cuda.max_memory_allocated()


def _models_bert(info):
    """BERT-base pretraining at bench.py's configuration on B1-B3."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import BertForPretraining, bert_config
    cfg = bert_config("bert-base", hidden_dropout=0.0, attention_dropout=0.0,
                      fused_loss=True)
    pt.seed(0)
    net = BertForPretraining(cfg, device="cuda")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    n_params = sum(p.numel() for p in net.parameters())
    batch = _bert_batch(np.random.RandomState(0), BERT_BATCH, BERT_SEQ,
                        cfg.vocab_size)
    model = _bert_model(net)
    model.train_batch([batch[0]], list(batch[1:]))     # first-call set-up
    torch.cuda.synchronize()
    # the main path: the timed steps, with the counts from 0
    _reset_flash_counts()
    t0 = time.perf_counter()
    losses = [model.train_batch([batch[0]], list(batch[1:]))["loss"]
              for _ in range(BERT_TIMED_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / BERT_TIMED_STEPS
    launches = _flash_counts()
    losses = [float(v) for v in losses]
    sps = BERT_BATCH / step_s
    flops_tok = 6 * n_params + 12 * cfg.num_layers * BERT_SEQ * \
        cfg.hidden_size
    mfu = sps * BERT_SEQ * flops_tok / PEAK_OPS_PER_S[torch.bfloat16]

    def work():
        for _ in range(2):
            model.train_batch([batch[0]], list(batch[1:]))
    prof = _profile(work, 2, "step", phase="models", run="bert profile",
                    steps=2)
    emit(prof)
    # an eval batch goes through the dense criterion: B1 only
    _reset_flash_counts()
    ev = model.eval_batch([batch[0]], list(batch[1:]))
    torch.cuda.synchronize()
    eval_launches = _flash_counts()
    eval_loss = ev["loss"]
    while isinstance(eval_loss, (list, tuple)):
        eval_loss = eval_loss[0]
    eval_loss = float(torch.as_tensor(eval_loss).reshape(-1)[0])
    del model
    k_losses, k_counts = _bert_parity(net, init, batch, "kernel")
    p_losses, p_counts = _bert_parity(net, init, batch, "plain")
    rel = [abs(a - b) / abs(b) for a, b in zip(k_losses, p_losses)]
    g_k = _bert_attn_grad(net, init, batch, "kernel")
    g_p = _bert_attn_grad(net, init, batch, "plain")
    g_32 = _bert_attn_grad(net, init, batch, "plain", o1=False)
    g_k32 = _bert_attn_grad(net, init, batch, "kernel", o1=False)

    def rel_norm(a, b):
        return float((a - b).norm() / b.norm())
    grad = {"o1_kernel_vs_f32": rel_norm(g_k, g_32),
            "o1_plain_vs_f32": rel_norm(g_p, g_32),
            "o1_kernel_vs_plain": rel_norm(g_k, g_p),
            "f32_kernel_vs_plain": rel_norm(g_k32, g_32)}
    del g_k, g_p, g_32, g_k32
    net.load_state_dict(init)
    peak_fused = _bert_peak(net, batch, True)
    peak_dense = _bert_peak(net, batch, False)
    layers = cfg.num_layers
    out = {"phase": "models", "run": "bert-base pretraining",
           "card": info["nvidia_smi"], "params": n_params,
           "batch": BERT_BATCH, "seq": BERT_SEQ, "vocab": cfg.vocab_size,
           "amp": "O1", "optimizer": "AdamW 1e-4 wd 0.01",
           "step_ms": step_s * 1e3, "samples_per_s": sps,
           "tokens_per_s": sps * BERT_SEQ, "mfu": mfu,
           "mfu_flops_per_token": flops_tok, "losses": losses,
           "launches": launches, "eval_launches": eval_launches,
           "eval_loss": eval_loss, "flash_share": prof["flash_share"],
           "idle_share": prof["idle_share"], "kernel_losses": k_losses,
           "plain_losses": p_losses, "rel_diff": rel,
           "kernel_launches": k_counts, "plain_launches": p_counts,
           "attn_grad": grad, "peak_bytes_fused": peak_fused,
           "peak_bytes_dense": peak_dense,
           "peak_saving_min": BERT_BATCH * BERT_SEQ * cfg.vocab_size * 4}
    emit(out)
    del net, init
    torch.cuda.empty_cache()
    checks = {
        "bert_timed_launches": all(v == layers * BERT_TIMED_STEPS
                                   for v in launches.values()),
        "bert_eval_launches": eval_launches == {
            "flash_attention_fwd": layers, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0},
        "bert_parity_launches": all(v == layers * PARITY_STEPS
                                    for v in k_counts.values()),
        "bert_plain_launches": all(v == 0 for v in p_counts.values()),
        "bert_losses_finite": all(math.isfinite(v) for v in
                                  losses + k_losses + p_losses
                                  + [eval_loss]),
        "bert_tenth_loss_below_first": losses[-1] < losses[0],
        "bert_kernel_losses_match_twins": max(rel) <= TRAIN_LOSS_RTOL,
        "bert_attn_grad_o1_as_close_to_f32_as_twins":
            grad["o1_kernel_vs_f32"] <= NN_GRAD_ERR_RATIO
            * grad["o1_plain_vs_f32"],
        "bert_attn_grad_f32_matches_twins":
            grad["f32_kernel_vs_plain"] <= QKV_GRAD_RTOL,
        "bert_fused_peak_lower": peak_dense - peak_fused
        >= out["peak_saving_min"],
    }
    return checks, launches


def _close_over_limit(got, want):
    """max |got - want| / (atol + rtol |want|), the layer limit."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    lim = MODELS_LAYER_ATOL + MODELS_LAYER_RTOL * want.abs()
    return float(((got - want).abs() / lim).max()) if want.numel() else 0.0


def _models_bert_cls(info):
    """BertForSequenceClassification in eval: a padded batch takes the
    masked plain path (0 launches), card against the CPU; the unpadded
    batch at length 128 launches B1 once a layer."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                              BertModel, bert_config)
    cfg = bert_config("bert-base", hidden_dropout=0.0,
                      attention_dropout=0.0)
    pt.seed(0)
    cpu = BertForSequenceClassification(cfg, num_classes=2, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    cpu.eval()
    card.eval()
    rs = np.random.RandomState(1)
    ids = rs.randint(1, cfg.vocab_size, (2, BERT_SEQ))
    ids[0, 90:] = cfg.pad_token_id
    ids[1, 40:] = cfg.pad_token_id
    with torch.no_grad():
        want = cpu(torch.as_tensor(ids), attn_mask=BertModel
                   .attention_mask_from_ids(torch.as_tensor(ids), 0))
        t_ids = torch.as_tensor(ids, device="cuda")
        _reset_flash_counts()
        got = card(t_ids, attn_mask=BertModel.attention_mask_from_ids(
            t_ids, 0))
        torch.cuda.synchronize()
        padded_launches = _flash_counts()
        full = torch.as_tensor(rs.randint(1, cfg.vocab_size,
                                          (BERT_BATCH, BERT_SEQ)),
                               device="cuda")
        _reset_flash_counts()
        logits = card(full)
        torch.cuda.synchronize()
        full_launches = _flash_counts()
    over = _close_over_limit(got, want)
    emit({"phase": "models", "run": "bert-base classification eval",
          "padded_rows": 2, "padded_launches": padded_launches,
          "padded_err_over_limit": over, "unpadded_batch": BERT_BATCH,
          "unpadded_launches": full_launches,
          "limit": f"|card - cpu| <= {MODELS_LAYER_ATOL} + "
                   f"{MODELS_LAYER_RTOL} |cpu|"})
    del cpu, card
    torch.cuda.empty_cache()
    return {
        "cls_padded_no_launch": all(v == 0 for v in
                                    padded_launches.values()),
        "cls_padded_card_vs_cpu": over <= 1.0,
        "cls_unpadded_b1_launches": full_launches == {
            "flash_attention_fwd": cfg.num_layers,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0},
        "cls_unpadded_finite": bool(torch.isfinite(logits).all()),
    }


def _resnet_model(net):
    import paddle_tpu_torch as pt
    model = pt.Model(net)
    model.prepare(pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=net),
                  pt.nn.CrossEntropyLoss(), amp_configs="O1")
    return model


def _resnet_first_step(init, dev, x, y):
    """The first step's loss and gradient norm in float32 at batch
    ``RESNET_CPU_BATCH`` from ``init``, on ``dev``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet50
    net = resnet50(device=dev)
    net.load_state_dict(init)
    net.train()
    logits = net(torch.as_tensor(x, device=dev))
    loss = pt.nn.CrossEntropyLoss()(logits, torch.as_tensor(y, device=dev))
    loss.backward()
    gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                           for p in net.parameters()))
    return float(loss.detach()), float(gnorm)


def _image_folder(root, n, classes, seed):
    """``n`` uint8 HWC images of RESNET_FOLDER_SIZE^2 drawn from ``seed``
    as ``.npy`` files, one directory a class."""
    rs = np.random.RandomState(seed)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:08d}"), exist_ok=True)
    for i in range(n):
        img = rs.randint(0, 256, (RESNET_FOLDER_SIZE, RESNET_FOLDER_SIZE, 3),
                         dtype=np.uint8)
        np.save(os.path.join(root, f"n{i % classes:08d}", f"{i:05d}.npy"),
                img)


def _models_resnet(info):
    """ResNet-50 at bench.py's configuration: timed train steps on the
    in-memory batch, the first step against the CPU, then Model.fit over
    the ImageNet training pipeline (DatasetFolder, numpy transforms, 4
    fork workers)."""
    import tempfile
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import resnet50
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.vision import datasets, transforms as T
    pt.seed(0)
    net = resnet50(device="cuda")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    rs = np.random.RandomState(0)
    imgs = rs.randn(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE) \
        .astype(np.float32)
    labels = rs.randint(0, 1000, (RESNET_BATCH, 1))
    model = _resnet_model(net)
    mean_before = net.bn1._mean.detach().clone()
    losses, stamps = [], []
    torch.cuda.synchronize()
    for _ in range(RESNET_STEPS):
        losses.append(model.train_batch([imgs], [labels])["loss"])
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    losses = [float(v) for v in losses]
    # images/s over the steps after the first two (cuDNN's algorithm
    # search and the first allocations)
    step_s = (stamps[-1] - stamps[1]) / (RESNET_STEPS - 2)
    ips = RESNET_BATCH / step_s
    flops_img = 3 * RESNET50_FWD_FLOPS
    stats_moved = not torch.equal(mean_before, net.bn1._mean)
    del model
    # the first step in float32, card against CPU, from the same weights
    xs, ys = imgs[:RESNET_CPU_BATCH], labels[:RESNET_CPU_BATCH, 0]
    init_cpu = {k: v.cpu() for k, v in init.items()}
    loss_card, g_card = _resnet_first_step(init, "cuda", xs, ys)
    loss_cpu, g_cpu = _resnet_first_step(init_cpu, "cpu", xs, ys)
    first = {"loss_card": loss_card, "loss_cpu": loss_cpu,
             "grad_norm_card": g_card, "grad_norm_cpu": g_cpu,
             "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
             "grad_norm_rel": abs(g_card - g_cpu) / abs(g_cpu)}
    # Model.fit over the ImageNet training pipeline
    n_img = RESNET_BATCH * RESNET_FIT_STEPS
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        t0 = time.perf_counter()
        _image_folder(tmp, n_img, 16, seed=1)
        write_s = time.perf_counter() - t0
        ds = datasets.DatasetFolder(tmp, transform=T.Compose([
            T.RandomResizedCrop(RESNET_SIZE), T.RandomHorizontalFlip(),
            T.ToTensor(), T.Normalize([0.485, 0.456, 0.406],
                                      [0.229, 0.224, 0.225])]))
        net.load_state_dict(init)
        model = _resnet_model(net)
        fit_losses = []

        class Tap(pt.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None):
                fit_losses.append(logs["loss"])
        tracing.clear()
        tracing.enable()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(ds, batch_size=RESNET_BATCH, epochs=1, shuffle=True,
                  verbose=0, num_workers=RESNET_FIT_WORKERS,
                  callbacks=[Tap()])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        spans = tracing.rollup("io.")
        tracing.disable()
        tracing.clear()
    fit_losses = [float(v) for v in fit_losses]
    wait = spans.get("io.next_wait", {"count": 0, "total_s": 0.0})
    out = {"phase": "models", "run": "resnet-50 training",
           "card": info["nvidia_smi"],
           "params": sum(p.numel() for p in net.parameters()),
           "batch": RESNET_BATCH, "image": RESNET_SIZE, "amp": "O1",
           "optimizer": "Momentum 0.1 / 0.9", "losses": losses,
           "step_ms": step_s * 1e3, "images_per_s": ips,
           "mfu": ips * flops_img / PEAK_OPS_PER_S[torch.bfloat16],
           "bn_stats_moved": stats_moved, "first_step_f32": first,
           "fit": {"images": n_img, "steps": len(fit_losses),
                   "workers": RESNET_FIT_WORKERS,
                   "folder_write_s": write_s, "fit_s": fit_s,
                   "images_per_s": n_img / fit_s,
                   "mfu": n_img / fit_s * flops_img
                   / PEAK_OPS_PER_S[torch.bfloat16],
                   "losses": fit_losses,
                   "io_next_wait_s": wait["total_s"],
                   "io_next_wait_per_step_s":
                       wait["total_s"] / max(wait["count"], 1),
                   "io_next_waits": wait["count"]}}
    emit(out)
    del net, init, model
    torch.cuda.empty_cache()
    return {
        "resnet_losses_finite": all(math.isfinite(v) for v in
                                    losses + fit_losses),
        "resnet_tenth_loss_below_first": losses[-1] < losses[0],
        "resnet_bn_stats_moved": stats_moved,
        "resnet_first_step_loss_vs_cpu": first["loss_rel"]
        <= RESNET_CPU_RTOL,
        "resnet_first_step_grad_norm_vs_cpu": first["grad_norm_rel"]
        <= RESNET_CPU_GRAD_RTOL,
        "resnet_fit_steps": len(fit_losses) == RESNET_FIT_STEPS,
        "resnet_fit_io_waits": wait["count"] >= RESNET_FIT_STEPS,
    }


def _models_zoo(info):
    """Every zoo constructor's eval forward on the card against the port
    on the CPU at the JAX tests' sizes, float32, TF32 off; one SGD step
    of squeezenet1_1 (tests/test_models_vision.py:119's model)."""
    import copy
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import models
    rows, t0 = [], time.perf_counter()
    for name, kw, size in ZOO:
        pt.seed(0)
        cpu = getattr(models, name)(num_classes=10, device="cpu", **kw)
        card = copy.deepcopy(cpu).to("cuda")
        cpu.eval()
        card.eval()
        ch = 1 if name == "LeNet" else 3
        x = np.random.RandomState(0).randn(2, ch, size, size) \
            .astype(np.float32)
        with torch.no_grad():
            want = cpu(torch.as_tensor(x))
            got = card(torch.as_tensor(x, device="cuda"))
        rows.append({"model": name, "input": [2, ch, size, size],
                     "err_over_limit": _close_over_limit(got, want)})
        del cpu, card
    # one train step (SGD 0.01) on each side from the same weights
    pt.seed(0)
    cpu = models.squeezenet1_1(num_classes=4, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    x = np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32)
    y = np.array([0, 1, 2, 3])
    step = []
    for net in (cpu, card):
        m = pt.Model(net)
        m.prepare(optimizer=pt.optimizer.SGD(learning_rate=0.01,
                                             parameters=net),
                  loss=pt.nn.CrossEntropyLoss())
        step.append((float(m.train_batch([x], [y])["loss"]),
                     {k: v.detach().cpu() for k, v in
                      net.state_dict().items()}))
    step_over = max([_close_over_limit(torch.tensor(step[1][0]),
                                       torch.tensor(step[0][0]))] +
                    [_close_over_limit(step[1][1][k], v)
                     for k, v in step[0][1].items()])
    emit({"phase": "models", "run": "vision zoo card vs cpu",
          "limit": f"|card - cpu| <= {MODELS_LAYER_ATOL} + "
                   f"{MODELS_LAYER_RTOL} |cpu|", "models": rows,
          "squeezenet_step_err_over_limit": step_over,
          "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    return {"zoo_card_vs_cpu": all(r["err_over_limit"] <= 1.0
                                   for r in rows),
            "zoo_train_step_card_vs_cpu": step_over <= 1.0}, \
        [r["model"] for r in rows if not r["err_over_limit"] <= 1.0]


def _detector_boxes(rs):
    """A detector's raw output: DET_BOXES boxes jittered around 60
    objects of 1088 x 800, DET_CLASSES classes, uniform scores."""
    obj_xy = rs.uniform(0, 900, (60, 2))
    obj_wh = rs.uniform(30, 250, (60, 2))
    obj_cls = rs.randint(0, DET_CLASSES, 60)
    which = rs.randint(0, 60, DET_BOXES)
    xy = obj_xy[which] + rs.randn(DET_BOXES, 2) * 0.1 * obj_wh[which]
    wh = obj_wh[which] * np.exp(rs.randn(DET_BOXES, 2) * 0.1)
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    return boxes, rs.rand(DET_BOXES).astype(np.float32), obj_cls[which]


def _models_ops(info):
    """The detection ops and Viterbi decoding at detection sizes, card
    against the port on the CPU, each timed by CUDA events."""
    from paddle_tpu_torch import text
    from paddle_tpu_torch.vision import ops
    rs = np.random.RandomState(4)
    boxes, scores, cls = _detector_boxes(rs)
    feat = rs.randn(*DET_FEATURE).astype(np.float32)
    wh = np.exp(rs.uniform(np.log(16), np.log(112), (DET_ROIS, 2)))
    xy = rs.uniform(0, 1, (DET_ROIS, 2)) * (np.array([1088, 800]) - wh)
    rois = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    num = np.array([DET_ROIS // 2, DET_ROIS - DET_ROIS // 2])
    off = (rs.randn(DET_FEATURE[0], 18, *DET_FEATURE[2:]) * 2) \
        .astype(np.float32)
    c = DET_FEATURE[1]
    w = (rs.randn(c, c, 3, 3) * 0.02).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    pot = rs.randn(*VITERBI_SHAPE).astype(np.float32)
    trans = rs.randn(VITERBI_SHAPE[2], VITERBI_SHAPE[2]).astype(np.float32)

    host = {"boxes": boxes, "scores": scores, "cls": cls, "feat": feat,
            "rois": rois, "num": num, "off": off, "w": w, "bias": bias,
            "pot": pot, "trans": trans}
    calls = {
        "nms": lambda t: ops.nms(t["boxes"], 0.5, t["scores"], t["cls"],
                                 list(range(DET_CLASSES))),
        "roi_align_adaptive": lambda t: ops.roi_align(
            t["feat"], t["rois"], t["num"], 7, 0.25, -1),
        "roi_align_ratio2": lambda t: ops.roi_align(
            t["feat"], t["rois"], t["num"], 7, 0.25, 2),
        "roi_pool": lambda t: ops.roi_pool(t["feat"], t["rois"], t["num"],
                                           7, 0.25),
        "deform_conv2d": lambda t: ops.deform_conv2d(
            t["feat"], t["off"], t["w"], t["bias"], 1, 1),
        "viterbi_decode": lambda t: text.viterbi_decode(t["pot"],
                                                        t["trans"]),
    }
    cpu = {k: torch.as_tensor(v) for k, v in host.items()}
    card = {k: v.to("cuda") for k, v in cpu.items()}
    rows, ok = {}, {}
    for name, call in calls.items():
        want = call(cpu)
        got, ms = _warm_timed(lambda: call(card))
        if name == "nms":
            equal = torch.equal(got.cpu(), want)
            rows[name] = {"ms": ms, "kept": int(want.numel()),
                          "kept_equal": equal, "boxes": DET_BOXES,
                          "classes": DET_CLASSES}
            ok[name] = equal
        elif name == "viterbi_decode":
            equal = torch.equal(got[1].cpu(), want[1])
            over = _close_over_limit(got[0], want[0])
            rows[name] = {"ms": ms, "shape": list(VITERBI_SHAPE),
                          "paths_equal": equal, "score_err_over_limit": over}
            ok[name] = equal and over <= 1.0
        else:
            over = _close_over_limit(got, want)
            rows[name] = {"ms": ms, "err_over_limit": over,
                          "shape": list(got.shape)}
            ok[name] = over <= 1.0
    emit({"phase": "models", "run": "vision ops card vs cpu",
          "feature": list(DET_FEATURE), "rois": DET_ROIS,
          "timing": "CUDA events, the second of two calls",
          "limit": f"|card - cpu| <= {MODELS_LAYER_ATOL} + "
                   f"{MODELS_LAYER_RTOL} |cpu|; nms and paths exact",
          "card": info["nvidia_smi"], "ops": rows})
    return {f"op_{k}": v for k, v in ok.items()}


def _hf_state_dicts(rs, v=96, h=64, layers=2, pos=32, kv=2, heads=4):
    """GPT-2-, BERT- and LLaMA-layout state dicts in HF names at the CPU
    tests' widths, drawn from ``rs``."""
    def r(*shape):
        return torch.as_tensor((rs.randn(*shape) * 0.05).astype(np.float32))
    gpt = {"transformer.wte.weight": r(v, h),
           "transformer.wpe.weight": r(pos, h),
           "transformer.ln_f.weight": 1 + r(h),
           "transformer.ln_f.bias": r(h)}
    bert = {"bert.embeddings.word_embeddings.weight": r(v, h),
            "bert.embeddings.position_embeddings.weight": r(pos, h),
            "bert.embeddings.token_type_embeddings.weight": r(2, h),
            "bert.embeddings.LayerNorm.weight": 1 + r(h),
            "bert.embeddings.LayerNorm.bias": r(h),
            "bert.pooler.dense.weight": r(h, h),
            "bert.pooler.dense.bias": r(h)}
    hd = h // heads
    llama = {"model.embed_tokens.weight": r(v, h),
             "model.norm.weight": 1 + r(h), "lm_head.weight": r(v, h)}
    for i in range(layers):
        p = f"transformer.h.{i}"
        gpt.update({f"{p}.ln_1.weight": 1 + r(h), f"{p}.ln_1.bias": r(h),
                    f"{p}.attn.c_attn.weight": r(h, 3 * h),
                    f"{p}.attn.c_attn.bias": r(3 * h),
                    f"{p}.attn.c_proj.weight": r(h, h),
                    f"{p}.attn.c_proj.bias": r(h),
                    f"{p}.ln_2.weight": 1 + r(h), f"{p}.ln_2.bias": r(h),
                    f"{p}.mlp.c_fc.weight": r(h, 4 * h),
                    f"{p}.mlp.c_fc.bias": r(4 * h),
                    f"{p}.mlp.c_proj.weight": r(4 * h, h),
                    f"{p}.mlp.c_proj.bias": r(h)})
        p = f"bert.encoder.layer.{i}"
        for n, o, k in (("attention.self.query", h, h),
                        ("attention.self.key", h, h),
                        ("attention.self.value", h, h),
                        ("attention.output.dense", h, h),
                        ("intermediate.dense", 2 * h, h),
                        ("output.dense", h, 2 * h)):
            bert[f"{p}.{n}.weight"] = r(o, k)
            bert[f"{p}.{n}.bias"] = r(o)
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            bert[f"{p}.{n}.weight"] = 1 + r(h)
            bert[f"{p}.{n}.bias"] = r(h)
        p = f"model.layers.{i}"
        llama.update({f"{p}.input_layernorm.weight": 1 + r(h),
                      f"{p}.post_attention_layernorm.weight": 1 + r(h),
                      f"{p}.self_attn.q_proj.weight": r(h, h),
                      f"{p}.self_attn.k_proj.weight": r(kv * hd, h),
                      f"{p}.self_attn.v_proj.weight": r(kv * hd, h),
                      f"{p}.self_attn.o_proj.weight": r(h, h),
                      f"{p}.mlp.gate_proj.weight": r(96, h),
                      f"{p}.mlp.up_proj.weight": r(96, h),
                      f"{p}.mlp.down_proj.weight": r(h, 96)})
    return gpt, bert, llama


def _models_convert(info):
    """The three converters on the card against the port on the CPU."""
    from paddle_tpu_torch.models import convert
    gpt, bert, llama = _hf_state_dicts(np.random.RandomState(5))
    ids = np.random.RandomState(6).randint(0, 96, (2, 16))
    nodrop = {"hidden_dropout": 0.0, "attention_dropout": 0.0}
    runs = {
        "gpt2": lambda d: convert.gpt2_from_huggingface(
            gpt, config={"num_heads": 2, **nodrop}, device=d),
        "bert": lambda d: convert.bert_from_huggingface(
            bert, config={"num_heads": 2, **nodrop}, device=d),
        "llama": lambda d: convert.llama_from_huggingface(
            llama, config={"num_heads": 4, "num_kv_heads": 2}, device=d),
    }
    rows = {}
    for name, build in runs.items():
        outs = []
        for d in ("cpu", "cuda"):
            net = build(d)
            net.eval()
            with torch.no_grad():
                out = net(torch.as_tensor(ids, device=d))
            outs.append(out[0] if isinstance(out, tuple) else out)
        rows[name] = _close_over_limit(outs[1], outs[0])
    emit({"phase": "models", "run": "converters card vs cpu",
          "err_over_limit": rows})
    return {f"convert_{k}": v <= 1.0 for k, v in rows.items()}


def phase_models(info) -> dict:
    """Models and data on the card: BERT-base pretraining at bench.py's
    configuration on B1-B3 (against the twins), BERT classification
    eval, ResNet-50 training (in-memory batch and the ImageNet folder
    pipeline through Model.fit), the vision zoo, the detection ops and
    the HF converters against the port on the CPU."""
    t_phase = time.perf_counter()
    checks, launches = _models_bert(info)
    checks.update(_models_bert_cls(info))
    checks.update(_models_resnet(info))
    zoo_checks, bad_zoo = _models_zoo(info)
    checks.update(zoo_checks)
    checks.update(_models_ops(info))
    checks.update(_models_convert(info))
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_budget"] = phase_s <= MODELS_PHASE_BUDGET_S
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "models_checks", "card": info["nvidia_smi"],
          "phase_s": phase_s, "budget_s": MODELS_PHASE_BUDGET_S,
          "bad_zoo": bad_zoo, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"models checks failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# the tooling: profiler, cost model, jit, static / testing / quant
# ---------------------------------------------------------------------------

TOOLING_BUDGET_S = 60.0
TOOLING_FIT_STEPS = 6           # Model.fit steps under the profiler
TOOLING_RECORD_STEPS = 3        # make_scheduler(closed=1, ready=1, record=3)
TOOLING_JIT_SHAPES = ((8, 1024), (2, 100))
TOOLING_FLOPS_RTOL = 0.01       # a step's FLOPs on the kernels vs the twins
TOOLING_FLOPS_RATIO = (1.0, 1.30)   # tests/test_perf_gate.py's bound
TOOLING_KEY = bytes(range(32))
PROFILEZ_WINDOW_S = 5.0


def _tooling_dir(name):
    import tempfile
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out, exist_ok=True)
    return tempfile.mkdtemp(prefix=f"{name}_", dir=out)


def _trace_kernels(path) -> dict:
    """{kernel name: count} of the card's kernels in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _count_named(kernels, word) -> int:
    return sum(n for k, n in kernels.items() if word in k)


def _summary_calls(text) -> dict:
    """{event: calls} of a profiler summary()'s model-perspective rows."""
    out = {}
    for line in text.splitlines():
        name = line[:40].strip()
        if name in ("Dataloader", "TrainStep", "Callbacks", "Eval"):
            out.setdefault(name, int(line[40:48]))
    return out


def _tooling_profiler(net, ids, root) -> tuple:
    """Model.fit of 6 steps under Profiler(make_scheduler(closed=1,
    ready=1, record=3)): the summary's buckets, the RECORD window's
    trace (B1-B3 12 a step), export_chrome_tracing inside the window and
    the launch counters. A window without device events is taken again
    (up to 3 fits), counted in PROFILER_MISSES."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import observability, profiler
    from paddle_tpu_torch.callbacks import Callback
    ds = pt.io.TensorDataset([ids[:, :-1], ids[:, 1:]])
    for attempt in range(3):
        prof = profiler.Profiler(
            scheduler=profiler.make_scheduler(closed=1, ready=1,
                                              record=TOOLING_RECORD_STEPS),
            log_dir=os.path.join(root, f"prof{attempt}"))

        class Step(Callback):
            def on_train_batch_end(self, step, logs=None):
                prof.step()

        model = _train_model(net)
        torch.cuda.synchronize()
        _reset_flash_counts()
        t0 = time.perf_counter()
        prof.start()
        try:
            model.fit(ds, batch_size=TRAIN_BATCH, epochs=1, verbose=0,
                      shuffle=False, callbacks=[Step()])
        finally:
            prof.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _flash_counts()
        files = prof.trace_files
        if files and files[0]["device_events"]:
            break
        PROFILER_MISSES["windows"] += 1
    kernels = _trace_kernels(files[0]["path"]) if files else {}
    calls = _summary_calls(prof.summary())
    exported = observability.export_chrome_tracing(
        prof, os.path.join(root, "host_trace.json"))
    with open(exported) as f:
        host = [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "host"]
    w0, w1 = prof.recording_windows()[0]
    inside = all(e["ts"] <= w1 * 1e6 + 1 and w0 * 1e6 - 1 <=
                 e["ts"] + e["dur"] for e in host)
    per = {k: _count_named(kernels, w) for k, w in (
        ("flash_attention_fwd", "flash_fwd"),
        ("flash_attention_bwd_dq", "flash_bwd_dq"),
        ("flash_attention_bwd_dkv", "flash_bwd_dkv"))}
    want = LAYERS * TOOLING_RECORD_STEPS
    run = {"phase": "tooling", "run": "profiled fit",
           "steps": TOOLING_FIT_STEPS, "wall_s": wall,
           "attempts": attempt + 1, "windows": len(files),
           "device_events": files[0]["device_events"] if files else None,
           "summary_calls": calls, "window_kernels": per,
           "host_events_exported": len(host),
           "train_steps_exported": sum(1 for e in host
                                       if e["name"] == "TrainStep"),
           "launches": counts}
    emit(run)
    checks = {
        "summary_train_steps": calls.get("TrainStep") == TOOLING_FIT_STEPS,
        # the pass's closing next() is timed too, as in the JAX package
        "summary_dataloader": calls.get("Dataloader") ==
        TOOLING_FIT_STEPS + 1,
        "summary_callbacks": calls.get("Callbacks") == TOOLING_FIT_STEPS,
        "one_window": len(files) == 1,
        "window_has_device_events": bool(files and
                                         files[0]["device_events"]),
        "window_names_b1_b2_b3": all(v == want for v in per.values()),
        "export_inside_window": inside and bool(host),
        "export_train_steps": run["train_steps_exported"] ==
        TOOLING_RECORD_STEPS,
        "launches_12_a_step": all(v == LAYERS * TOOLING_FIT_STEPS
                                  for v in counts.values()),
    }
    return checks, counts


def _tooling_cost(net, cfg, ids_np, cpu_net) -> dict:
    """CostModel.profile_measure of one train step on the kernels and
    profile on the twins; the FLOPs against 6NT + 6LsHT; memory_profile
    beside the allocator's peak; flops() card against CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import cost_model
    from paddle_tpu_torch.ops import flash_attention as fa
    model = _train_model(net)

    def step():
        return model.train_batch([ids_np], [ids_np])["loss"]

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    cm = cost_model.CostModel()
    _reset_flash_counts()
    kc = cm.profile_measure(step, (), warmup=1, iters=3)
    counts = _flash_counts()
    fa.impl = "plain"
    try:
        pc = cm.profile(step, ())
    finally:
        fa.impl = "kernel"
    mem = cost_model.memory_profile(step, ())
    n = sum(p.numel() for p in net.parameters())
    tokens = ids_np.size
    analytic = 6 * n * tokens + 6 * cfg.num_layers * TRAIN_SEQ * \
        cfg.hidden_size * tokens
    ratio = kc.flops / analytic
    rel = abs(kc.flops - pc.flops) / pc.flops
    f_card = pt.flops(net, (1, TRAIN_SEQ), dtypes=["int64"])
    f_cpu = pt.flops(cpu_net, (1, TRAIN_SEQ), dtypes=["int64"])
    emit({"phase": "tooling", "run": "cost model", "flops_kernels":
          kc.flops, "flops_twins": pc.flops, "flops_rel_diff": rel,
          "analytic_6NT_6LsHT": analytic, "flops_over_analytic": ratio,
          "bytes_accessed": kc.bytes_accessed, "raw": kc.raw,
          "measured_ms": kc.measured_seconds * 1e3,
          "host_step_ms": step_ms,
          "memory_profile": {"temp_bytes": mem.temp_bytes,
                             "argument_bytes": mem.argument_bytes,
                             "output_bytes": mem.output_bytes},
          "max_memory_allocated": mem.device_peak_bytes,
          "flops_fn_card": f_card, "flops_fn_cpu": f_cpu,
          "launches_counted_run": counts})
    return {
        "kernel_flops_eq_twin_flops": rel <= TOOLING_FLOPS_RTOL,
        "flops_ratio_in_bound": TOOLING_FLOPS_RATIO[0] <= ratio <=
        TOOLING_FLOPS_RATIO[1],
        "kernels_reported": kc.raw["kernel_launches"] == 3 * LAYERS,
        "measured": kc.measured_seconds is not None and
        kc.measured_seconds > 0,
        "memory_profile_positive": mem.temp_bytes > 0 and
        mem.device_peak_bytes > 0,
        "flops_fn_card_eq_cpu": f_card == f_cpu and f_card > 0,
    }


def _artifact_bytes(d) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def _tooling_jit(net, cfg, root, cpu_net) -> dict:
    """jit.save of the eval forward with InputSpec([None, None], int64),
    jit.load on the card, the logits at two shapes against the eager
    model's, B1 12 a loaded forward; then weight-only
    quantize_post_training of the same model, saved encrypted: loaded
    with its key, refused without it, its state's bytes against the f32
    artifact's."""
    from paddle_tpu_torch import jit, quant
    net.eval()
    spec = [jit.InputSpec([None, None], "int64")]
    rs = np.random.RandomState(3)
    d_f32 = os.path.join(root, "jit_f32")
    t0 = time.perf_counter()
    jit.save(net, d_f32, input_spec=spec)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = jit.load(d_f32, device="cuda")
    load_s = time.perf_counter() - t0
    checks, runs = {}, []
    for shape in TOOLING_JIT_SHAPES:
        ids = torch.as_tensor(rs.randint(0, cfg.vocab_size, shape),
                              device="cuda")
        with torch.no_grad():
            eager = net(ids)
        _reset_flash_counts()
        got = loaded(ids)
        torch.cuda.synchronize()
        b1 = _flash_counts()["flash_attention_fwd"]
        err = (got - eager).abs()
        key = "x".join(map(str, shape))
        runs.append({"shape": list(shape), "b1_launches": b1,
                     "max_abs_err": float(err.max()),
                     "bit_equal": bool(torch.equal(got, eager))})
        checks[f"logits_{key}"] = bool(
            (err <= 1e-5 + 1e-4 * eager.abs()).all())
        checks[f"b1_12_{key}"] = b1 == LAYERS
    del loaded
    big = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                     (TRAIN_BATCH, TRAIN_SEQ)),
                          device="cuda")
    with torch.no_grad():
        ref = net(big)
    swapped = quant.quantize_post_training(net)
    swapped_cpu = quant.quantize_post_training(cpu_net)
    with torch.no_grad():
        _reset_flash_counts()
        q = net(big)
    torch.cuda.synchronize()
    qb1 = _flash_counts()["flash_attention_fwd"]
    d_q = os.path.join(root, "jit_int8")
    t0 = time.perf_counter()
    jit.save(net, d_q, input_spec=spec, encrypt_key=TOOLING_KEY)
    enc_save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_loaded = jit.load(d_q, decrypt_key=TOOLING_KEY, device="cuda")
    enc_load_s = time.perf_counter() - t0
    _reset_flash_counts()
    q_prog = q_loaded(big)
    torch.cuda.synchronize()
    q_prog_b1 = _flash_counts()["flash_attention_fwd"]
    try:
        jit.load(d_q, device="cuda")
        checks["encrypted_refused_without_key"] = False
    except ValueError:
        checks["encrypted_refused_without_key"] = True
    q_err = float((q - ref).abs().max())
    pkl_f32 = os.path.getsize(os.path.join(d_f32, "params.pkl"))
    pkl_int8 = os.path.getsize(os.path.join(d_q, "params.pkl"))
    emit({"phase": "tooling", "run": "jit", "runs": runs,
          "save_s": save_s, "load_s": load_s,
          "artifact_bytes": _artifact_bytes(d_f32),
          "files": sorted(os.listdir(d_f32)),
          "int8_swapped": swapped, "int8_swapped_cpu": swapped_cpu,
          "int8_logits_max_abs_err": q_err,
          "int8_logits_rel_err": q_err / float(ref.abs().max()),
          "int8_b1_launches": qb1, "int8_program_b1_launches": q_prog_b1,
          "int8_program_bit_equal": bool(torch.equal(q_prog, q)),
          "int8_encrypted_save_s": enc_save_s,
          "int8_encrypted_load_s": enc_load_s,
          "int8_artifact_bytes": _artifact_bytes(d_q),
          "params_pkl_bytes_f32": pkl_f32, "params_pkl_bytes_int8": pkl_int8})
    checks.update({
        "encrypted_loads_with_key": bool(
            ((q_prog - q).abs() <= 1e-5 + 1e-4 * q.abs()).all()),
        "int8_program_b1_12": q_prog_b1 == LAYERS,
        "int8_swapped_eq_cpu": swapped == swapped_cpu == 4 * LAYERS,
        "int8_b1_12": qb1 == LAYERS,
        "int8_logits_finite": bool(torch.isfinite(q).all()),
        "int8_state_smaller": pkl_int8 < pkl_f32,
    })
    return checks


def _close(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and bool(
        (np.abs(a - b) <= 1e-5 + 1e-4 * np.abs(b)).all())


def _tooling_card_vs_cpu() -> dict:
    """A static program (fc, softmax, append_backward), testing OpSpecs
    and the int8 activation paths, on the card against the CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, quant, static, testing
    from paddle_tpu_torch.core import device as core_device
    from paddle_tpu_torch.nn import functional as F

    def np_softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    x_np = np.random.RandomState(4).randn(4, 16).astype(np.float32)
    specs = [
        testing.OpSpec("tanh", pt.tanh, np.tanh,
                       (testing.arr((8, 16)),)),
        testing.OpSpec("matmul", pt.matmul, np.matmul,
                       (testing.arr((8, 16)), testing.arr((16, 4), seed=1)),
                       grad_wrt=(0, 1)),
        testing.OpSpec("softmax", F.softmax, np_softmax,
                       (testing.arr((4, 10), seed=2),)),
    ]
    out = {}
    for dev in ("cuda", "cpu"):
        pt.set_device(dev)
        try:
            pt.seed(0)
            main = static.Program()
            with static.program_guard(main):
                x = static.data("x", [4, 16])
                h = static.nn.fc(x, 8, activation="tanh")
                p = static.nn.sequence_softmax(h)
                y = static.nn.sequence_pool(p, "max")
                grads = static.append_backward(y)
            fetched = static.Executor().run(
                main, feed={"x": x_np},
                fetch_list=[h, p, y] + [g for _, g in grads])
            spec_ok, spec_out = True, []
            for s in specs:
                try:
                    testing.run_spec(s)
                except AssertionError:
                    spec_ok = False
                with torch.no_grad():
                    spec_out.append(s.fn(*[torch.as_tensor(i, device=dev)
                                          for i in s.inputs]).cpu())
            pt.seed(0)
            lin = nn.Linear(768, 3072).to(dev)
            conv = nn.Conv2D(512, 512, 3, padding=1).to(dev)
            rs = np.random.RandomState(5)
            xl = torch.as_tensor(rs.randn(64, 768).astype(np.float32),
                                 device=dev)
            xc = torch.as_tensor(rs.randn(2, 512, 14, 14)
                                 .astype(np.float32), device=dev)
            ql = quant.QuantizedLinear.from_linear(lin, act_scale=float(
                xl.abs().max()) / 127)
            qc = quant.QuantizedConv2D(conv, act_scale=float(
                xc.abs().max()) / 127)
            with torch.no_grad():
                acc_l = quant._int8_matmul_i32(
                    quant._quantize_act(xl, ql.act_scale, 8), ql.qweight)
                acc_c = F.conv_nd(quant._quantize_act(xc, qc.act_scale, 8),
                                  qc.qweight, None, 1, 1,
                                  preferred_element_type=torch.int32)
                y_l, y_c = ql(xl), qc(xc)
            out[dev] = {"static": fetched, "spec_ok": spec_ok,
                        "spec_out": spec_out, "acc_l": acc_l.cpu(),
                        "acc_c": acc_c.cpu(), "y_l": y_l.cpu(),
                        "y_c": y_c.cpu()}
        finally:
            core_device.set_current(None)
    g, c = out["cuda"], out["cpu"]
    checks = {
        "static_fetches_card_eq_cpu": all(
            _close(a, b) for a, b in zip(g["static"], c["static"])),
        "static_grads_nonzero": all(np.abs(a).sum() > 0
                                    for a in c["static"][3:]),
        "opspecs_pass_card": g["spec_ok"], "opspecs_pass_cpu": c["spec_ok"],
        "opspecs_card_eq_cpu": all(_close(a, b) for a, b in
                                   zip(g["spec_out"], c["spec_out"])),
        "int8_linear_int32_equal": torch.equal(g["acc_l"], c["acc_l"]),
        "int8_conv_int32_equal": torch.equal(g["acc_c"], c["acc_c"]),
        "int8_linear_out": _close(g["y_l"], c["y_l"]),
        "int8_conv_out": _close(g["y_c"], c["y_c"]),
    }
    emit({"phase": "tooling", "run": "card vs cpu",
          "int8_conv_max_abs_acc": int(c["acc_c"].abs().max()),
          "int8_linear_max_abs_acc": int(c["acc_l"].abs().max()),
          "static_fetches": len(g["static"])})
    return checks


def phase_tooling(info) -> dict:
    """The tooling at gpt2-small full width (the train phase's model and
    trainer): a profiled Model.fit, the cost model of a train step, the
    eval forward through jit.save / jit.load on B1, int8 PTQ, and the
    static, testing and quant modules card against CPU; within 60 s."""
    import shutil
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_config
    t_phase = time.perf_counter()
    cfg = gpt_config("gpt2-small", max_position_embeddings=TRAIN_SEQ,
                     hidden_dropout=0.0, attention_dropout=0.0,
                     fused_loss=True)
    pt.seed(0)
    net = GPTForCausalLM(cfg, device="cuda")
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    cpu_net = GPTForCausalLM(cfg, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in init.items()})
    rs = np.random.RandomState(7)
    fit_ids = rs.randint(0, cfg.vocab_size,
                         (TRAIN_BATCH * TOOLING_FIT_STEPS, TRAIN_SEQ + 1))
    step_ids = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))
    root = _tooling_dir("tooling")
    times = {}
    try:
        t0 = time.perf_counter()
        checks, launches = _tooling_profiler(net, fit_ids, root)
        times["profiler"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        checks.update({f"cost_{k}": v for k, v in
                       _tooling_cost(net, cfg, step_ids, cpu_net).items()})
        times["cost_model"] = time.perf_counter() - t0
        net.load_state_dict(init)
        t0 = time.perf_counter()
        checks.update({f"jit_{k}": v for k, v in
                       _tooling_jit(net, cfg, root, cpu_net).items()})
        times["jit"] = time.perf_counter() - t0
        del cpu_net
        t0 = time.perf_counter()
        checks.update({f"card_vs_cpu_{k}": v for k, v in
                       _tooling_card_vs_cpu().items()})
        times["card_vs_cpu"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_budget"] = phase_s <= TOOLING_BUDGET_S
    checks = {k: bool(v) for k, v in checks.items()}
    emit({"phase": "tooling_checks", "card": info["nvidia_smi"],
          "phase_s": phase_s, "budget_s": TOOLING_BUDGET_S,
          "part_s": times, "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"tooling checks failed: {failed}")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        return out

    info = phase_device()
    # float32 products in full float32, bf16 products with float32
    # reductions: the JAX package's numerics
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    # the kernels build on the host (nvcc) while the tensor phase, which
    # launches none of them, runs on the card
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(timed, "build", phase_build)
        timed("tensor", phase_tensor, info)
        build.result()
    head = timed("kernels", phase_kernels)
    flash_heads = timed("flash_kernels", phase_flash_kernels)
    launches, serve_ctx = timed("serve", phase_serve)
    timed("serve_http", phase_serve_http, serve_ctx)
    timed("fleet", phase_fleet, info, serve_ctx)
    del serve_ctx
    train_launches = timed("train", phase_train)
    fit = timed("fit", phase_fit)
    timed("checkpoint", phase_checkpoint, fit)
    timed("train_loop", phase_train_loop)
    dist_launches = timed("distributed", phase_distributed, info)
    mp_launches = timed("model_parallel", phase_model_parallel, info)
    sp_launches = timed("sequence_parallel", phase_sequence_parallel, info)
    nn_launches = timed("nn", phase_nn, info)
    moe_launches = timed("moe_ep", phase_moe_ep, info)
    timed("ctr", phase_ctr, info)
    models_launches = timed("models", phase_models, info)
    tooling_launches = timed("tooling", phase_tooling, info)
    for launches_of in (dist_launches, mp_launches, sp_launches,
                        nn_launches, moe_launches, models_launches,
                        tooling_launches):
        for k, v in launches_of.items():
            train_launches[k] += v
    emit({"phase": "timing", "seconds": phase_s,
          "total_s": time.perf_counter() - t_start,
          "profiler_misses": PROFILER_MISSES})
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
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2], sys.argv[3], float(sys.argv[4]))
    else:
        main()
