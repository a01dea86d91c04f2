"""Host profile of ``chip_smoke.py``'s phases on one card.

Run on a machine with a CUDA card, from the root of the repo:

    python3 tools/torch_phase_profile.py [--out DIR] PHASE [PHASE ...]

PHASE names a ``chip_smoke.phase_<PHASE>`` that takes no argument or the
device info (``serve``, ``train``, ``fit``, ``train_loop``,
``flash_kernels``, ``tensor``, ...). The script prints the card's name
and power limit, the seconds of ``import torch``, of importing the port
and of the card's first allocation, sets ``chip_smoke.main()``'s backend
flags, builds the kernels, then runs each phase under ``cProfile``:
it prints the phase's wall and writes the 45 functions of most
cumulative time to ``DIR/prof_<PHASE>.txt`` (``chiprun_out`` by default).
"""

import argparse
import cProfile
import inspect
import io
import os
import pstats
import sys
import time

t_start = time.perf_counter()
import torch  # noqa: E402

t_torch = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import paddle_tpu_torch  # noqa: E402,F401

t_port = time.perf_counter()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_phase_profile: no CUDA device")
    import chip_smoke as c
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    print("imports_s", {"torch": t_torch - t_start,
                        "paddle_tpu_torch": t_port - t_torch,
                        "card": time.perf_counter() - t0}, flush=True)
    info = c.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    c.phase_build()
    os.makedirs(args.out, exist_ok=True)
    for name in args.phases:
        fn = getattr(c, f"phase_{name}")
        call = (fn, info) if inspect.signature(fn).parameters else (fn,)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(*call)
        wall = time.perf_counter() - t0
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative") \
            .print_stats(45)
        with open(os.path.join(args.out, f"prof_{name}.txt"), "w") as f:
            f.write(text.getvalue())
        print("phase", name, "wall_s", wall, flush=True)


if __name__ == "__main__":
    main()
