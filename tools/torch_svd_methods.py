"""Time and residual of torch.linalg.svd's cuSOLVER methods on one card.

Run on a machine with a CUDA card:

    python3 tools/torch_svd_methods.py [n]

For a Gaussian n x n float32 matrix (n 4096 by default) and one with
singular values in about [1, 3] (a Gaussian over sqrt(n) plus 2 I), each
method (torch's default, ``gesvd``, ``gesvdj``, ``gesvda``) with and
without full matrices: one untimed call, then one timed by CUDA events,
and the relative reconstruction error ``||A - U S Vh|| / ||A||``. It
prints the card's name and power limit first. ``paddle_tpu_torch.linalg``
takes ``gesvd`` on the card from these numbers.
"""

import math
import subprocess
import sys

import torch


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_svd_methods: no CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    mats = {"gauss": torch.randn(n, n, device="cuda", generator=g),
            "cond3": torch.randn(n, n, device="cuda", generator=g)
            / math.sqrt(n) + 2 * torch.eye(n, device="cuda")}
    for name, a in mats.items():
        for method in (None, "gesvd", "gesvdj", "gesvda"):
            for full in (True, False):
                torch.linalg.svd(a, full_matrices=full, driver=method)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                u, s, vt = torch.linalg.svd(a, full_matrices=full,
                                            driver=method)
                end.record()
                torch.cuda.synchronize()
                k = s.shape[-1]
                res = torch.linalg.matrix_norm(a - (u[:, :k] * s) @ vt[:k]) \
                    / torch.linalg.matrix_norm(a)
                print(f"{name} n={n} method={method} full={full} "
                      f"{start.elapsed_time(end):.1f} ms "
                      f"residual {float(res):.3e}", flush=True)


if __name__ == "__main__":
    main()
