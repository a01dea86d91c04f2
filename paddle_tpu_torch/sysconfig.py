"""paddle.sysconfig parity (ref: python/paddle/sysconfig.py), the
port's counterpart of ``paddle_tpu/sysconfig.py``."""

import os


def get_include() -> str:
    """Directory of the port's native sources (the CUDA kernels and the
    C++ accessor, ``csrc/``), which double as its native interface."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "csrc")


def get_lib() -> str:
    """Directory the port's shared libraries are built into at first
    use (``build/paddle_tpu_torch/`` at the repository root)."""
    from .ops._kernels import BUILD_DIR
    return str(BUILD_DIR)
