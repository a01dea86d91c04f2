"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
Hopper GPU.

Same module layout, public names and parameter layouts as the JAX
package ``paddle_tpu``, which stays the reference; every Pallas kernel
on a ported path becomes a CUDA kernel written by hand for sm_90a
(``csrc/``), beside a plain PyTorch twin that the CPU runs. This
package imports torch, numpy and the standard library only.
"""

from . import inference, models, nn  # noqa: F401
from .core.rng import seed  # noqa: F401
from .inference import LLMEngine  # noqa: F401
