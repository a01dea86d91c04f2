"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
Hopper GPU.

Same module layout, public names and parameter layouts as the JAX
package ``paddle_tpu``, which stays the reference; every Pallas kernel
on a ported path becomes a CUDA kernel written by hand for sm_90a
(``csrc/``), beside a plain PyTorch twin that the CPU runs. This
package imports torch, numpy and the standard library only.

The top level carries the flat ``paddle.*`` API as the JAX package's
does: the tensor functions (``to_tensor``, ``zeros``, ``randn``,
``matmul``, ...), the dtype aliases, ``grad`` / ``no_grad`` / ``save`` /
``load``, the math namespaces (``linalg``, ``fft``, ``signal``,
``sparse``, ``distribution``, ``autograd``, ``regularizer``),
``device``, and the data side: ``vision`` (datasets, transforms,
detection ops), ``text`` (readers, Viterbi decoding) and ``hub``.
Functions that take no tensor create on the device ``set_device``
chose, the card by default.
"""

from .core import dtype as _dtype_mod
from .core import flags as _flags_mod

# dtype aliases (paddle.float32 etc.)
from .core.dtype import (bfloat16, bool_, complex64, complex128,  # noqa
                         float16, float32, float64, int8, int16, int32,
                         int64, uint8, dtype, get_default_dtype,
                         set_default_dtype)

get_flags = _flags_mod.get_flags
set_flags = _flags_mod.set_flags

# flat tensor API (paddle.add, paddle.reshape, ... as in the reference)
from .tensor import *  # noqa: F401,F403,E402
from . import tensor  # noqa: F401,E402

from . import amp, inference, models, nn, ops, optimizer  # noqa: F401,E402
from . import io  # noqa: F401,E402
from . import metric  # noqa: F401,E402
from .core.rng import seed  # noqa: F401,E402
from .hapi.model import Model  # noqa: F401,E402
from .hapi.summary import flops, summary  # noqa: F401,E402
from . import hapi  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from .inference import LLMEngine  # noqa: F401,E402

from .framework import (grad, no_grad, save, load,  # noqa: F401,E402
                        value_and_grad)
from .framework import jit as compile  # noqa: F401,E402
from . import autograd  # noqa: F401,E402
from . import device  # noqa: F401,E402
from . import distribution  # noqa: F401,E402
from . import fft  # noqa: F401,E402
from . import incubate  # noqa: F401,E402
from . import linalg  # noqa: F401,E402
from . import regularizer  # noqa: F401,E402
from . import signal  # noqa: F401,E402
from . import sparse  # noqa: F401,E402
from . import hub  # noqa: F401,E402
from . import text  # noqa: F401,E402
from . import vision  # noqa: F401,E402
from .device import (device_count, is_compiled_with_cuda,  # noqa: E402,F401
                     set_device)


def is_compiled_with_tpu() -> bool:
    """The port runs on CUDA and the CPU, never a TPU."""
    return False


def iinfo(dtype):
    """ref: paddle.iinfo — integer dtype range info."""
    import torch as _torch
    return _torch.iinfo(_dtype_mod.dtype(dtype))


def finfo(dtype):
    """ref: paddle.finfo — float dtype info (bfloat16 included)."""
    import torch as _torch
    return _torch.finfo(_dtype_mod.dtype(dtype))


from .compat_fill import (  # noqa: E402,F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, NPUPlace, ParamAttr, Tensor,
    batch, bool, check_shape, create_parameter, disable_signal_handler,
    disable_static, enable_static, get_cuda_rng_state, in_dynamic_mode,
    is_grad_enabled, set_cuda_rng_state, set_grad_enabled)
