"""The rest of the device surface (the port's counterpart of
``paddle_tpu/device/fill_r4.py``): the Place records and the vendor
probes. The port is built for CUDA, so ``is_compiled_with_cuda`` is
True; every other vendor probe is False."""

from __future__ import annotations

import torch


class _Place:
    """Tagged device identity (ref: platform/place.h Place)."""

    kind = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def get_device_id(self) -> int:
        return self.device_id

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(_Place):
    kind = "cpu"

    def __init__(self):
        super().__init__(0)

    def __repr__(self):
        return "CPUPlace"


class TPUPlace(_Place):
    kind = "tpu"


class CUDAPlace(_Place):
    kind = "gpu"


class CUDAPinnedPlace(_Place):
    kind = "gpu_pinned"

    def __init__(self):
        super().__init__(0)


class NPUPlace(_Place):
    kind = "npu"


class XPUPlace(_Place):
    kind = "xpu"


class MLUPlace(_Place):
    kind = "mlu"


class IPUPlace(_Place):
    kind = "ipu"

    def __init__(self):
        super().__init__(0)


def is_compiled_with_cuda() -> bool:
    return True


def is_compiled_with_rocm() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def get_cudnn_version():
    """cuDNN's version as an int, None where torch has no cuDNN."""
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


def get_available_device():
    """``["gpu:0", ...]`` for each card, ``["cpu"]`` with none."""
    n = torch.cuda.device_count()
    return [f"gpu:{i}" for i in range(n)] if n else ["cpu"]


def get_all_custom_device_type():
    """No custom-device plugins: the port runs on CUDA and the CPU."""
    return []


def get_available_custom_device():
    return []
