"""paddle_tpu_torch.optimizer (the port's counterpart of
``paddle_tpu.optimizer``): SGD, Adam and AdamW so far."""

from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Optimizer  # noqa: F401
