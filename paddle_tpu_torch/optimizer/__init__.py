"""paddle_tpu_torch.optimizer (the port's counterpart of
``paddle_tpu.optimizer``): every optimizer of the JAX package."""

from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adafactor, Adagrad, Adam,  # noqa: F401
                        Adamax, AdamW, Lamb, LarsMomentum, Momentum,
                        Optimizer, RMSProp)
