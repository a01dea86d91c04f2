"""High-level API of the port: ``Model`` (fit/evaluate/predict and the
batch-level steps), the training callbacks and ``summary``."""

from . import callbacks  # noqa: F401
from .callbacks import (Callback, CSVLogger, EarlyStopping,  # noqa: F401
                        LRScheduler, ModelCheckpoint, ProgBarLogger)
from .model import Model  # noqa: F401
