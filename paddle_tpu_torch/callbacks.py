"""``paddle_tpu_torch.callbacks``: the training callbacks of
:mod:`paddle_tpu_torch.hapi.callbacks`."""

from .hapi.callbacks import (Callback, CallbackList, CSVLogger,  # noqa
                             EarlyStopping, LRScheduler,
                             ModelCheckpoint, ProgBarLogger)
