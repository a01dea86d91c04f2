"""Training callbacks (the port's counterpart of
``paddle_tpu/hapi/callbacks.py``): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``LRScheduler``,
``EarlyStopping``, ``CSVLogger`` and ``config_callbacks``, with the same
events, logs and defaults."""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks: List[Callback], model=None, params=None):
        self.callbacks = callbacks
        for cb in callbacks:
            if model is not None:
                cb.set_model(model)
            if params is not None:
                cb.set_params(params)

    def _call(self, name, *args, **kwargs):
        for cb in self.callbacks:
            getattr(cb, name)(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: self._call(name, *a, **k)
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Prints epoch headers, every ``log_freq``-th step's logs and the
    epoch and eval summaries."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    @staticmethod
    def _fmt(logs) -> str:
        # float() here is the train loop's host sync — it happens at
        # display time (every log_freq steps), not per step
        def one(k, v):
            try:
                return f"{k}: {float(v):.4f}"
            except (TypeError, ValueError):
                return f"{k}: {v}"
        return " - ".join(one(k, v) for k, v in logs.items())

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        if self.verbose == 2 and step % self.log_freq == 0:
            total = f"/{self.steps}" if self.steps else ""
            print(f"step {step + 1}{total} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        if self.verbose:
            dur = time.time() - self._start
            print(f"Epoch {epoch + 1} done in {dur:.1f}s - "
                  f"{self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        logs = logs or {}
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    """Saves ``Model.save(save_dir/<epoch>)`` every ``save_freq`` epochs
    and ``save_dir/final`` at the end of training."""

    def __init__(self, save_freq: int = 1, save_dir: str = "checkpoint"):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is not None and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler after every batch
    (``by_step``) and/or every epoch (``by_epoch``)."""

    def __init__(self, by_step: bool = True, by_epoch: bool = False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_lr", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """Stops training once ``monitor`` (an eval log) has not improved
    for ``patience`` evaluations."""

    def __init__(self, monitor: str = "loss", mode: str = "auto",
                 patience: int = 0, verbose: int = 1,
                 min_delta: float = 0.0, baseline: Optional[float] = None,
                 save_best_model: bool = True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda cur, best: cur < best - self.min_delta
            self.best = float("inf")
        else:
            self.monitor_op = lambda cur, best: cur > best + self.min_delta
            self.best = -float("inf")
        self.wait = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        if self.baseline is not None:
            self.best = self.baseline

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.monitor_op(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping: {self.monitor} plateaued "
                          f"(best={self.best:.5f})")


class CSVLogger(Callback):
    """Log per-epoch metrics to CSV."""

    def __init__(self, path: str, append: bool = False):
        super().__init__()
        self.path = path
        self.append = append
        self._keys = None

    def on_train_begin(self, logs=None):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._file = open(self.path, "a" if self.append else "w",
                          newline="")
        self._writer = None

    @staticmethod
    def _coerce(v):
        # logs carry device tensors / lazy deferred-metric views (the
        # train loop never syncs per step) — a CSV cell is a display
        # boundary, so coerce to a host float here
        try:
            return float(v)
        except (TypeError, ValueError):
            return v

    def on_epoch_end(self, epoch, logs=None):
        logs = dict(logs or {})
        logs["epoch"] = epoch
        if self._writer is None:
            self._keys = list(logs.keys())
            self._writer = csv.DictWriter(self._file, fieldnames=self._keys)
            self._writer.writeheader()
        self._writer.writerow({k: self._coerce(logs.get(k))
                               for k in self._keys})
        self._file.flush()

    def on_train_end(self, logs=None):
        self._file.close()


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     verbose: int = 2, metrics=None,
                     save_dir=None, log_freq: int = 1) -> CallbackList:
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(verbose=verbose, log_freq=log_freq)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_dir=save_dir))
    lst = CallbackList(cbks, model,
                       {"epochs": epochs, "steps": steps,
                        "verbose": verbose, "metrics": metrics or []})
    return lst
