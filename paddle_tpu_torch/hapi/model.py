"""``Model``, the Keras-style trainer (the port's counterpart of the
batch-level part of ``paddle_tpu/hapi/model.py``).

``prepare`` takes the optimizer, the loss and the AMP configuration;
``train_batch`` runs one eager step on the network's device: the
forward under the AMP context, the loss outside it (as in the JAX
package's step), ``loss.float().backward()``, then the optimizer's
``apply_in_place`` (its pure ``apply_gradients``, written back into the
parameters) at ``step_idx = self._step_count`` on the model's own
optimizer state. It returns the loss as a 0-dim device tensor and never
syncs the host.

Weights cross from the JAX package with
:func:`paddle_tpu_torch.interop.load_reference_state`; both packages'
optimizers start from zero moments, so a first step needs no optimizer
state carried across. ``fit``/``evaluate``/``predict`` with a
``DataLoader``, callbacks, metrics, the numeric guard and the fused
K-step loop are ROADMAP Queue A items.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import amp
from ..optimizer.optimizer import Optimizer


def _as_tuple(x):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


class Model:
    """Wraps a network for batch-level training, evaluation and
    prediction. ``inputs``/``labels`` (input specs) are accepted for the
    JAX package's signature; the batch-level API does not need them."""

    def __init__(self, network: torch.nn.Module, inputs=None, labels=None):
        self.network = network
        self._optimizer: Optional[Optimizer] = None
        self._loss = None
        self._amp_configs = None
        self._opt_state = None
        self._step_count = 0

    def prepare(self, optimizer: Optional[Optimizer] = None, loss=None,
                metrics=None, amp_configs=None, numeric_guard=None) -> None:
        """``amp_configs``: a level string (``"O1"``/``"O2"``, ``"O0"`` or
        None for none) or a dict {level, dtype, custom_white_list,
        custom_black_list}. Metrics and the numeric guard are not ported
        yet and raise."""
        if metrics:
            raise NotImplementedError(
                "Model.prepare(metrics=...) is not ported yet (ROADMAP "
                "Queue A: fit/evaluate, DataLoader, callbacks, metric/)")
        if numeric_guard:
            raise NotImplementedError(
                "Model.prepare(numeric_guard=...) is not ported yet "
                "(ROADMAP Queue A: numeric guard and GradScaler)")
        self._optimizer = optimizer
        self._loss = loss
        self._amp_configs = amp_configs
        self._opt_state = None

    def _amp_context(self):
        cfg = self._amp_configs
        if not cfg:
            return contextlib.nullcontext()
        if isinstance(cfg, str):
            cfg = {"level": cfg}
        level = cfg.get("level", "O1")
        if level == "O0":
            return contextlib.nullcontext()
        return amp.auto_cast(
            enable=True, dtype=cfg.get("dtype"), level=level,
            custom_white_list=cfg.get("custom_white_list"),
            custom_black_list=cfg.get("custom_black_list"))

    def _compute_loss(self, outputs, labels):
        return self._loss(*_as_tuple(outputs), *_as_tuple(labels))

    def _device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _to_device(self, xs):
        dev = self._device()
        return tuple(x.to(dev) if isinstance(x, torch.Tensor)
                     else torch.as_tensor(np.asarray(x), device=dev)
                     for x in xs)

    def _trainable(self) -> Dict[str, torch.nn.Parameter]:
        return {k: p for k, p in self.network.named_parameters()
                if p.requires_grad}

    def train_batch(self, inputs, labels=None) -> Dict[str, Any]:
        """One optimizer step on one batch; returns ``{"loss": <0-dim
        device tensor>}`` without a host sync."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before "
                               "train_batch")
        self.network.train()
        inputs = self._to_device(_as_tuple(inputs))
        labels = self._to_device(_as_tuple(labels)) \
            if labels is not None else ()
        params = self._trainable()
        with self._amp_context():
            out = self.network(*inputs)
        loss = self._compute_loss(out, labels).float()
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        self._opt_state = self._optimizer.apply_in_place(
            params, grads, self._opt_state, self._step_count)
        for p in params.values():
            p.grad = None
        self._step_count += 1
        return {"loss": loss.detach()}

    def train_loop_batch(self, inputs, labels=None):
        raise NotImplementedError(
            "Model.train_loop_batch (the fused K-step loop) is not ported "
            "yet (ROADMAP Queue A: train_loop_batch as a CUDA graph)")

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None) -> Dict[str, Any]:
        """Forward (eval mode, under the AMP context) and, with a loss,
        ``{"loss": <0-dim device tensor>}``."""
        self.network.eval()
        inputs = self._to_device(_as_tuple(inputs))
        labels = self._to_device(_as_tuple(labels)) \
            if labels is not None else ()
        with self._amp_context():
            out = self.network(*inputs)
        logs = {}
        if self._loss is not None:
            logs["loss"] = self._compute_loss(out, labels)
        return logs

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The eval-mode forward of one batch, without the AMP context
        (as in the JAX package's predict step)."""
        self.network.eval()
        return self.network(*self._to_device(_as_tuple(inputs)))

    def parameters(self):
        return self.network.parameters()
