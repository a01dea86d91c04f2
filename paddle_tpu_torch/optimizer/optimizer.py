"""Optimizers (the port's counterpart of
``paddle_tpu/optimizer/optimizer.py``): the ``Optimizer`` base, SGD,
Adam and AdamW.

The JAX package's functional core is kept: ``init_state(params)`` and
``apply_gradients(params, grads, state, step) -> (new_params,
new_state)`` over ``{name: tensor}`` dicts, pure (inputs are not
modified), with the same state layout: ``m``, ``v`` (dicts of float32
tensors for half parameters under ``multi_precision``), ``t`` (a host
int here, so the bias corrections are host scalars and need no sync)
and ``master`` (float32 copies of the half parameters' values, present
only when some parameter is half). ``step(grads)`` serves eager
workflows by writing the new values into the bound parameters.
``torch.optim`` is not used; the updates are ``torch._foreach_*``
kernels over the parameter list. The remaining optimizers of the JAX
package are ROADMAP Queue A items.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..nn.clip import GradClipBase
from .lr import LRScheduler, make_schedule

_HALF = (torch.bfloat16, torch.float16)
Tensors = Dict[str, torch.Tensor]


class Optimizer:
    """Base class. Subclasses implement ``init_state`` and ``_update``."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay: float = 0.0,
                 grad_clip: Optional[GradClipBase] = None,
                 multi_precision: bool = True):
        self._lr = learning_rate
        self.lr_fn = make_schedule(learning_rate)
        self.weight_decay = float(weight_decay or 0.0)
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self._layer: Optional[torch.nn.Module] = None
        self._params: Optional[Tensors] = None
        self._state = None
        self._step_count = 0
        if isinstance(parameters, torch.nn.Module):
            self._layer = parameters
        elif isinstance(parameters, dict):
            self._params = dict(parameters)
        elif parameters is not None:
            # a list of tensors: positional names
            self._params = {str(i): p for i, p in enumerate(parameters)}

    # -- functional core ----------------------------------------------------
    def init_state(self, params: Tensors) -> dict:
        raise NotImplementedError

    def _update(self, grads: Tensors, state: dict, params: Tensors,
                lr: float):
        """Return (updates, new_state): updates are deltas added to the
        parameters (learning rate and weight decay included)."""
        raise NotImplementedError

    def _maybe_master_state(self, params: Tensors) -> dict:
        state: dict = {}
        if self.multi_precision and any(p.dtype in _HALF
                                        for p in params.values()):
            state["master"] = {k: p.detach().float() if p.dtype in _HALF
                               else p.detach()
                               for k, p in params.items()}
        return state

    @torch.no_grad()
    def apply_gradients(self, params: Tensors, grads: Tensors, state: dict,
                        step: int):
        """The pure update: new parameters and state from ``state``
        (made by ``init_state``); ``step`` drives the LR schedule."""
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        lr = float(self.lr_fn(step))
        master = state.get("master")
        work = master if master is not None else params
        names = list(work)
        updates, new_state = self._update(grads, state, work, lr)
        new_work = dict(zip(names, torch._foreach_add(
            [work[k] for k in names], [updates[k] for k in names])))
        if master is not None:
            new_state["master"] = new_work
        new_params = {k: new_work[k].to(params[k].dtype) for k in names}
        return new_params, new_state

    # -- stateful / eager API (Paddle style) --------------------------------
    def _bound_params(self) -> Tensors:
        if self._layer is not None:
            return {k: p for k, p in self._layer.named_parameters()
                    if p.requires_grad}
        if self._params is not None:
            return self._params
        raise ValueError("optimizer has no bound parameters")

    def apply_in_place(self, params: Tensors, grads: Tensors,
                       state: Optional[dict], step: int) -> dict:
        """One update of ``params[k]`` for every ``k`` in ``grads``,
        written into the tensors in place; ``state`` None starts it with
        ``init_state``. Returns the new state. The write-back of
        :meth:`step` and of ``Model.train_batch``."""
        values = {k: params[k].detach() for k in grads}
        if state is None:
            state = self.init_state(values)
        new, state = self.apply_gradients(values, grads, state, step)
        with torch.no_grad():
            torch._foreach_copy_([params[k] for k in new], list(new.values()))
        return state

    def step(self, grads: Optional[Tensors] = None) -> None:
        """Eager update of the bound parameters, in place. ``grads``
        defaults to the ``.grad`` of every bound parameter that has one;
        only parameters present in ``grads`` are updated."""
        params = self._bound_params()
        if grads is None:
            grads = {k: p.grad for k, p in params.items()
                     if p.grad is not None}
        missing = [k for k in grads if k not in params]
        if missing:
            raise KeyError(f"grads for unknown parameters {missing[:3]}")
        self._state = self.apply_in_place(params, grads, self._state,
                                          self._step_count)
        self._step_count += 1

    def clear_grad(self) -> None:
        for p in self._bound_params().values():
            p.grad = None

    clear_gradients = clear_grad

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr.get_lr()
        return float(self._lr)

    def set_lr(self, value: float) -> None:
        self._lr = float(value)
        self.lr_fn = make_schedule(value)

    def state_dict(self) -> dict:
        return {"state": self._state, "step": self._step_count}

    def set_state_dict(self, sd: dict) -> None:
        self._state = sd["state"]
        self._step_count = sd["step"]


class SGD(Optimizer):
    def init_state(self, params):
        return self._maybe_master_state(params)

    def _update(self, grads, state, params, lr):
        out = {}
        for k, p in params.items():
            g = grads[k].to(p.dtype)
            if self.weight_decay:
                g = g + self.weight_decay * p
            out[k] = -lr * g
        return out, state


class Adam(Optimizer):
    """Bias-corrected, epsilon outside the square root, as Paddle's adam
    kernel; weight decay is coupled into the gradient (AdamW decouples
    it)."""

    _decoupled_wd = False

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay: float = 0.0,
                 grad_clip=None, multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)
        s["m"] = {k: torch.zeros_like(p) for k, p in base.items()}
        s["v"] = {k: torch.zeros_like(p) for k, p in base.items()}
        s["t"] = 0
        return s

    def _decays(self, names):
        """Per-parameter decay on/off from apply_decay_param_fun."""
        fn = getattr(self, "apply_decay_param_fun", None)
        return [True if fn is None else bool(fn(n)) for n in names]

    def _update(self, grads, state, params, lr):
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, \
            self.weight_decay
        t = state["t"] + 1
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        names = list(params)
        ps = [params[k] for k in names]
        gs = [grads[k].to(params[k].dtype) for k in names]
        decays = self._decays(names)
        if wd and not self._decoupled_wd:
            gs = [g + wd * p if d else g for g, p, d in zip(gs, ps, decays)]
        m = torch._foreach_mul([state["m"][k] for k in names], b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        v = torch._foreach_mul([state["v"][k] for k in names], b2)
        torch._foreach_addcmul_(v, gs, gs, value=1 - b2)
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        torch._foreach_mul_(delta, -lr)
        if wd and self._decoupled_wd:
            idx = [i for i, d in enumerate(decays) if d]
            if idx:
                torch._foreach_add_([delta[i] for i in idx],
                                    [ps[i] for i in idx], alpha=-lr * wd)
        new_state = dict(state)
        new_state.update(m=dict(zip(names, m)), v=dict(zip(names, v)), t=t)
        return dict(zip(names, delta)), new_state


class AdamW(Adam):
    """Decoupled weight decay: ``-lr * wd * p`` on the pre-update value
    of every parameter that ``apply_decay_param_fun`` (default: all)
    accepts."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay: float = 0.01,
                 grad_clip=None, multi_precision: bool = True,
                 apply_decay_param_fun: Optional[Callable] = None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self.apply_decay_param_fun = apply_decay_param_fun
