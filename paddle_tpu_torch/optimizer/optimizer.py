"""Optimizers (the port's counterpart of
``paddle_tpu/optimizer/optimizer.py``): the ``Optimizer`` base, SGD,
Momentum, Adam, AdamW, Adagrad, RMSProp, Adadelta, Adamax, Lamb,
Adafactor and LarsMomentum.

The JAX package's functional core is kept: ``init_state(params)`` and
``apply_gradients(params, grads, state, step) -> (new_params,
new_state)`` over ``{name: tensor}`` dicts, pure (inputs are not
modified), with the same state names and layouts (``m``, ``v``,
``velocity``, ``acc``, ``vr``/``vc``, ..., dicts of float32 tensors for
half parameters under ``multi_precision``; ``master``, float32 copies
of the half parameters' values, present only when some parameter is
half), so a ``.pdopt`` crosses between the packages. The step counter
``t`` is a host int, so the bias corrections are host scalars and need
no sync; ``Model`` under the numeric guard makes it a 0-dim int32
device tensor (a masked step must leave it unchanged without a host
read), and the corrections are then computed on the device in float64
and rounded to float32, the same float the host computes.
``step(grads)`` serves eager workflows by writing the new values into
the bound parameters. ``torch.optim`` is not used; the updates are
``torch._foreach_*`` kernels over the parameter list, or per-tensor
ops where an update takes a norm of each parameter (Lamb, Adafactor,
LarsMomentum).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..nn import clip as _clip
from ..nn.clip import GradClipBase
from .lr import LRScheduler, make_schedule

_HALF = (torch.bfloat16, torch.float16)
Tensors = Dict[str, torch.Tensor]


def _of_step(t, fn):
    """``fn(t)`` of the step counter: a host float for an int ``t``; for
    a device counter, a 0-dim float32 tensor computed in float64, which
    rounds to the float the host path gives."""
    if isinstance(t, torch.Tensor):
        return fn(t.double()).float()
    return fn(t)


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
        bc1 = _of_step(t, lambda u: 1 - b1 ** u)
        bc2 = _of_step(t, lambda u: 1 - b2 ** u)
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


def _zeros_state(base: Tensors, fill: float = 0.0) -> Tensors:
    return {k: torch.full_like(p, fill) for k, p in base.items()}


def _coupled_grads(opt, grads, params):
    """Gradients cast to the working dtype, with ``weight_decay * p``
    added (the coupled decay of the JAX package's optimizers)."""
    names = list(params)
    gs = [grads[k].to(params[k].dtype) for k in names]
    if opt.weight_decay:
        gs = [g + opt.weight_decay * params[k] for g, k in zip(gs, names)]
    return names, gs


class Momentum(Optimizer):
    """Heavy-ball momentum, ``use_nesterov`` for the Nesterov form."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def init_state(self, params):
        s = self._maybe_master_state(params)
        s["velocity"] = _zeros_state(s.get("master", params))
        return s

    def _update(self, grads, state, params, lr):
        mu = self.momentum
        names, gs = _coupled_grads(self, grads, params)
        v = torch._foreach_mul([state["velocity"][k] for k in names], mu)
        torch._foreach_add_(v, gs)
        if self.use_nesterov:
            delta = torch._foreach_add(gs, torch._foreach_mul(v, mu))
        else:
            delta = [x.clone() for x in v]
        torch._foreach_mul_(delta, -lr)
        new_state = dict(state)
        new_state["velocity"] = dict(zip(names, v))
        return dict(zip(names, delta)), new_state


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 parameters=None, weight_decay: float = 0.0,
                 grad_clip=None, initial_accumulator_value: float = 0.0,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def init_state(self, params):
        s = self._maybe_master_state(params)
        s["acc"] = _zeros_state(s.get("master", params), self.init_acc)
        return s

    def _update(self, grads, state, params, lr):
        names, gs = _coupled_grads(self, grads, params)
        acc = torch._foreach_addcmul([state["acc"][k] for k in names], gs, gs)
        denom = torch._foreach_sqrt(acc)
        torch._foreach_add_(denom, self.epsilon)
        delta = torch._foreach_div(torch._foreach_mul(gs, -lr), denom)
        new_state = dict(state)
        new_state["acc"] = dict(zip(names, acc))
        return dict(zip(names, delta)), new_state


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, parameters=None,
                 weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)
        s["ms"] = _zeros_state(base)
        s["mom"] = _zeros_state(base)
        if self.centered:
            s["mg"] = _zeros_state(base)
        return s

    def _update(self, grads, state, params, lr):
        rho, eps, mu = self.rho, self.epsilon, self.momentum
        names, gs = _coupled_grads(self, grads, params)
        ms = torch._foreach_mul([state["ms"][k] for k in names], rho)
        torch._foreach_addcmul_(ms, gs, gs, value=1 - rho)
        new_state = dict(state)
        if self.centered:
            mg = torch._foreach_mul([state["mg"][k] for k in names], rho)
            torch._foreach_add_(mg, gs, alpha=1 - rho)
            var = torch._foreach_sub(ms, torch._foreach_mul(mg, mg))
            new_state["mg"] = dict(zip(names, mg))
        else:
            var = ms
        denom = torch._foreach_sqrt(torch._foreach_add(var, eps))
        mom = torch._foreach_mul([state["mom"][k] for k in names], mu)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(gs, lr), denom))
        new_state["ms"] = dict(zip(names, ms))
        new_state["mom"] = dict(zip(names, mom))
        return dict(zip(names, torch._foreach_neg(mom))), new_state


class Adadelta(Optimizer):
    def __init__(self, learning_rate=1.0, rho: float = 0.95,
                 epsilon: float = 1e-6, parameters=None,
                 weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.rho, self.epsilon = rho, epsilon

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)
        s["avg_sq"] = _zeros_state(base)
        s["avg_dx"] = _zeros_state(base)
        return s

    def _update(self, grads, state, params, lr):
        rho, eps = self.rho, self.epsilon
        names, gs = _coupled_grads(self, grads, params)
        asq = torch._foreach_mul([state["avg_sq"][k] for k in names], rho)
        torch._foreach_addcmul_(asq, gs, gs, value=1 - rho)
        adx_old = [state["avg_dx"][k] for k in names]
        # dx = -sqrt(adx + eps) / sqrt(asq + eps) * g
        dx = torch._foreach_div(
            torch._foreach_neg(torch._foreach_sqrt(
                torch._foreach_add(adx_old, eps))),
            torch._foreach_sqrt(torch._foreach_add(asq, eps)))
        dx = torch._foreach_mul(dx, gs)
        adx = torch._foreach_mul(adx_old, rho)
        torch._foreach_addcmul_(adx, dx, dx, value=1 - rho)
        new_state = dict(state)
        new_state["avg_sq"] = dict(zip(names, asq))
        new_state["avg_dx"] = dict(zip(names, adx))
        return dict(zip(names, torch._foreach_mul(dx, lr))), new_state


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision: bool = True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)
        s["m"] = _zeros_state(base)
        s["u"] = _zeros_state(base)
        s["t"] = 0
        return s

    def _update(self, grads, state, params, lr):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = state["t"] + 1
        step = _of_step(t, lambda u: -lr / (1 - b1 ** u))
        names, gs = _coupled_grads(self, grads, params)
        m = torch._foreach_mul([state["m"][k] for k in names], b1)
        torch._foreach_add_(m, gs, alpha=1 - b1)
        u = torch._foreach_maximum(
            torch._foreach_mul([state["u"][k] for k in names], b2),
            torch._foreach_abs(gs))
        # -lr / bc1 * m / (u + eps)
        delta = torch._foreach_div(
            torch._foreach_mul(m, step), torch._foreach_add(u, eps))
        new_state = dict(state)
        new_state.update(m=dict(zip(names, m)), u=dict(zip(names, u)), t=t)
        return dict(zip(names, delta)), new_state


class Lamb(Optimizer):
    """Adam with a layer-wise trust ratio ``||p|| / ||r||`` (large-batch
    training); ``exclude_from_weight_decay_fn(name)`` turns the decay off
    per parameter."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)
        s["m"] = _zeros_state(base)
        s["v"] = _zeros_state(base)
        s["t"] = 0
        return s

    def _update(self, grads, state, params, lr):
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, \
            self.weight_decay
        t = state["t"] + 1
        bc1 = _of_step(t, lambda u: 1 - b1 ** u)
        bc2 = _of_step(t, lambda u: 1 - b2 ** u)
        out, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k].to(p.dtype)
            m = b1 * state["m"][k] + (1 - b1) * g
            v = b2 * state["v"][k] + (1 - b2) * torch.square(g)
            r = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if wd and (self.exclude_fn is None or not self.exclude_fn(k)):
                r = r + wd * p
            # per-tensor norms over the tensor's pieces on a mesh
            w_norm = torch.sqrt(_clip.tensor_sum(
                k, torch.sum(torch.square(p))))
            r_norm = torch.sqrt(_clip.tensor_sum(
                k, torch.sum(torch.square(r))))
            trust = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, 1.0)
            out[k] = -lr * trust * r
            new_m[k], new_v[k] = m, v
        new_state = dict(state)
        new_state.update(m=new_m, v=new_v, t=t)
        return out, new_state


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018), the T5 formulation: factored
    second moments for every parameter of two or more dims (row and
    column statistics in ``vr``/``vc``, ``v`` empty; a vector keeps a
    full ``v`` and empty ``vr``/``vc``), decay ``1 - t^-0.8``, update-RMS
    clipping at ``clip_threshold``, ``scale_parameter`` (step size times
    ``max(epsilon2, RMS(p))``), the relative step ``min(1e-2, 1 /
    sqrt(t))`` when no learning rate is given, no first moment unless
    ``beta1`` is set. A 3-D parameter whose slices hold at least 2^20
    elements is updated slice by slice (clip and scale per slice), as
    the JAX package updates scan-stacked layers."""

    def __init__(self, learning_rate=None, beta1: Optional[float] = None,
                 decay_rate: float = 0.8, epsilon1: float = 1e-30,
                 epsilon2: float = 1e-3, clip_threshold: float = 1.0,
                 scale_parameter: bool = True, parameters=None,
                 weight_decay: float = 0.0, grad_clip=None,
                 multi_precision: bool = True):
        self.relative_step = learning_rate is None
        super().__init__(1.0 if learning_rate is None else learning_rate,
                         parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1 = beta1
        self.decay_rate = decay_rate
        self.epsilon1, self.epsilon2 = epsilon1, epsilon2
        self.clip_threshold = clip_threshold
        self.scale_parameter = scale_parameter

    @staticmethod
    def _factored(p) -> bool:
        return p.dim() >= 2

    def init_state(self, params):
        s = self._maybe_master_state(params)
        base = s.get("master", params)

        def zeros(p, shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        s["vr"] = {k: zeros(p, p.shape[:-1] if self._factored(p) else (0,))
                   for k, p in base.items()}
        s["vc"] = {k: zeros(p, p.shape[:-2] + p.shape[-1:]
                            if self._factored(p) else (0,))
                   for k, p in base.items()}
        s["v"] = {k: zeros(p, (0,) if self._factored(p) else p.shape)
                  for k, p in base.items()}
        if self.beta1 is not None:
            s["m"] = {k: zeros(p, p.shape) for k, p in base.items()}
        s["t"] = 0
        return s

    def _core(self, g, vr, vc, v, m, p, decay, step_size, shard=None):
        """One logical parameter's update: (delta, vr, vc, v, m).
        ``decay`` is (decay, 1 - decay), ``step_size`` (step size, step
        size times weight decay). ``shard``: ``(group, {dim: count})``
        when ``p`` is one piece of a tensor split along those (negative)
        dims over the ranks of ``group``; its means and RMS are then the
        whole tensor's."""
        decay, fresh = decay
        step_size, wd_step = step_size
        nd = p.dim()

        def mean(x, pdims, xdims=None, keepdim=False):
            xdims = pdims if xdims is None else xdims
            out = x.sum(dim=xdims, keepdim=keepdim)
            count = math.prod(x.shape[d] for d in xdims)
            hit = [c for d, c in (shard[1].items() if shard else ())
                   if d in pdims]
            if hit:
                out = _clip._allreduce(out, shard[0])
                count *= math.prod(hit)
            return out / count

        def rms(x):
            return torch.sqrt(mean(torch.square(x),
                                   tuple(range(-nd, 0))) + 1e-30)
        g32 = g.float()
        g2 = torch.square(g32) + self.epsilon1
        if self._factored(p):
            vr = decay * vr + fresh * mean(g2, (-1,))
            vc = decay * vc + fresh * mean(g2, (-2,))
            # v_hat = outer(vr, vc) / mean(vr): a rank-1 second moment
            r = vr / mean(vr, (-2,), (-1,), keepdim=True)
            u = g32 * torch.rsqrt(r)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            v = decay * v + fresh * g2
            u = g32 * torch.rsqrt(v)
        u = u / torch.clamp(rms(u) / self.clip_threshold, min=1.0)
        alpha = step_size * torch.clamp(rms(p), min=self.epsilon2) \
            if self.scale_parameter else step_size
        if m is not None:
            m = self.beta1 * m + (1 - self.beta1) * u
            u = m
        delta = (-alpha * u - wd_step * p.float()).to(p.dtype)
        return delta, vr, vc, v, m

    def _update(self, grads, state, params, lr):
        t = state["t"] + 1
        rate, wd = self.decay_rate, self.weight_decay
        decay = (_of_step(t, lambda u: 1.0 - u ** -rate),
                 _of_step(t, lambda u: 1 - (1.0 - u ** -rate)))

        def rel(u):  # min(1e-2, 1 / sqrt(t)), on the host or the device
            s = 1.0 / u ** 0.5
            return s.clamp(max=1e-2) if isinstance(s, torch.Tensor) \
                else min(1e-2, s)
        if self.relative_step:
            step_size = (_of_step(t, rel), _of_step(t, lambda u: rel(u) * wd))
        else:
            step_size = (lr, lr * wd)
        out = {}
        new = {n: {} for n in ("vr", "vc", "v", "m")}
        for k, p in params.items():
            g, vr, vc, v = (grads[k], state["vr"][k], state["vc"][k],
                            state["v"][k])
            m = state["m"][k] if self.beta1 is not None else None
            shard = _clip.shard_of(k)
            split = {d - p.dim(): c for d, c in shard[2].items()} \
                if shard else {}
            full = [n * split.get(d - p.dim(), 1)
                    for d, n in enumerate(p.shape)]
            if p.dim() == 3 and full[-2] * full[-1] >= (1 << 20):
                # slice by slice: a piece split along dim 0 holds whole
                # slices
                sub = {d: c for d, c in split.items() if d != -3}
                sub = (shard[1], sub) if sub else None
                rows = [self._core(g[i], vr[i], vc[i], v,
                                   None if m is None else m[i], p[i],
                                   decay, step_size, sub)
                        for i in range(p.shape[0])]
                res = [torch.stack([r[0] for r in rows]),
                       torch.stack([r[1] for r in rows]),
                       torch.stack([r[2] for r in rows]), v,
                       None if m is None else
                       torch.stack([r[4] for r in rows])]
            else:
                res = self._core(g, vr, vc, v, m, p, decay, step_size,
                                 (shard[1], split) if split else None)
            out[k] = res[0]
            for n, val in zip(("vr", "vc", "v", "m"), res[1:]):
                new[n][k] = val
        new_state = dict(state)
        new_state.update(vr=new["vr"], vc=new["vc"], v=new["v"], t=t)
        if self.beta1 is not None:
            new_state["m"] = new["m"]
        return out, new_state


class LarsMomentum(Optimizer):
    """LARS: momentum with a layer-wise rate ``lr * lars_coeff * ||p|| /
    (||g|| + lars_weight_decay * ||p|| + epsilon)``."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 lars_coeff: float = 0.001, lars_weight_decay: float = 0.0005,
                 parameters=None, grad_clip=None, epsilon: float = 1e-9,
                 multi_precision: bool = True):
        super().__init__(learning_rate, parameters, lars_weight_decay,
                         grad_clip, multi_precision)
        self.momentum = momentum
        self.lars_coeff = lars_coeff
        self.epsilon = epsilon

    def init_state(self, params):
        s = self._maybe_master_state(params)
        s["velocity"] = _zeros_state(s.get("master", params))
        return s

    def _update(self, grads, state, params, lr):
        mu, coeff, wd, eps = (self.momentum, self.lars_coeff,
                              self.weight_decay, self.epsilon)
        out, vel = {}, {}
        for k, p in params.items():
            g = grads[k].to(p.dtype)
            p_norm = torch.sqrt(_clip.tensor_sum(
                k, torch.sum(torch.square(p))))
            g_norm = torch.sqrt(_clip.tensor_sum(
                k, torch.sum(torch.square(g))))
            local_lr = torch.where(
                (p_norm > 0) & (g_norm > 0),
                lr * coeff * p_norm / (g_norm + wd * p_norm + eps),
                torch.full_like(p_norm, lr))
            v = mu * state["velocity"][k] + local_lr * (g + wd * p)
            out[k], vel[k] = -v, v
        new_state = dict(state)
        new_state["velocity"] = vel
        return out, new_state
