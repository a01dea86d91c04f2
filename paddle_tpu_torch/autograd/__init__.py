"""paddle_tpu_torch.autograd — functional autodiff, PyLayer and the
recorded training step (the port's counterpart of
``paddle_tpu/autograd/__init__.py``).

``vjp`` / ``jvp`` / ``Jacobian`` / ``Hessian`` keep the JAX package's
calling conventions on ``torch.func``. ``PyLayer`` is a
``torch.autograd.Function`` behind Paddle's ``ctx`` API
(``save_for_backward`` / ``saved_tensor`` / ``attrs``). ``record`` runs
a forward on torch's tape and fills ``tape.grads`` by parameter name
with ``torch.autograd.grad``; buffers a forward mutates (BatchNorm's
statistics) are updated in place by the forward itself. ``backward`` is
torch's: where the JAX package has no tape and raises, the port runs
``torch.autograd.backward``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _ones_like_tree(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_ones_like_tree(t) for t in tree)
    return torch.ones_like(tree)


def vjp(func: Callable, xs, v=None):
    """ref: incubate/autograd/functional.py vjp(func, xs, v).
    Returns (func(xs), vjp_result)."""
    single = not isinstance(xs, (tuple, list))
    args = (xs,) if single else tuple(xs)
    out, pullback = torch.func.vjp(func, *args)
    if v is None:
        v = _ones_like_tree(out)
    grads = pullback(v)
    return out, grads[0] if single else grads


def jvp(func: Callable, xs, v=None):
    """ref: incubate/autograd/functional.py jvp."""
    single = not isinstance(xs, (tuple, list))
    args = (xs,) if single else tuple(xs)
    if v is None:
        tangents = tuple(torch.ones_like(a) for a in args)
    else:
        tangents = (v,) if single else tuple(v)
    return torch.func.jvp(func, args, tangents)


class _Full:
    def __getitem__(self, idx):
        return self._value[idx]

    @property
    def shape(self):
        return tuple(self._value.shape)

    def __array__(self, dtype=None):
        import numpy as np
        return np.asarray(self._value.detach().cpu(), dtype=dtype)


class Jacobian(_Full):
    """ref: incubate/autograd/functional.py Jacobian — the full
    jacobian (reverse mode), indexable."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        fn = torch.func.jacrev(func)
        self._value = torch.func.vmap(fn)(xs) if is_batched else fn(xs)


class Hessian(_Full):
    """ref: incubate/autograd/functional.py Hessian."""

    def __init__(self, func: Callable, xs, is_batched: bool = False):
        fn = torch.func.hessian(func)
        self._value = torch.func.vmap(fn)(xs) if is_batched else fn(xs)


jacobian = torch.func.jacrev
hessian = torch.func.hessian


def grad(fun: Callable, argnums=0, has_aux: bool = False):
    """``jax.grad``'s convention (see ``framework.grad``)."""
    return torch.func.grad(fun, argnums=argnums, has_aux=has_aux)


# ---------------------------------------------------------------------------
# PyLayer
# ---------------------------------------------------------------------------

class PyLayerContext:
    """ref: py_layer.py PyLayerContext — save_for_backward/saved_tensor
    and free-form ``attrs``."""

    def __init__(self):
        self._saved: Tuple = ()
        self.attrs: dict = {}

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        return self._saved


class PyLayerMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)
        if name == "PyLayer" or not bases:
            return
        layer = cls

        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(tctx, *args):
                ctx = PyLayerContext()
                out = layer.forward(ctx, *args)
                tctx.pctx = ctx
                tctx.n_args = len(args)
                return out

            @staticmethod
            def backward(tctx, *grads):
                g = grads[0] if len(grads) == 1 else grads
                out = layer.backward(tctx.pctx, g)
                if not isinstance(out, tuple):
                    out = (out,)
                # None for the arguments backward gives no gradient
                return out + (None,) * (tctx.n_args - len(out))

        _Fn.__name__ = f"{name}Function"
        cls._fn = _Fn


class PyLayer(metaclass=PyLayerMeta):
    """User-defined differentiable op (ref: paddle.autograd.PyLayer).

    Subclass with static ``forward(ctx, *args)`` and
    ``backward(ctx, grad)``; call with ``MyLayer.apply(*args)``. Runs as
    a ``torch.autograd.Function``."""

    @staticmethod
    def forward(ctx: PyLayerContext, *args):
        raise NotImplementedError

    @staticmethod
    def backward(ctx: PyLayerContext, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args):
        return cls._fn.apply(*args)


# ---------------------------------------------------------------------------
# dygraph-style training bridge
# ---------------------------------------------------------------------------

class record:
    """The dygraph ``loss.backward(); opt.step()`` idiom with the JAX
    package's surface::

        tape = autograd.record(net)
        loss = tape.run(lambda: criterion(net(x), y))
        tape.backward()            # tape.grads, by parameter name
        opt.step(tape.grads)

    ``run`` executes the thunk on torch's tape and takes the gradient of
    its scalar result with respect to the trainable parameters of the
    given layers (zeros for a parameter the thunk does not use). With
    several layers the names are prefixed ``"i~"``."""

    def __init__(self, *layers):
        from ..nn.layer import Layer
        if not layers or not all(isinstance(l, Layer) for l in layers):
            raise ValueError("record(*layers) needs at least one Layer")
        self._layers = layers
        self.grads = None
        self.loss = None

    def _named(self):
        params = {}
        for i, l in enumerate(self._layers):
            prefix = f"{i}~" if len(self._layers) > 1 else ""
            meta = l.param_meta()
            for name, p in l.named_parameters():
                if meta[name].trainable:
                    params[prefix + name] = p
        return params

    def run(self, thunk):
        params = self._named()
        with torch.enable_grad():
            loss = thunk()
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        self.loss = loss.detach()
        self.grads = {name: (g if g is not None else torch.zeros_like(p))
                      for (name, p), g in zip(params.items(), grads)}
        return self.loss

    def backward(self):
        """Grads were produced by ``run`` (one fused fwd+bwd); this
        makes the idiom read like the reference."""
        if self.grads is None:
            raise RuntimeError("record.backward() before run()")
        return self.grads

    def layer_grads(self, i: int):
        """Grads of layer ``i`` with unprefixed names — feed one
        optimizer per layer when recording several layers."""
        if self.grads is None:
            raise RuntimeError("record.layer_grads() before run()")
        if len(self._layers) == 1:
            return dict(self.grads)
        pre = f"{i}~"
        return {k[len(pre):]: v for k, v in self.grads.items()
                if k.startswith(pre)}


def backward(tensors, grad_tensors=None, retain_graph=False):
    """ref: autograd/backward_mode.py backward: accumulate the gradients
    of ``tensors`` into the ``.grad`` of the leaves they depend on
    (``torch.autograd.backward``)."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=retain_graph)
