"""``Layer`` and ``LayerList`` on ``torch.nn.Module``
(the port's counterpart of ``paddle_tpu/nn/layer.py``).

Parameters are registered under the same attribute names as in the JAX
package, so the dotted state-dict keys are identical
(``gpt.layers.0.attn.qkv_proj.weight``, ...) and a state dict passes
between the two packages through numpy unchanged
(:func:`paddle_tpu_torch.interop.load_reference_state`).

A layer records the logical sharding axes of its parameters in
``_param_axes`` (``{attribute: (axis name or None per dim)}``, e.g.
``("embed", "mlp")`` for a column-parallel weight), and
:meth:`Layer.param_meta` reports them by dotted name, as the JAX
package's ``Layer.param_meta`` does; ``paddle_tpu_torch.parallel`` maps
them onto mesh axes. A :class:`Parameter` assigned to a layer attribute
registers its ``axes`` the same way.

:func:`functional_call` runs a layer as a function of ``(params,
buffers)`` and returns the buffers its forward wrote (BatchNorm's
running statistics), as the JAX package's does; a layer's *derived*
attributes (``nn.utils.weight_norm`` / ``spectral_norm``) are recomputed
from the live parameters on every access.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import dtype as dtype_mod


class Parameter(torch.nn.Parameter):
    """A parameter declaration: ``value`` with its trainability
    (``requires_grad``) and logical sharding ``axes``, which assigning
    it to a :class:`Layer` attribute records (``Layer.param_meta``).
    Non-float values are never trainable."""

    def __new__(cls, value, trainable: bool = True,
                axes: Optional[Tuple[Optional[str], ...]] = None):
        t = torch.as_tensor(value).detach()
        p = super().__new__(cls, t, requires_grad=bool(
            trainable and (t.is_floating_point() or t.is_complex())))
        p.axes = tuple(axes) if axes is not None else None
        return p

    def __deepcopy__(self, memo):
        out = Parameter(self.detach().clone(), self.requires_grad,
                        self.axes)
        memo[id(self)] = out
        return out


class ParamMeta:
    """A parameter's trainability and logical sharding axes."""
    __slots__ = ("trainable", "axes")

    def __init__(self, trainable: bool = True,
                 axes: Optional[Tuple[Optional[str], ...]] = None):
        self.trainable = trainable
        self.axes = axes


class Layer(torch.nn.Module):
    """Base class of the port's modules."""

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, Parameter):
            self.set_param_axes(name, value.axes)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            derived = self.__dict__.get("_derived")
            if derived and name in derived:
                return derived[name](self)
            raise

    def register_forward_post_hook(self, hook) -> "HookRemoveHelper":
        """``hook(layer, args, out)``; a non-None return replaces the
        output."""
        return HookRemoveHelper(self.register_forward_hook(hook))

    def register_forward_pre_hook(self, hook, **kwargs
                                  ) -> "HookRemoveHelper":
        """``hook(layer, args)``; a non-None return replaces the
        positional arguments (a non-tuple becomes a 1-tuple)."""
        return HookRemoveHelper(
            super().register_forward_pre_hook(hook, **kwargs))

    def set_param_axes(self, name: str, axes) -> None:
        """Record the logical axes of this layer's parameter ``name``."""
        if not hasattr(self, "_param_axes"):
            self._param_axes = {}
        self._param_axes[name] = tuple(axes) if axes is not None else None

    def param_meta(self, prefix: str = "") -> Dict[str, ParamMeta]:
        """``{dotted name: ParamMeta}`` for every parameter, the names of
        ``named_parameters()``; a parameter whose layer declares no axes
        has ``axes`` None (replicated)."""
        out = {}
        for mod_name, mod in self.named_modules():
            axes = getattr(mod, "_param_axes", {})
            for pname, p in mod.named_parameters(recurse=False):
                name = ".".join(x for x in (prefix, mod_name, pname) if x)
                out[name] = ParamMeta(p.requires_grad, axes.get(pname))
        return out

    def create_parameter(self, shape, dtype=None,
                         initializer: Optional[Callable] = None,
                         trainable: bool = True,
                         axes=None) -> "Parameter":
        """A new parameter drawn by ``initializer`` (by default the global
        one of ``initializer.set_global_initializer``, else
        ``XavierUniform``) on the CPU, with its logical ``axes``; the
        caller assigns it to an attribute."""
        from . import initializer as I
        dt = dtype_mod.dtype(dtype) if dtype is not None \
            else dtype_mod.get_default_dtype()
        init = initializer or I.get_global_initializer() \
            or I.XavierUniform()
        return Parameter(init(shape, dt), trainable=trainable, axes=axes)

    def add_parameter(self, name: str, param) -> None:
        setattr(self, name, param)


class LayerList(torch.nn.ModuleList):
    """Sublayers keyed ``"0"``, ``"1"``, ... as in the JAX package."""


class Sequential(Layer):
    """Sublayers keyed ``"0"``, ``"1"``, ... (or by ``(name, layer)``
    pairs) applied in turn, as in the JAX package."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        for i, l in enumerate(layers):
            if isinstance(l, tuple):  # (name, layer) pairs
                self.add_module(l[0], l[1])
            else:
                self.add_module(str(i), l)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def forward(self, x):
        for l in self._modules.values():
            x = l(x)
        return x


class LayerDict(torch.nn.ModuleDict):
    """Sublayers keyed by name, as in the JAX package."""


class HookRemoveHelper:
    """The handle of a forward hook: :meth:`remove` detaches it."""

    def __init__(self, handle):
        self._handle = handle
        self.id = handle.id

    def remove(self):
        self._handle.remove()


def split_state(layer: torch.nn.Module):
    """``(params, buffers)``: the layer's parameters and buffers by dotted
    name."""
    return (OrderedDict(layer.named_parameters()),
            OrderedDict(layer.named_buffers()))


def functional_call(layer: torch.nn.Module, params, buffers, *args,
                    training: Optional[bool] = None, **kwargs):
    """``layer``'s forward as a pure function of ``params`` and
    ``buffers`` (``torch.func.functional_call``): returns ``(output,
    new_buffers)``, the buffers as the forward left them (running
    statistics), and leaves the layer's own tensors, the tensors passed
    in and the ``training`` flags as they were (a forward updates its
    buffers in place, so it gets copies). ``training`` sets the mode for
    the call."""
    prev = None
    if training is not None:
        prev = [(m, m.training) for m in layer.modules()]
        layer.train(training)
    state = {**params, **{k: v.clone() for k, v in buffers.items()}}
    try:
        out = torch.func.functional_call(layer, state, args, kwargs)
    finally:
        if prev is not None:
            for m, mode in prev:
                m.training = mode
    return out, OrderedDict((k, state[k]) for k in buffers)
