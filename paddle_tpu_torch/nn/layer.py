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
them onto mesh axes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..core import dtype as dtype_mod


class ParamMeta:
    """A parameter's trainability and logical sharding axes."""
    __slots__ = ("trainable", "axes")

    def __init__(self, trainable: bool = True,
                 axes: Optional[Tuple[Optional[str], ...]] = None):
        self.trainable = trainable
        self.axes = axes


class Layer(torch.nn.Module):
    """Base class of the port's modules."""

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
                         trainable: bool = True) -> torch.nn.Parameter:
        """A new parameter drawn by ``initializer`` (by default the global
        one of ``initializer.set_global_initializer``, else
        ``XavierUniform``) on the CPU; the caller assigns it to an
        attribute."""
        from . import initializer as I
        dt = dtype_mod.dtype(dtype) if dtype is not None \
            else dtype_mod.get_default_dtype()
        init = initializer or I.get_global_initializer() \
            or I.XavierUniform()
        return torch.nn.Parameter(init(shape, dt), requires_grad=trainable)


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
