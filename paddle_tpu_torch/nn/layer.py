"""``Layer`` and ``LayerList`` on ``torch.nn.Module``
(the port's counterpart of ``paddle_tpu/nn/layer.py``).

Parameters are registered under the same attribute names as in the JAX
package, so the dotted state-dict keys are identical
(``gpt.layers.0.attn.qkv_proj.weight``, ...) and a state dict passes
between the two packages through numpy unchanged
(:func:`paddle_tpu_torch.interop.load_reference_state`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import dtype as dtype_mod


class Layer(torch.nn.Module):
    """Base class of the port's modules."""

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
