"""Carry weights from the JAX package into the port.

Both packages keep the same module tree, parameter names and layouts
(``Linear`` weights are ``[in, out]`` in both), so a JAX state dict
loads by identical key with no transposes::

    state = {k: np.asarray(v) for k, v in jax_net.state_dict().items()}
    load_reference_state(torch_net, state)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def load_reference_state(module: torch.nn.Module,
                         state: Dict[str, np.ndarray],
                         strict: bool = True) -> torch.nn.Module:
    """Copy every entry of ``state`` into ``module``'s tensor of the same
    key, cast to that tensor's dtype and device. Under ``strict`` a key
    missing on either side raises; a shape mismatch always raises, but
    for a parameter that a Model on a mesh holds as this rank's piece,
    which takes its piece of the whole value."""
    own = module.state_dict()
    # a Model's parameters on a mesh that are this rank's pieces (tp
    # slices, pp stages, ep experts) take their piece of a whole value
    pieces = {k: p._local_of for k, p in module.named_parameters()
              if hasattr(p, "_local_of")}
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if strict and (missing or extra):
        raise ValueError(f"state mismatch: missing={missing}, "
                         f"unexpected={extra}")
    with torch.no_grad():
        for key, value in state.items():
            if key not in own:
                continue
            value = np.asarray(value)
            if key in pieces and tuple(value.shape) != tuple(
                    own[key].shape):
                value = pieces[key](torch.from_numpy(np.array(value))
                                    ).numpy()
            if tuple(value.shape) != tuple(own[key].shape):
                raise ValueError(
                    f"{key}: shape {tuple(value.shape)} does not match "
                    f"the module's {tuple(own[key].shape)}")
            own[key].copy_(torch.from_numpy(np.array(value)))
    return module
