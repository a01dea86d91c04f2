"""Weight regularizers (the port's counterpart of
``paddle_tpu/regularizer.py``): a penalty over a tree of parameters and
the gradient transform the optimizer applies."""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [] if tree is None else [tree]


def _map2(fn, a, b):
    if isinstance(a, dict):
        return type(a)((k, _map2(fn, v, b[k])) for k, v in a.items())
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


class L1Decay:
    """ref: regularizer.py L1Decay(regularization_coeff)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = coeff

    def penalty(self, params) -> torch.Tensor:
        return self.coeff * sum(torch.abs(p).sum()
                                for p in _leaves(params))

    def grad_transform(self, grads, params):
        return _map2(lambda g, p: g + self.coeff * torch.sign(p),
                     grads, params)


class L2Decay:
    """ref: regularizer.py L2Decay(regularization_coeff)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = coeff

    def penalty(self, params) -> torch.Tensor:
        return 0.5 * self.coeff * sum((p * p).sum()
                                      for p in _leaves(params))

    def grad_transform(self, grads, params):
        return _map2(lambda g, p: g + self.coeff * p, grads, params)
