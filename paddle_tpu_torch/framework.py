"""Framework-level utilities (the port's counterpart of
``paddle_tpu/framework.py``): the functional autodiff facade, ``jit``,
``save`` and ``load``.

- ``grad`` / ``value_and_grad`` are ``jax.grad``'s and
  ``jax.value_and_grad``'s conventions on ``torch.func``: ``grad(fn)``
  returns a function of ``fn``'s arguments giving the gradient of its
  scalar output with respect to argument ``argnums`` (a tensor or a
  pytree of tensors); ``value_and_grad`` returns ``(value, grad)``
  (``torch.func.grad_and_value`` returns ``(grad, value)``).
- ``jit`` / ``to_static`` (and the top-level ``compile``): the port runs
  eagerly everywhere, so they return a callable that computes the same
  values as the function, uncompiled.
- ``save`` / ``load`` pickle a tree of numpy arrays (protocol 4), the
  JAX package's format: a file written by either package loads in the
  other. ``load`` returns torch tensors (on the CPU) where the file
  holds numeric arrays; bfloat16 tensors are written as float32 (numpy
  has no bfloat16).
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
from typing import Any, Callable

import numpy as np
import torch

from .nn.layer import Layer  # noqa: F401  (the JAX module exports it too)


def grad(fun: Callable, argnums=0, has_aux: bool = False):
    """``jax.grad``: the gradient of ``fun``'s scalar output."""
    return torch.func.grad(fun, argnums=argnums, has_aux=has_aux)


def value_and_grad(fun: Callable, argnums=0, has_aux: bool = False):
    """``jax.value_and_grad``: ``(value, grad)``, or ``((value, aux),
    grad)`` with ``has_aux``."""
    inner = torch.func.grad_and_value(fun, argnums=argnums,
                                      has_aux=has_aux)

    @functools.wraps(fun)
    def f(*args, **kwargs):
        g, v = inner(*args, **kwargs)
        return v, g
    return f


@contextlib.contextmanager
def no_grad():
    """``paddle.no_grad``: torch's ``no_grad`` scope, with the
    grad-enabled flag (``compat_fill.is_grad_enabled``) answering False
    inside it."""
    with torch.no_grad():
        yield


def jit(fn: Callable = None, *, static_argnums=(), donate_argnums=(),
        **jit_kwargs):
    """``@paddle_tpu_torch.jit``: the port runs eagerly, so this returns
    ``fn`` itself (same values, no compilation); as a decorator with
    arguments it returns the identity decorator."""
    def wrap(f):
        return f
    if fn is None:
        return wrap
    return wrap(fn)


to_static = jit


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype is torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _map_tree(fn, obj):
    """``jax.tree_util.tree_map`` over dicts, lists and tuples (None is an
    empty node)."""
    if obj is None:
        return None
    if isinstance(obj, dict):
        return type(obj)((k, _map_tree(fn, v)) for k, v in obj.items())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tree(fn, v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tree(fn, v) for v in obj)
    return fn(obj)


def save(obj: Any, path: str) -> None:
    """Serialize a state_dict / pytree / Layer to ``path``
    (ref: paddle.save, python/paddle/framework/io.py:574)."""
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_map_tree(_to_numpy, obj), f, protocol=4)


def _to_tensor(x):
    if isinstance(x, np.ndarray) and x.dtype.kind in "biufc":
        return torch.from_numpy(np.array(x, copy=True))
    return x


def load(path: str) -> Any:
    """ref: paddle.load (python/paddle/framework/io.py:791); numeric
    arrays come back as CPU tensors."""
    with open(path, "rb") as f:
        return _map_tree(_to_tensor, pickle.load(f))
