"""paddle_tpu_torch.testing — the systematic op-test harness (the port's
counterpart of ``paddle_tpu/testing/__init__.py``).

Reference being replaced: ``OpTest``
(python/paddle/fluid/tests/unittests/op_test.py:309 ``check_output`` —
forward vs a reference implementation with per-dtype tolerances;
op_test.py:1892 ``check_grad`` — numeric finite-difference gradients
with per-op ``max_relative_error``).

As in the JAX package, the gradient check is a *directional-derivative
identity* — for random direction ``v`` and cotangent ``u``::

    <grad_x <f(x), u>, v>  ==  d/de <f(x + e v), u> |_{e=0}

The left side is one ``torch.autograd.grad`` call over every argument in
``grad_wrt`` (the thing being validated); the right side is one central
finite difference per argument — two forward evaluations, O(1) instead
of O(numel). The cotangent and directions are the JAX package's draws
(``RandomState(1234)`` per call, ``RandomState(99 + slot)``). Forward
checks compare the op against a NumPy reference under the same
per-dtype tolerance table. Inputs go to the device ``set_device`` chose
(the card by default); ``jit`` is kept for the spec's signature: the
port runs every op eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

# per-dtype forward tolerances (ref: op_test.py dtype-dependent
# atol/rtol selection in check_output)
FORWARD_TOL: Dict[Any, Tuple[float, float]] = {
    np.dtype(np.float32): (2e-5, 2e-5),
    np.dtype(np.float64): (1e-12, 1e-12),
    np.dtype(np.float16): (2e-3, 2e-3),
    # bfloat16 compared after cast to f32
}
# directional FD: f32 central differences are noisy; this is a
# structure/sign check, not a precision check (ref: per-op
# max_relative_error values of 0.005-0.7 in the unittests)
GRAD_RTOL = 5e-2
GRAD_ATOL = 1e-3


def arr(shape, low=-1.0, high=1.0, dtype=np.float32, seed=0):
    """Deterministic test input on [low, high)."""
    r = np.random.RandomState(seed)
    x = r.uniform(low, high, size=shape)
    return x.astype(dtype)


@dataclass
class OpSpec:
    """One op's test declaration: the op, a NumPy reference, inputs."""
    name: str
    fn: Callable                      # the paddle_tpu_torch op
    ref: Optional[Callable]           # NumPy reference (None: skip fwd)
    inputs: Tuple[Any, ...]           # positional inputs (np arrays ok)
    kwargs: Dict[str, Any] = field(default_factory=dict)
    grad: bool = True                 # run the directional-FD check
    grad_wrt: Tuple[int, ...] = (0,)  # which positional args get grads
    jit: bool = True                  # False: dynamic-output-shape op
    fd_eps: float = 1e-3
    rtol: Optional[float] = None      # forward override
    atol: Optional[float] = None
    grad_rtol: float = GRAD_RTOL
    grad_atol: float = GRAD_ATOL

    def __repr__(self):  # pytest id
        return self.name


def _device():
    from ..core.device import current_device
    return current_device()


def _tensor(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(x), device=dev)
    return x


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, dict):
        return [leaf for k in sorted(out) for leaf in _leaves(out[k])]
    return [out] if out is not None else []


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def check_forward(spec: OpSpec) -> None:
    if spec.ref is None:
        return
    dev = _device()
    with torch.no_grad():
        out = spec.fn(*[_tensor(x, dev) for x in spec.inputs],
                      **spec.kwargs)
    expect = spec.ref(*[np.asarray(x) for x in spec.inputs])
    out_t = _leaves(out)
    exp_t = _leaves(expect)
    assert len(out_t) == len(exp_t), \
        f"{spec.name}: {len(out_t)} outputs vs {len(exp_t)} expected"
    for o, e in zip(out_t, exp_t):
        o = _host(o)
        e = np.asarray(e)
        rtol, atol = FORWARD_TOL.get(np.dtype(o.dtype) if
                                     o.dtype.kind == "f" else None,
                                     (0.0, 0.0))
        np.testing.assert_allclose(
            o, e.astype(o.dtype) if o.dtype.kind == "f" else e,
            rtol=spec.rtol if spec.rtol is not None else rtol,
            atol=spec.atol if spec.atol is not None else atol,
            err_msg=f"{spec.name} forward mismatch")


def check_grad(spec: OpSpec) -> None:
    if not spec.grad:
        return
    dev = _device()
    inputs = [_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                      else x, dev) for x in spec.inputs]

    def scalar(*args):
        # the RandomState is created per call so the gradient, f(x+ev)
        # and f(x-ev) all contract against the SAME cotangent u
        r = np.random.RandomState(1234)
        out = spec.fn(*args, **spec.kwargs)
        total = 0.0
        for leaf in _leaves(out):
            u = torch.as_tensor(r.uniform(-1, 1, size=tuple(leaf.shape))
                                .astype(np.float32), device=leaf.device)
            total = total + torch.sum(leaf.float() * u)
        return total

    wrt = [inputs[i].detach().requires_grad_(True) for i in spec.grad_wrt]
    args = list(inputs)
    for i, w in zip(spec.grad_wrt, wrt):
        args[i] = w
    grads = torch.autograd.grad(scalar(*args), wrt, allow_unused=True)
    with torch.no_grad():
        for slot, g in zip(spec.grad_wrt, grads):
            x = inputs[slot]
            rv = np.random.RandomState(99 + slot)
            v = torch.as_tensor(rv.uniform(-1, 1, size=tuple(x.shape))
                                .astype(np.float32), device=dev)
            eps = spec.fd_eps
            plus = list(inputs)
            minus = list(inputs)
            plus[slot] = x + eps * v
            minus[slot] = x - eps * v
            fd = (float(scalar(*plus)) - float(scalar(*minus))) / (2 * eps)
            analytic = 0.0 if g is None else float(torch.sum(g * v))
            np.testing.assert_allclose(
                analytic, fd, rtol=spec.grad_rtol, atol=spec.grad_atol,
                err_msg=f"{spec.name} grad (arg {slot}): analytic "
                        f"{analytic} vs finite-difference {fd}")


def check_forward_bf16(spec: OpSpec, rtol: float = 3e-2,
                       atol: float = 3e-2) -> None:
    """Forward check with bf16 inputs against the f32 NumPy reference —
    the dtype half of the reference's per-dtype OpTest sweep. Inputs are
    rounded through bf16 first so the reference sees the same quantized
    values."""
    if spec.ref is None or not spec.jit:
        return
    dev = _device()
    cast = []
    for x in spec.inputs:
        arr_ = _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
        if arr_.dtype == np.float32:
            cast.append(torch.as_tensor(arr_, device=dev)
                        .to(torch.bfloat16))
        else:
            cast.append(x)
    if not any(isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
               for x in cast):
        return  # no float inputs: nothing dtype-specific to test
    with torch.no_grad():
        out = spec.fn(*[_tensor(x, dev) for x in cast], **spec.kwargs)
    ref_in = [_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in cast]
    expect = spec.ref(*ref_in)
    for o, e in zip(_leaves(out), _leaves(expect)):
        o = _host(o)
        if o.dtype.kind != "f" and np.asarray(e).dtype.kind != "f":
            continue  # int/bool outputs compared exactly in f32 sweep
        np.testing.assert_allclose(
            o.astype(np.float32), np.asarray(e, np.float32),
            rtol=rtol, atol=atol,
            err_msg=f"{spec.name} bf16 forward mismatch")


def run_spec(spec: OpSpec) -> None:
    check_forward(spec)
    check_grad(spec)
