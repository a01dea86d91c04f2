"""Shared helpers of the port's nn tests (``tests/test_torch_nn_*.py``,
``test_torch_rnn.py``, ``test_torch_moe.py``): build a layer in both
packages, carry the JAX layer's (randomized) parameters across by state
dict key, and hold outputs, buffers and parameter gradients of the port
against the JAX package's on the same numpy inputs."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import nn as jnn
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_reference_state

TOL = 1e-5


def rand(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def carry(jl, tl, perturb=True, scale=0.5):
    """Randomize the JAX layer's parameters (buffers kept), then load its
    whole state into the port's layer."""
    if perturb:
        params, _ = jnn.split_state(jl)
        new = {k: rand(*v.shape, seed=i + 7, scale=scale)
               for i, (k, v) in enumerate(sorted(params.items()))}
        jl.set_state_dict({**{k: np.asarray(v) for k, v in
                              jl.state_dict().items()}, **new})
    state = {k: np.asarray(v) for k, v in jl.state_dict().items()}
    load_reference_state(tl, state)


def close(got, want, tol=TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


def both(name, *args, **kwargs):
    """The layer ``name`` built with the same arguments in each package."""
    return getattr(jnn, name)(*args, **kwargs), \
        getattr(tnn, name)(*args, **kwargs)


def check_layer(jl, tl, inputs, training=False, grads=True, tol=TOL,
                perturb=True):
    """Forward (and, with parameters, the gradients of ``sum(out * r)``)
    of both layers on ``inputs`` (numpy arrays; ints stay ints); the
    buffers the forward leaves must match too. Returns the port's
    output."""
    carry(jl, tl, perturb)
    tl.train(training)
    (jl.train() if training else jl.eval())
    params, bufs = jnn.split_state(jl)
    jx = [jnp.asarray(a) for a in inputs]
    tx = [torch.from_numpy(np.array(a)) for a in inputs]

    def run(p):
        return jnn.functional_call(jl, p, bufs, *jx, training=training)

    jout, jbufs = run(params)
    tout = tl(*tx)
    close(tout, jout, tol, "output")
    tbufs = dict(tl.named_buffers())
    for k, v in jbufs.items():
        close(tbufs[k], v, tol, f"buffer {k}")
    if grads and params:
        r = rand(*np.shape(jout), seed=99)
        jg = jax.grad(lambda p: jnp.sum(run(p)[0] * r))(params)
        (tout * torch.from_numpy(r)).sum().backward()
        tp = dict(tl.named_parameters())
        for k, g in jg.items():
            close(tp[k].grad, g, tol, f"grad {k}")
    return tout
