"""``paddle_tpu/nn/utils.py`` in the port: the weight
reparameterizations (``weight_norm``, ``spectral_norm``), parameter
vector packing, and the depth loop over a stack of identical blocks
(``scan_layer_stack``, ``scan_stacked_apply``) with the rematerialized
call it and ``GPTConfig(remat=True)`` use (:func:`checkpoint`).

A reparameterized weight is a *derived* attribute of its layer
(``Layer.__getattr__``): recomputed from the live parameters on every
access, so no value goes stale. Spectral norm's power-iteration vector
``{name}_u`` is a buffer advanced once a forward by a pre-hook, as the
JAX package's is; the port iterates in float64 and stores float32, so
the stored vector does not depend on the device's summation order.

The JAX package stacks the blocks' parameters to ``[L, ...]`` and runs
one ``lax.scan``; eager PyTorch gains nothing from one lowering, so the
port loops over the blocks (state-dict names stay the same) and keeps
what the scan changes in the numbers: each layer's dropout keys come
from ``fold_in(next_key(rng_tag), i)``, not from the ambient stream in
sequence.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from .. import amp
from ..core import rng, threefry
from .layer import Layer, Parameter


def _norm_except(v, dim: int):
    dim = dim % v.dim()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return v.square().sum(dim=axes, keepdim=True).sqrt()


def _register_derived(layer: Layer, name: str, fn) -> None:
    derived = layer.__dict__.get("_derived")
    if derived is None:
        derived = {}
        object.__setattr__(layer, "_derived", derived)
    derived[name] = fn


def _pop_param(layer: Layer, name: str):
    """Remove parameter ``name``: (tensor, trainable, axes)."""
    p = layer._parameters.pop(name)
    axes = getattr(layer, "_param_axes", {}).pop(name, None)
    return p.detach(), p.requires_grad, axes


def weight_norm(layer: Layer, name: str = "weight", dim: int = 0) -> Layer:
    """w = g * v / ||v||: registers ``{name}_v`` (direction) and
    ``{name}_g`` (magnitude, the norm over every dim but ``dim``);
    ``{name}`` becomes a derived attribute recomputed from them."""
    if name not in layer._parameters:
        raise ValueError(f"{name!r} is not a parameter of the layer")
    if f"{name}_v" in layer._parameters:
        raise ValueError(f"weight_norm already applied to {name!r}")
    w, trainable, axes = _pop_param(layer, name)
    dim = dim % w.dim()
    g = _norm_except(w, dim)
    layer.add_parameter(f"{name}_v", Parameter(w.clone(), trainable, axes))
    layer.add_parameter(f"{name}_g", Parameter(g, trainable))

    def _derive(m):
        v = m._parameters[f"{name}_v"]
        return m._parameters[f"{name}_g"] * v / torch.clamp(
            _norm_except(v, dim), min=1e-12)

    _register_derived(layer, name, _derive)
    dims = layer.__dict__.setdefault("_weight_norm_dims", {})
    dims[name] = dim
    return layer


def remove_weight_norm(layer: Layer, name: str = "weight") -> Layer:
    """Fold ``g * v / ||v||`` back into one parameter, keeping the
    trainable flag and the sharding axes."""
    dims = layer.__dict__.get("_weight_norm_dims", {})
    if name not in dims:
        raise ValueError(f"weight_norm not applied to {name!r}")
    dim = dims.pop(name)
    v, trainable, axes = _pop_param(layer, f"{name}_v")
    g, _, _ = _pop_param(layer, f"{name}_g")
    layer.__dict__.get("_derived", {}).pop(name, None)
    layer.add_parameter(name, Parameter(
        g * v / torch.clamp(_norm_except(v, dim), min=1e-12),
        trainable, axes))
    return layer


def spectral_norm(layer: Layer, name: str = "weight",
                  n_power_iterations: int = 1, eps: float = 1e-12,
                  dim: int = 0) -> Layer:
    """w / sigma_max(w), sigma estimated by power iteration: the buffer
    ``{name}_u`` starts as JAX's ``normal(key(0))`` draw, normalised
    (threefry), and a forward pre-hook advances it ``n_power_iterations``
    steps before each forward; the parameter becomes ``{name}_orig``
    and ``{name}`` a derived attribute."""
    if name not in layer._parameters:
        raise ValueError(f"{name!r} is not a parameter of the layer")
    if n_power_iterations < 1:
        raise ValueError("n_power_iterations must be >= 1")
    w, trainable, axes = _pop_param(layer, name)
    dim = dim % w.dim()

    def _mat(w_):
        return w_.movedim(dim, 0).reshape(w_.shape[dim], -1)

    u0 = threefry.normal(threefry.prng_key(0), (w.shape[dim],))
    layer.register_buffer(f"{name}_u", u0 / torch.linalg.vector_norm(u0))
    layer.add_parameter(f"{name}_orig", Parameter(w.clone(), trainable,
                                                  axes))

    @torch.no_grad()
    def _advance(m, args):
        mat = _mat(m._parameters[f"{name}_orig"]).double()
        buf = m._buffers[f"{name}_u"]
        u = buf.double()
        for _ in range(n_power_iterations):
            v = mat.T @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = mat @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
        buf.copy_(u.to(buf.dtype))

    def _derive(m):
        w_ = m._parameters[f"{name}_orig"]
        mat = _mat(w_)
        u = m._buffers[f"{name}_u"].detach()
        v = mat.T @ u
        v = (v / torch.clamp(torch.linalg.vector_norm(v), min=eps)).detach()
        return w_ / (u @ (mat @ v))

    layer.register_forward_pre_hook(_advance)
    _register_derived(layer, name, _derive)
    return layer


def parameters_to_vector(parameters) -> torch.Tensor:
    """The parameters flattened into one vector."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters):
    """``vec`` split back into tensors shaped like ``parameters``,
    returned as a list (the JAX package's form: no in-place copy)."""
    out, off = [], 0
    for p in parameters:
        n = p.numel()
        out.append(vec[off:off + n].reshape(p.shape))
        off += n
    return out


def checkpoint(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant).

    The recompute replays the forward's thread-local state, which
    torch's checkpoint does not know: the innermost key stream (its key
    and the counters of its sub-streams, so dropout draws the same
    masks again), a data-parallel rank's rows, a tensor-parallel rank's
    heads and a sequence-parallel rank's positions of the masks
    (``rng.batch_rows`` / ``rng.head_slice`` / ``rng.seq_slice``: the
    backward runs after their scope closed) and the
    ``amp.auto_cast`` state (the recompute may run on the autograd
    engine's device thread, where none is set). The
    live stream advances past the forward's draws, as an unwrapped call
    advances it. With gradients off it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    stream = rng.current_stream()
    key, drawn = stream._key, dict(stream._streams)
    amp_state = amp._saved_state()
    slices = rng.saved_slices()
    after = {}

    def run(*a):
        replay = rng.KeyStream(key)
        replay._streams = dict(drawn)
        with rng.use_stream(replay), amp._restored(amp_state), \
                rng.restored_slices(slices):
            out = fn(*a, **kwargs)
        after["streams"] = replay._streams
        return out

    out = torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)
    stream._streams = after["streams"]
    return out


def scan_layer_stack(layers, x, *, remat: bool = False, constraint=None,
                     rng_tag: str = "scan_stack", **call_kwargs):
    """Apply structurally identical ``layers`` to ``x`` in turn, as the
    JAX package's ``lax.scan`` over them does: one key
    ``next_key(rng_tag)`` drawn from the current stream, and layer ``i``
    run under ``key_guard(fold_in(key, i))``; with ``remat`` each layer
    is a :func:`checkpoint` (the saved state is the layer boundaries).
    ``constraint`` is applied to each layer's output; ``call_kwargs`` go
    to every layer. Blocks must hold no buffers and share one parameter
    structure, as the JAX package requires."""
    layers = list(layers)
    shapes = [[(n, tuple(p.shape)) for n, p in layer.named_parameters()]
              for layer in layers]
    for layer in layers:
        bufs = [n for n, _ in layer.named_buffers()]
        if bufs:
            raise NotImplementedError(
                f"scan_layer_stack requires buffer-free blocks; found "
                f"buffers {bufs}")
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            "scan_layer_stack requires structurally identical blocks")
    base = rng.current_stream().next_key(rng_tag)
    for i, layer in enumerate(layers):
        def body(h, layer=layer, key=threefry.fold_in(base, i)):
            with rng.key_guard(key):
                out = layer(h, **call_kwargs)
            return constraint(out) if constraint is not None else out
        x = checkpoint(body, x) if remat else body(x)
    return x


def scan_stacked_apply(template, stacked, x, *, remat: bool = False,
                       constraint=None, rng_tag: str = "scan_stack",
                       training=None, **call_kwargs):
    """Apply ``template`` with each leading-dim slice of ``stacked``
    (``{name: [L, ...]}`` parameters) in turn, as the JAX package's
    ``lax.scan`` does: layer ``i`` runs under ``key_guard(fold_in(
    next_key(rng_tag), i))`` through :func:`~paddle_tpu_torch.nn.layer.
    functional_call`; with ``remat`` each layer is a :func:`checkpoint`."""
    from .layer import functional_call

    n = next(iter(stacked.values())).shape[0]
    base = rng.current_stream().next_key(rng_tag)
    for i in range(n):
        def body(h, i=i, key=threefry.fold_in(base, i)):
            params_i = {k: v[i] for k, v in stacked.items()}
            with rng.key_guard(key):
                out, _ = functional_call(template, params_i, {}, h,
                                         training=training, **call_kwargs)
            return constraint(out) if constraint is not None else out
        x = checkpoint(body, x) if remat else body(x)
    return x
