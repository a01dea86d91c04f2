"""Depth-loop utilities of ``paddle_tpu/nn/utils.py``: the scan over a
stack of identical blocks (``scan_layer_stack``) and the
rematerialized call it and ``GPTConfig(remat=True)`` use
(:func:`checkpoint`).

The JAX package stacks the blocks' parameters to ``[L, ...]`` and runs
one ``lax.scan``; eager PyTorch gains nothing from one lowering, so the
port loops over the blocks' own parameters (state-dict names stay the
same) and keeps what the scan changes in the numbers: each layer's
dropout keys come from ``fold_in(next_key(rng_tag), i)``, not from the
ambient stream in sequence. The rest of the JAX module (weight and
spectral norm, ``parameters_to_vector``) is ROADMAP A7.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from .. import amp
from ..core import rng, threefry


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
