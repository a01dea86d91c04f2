"""Activation recomputation and gradient accumulation (the port's
counterpart of ``paddle_tpu/parallel/recompute.py``).

Recompute replaces the reference's PyLayer-based re-forward
(python/paddle/distributed/fleet/utils/recompute.py:350 ``recompute`` /
:207 ``RecomputeFunction`` — saves inputs and RNG state, re-runs the
forward inside the backward). Here it is
:func:`paddle_tpu_torch.nn.utils.checkpoint`, which recomputes through
``torch.utils.checkpoint`` and replays the forward's key stream and AMP
state, so dropout draws the same masks again and the loss and gradients
are those of the plain call.

Gradient merge replaces the reference's gradient_merge_optimizer
(fleet/meta_optimizers/gradient_merge_optimizer.py): an optimizer
wrapper that accumulates ``k_steps`` microbatch gradients in its state
(``{"inner", "acc", "count"}``, the JAX package's layout, so the
accumulators ride ``Model``'s checkpoint tree) and steps the wrapped
optimizer once every ``k_steps`` calls.
"""

from __future__ import annotations

import torch

from ..nn.layer import Layer
from ..nn.utils import checkpoint
from ..optimizer.optimizer import Optimizer


def recompute(function, *args, preserve_rng_state: bool = True, **kwargs):
    """Run ``function`` normally in the forward; re-run it in the
    backward instead of saving its activations (ref:
    fleet/utils/recompute.py:350). ``preserve_rng_state`` is accepted
    for API parity: the recompute always replays the forward's dropout
    keys."""
    del preserve_rng_state
    return checkpoint(function, *args, **kwargs)


class RecomputeSequential(Layer):
    """Sequential container whose segments are recomputed in the
    backward (``segments`` = number of checkpoint boundaries); the
    sublayers are ``body.0``, ``body.1``, ... as in the JAX package."""

    def __init__(self, *layers, segments: int = 1):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        self.body = torch.nn.Sequential(*layers)
        self.segments = max(1, segments)

    def forward(self, x):
        layers = list(self.body)
        n = len(layers)
        per = -(-n // self.segments)  # ceil: never more chunks than asked
        for i in range(0, n, per):
            chunk = layers[i:i + per]

            def run(v, chunk=chunk):
                for layer in chunk:
                    v = layer(v)
                return v
            x = checkpoint(run, x)
        return x


class GradientMerge:
    """Optimizer wrapper: step every ``k_steps`` calls, accumulating
    grads in between (ref: gradient_merge_optimizer.py). ``avg=True``
    divides the merged grad by k (the reference's default). The counter
    is a host int, as the optimizers' step counters are."""

    def __init__(self, inner: Optimizer, k_steps: int, avg: bool = True):
        self.inner = inner
        self.k_steps = int(k_steps)
        self.avg = avg
        # lr_fn/grad_clip etc. delegate to inner via __getattr__

    def __getattr__(self, name):
        if name == "inner":  # not yet set (unpickling) — avoid recursion
            raise AttributeError(name)
        return getattr(self.inner, name)

    def init_state(self, params):
        return {"inner": self.inner.init_state(params),
                "acc": {k: torch.zeros_like(p) for k, p in params.items()},
                "count": 0}

    @torch.no_grad()
    def apply_gradients(self, params, grads, state, step):
        names = list(state["acc"])
        acc = dict(zip(names, torch._foreach_add(
            [state["acc"][k] for k in names], [grads[k] for k in names])))
        count = state["count"] + 1
        # a device counter (the numeric guard armed) is read on the host
        if int(count) < self.k_steps:
            return params, {"inner": state["inner"], "acc": acc,
                            "count": count}
        count = count * 0   # 0 of the counter's own kind
        merged = acc
        if self.avg:
            merged = dict(zip(names, torch._foreach_div(
                list(acc.values()), self.k_steps)))
        # the LR schedule advances per merged step, not per microbatch
        new_params, inner = self.inner.apply_gradients(
            params, merged, state["inner"], step // self.k_steps)
        zeros = {k: torch.zeros_like(v) for k, v in acc.items()}
        return new_params, {"inner": inner, "acc": zeros, "count": count}

    # Model.train_batch's write-back, through the merge
    apply_in_place = Optimizer.apply_in_place
