"""Model summary (the port's counterpart of
``paddle_tpu/hapi/summary.py``): the per-layer table and parameter
counts of ``paddle.summary``.

The JAX package traces its probe forward under ``jax.eval_shape``; here
one forward of zeros at ``input_size`` runs under ``torch.no_grad`` on
the network's device, and forward hooks on the leaf layers record each
output shape. ``flops`` reads XLA's cost analysis in the JAX package and
waits here for the port's ``cost_model`` (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _leaf_layers(net: torch.nn.Module):
    for name, sub in net.named_modules():
        if not any(True for _ in sub.children()):  # leaves only
            yield name or type(net).__name__, sub


def _param_count(layer: torch.nn.Module) -> Tuple[int, int]:
    total = trainable = 0
    for p in layer.parameters():
        n = p.numel()
        total += n
        if p.requires_grad:
            trainable += n
    return total, trainable


def _shapes(out) -> List[tuple]:
    if isinstance(out, torch.Tensor):
        return [tuple(out.shape)]
    if isinstance(out, (tuple, list)):
        return [s for o in out for s in _shapes(o)]
    if isinstance(out, dict):
        return [s for o in out.values() for s in _shapes(o)]
    return []


def _probe(net: torch.nn.Module, input_size, dtypes=None):
    """One forward of zeros, recording per-layer output shapes by
    forward hooks."""
    if isinstance(input_size, tuple) and input_size and \
            not isinstance(input_size[0], (tuple, list)):
        input_size = [tuple(input_size)]
    dtypes = dtypes or ["float32"] * len(input_size)
    records: List[dict] = []
    hooks = []
    for name, sub in _leaf_layers(net):
        def post(layer, args, out, _name=name):
            records.append({
                "name": _name, "layer": layer,
                "in_shape": tuple(args[0].shape) if args and isinstance(
                    args[0], torch.Tensor) else (),
                "out_shapes": _shapes(out)})
        hooks.append(sub.register_forward_hook(post))
    training = net.training
    dev = next(net.parameters()).device
    try:
        net.eval()
        xs = [torch.zeros(tuple(s), dtype=getattr(torch, str(d)),
                          device=dev)
              for s, d in zip(input_size, dtypes)]
        with torch.no_grad():
            net(*xs)
    finally:
        if training:
            net.train()
        for h in hooks:
            h.remove()
    return records


def summary(net: torch.nn.Module, input_size=None, dtypes=None,
            print_table: bool = True) -> Dict[str, int]:
    """Prints the layer table (with ``input_size``) and the parameter
    counts; returns {'total_params', 'trainable_params'}."""
    total, trainable = _param_count(net)
    rows = []
    if input_size is not None:
        for r in _probe(net, input_size, dtypes):
            p, _ = _param_count(r["layer"])
            shapes = r["out_shapes"]
            rows.append((r["name"], type(r["layer"]).__name__,
                         str(shapes[0] if len(shapes) == 1 else shapes),
                         p))
    if print_table:
        if rows:
            w = max(len(r[0]) for r in rows) + 2
            print(f"{'Layer':<{w}}{'Type':<24}{'Output Shape':<28}"
                  f"{'Params':>12}")
            print("-" * (w + 64))
            for name, typ, shape, p in rows:
                print(f"{name:<{w}}{typ:<24}{shape:<28}{p:>12,}")
            print("-" * (w + 64))
        print(f"Total params: {total:,}")
        print(f"Trainable params: {trainable:,}")
        print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}


def flops(net: torch.nn.Module, input_size, dtypes=None,
          print_detail: bool = False) -> int:
    """Not ported yet: the JAX package reads XLA's cost analysis."""
    raise NotImplementedError(
        "hapi.summary.flops is not ported yet (ROADMAP A7: cost_model)")
