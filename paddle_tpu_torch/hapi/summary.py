"""Model summary and FLOPs (the port's counterpart of
``paddle_tpu/hapi/summary.py``): the per-layer table and parameter
counts of ``paddle.summary`` and the analytic count of ``paddle.flops``.

The JAX package traces its probe forward under ``jax.eval_shape``; here
one forward of zeros at ``input_size`` runs under ``torch.no_grad`` on
the network's device, and forward hooks on the leaf layers record each
output shape. ``flops`` counts over the same probe, layer by layer, as
the JAX package's does (conv, Linear and the norms; batch included), so
both return the same integer for the same network and ``input_size``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
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


# -- FLOP counters (ref: hapi/dynamic_flops.py register_hooks table) -------

def _conv_flops(layer, in_shape, out_shape) -> float:
    """Any conv rank: 2 * N * prod(spatial_out) * Cout * Cin *
    prod(kernel) / groups (NC... layout)."""
    k = layer.kernel_size
    k = k if isinstance(k, (tuple, list)) else (k,)
    n, cout = out_shape[0], out_shape[1]
    spatial = out_shape[2:]
    return 2.0 * n * float(np.prod(spatial)) * cout * \
        layer.in_channels * float(np.prod(k)) / layer.groups


def _linear_flops(layer, in_shape, out_shape) -> float:
    return 2.0 * float(np.prod(in_shape[:-1])) * layer.in_features * \
        layer.out_features


def flops(net: torch.nn.Module, input_size, dtypes=None,
          print_detail: bool = False) -> int:
    """ref: paddle.flops(net, input_size) — analytic multiply-add count
    over conv/linear/norm layers (one fwd pass, batch included)."""
    from ..nn.layers import norm as norm_mod
    from ..nn.layers.common import Linear
    from ..nn.layers.conv import _ConvNd

    total = 0.0
    for r in _probe(net, input_size, dtypes):
        layer = r["layer"]
        out0 = r["out_shapes"][0] if r["out_shapes"] else ()
        f = 0.0
        if isinstance(layer, _ConvNd) and len(out0) >= 3:
            f = _conv_flops(layer, r["in_shape"], out0)
        elif isinstance(layer, Linear):
            f = _linear_flops(layer, r["in_shape"], out0)
        elif isinstance(layer, (norm_mod._BatchNormBase,
                                norm_mod.LayerNorm, norm_mod.RMSNorm,
                                norm_mod.GroupNorm,
                                norm_mod.InstanceNorm2D)):
            f = 2.0 * float(np.prod(out0)) if out0 else 0.0
        if print_detail and f:
            print(f"{r['name']:<40}{f / 1e6:>12.2f} MFLOPs")
        total += f
    if print_detail:
        print(f"Total FLOPs: {total / 1e9:.3f} GFLOPs")
    return int(total)
