"""ASP — automatic structured (n:m) sparsity (the port's counterpart of
``paddle_tpu/incubate/asp.py``).

Reference being replaced: ``paddle.incubate.asp`` / ``static.sparsity``
(python/paddle/fluid/contrib/sparsity/asp.py — ``prune_model`` computes
n:m masks per supported weight, ``decorate`` wraps the optimizer so
masks are re-applied after each ``step``, keeping pruned weights at zero
through fine-tuning; utils.py ``create_mask``/``check_sparsity``).

The masks are the JAX package's: in every group of ``m`` consecutive
weights keep the ``n`` largest magnitudes (a stable sort, so ties keep
the later positions, as ``jnp.argsort`` does). Hopper's sparse tensor
cores take exactly this 2:4 pattern; the port's matmuls stay dense, so
ASP serves compression and sparsity-aware fine-tuning with the same API.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# registry of per-layer masks keyed by parameter path, mirroring the
# reference's ASPHelper.__asp_info masks map (sparsity/asp.py)
_masks: Dict[int, Dict[str, torch.Tensor]] = {}


def create_mask(w, n: int = 2, m: int = 4):
    """Boolean keep-mask with the n:m pattern: in every group of ``m``
    consecutive weights, keep the ``n`` largest by magnitude
    (ref: sparsity/utils.py create_mask, MaskAlgo_MASK_1D). Conv
    weights [O, I, kh, kw] are viewed as 2D [O, I*kh*kw] first. Returns
    ``None`` when the grouped axis does not divide by ``m``."""
    w = torch.as_tensor(w)
    if w.dim() < 1:
        return None
    view = w.reshape(w.shape[0], -1) if w.dim() > 2 else w
    if view.shape[-1] % m:
        return None
    flat = view.detach().abs().reshape(-1, m)
    keep_idx = torch.argsort(flat, dim=-1, stable=True)[:, m - n:]
    keep = torch.zeros(flat.shape, dtype=torch.bool, device=w.device)
    keep.scatter_(1, keep_idx, True)
    return keep.reshape(w.shape)


def check_sparsity(w, n: int = 2, m: int = 4) -> bool:
    """True iff every m-group has at most n non-zeros
    (ref: sparsity/utils.py check_sparsity)."""
    w = _numpy(w)
    view = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
    if view.shape[-1] % m:
        return False
    groups = view.reshape(-1, m)
    return bool(((groups != 0).sum(axis=-1) <= n).all())


def calculate_density(w) -> float:
    """ref: paddle.incubate.asp.calculate_density."""
    w = _numpy(w)
    return float((w != 0).sum() / w.size)


def _numpy(w):
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def _prunable(net) -> List[str]:
    """Weights ASP prunes: 2D+ matmul/conv weights, skipping norms,
    biases and embeddings (ref: ASPHelper._is_supported_layer)."""
    from ..nn.layers.common import Embedding
    emb = {id(l.weight) for l in net.modules() if isinstance(l, Embedding)}
    out = []
    for name, p in net.named_parameters():
        if p.dim() >= 2 and id(p) not in emb and \
                not name.endswith("bias"):
            out.append(name)
    return out


@torch.no_grad()
def _apply(net, masks) -> None:
    for name, mask in masks.items():
        w = net.get_parameter(name)
        w.copy_(torch.where(mask, w, torch.zeros_like(w)))


def prune_model(net, n: int = 2, m: int = 4,
                mask_algo: str = "mask_1d") -> Dict[str, torch.Tensor]:
    """Compute + apply n:m masks to every prunable weight in place;
    returns the masks (ref: paddle.incubate.asp.prune_model)."""
    if mask_algo not in ("mask_1d",):
        raise NotImplementedError(
            f"mask_algo={mask_algo!r}: only the 1D mask is implemented, "
            "as in the JAX package (the 2D permutation search buys "
            "accuracy for the sparse tensor cores' layout)")
    masks = {}
    for name in _prunable(net):
        mask = create_mask(net.get_parameter(name), n=n, m=m)
        if mask is None:  # grouped axis not divisible by m
            continue
        masks[name] = mask
    _apply(net, masks)
    _masks[id(net)] = masks
    return masks


def decorate(optimizer, net=None):
    """Wrap the optimizer so masks are re-applied after every update —
    pruned weights stay exactly zero through fine-tuning (ref:
    paddle.incubate.asp.decorate → OptimizerWithSparsityGuarantee).
    ``step`` re-masks the bound layer; ``apply_gradients`` (what
    ``Model``'s train step and ``apply_in_place`` call) masks the new
    parameters it returns."""
    net = net or optimizer._layer
    if net is None:
        raise ValueError("asp.decorate needs the optimizer bound to a "
                         "Layer (parameters=net) or an explicit net=")
    orig_step = optimizer.step
    orig_apply = optimizer.apply_gradients

    def step(grads=None):
        orig_step(grads)
        _apply(net, _masks.get(id(net), {}))

    def apply_gradients(params, grads, state, step_idx):
        new_params, new_state = orig_apply(params, grads, state, step_idx)
        masks = _masks.get(id(net), {})
        new_params = {
            name: (torch.where(masks[name].to(v.device), v,
                               torch.zeros_like(v))
                   if name in masks else v)
            for name, v in new_params.items()}
        return new_params, new_state

    optimizer.step = step
    optimizer.apply_gradients = apply_gradients
    return optimizer


def reset(net) -> None:
    _masks.pop(id(net), None)

