"""Mixture of experts (the port's counterpart of
``paddle_tpu/nn/layers/moe.py``): the naive, GShard and Switch gates,
the stacked expert FFN and the capacity-bounded ``MoELayer``.

The routing is the JAX package's dense GShard algebra: top-k with
capacity ``max(ceil(s * top_k * f / e), 4)`` a group (a group is one
row of the batch), one-hot dispatch ``[g, s, e, c]`` and combine
tensors, and einsums. A token past its expert's capacity is dropped
(dispatched nowhere, its output zero). ``argmax`` ties take the first
expert, in both packages. The expert weights are stacked ``[e, d, f]``
parameters with the logical ``expert`` axis.

On a live ``ep`` mesh axis (``parallel.distributed_model``) ep rank r
holds experts ``[r e/ep, (r + 1) e/ep)`` as ``[e/ep, d, f]`` /
``[e/ep, f, d]`` tensors. The JAX rules do not split the rows over ep,
so every ep rank of a data slice holds the same tokens; GSPMD then
partitions the dispatch einsum by expert and gathers what the combine
einsum needs. A port rank does that by hand: it computes the gate, the
capacity, ``dispatch`` and ``combine`` as one process does (the same
rows and the same gate weights, so the same positions, drops and aux
loss, bit for bit), runs its own experts on its slice of ``dispatch``,
and gathers the experts' outputs over ep (``collective.gather_from_ep``)
before the combine, which every rank computes whole: the forward equals
one process's, and the combine's gradient (the gate's included) is
whole on every rank. Backward, a rank keeps its experts' slice of the
output gradient, and the input's gradient through the dispatch (its
experts' share) is summed over ep (``collective.copy_to_ep``); the aux
loss is counted once, on every rank alike.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from ... import amp
from .. import functional as F
from .. import initializer as I
from ..layer import Layer

# active aux-loss collectors (innermost last)
_AUX_STACK: list = []


@contextlib.contextmanager
def collect_aux_losses():
    """Collect the gates' auxiliary losses raised during a forward::

        with collect_aux_losses() as get_aux:
            out = model(x)
        loss = criterion(out, y) + get_aux()
    """
    bucket: list = []
    _AUX_STACK.append(bucket)
    try:
        yield lambda: (sum(bucket) if bucket
                       else torch.zeros((), dtype=torch.float32))
    finally:
        _AUX_STACK.pop()


class NaiveGate(Layer):
    """Top-k softmax gate without an auxiliary loss."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.weight = self.create_parameter(
            [d_model, num_experts], initializer=I.XavierUniform(),
            axes=("embed", None))

    def logits(self, x):
        """float32 logits (the JAX package's
        ``preferred_element_type``)."""
        return torch.einsum("gsd,de->gse", x.float(), self.weight.float())

    def forward(self, x):
        return self.logits(x), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


class GShardGate(NaiveGate):
    """Top-2 gate with GShard's load-balancing auxiliary loss."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 aux_loss_weight: float = 1e-2):
        super().__init__(d_model, num_experts, top_k=top_k)
        self.aux_loss_weight = aux_loss_weight

    def _load_balance_aux(self, probs):
        """fraction of tokens routed first to each expert times its mean
        probability, summed, times e^2 and the weight."""
        mask1 = F.one_hot(torch.argmax(probs, dim=-1), self.num_experts)
        density = mask1.mean(dim=1)
        density_proxy = probs.mean(dim=1)
        aux = (density * density_proxy).sum(-1).mean() * \
            (self.num_experts ** 2) * self.aux_loss_weight
        return aux.float()

    def forward(self, x):
        logits = self.logits(x)
        return logits, self._load_balance_aux(torch.softmax(logits, -1))


class SwitchGate(GShardGate):
    """Top-1 gate (Switch Transformer) with GShard's aux loss."""

    def __init__(self, d_model: int, num_experts: int,
                 aux_loss_weight: float = 1e-2):
        super().__init__(d_model, num_experts, top_k=1,
                         aux_loss_weight=aux_loss_weight)


class ExpertFFN(Layer):
    """Every expert's FFN as stacked weights ``[e, d, f]`` /
    ``[e, f, d]`` (on an ep mesh, this rank's experts: ``ep_params``
    are split over ep by ``parallel.reducer.MeshSync``)."""

    ep_params = ("w_in", "b_in", "w_out", "b_out")

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu"):
        super().__init__()
        self.w_in = self.create_parameter(
            [num_experts, d_model, d_hidden],
            initializer=I.XavierUniform(),
            axes=("expert", "embed", "mlp"))
        self.b_in = self.create_parameter(
            [num_experts, d_hidden], initializer=I.Constant(0.0),
            axes=("expert", "mlp"))
        self.w_out = self.create_parameter(
            [num_experts, d_hidden, d_model],
            initializer=I.XavierUniform(),
            axes=("expert", "mlp", "embed"))
        self.b_out = self.create_parameter(
            [num_experts, d_model], initializer=I.Constant(0.0),
            axes=("expert", "embed"))
        self.act = getattr(F, activation)

    def forward(self, x):  # x: [e, g, c, d] dispatched tokens
        x, w_in, w_out = amp.white_cast(x, self.w_in, self.w_out)
        h = torch.einsum("egcd,edf->egcf", x, w_in) + \
            self.b_in[:, None, None, :].to(x.dtype)
        h = self.act(h)
        return torch.einsum("egcf,efd->egcd", h, w_out) + \
            self.b_out[:, None, None, :].to(x.dtype)


class MoELayer(Layer):
    """Capacity-bounded top-k MoE FFN, ``[batch, seq, d]`` in and out.
    The last call's aux loss is ``aux_loss`` (or collected by
    :func:`collect_aux_losses`); ``forward_with_aux`` returns it."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 gate: str = "gshard", top_k: int = 2,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: Optional[float] = None,
                 activation: str = "gelu"):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = 1 if gate == "switch" else top_k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor or capacity_factor
        if gate == "naive":
            self.gate = NaiveGate(d_model, num_experts, top_k)
        elif gate == "gshard":
            self.gate = GShardGate(d_model, num_experts, top_k)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, num_experts)
        else:
            raise ValueError(f"unknown gate {gate!r}")
        self.experts = ExpertFFN(num_experts, d_model, d_hidden, activation)
        self._ep = None

    def attach_ep(self, ep) -> None:
        """Run on this ep rank's experts (``collective.EPGroup``); the
        experts' parameters are already its slice."""
        if self.num_experts % ep.size:
            raise ValueError(f"{self.num_experts} experts do not split "
                             f"over ep={ep.size}")
        self._ep = ep

    def _capacity(self, tokens_per_group: int) -> int:
        f = self.capacity_factor if self.training else \
            self.eval_capacity_factor
        cap = int(math.ceil(tokens_per_group * self.top_k * f /
                            self.num_experts))
        return max(cap, 4)

    def route(self, x):
        """``(dispatch [g, s, e, c], combine [g, s, e, c], aux)``: the
        iterative top-k assignment with capacity."""
        b, s, _ = x.shape
        logits, aux = self.gate(x)
        gates = torch.softmax(logits, dim=-1)
        c = self._capacity(s)
        e = self.num_experts
        dispatch = torch.zeros((b, s, e, c), dtype=x.dtype, device=x.device)
        combine = torch.zeros((b, s, e, c), dtype=torch.float32,
                              device=x.device)
        fill = torch.zeros((b, e), dtype=torch.int32, device=x.device)
        remaining = gates
        for _ in range(self.top_k):
            top_mask = F.one_hot(torch.argmax(remaining, dim=-1), e)
            gate_val = (gates * top_mask).sum(-1)
            # position of each token within its expert: running count
            pos_in_expert = (torch.cumsum(top_mask, dim=1) - top_mask) + \
                fill[:, None, :]
            pos = (pos_in_expert * top_mask).sum(-1).to(torch.int32)
            keep = pos < c
            pos_oh = F.one_hot(torch.where(keep, pos, c), c + 1,
                              x.dtype)[..., :c]
            contrib = top_mask[..., None] * pos_oh[:, :, None, :]
            dispatch = dispatch + contrib.to(x.dtype)
            combine = combine + contrib * torch.where(
                keep, gate_val, torch.zeros_like(gate_val))[:, :, None, None]
            fill = fill + top_mask.sum(dim=1).to(torch.int32)
            remaining = remaining * (1.0 - top_mask)
        return dispatch, combine, aux

    def forward_with_aux(self, x):
        b, s, d = x.shape
        dispatch, combine, aux = self.route(x)
        ep = self._ep
        if ep is None:
            expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x)
            expert_out = self.experts(expert_in)
        else:
            from ...parallel.collective import copy_to_ep, gather_from_ep
            n = self.num_experts // ep.size
            mine = dispatch[:, :, ep.index * n:(ep.index + 1) * n]
            expert_in = torch.einsum("gsec,gsd->egcd", mine,
                                     copy_to_ep(x, ep))
            expert_out = gather_from_ep(self.experts(expert_in), ep, 0)
        out = torch.einsum("gsec,egcd->gsd",
                           combine.to(expert_out.dtype), expert_out)
        return out.reshape(b, s, d), aux

    def forward(self, x):
        out, aux = self.forward_with_aux(x)
        if _AUX_STACK:
            _AUX_STACK[-1].append(aux)
        else:
            self.aux_loss = aux
        return out
