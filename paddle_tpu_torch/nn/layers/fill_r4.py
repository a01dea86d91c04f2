"""The rest of the layer classes (the port's counterpart of
``paddle_tpu/nn/layers/fill_r4.py``): thin layers over the functional
fills (``nn/functional_fill.py``), the transposed 1-D and 3-D
convolutions, instance norms, unpooling, ``ParameterList``, the
standalone ``SpectralNorm``, the loss classes, and beam-search decoding
(``BeamSearchDecoder`` with ``dynamic_decode``), under the JAX file's
names, arguments and parameter layouts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import threefry
from ...io import _tree_leaves, _tree_map
from .. import functional as F
from .. import initializer as I
from ..layer import Layer
from .conv import _ConvNd
from .rnn import RNNCellBase  # noqa: F401  (re-exported surface name)


# -- activations / shape ----------------------------------------------------

class LogSigmoid(Layer):
    def forward(self, x):
        return F.log_sigmoid(x)


class Silu(Layer):
    def forward(self, x):
        return F.silu(x)


class Softmax2D(Layer):
    """Softmax over the channel axis of NCHW inputs (ref:
    nn/layer/activation.py Softmax2D)."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects 3D/4D input")
        return torch.softmax(x, dim=-3)


class ChannelShuffle(Layer):
    """Interleave channel groups (ref: nn/layer/vision.py
    ChannelShuffle; ShuffleNet block primitive)."""

    def __init__(self, groups: int, data_format: str = "NCHW"):
        super().__init__()
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        if self.data_format == "NHWC":
            n, h, w, c = x.shape
            x = x.reshape(n, h, w, self.groups, c // self.groups)
            return x.transpose(3, 4).reshape(n, h, w, c)
        n, c, h, w = x.shape
        x = x.reshape(n, self.groups, c // self.groups, h, w)
        return x.transpose(1, 2).reshape(n, c, h, w)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


# -- conv transposes --------------------------------------------------------

class Conv1DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__()
        k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
        scale = 1.0 / math.sqrt(in_channels * k)
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups, k],
            initializer=I.Uniform(-scale, scale))
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], initializer=I.Uniform(-scale, scale))
        self.stride, self.padding = stride, padding
        self.output_padding, self.groups = output_padding, groups
        self.dilation, self.data_format = dilation, data_format

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
            output_size, self.data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size,
                         stride, padding, dilation, groups, weight_attr,
                         bias_attr, data_format, transposed=True)
        self.output_padding = output_padding

    def forward(self, x):
        return F.conv3d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups,
                                  self.data_format)


# -- norms / pooling --------------------------------------------------------

class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], initializer=I.Constant(0.0))

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size,
                                     self.return_mask)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
        super().__init__()
        self.kw = dict(kernel_size=kernel_size, stride=stride,
                       padding=padding, output_size=output_size,
                       data_format=data_format)

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, **self.kw)


class MaxUnPool2D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, **self.kw)


class MaxUnPool3D(MaxUnPool1D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format,
                         output_size)

    def forward(self, x, indices):
        return F.max_unpool3d(x, indices, **self.kw)


# -- containers / weight transforms -----------------------------------------

class ParameterList(Layer):
    """Indexable parameter container (ref: fluid/dygraph/layers
    ParameterList)."""

    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for p in parameters:
                self.append(p)

    def append(self, parameter):
        idx = len(self._parameters)
        from ..layer import Parameter
        if not isinstance(parameter, Parameter):
            parameter = Parameter(torch.as_tensor(parameter))
        self.add_parameter(str(idx), parameter)
        return self

    def __len__(self):
        return len(self._parameters)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __iter__(self):
        return iter(self._parameters.values())


class SpectralNorm(Layer):
    """Standalone spectral normalization layer: forward(weight) returns
    W / sigma_max(W) via power iteration (ref: nn/layer/norm.py
    SpectralNorm; the hook form lives in nn.utils.spectral_norm)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None):
        super().__init__()
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        # JAX's normal(PRNGKey(0)) / normal(PRNGKey(1)) draws (threefry)
        self.register_buffer("weight_u", threefry.normal(
            threefry.prng_key(0), (h,)))
        self.register_buffer("weight_v", threefry.normal(
            threefry.prng_key(1), (w,)))

    def forward(self, weight):
        w = weight
        mat = w.movedim(self.dim, 0).reshape(w.shape[self.dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = mat.T @ u
            v = v / (torch.linalg.norm(v) + self.eps)
            u = mat @ v
            u = u / (torch.linalg.norm(u) + self.eps)
        sigma = u @ mat @ v
        return w / sigma


# -- loss classes (wrap nn/functional_fill.py) ------------------------------

class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths,
                          label_lengths, self.blank, self.reduction,
                          norm_by_times)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label,
                                       self.margin, self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self.weight,
                                              self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.kw = dict(margin=margin, p=p, epsilon=epsilon, swap=swap,
                       reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative,
                                     **self.kw)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.kw = dict(distance_function=distance_function,
                       margin=margin, swap=swap, reduction=reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, **self.kw)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid classifier head (ref: nn/layer/loss.py
    HSigmoidLoss; default complete binary tree over num_classes)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self.num_classes = num_classes
        scale = 1.0 / math.sqrt(feature_size)
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size],
            initializer=I.Uniform(-scale, scale))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_classes - 1],
                                  initializer=I.Constant(0.0))

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self.num_classes,
                               self.weight, self.bias, path_table,
                               path_code)


# -- beam search decoding ---------------------------------------------------

class BeamSearchDecoder:
    """Beam-search wrapper over an RNN cell (ref: nn/layer/rnn.py
    BeamSearchDecoder). Drives
    ``cell(inputs, states) -> (output, new_states)``; ``embedding_fn``
    maps token ids to cell inputs; ``output_fn`` maps cell output to
    vocab logits (identity if the cell already emits logits)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn or (lambda ids: ids)
        self.output_fn = output_fn or (lambda x: x)

    def _tile(self, tree, batch):
        k = self.beam_size
        # [B, ...] -> [B * K, ...]
        return _tree_map(lambda x: torch.as_tensor(x).repeat_interleave(
            k, dim=0), tree)

    def _gather_beams(self, tree, parents, batch):
        k = self.beam_size
        base = torch.arange(batch, device=parents.device)[:, None] * k
        flat = (base + parents).reshape(-1)            # [B * K]
        return _tree_map(lambda x: x[flat], tree)


def _top_k(x, k):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def dynamic_decode(decoder, inits=None, max_step_num=64,
                   output_time_major=False, **kwargs):
    """Unrolled beam-search decode. Returns ``(predicted_ids [B, K, T]``
    (``[T, B, K]`` time-major), ``sequence_lengths [B, K])``."""
    cell_states = inits
    leaves = _tree_leaves(cell_states)
    if not leaves:
        raise ValueError(
            "dynamic_decode needs the cell's initial states: "
            "dynamic_decode(decoder, inits=cell.get_initial_states(B))")
    first = leaves[0]
    batch = first.shape[0]
    dev = first.device
    k = decoder.beam_size
    neg_inf = -1e30

    cell_states = decoder._tile(cell_states, batch)
    tokens = torch.full((batch, k), decoder.start_token, dtype=torch.int32,
                        device=dev)
    # beam 0 alive, the others dead at t = 0, so that beams differ
    log_probs = torch.tensor([[0.0] + [neg_inf] * (k - 1)],
                             device=dev).repeat(batch, 1)
    finished = torch.zeros((batch, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((batch, k), dtype=torch.int32, device=dev)
    step_ids, step_parents = [], []

    for _ in range(max_step_num):
        inp = decoder.embedding_fn(tokens.reshape(-1))
        out, cell_states = decoder.cell(inp, cell_states)
        logits = decoder.output_fn(out)
        v = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), -1).reshape(batch, k, v)
        # finished beams only extend with end_token, at no cost
        fin_mask = torch.full((v,), neg_inf, device=dev)
        fin_mask[decoder.end_token] = 0.0
        logp = torch.where(finished[..., None], fin_mask, logp)
        total = log_probs[..., None] + logp                # [B, K, V]
        log_probs, idx = _top_k(total.reshape(batch, k * v), k)
        parents = torch.div(idx, v, rounding_mode="floor")
        tokens = (idx % v).to(torch.int32)
        was_fin = torch.gather(finished, 1, parents)
        finished = was_fin | (tokens == decoder.end_token)
        lengths = torch.gather(lengths, 1, parents) + \
            (~was_fin).to(torch.int32)
        cell_states = decoder._gather_beams(cell_states, parents, batch)
        step_ids.append(tokens)
        step_parents.append(parents)
        if bool(finished.all()):
            break

    ids = torch.stack(step_ids)                      # [T, B, K]
    parents = torch.stack(step_parents)
    aligned = F.gather_tree(ids, parents)            # [T, B, K]
    if not output_time_major:
        aligned = aligned.permute(1, 2, 0)           # [B, K, T]
    return aligned, lengths
