"""Core layers (the port's counterpart of
``paddle_tpu/nn/layers/common.py``): Linear, Embedding, Dropout,
Flatten, Pad2D, Upsample and the activations as layers."""

from __future__ import annotations

from typing import Optional

import torch

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """y = xW + b with W stored ``[in_features, out_features]``, Paddle's
    layout (not torch's ``[out, in]``), so weights pass between the two
    packages untransposed. ``axes`` / ``bias_axes``: the logical
    sharding axes of W and b (``Layer.param_meta``)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, axes=None,
                 bias_axes=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        init_w = weight_attr if callable(weight_attr) else \
            (I.get_global_initializer() or I.XavierUniform())
        self.weight = self.create_parameter(
            [in_features, out_features], initializer=init_w)
        if bias_attr is False:
            self.bias = None
        else:
            init_b = bias_attr if callable(bias_attr) else \
                (I.get_global_bias_initializer() or I.Constant(0.0))
            self.bias = self.create_parameter([out_features],
                                              initializer=init_b)
            self.set_param_axes("bias", bias_axes)
        self.set_param_axes("weight", axes)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, weight_attr=None,
                 axes=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        init_w = weight_attr if callable(weight_attr) else I.Normal(0., 1.0)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], initializer=init_w)
        self.set_param_axes("weight", axes)

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(Layer):
    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Dropout2D(Layer):
    """Channel dropout (:func:`~paddle_tpu_torch.nn.functional.dropout2d`)."""

    def __init__(self, p: float = 0.5, data_format: str = "NCHW"):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Flatten(Layer):
    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis % x.dim(),
                             self.stop_axis % x.dim())


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Pad2D(Layer):
    def __init__(self, padding, mode: str = "constant", value: float = 0.0,
                 data_format: str = "NCHW"):
        super().__init__()
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, self.mode, self.value,
                     self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode: str = "nearest",
                 align_corners: bool = False, data_format: str = "NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.data_format)


def _act_layer(name, fn, **fixed):
    """A parameterless layer applying ``fn``: positional arguments map
    onto ``fn``'s parameters after ``x`` (``nn.CELU(0.2)``,
    ``nn.Hardtanh(-2, 2)``)."""
    import inspect
    try:
        arg_names = list(inspect.signature(fn).parameters)[1:]
    except (TypeError, ValueError):  # builtins without signatures
        arg_names = []

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = {**fixed, **dict(zip(arg_names, args)),
                            **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)
    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
GELU = _act_layer("GELU", F.gelu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Mish = _act_layer("Mish", F.mish)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
Softplus = _act_layer("Softplus", F.softplus)
Softsign = _act_layer("Softsign", F.softsign)
ELU = _act_layer("ELU", F.elu)
SELU = _act_layer("SELU", F.selu)


class LeakyReLU(Layer):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class Softmax(Layer):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters: int = 1, init: float = 0.25):
        super().__init__()
        self.weight = self.create_parameter(
            [num_parameters], initializer=I.Constant(init))

    def forward(self, x):
        w = self.weight
        if w.shape[0] > 1:
            w = w.reshape([1, -1] + [1] * (x.dim() - 2))
        return F.prelu(x, w)
