"""Linear, Embedding and Dropout (the port's counterpart of
``paddle_tpu/nn/layers/common.py``)."""

from __future__ import annotations

from typing import Optional

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class Linear(Layer):
    """y = xW + b with W stored ``[in_features, out_features]``, Paddle's
    layout (not torch's ``[out, in]``), so weights pass between the two
    packages untransposed."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        init_w = weight_attr if callable(weight_attr) else I.XavierUniform()
        self.weight = self.create_parameter(
            [in_features, out_features], initializer=init_w)
        if bias_attr is False:
            self.bias = None
        else:
            init_b = bias_attr if callable(bias_attr) else I.Constant(0.0)
            self.bias = self.create_parameter([out_features],
                                              initializer=init_b)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(Layer):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: Optional[int] = None, weight_attr=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        init_w = weight_attr if callable(weight_attr) else I.Normal(0., 1.0)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], initializer=init_w)

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(Layer):
    def __init__(self, p: float = 0.5, mode: str = "upscale_in_train"):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)
