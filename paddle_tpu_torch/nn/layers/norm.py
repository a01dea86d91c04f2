"""LayerNorm and RMSNorm (the port's counterpart of
``paddle_tpu/nn/layers/norm.py``)."""

from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
        else:
            init_w = weight_attr if callable(weight_attr) else I.Constant(1.)
            self.weight = self.create_parameter(list(self.normalized_shape),
                                                initializer=init_w)
        if bias_attr is False:
            self.bias = None
        else:
            init_b = bias_attr if callable(bias_attr) else I.Constant(0.)
            self.bias = self.create_parameter(list(self.normalized_shape),
                                              initializer=init_b)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)


class RMSNorm(Layer):
    def __init__(self, hidden_size: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter([hidden_size],
                                            initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)
