"""Normalization layers (the port's counterpart of
``paddle_tpu/nn/layers/norm.py``): BatchNorm1D/2D/3D, SyncBatchNorm,
LayerNorm, RMSNorm, GroupNorm and InstanceNorm2D.

BatchNorm keeps its running statistics in the buffers ``_mean`` and
``_variance`` with Paddle's momentum (``running = m * running + (1 - m)
* batch``, m = 0.9). Under a JAX mesh every BatchNorm normalises over
the GLOBAL batch, because GSPMD shards the rows and reduces for it; a
port rank holds only its rows, so inside a ``Model``'s step on a
``dp`` / ``fsdp`` mesh (``parallel.collective.data_rows``) every
BatchNorm, plain or Sync, sums the per-channel count, sum and centred
sum of squares over the data ranks before it normalises, and the
gradient flows back through the same sums. Every rank then holds the
running statistics of one process over the whole batch.
"""

from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW", use_global_stats: bool = False):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            init_w = weight_attr if callable(weight_attr) else I.Constant(1.)
            init_b = bias_attr if callable(bias_attr) else I.Constant(0.)
            self.weight = self.create_parameter([num_features],
                                                initializer=init_w)
            self.bias = self.create_parameter([num_features],
                                              initializer=init_b)
        self.register_buffer("_mean", torch.zeros(num_features))
        self.register_buffer("_variance", torch.ones(num_features))

    def forward(self, x):
        from ...parallel.collective import data_rows_group
        training = self.training and not self.use_global_stats
        y, new_mean, new_var = F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=training, momentum=self.momentum, epsilon=self.epsilon,
            data_format=self.data_format,
            group=data_rows_group() if training else None)
        if training:
            with torch.no_grad():
                self._mean.copy_(new_mean)
                self._variance.copy_(new_var)
        return y


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


BatchNorm = BatchNorm2D  # legacy alias (fluid.dygraph.BatchNorm)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm over the global batch; in the port every BatchNorm
    reduces over the data ranks (module docstring), as every BatchNorm
    does under the JAX package's GSPMD."""

    @classmethod
    def convert_sync_batchnorm(cls, layer: Layer) -> Layer:
        for name, sub in list(layer.named_children()):
            if isinstance(sub, _BatchNormBase) and \
                    not isinstance(sub, SyncBatchNorm):
                new = SyncBatchNorm(sub.num_features, sub.momentum,
                                    sub.epsilon,
                                    weight_attr=None if sub.weight is not None
                                    else False,
                                    data_format=sub.data_format)
                new.load_state_dict(sub.state_dict())
                setattr(layer, name, new)
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


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


class GroupNorm(Layer):
    def __init__(self, num_groups: int, num_channels: int,
                 epsilon: float = 1e-5, weight_attr=None, bias_attr=None,
                 data_format: str = "NCHW"):
        super().__init__()
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_channels], initializer=I.Constant(1.))
        self.bias = None if bias_attr is False else \
            self.create_parameter([num_channels], initializer=I.Constant(0.))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class InstanceNorm2D(Layer):
    def __init__(self, num_features: int, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.epsilon = epsilon
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                [num_features], initializer=I.Constant(0.0))

    def forward(self, x):
        return F.instance_norm(x, self.weight, self.bias, self.epsilon)
