"""Convolution layers (the port's counterpart of
``paddle_tpu/nn/layers/conv.py``): Conv1D/2D/3D and Conv2DTranspose.
The weight is ``[out, in / groups, *k]`` (transposed: ``[in, out /
groups, *k]``), the JAX package's layout and torch's, so weights pass
between the packages untransposed."""

from __future__ import annotations

from typing import Optional

from .. import functional as F
from .. import initializer as I
from ..layer import Layer


class _ConvNd(Layer):
    def __init__(self, ndim, in_channels, out_channels, kernel_size,
                 stride=1, padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transposed=False):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        k = F._norm_tuple(kernel_size, ndim)
        self.kernel_size = k
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        self.data_format = data_format
        fan_in = in_channels // groups
        for ki in k:
            fan_in *= ki
        init_w = weight_attr if callable(weight_attr) else \
            (I.get_global_initializer() or I.KaimingUniform(fan_in=fan_in))
        if transposed:
            wshape = [in_channels, out_channels // groups, *k]
        else:
            wshape = [out_channels, in_channels // groups, *k]
        self.weight = self.create_parameter(wshape, initializer=init_w)
        if bias_attr is False:
            self.bias = None
        else:
            init_b = bias_attr if callable(bias_attr) else \
                (I.get_global_bias_initializer() or I.Constant(0.0))
            self.bias = self.create_parameter([out_channels],
                                              initializer=init_b)


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups,
                        self.data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, weight_attr, bias_attr,
                         data_format, transposed=True)
        self.output_padding = output_padding

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding,
                                  self.dilation, self.groups,
                                  self.data_format)
