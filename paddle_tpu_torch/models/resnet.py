"""ResNet family (the port's counterpart of
``paddle_tpu/models/resnet.py``): BasicBlock / BottleneckBlock,
resnet18-152, ResNeXt and wide ResNet.

NCHW, with the JAX package's module tree and parameter names, so a JAX
state dict loads by identical key; BatchNorm keeps its running
statistics in the buffers ``_mean`` and ``_variance``. Convolutions are
cuDNN's through ``F.conv2d`` (the JAX package's are
``lax.conv_general_dilated``, outside any Pallas kernel)."""

from __future__ import annotations

from typing import Type, Union

from .. import nn
from ..core.device import resolve_device


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=nn.BatchNorm2D, groups=1, base_width=64):
        super().__init__()
        if groups != 1 or base_width != 64:
            raise ValueError(
                "BasicBlock only supports groups=1, base_width=64 "
                "(ref: vision/models/resnet.py BasicBlock)")
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride,
                               padding=1, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1,
                               bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 norm_layer=nn.BatchNorm2D, groups=1, base_width=64):
        super().__init__()
        # grouped/widened bottleneck (ResNeXt / WideResNet; ref:
        # vision/models/resnet.py BottleneckBlock width arithmetic)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=1, groups=groups, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    """ref: vision/models/resnet.py ResNet(Block, depth, num_classes,
    with_pool). Parameters are drawn on the CPU and moved to ``device``,
    the GPU unless the caller passes ``device="cpu"``."""

    def __init__(self, block: Type[Union[BasicBlock, BottleneckBlock]],
                 depth: int = 50, num_classes: int = 1000,
                 with_pool: bool = True, groups: int = 1,
                 width_per_group: int = 64, device=None):
        super().__init__()
        self.groups = groups
        self.base_width = width_per_group
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3],
                     50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
                     152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False)
        self.bn1 = nn.BatchNorm2D(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        self.to(resolve_device(device))

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False),
                nn.BatchNorm2D(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample,
                        groups=self.groups, base_width=self.base_width)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes,
                                groups=self.groups,
                                base_width=self.base_width))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.fc(x)
        return x


def _resnet(block, depth, **kwargs):
    return ResNet(block, depth, **kwargs)


def resnet18(**kwargs):
    return _resnet(BasicBlock, 18, **kwargs)


def resnet34(**kwargs):
    return _resnet(BasicBlock, 34, **kwargs)


def resnet50(**kwargs):
    return _resnet(BottleneckBlock, 50, **kwargs)


def resnet101(**kwargs):
    return _resnet(BottleneckBlock, 101, **kwargs)


def resnet152(**kwargs):
    return _resnet(BottleneckBlock, 152, **kwargs)


# ResNeXt / WideResNet variants (ref: vision/models/resnet.py
# resnext50_32x4d ... wide_resnet101_2 — same trunk, grouped/widened
# bottlenecks)

def resnext50_32x4d(**kw):
    return _resnet(BottleneckBlock, 50, groups=32, width_per_group=4, **kw)


def resnext50_64x4d(**kw):
    return _resnet(BottleneckBlock, 50, groups=64, width_per_group=4, **kw)


def resnext101_32x4d(**kw):
    return _resnet(BottleneckBlock, 101, groups=32, width_per_group=4,
                   **kw)


def resnext101_64x4d(**kw):
    return _resnet(BottleneckBlock, 101, groups=64, width_per_group=4,
                   **kw)


def resnext152_32x4d(**kw):
    return _resnet(BottleneckBlock, 152, groups=32, width_per_group=4,
                   **kw)


def resnext152_64x4d(**kw):
    return _resnet(BottleneckBlock, 152, groups=64, width_per_group=4,
                   **kw)


def wide_resnet50_2(**kw):
    return _resnet(BottleneckBlock, 50, width_per_group=128, **kw)


def wide_resnet101_2(**kw):
    return _resnet(BottleneckBlock, 101, width_per_group=128, **kw)
