"""Additional vision families (the port's counterpart of
``paddle_tpu/models/vision_extra.py``): AlexNet, SqueezeNet, DenseNet,
GoogLeNet, ShuffleNetV2, InceptionV3 (ref: python/paddle/vision/models/
{alexnet,squeezenet,densenet,googlenet,shufflenetv2,inceptionv3}.py —
same topologies, same constructor surface, the JAX package's parameter
names). Every top-level model draws its parameters on the CPU and moves
them to ``device``, the GPU unless the caller passes ``device="cpu"``."""

from __future__ import annotations

import torch

from .. import nn
from ..core.device import resolve_device
from ..nn import functional as F


# ---------------------------------------------------------------------------
# AlexNet (ref: vision/models/alexnet.py)
# ---------------------------------------------------------------------------

class AlexNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, device=None):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes),
        )
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


def alexnet(**kw):
    return AlexNet(**kw)


# ---------------------------------------------------------------------------
# SqueezeNet (ref: vision/models/squeezenet.py)
# ---------------------------------------------------------------------------

class Fire(nn.Layer):
    def __init__(self, in_ch, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(in_ch, squeeze, 1)
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        s = self.relu(self.squeeze(x))
        return torch.cat(
            [self.relu(self.expand1(s)), self.relu(self.expand3(s))],
            dim=1)


class SqueezeNet(nn.Layer):
    """version '1.0'/'1.1' (ref: squeezenet.py SqueezeNet)."""

    def __init__(self, version: str = "1.1", num_classes: int = 1000,
                 device=None):
        super().__init__()
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128), nn.MaxPool2D(3, stride=2),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2), Fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        else:
            raise ValueError(f"unknown version {version!r}")
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Conv2D(512, num_classes, 1), nn.ReLU(),
            nn.AdaptiveAvgPool2D(1))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.classifier(self.features(x))
        return x.reshape(x.shape[0], -1)


def squeezenet1_0(**kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet("1.1", **kw)


# ---------------------------------------------------------------------------
# DenseNet (ref: vision/models/densenet.py)
# ---------------------------------------------------------------------------

class _DenseLayer(nn.Layer):
    def __init__(self, in_ch, growth, bn_size):
        super().__init__()
        self.bn1 = nn.BatchNorm2D(in_ch)
        self.conv1 = nn.Conv2D(in_ch, bn_size * growth, 1,
                               bias_attr=False)
        self.bn2 = nn.BatchNorm2D(bn_size * growth)
        self.conv2 = nn.Conv2D(bn_size * growth, growth, 3, padding=1,
                               bias_attr=False)
        self.relu = nn.ReLU()

    def forward(self, x):
        y = self.conv1(self.relu(self.bn1(x)))
        y = self.conv2(self.relu(self.bn2(y)))
        return torch.cat([x, y], dim=1)


class _Transition(nn.Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = nn.BatchNorm2D(in_ch)
        self.conv = nn.Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.relu = nn.ReLU()
        self.pool = nn.AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(nn.Layer):
    """ref: densenet.py DenseNet(layers=121/161/169/201/264).
    Per-config (block layout, growth rate, stem channels) — 161 is the
    wide variant (growth 48, 96-channel stem)."""

    CONFIGS = {121: ((6, 12, 24, 16), 32, 64),
               161: ((6, 12, 36, 24), 48, 96),
               169: ((6, 12, 32, 32), 32, 64),
               201: ((6, 12, 48, 32), 32, 64),
               264: ((6, 12, 64, 48), 32, 64)}

    def __init__(self, layers: int = 121, growth_rate: int = None,
                 bn_size: int = 4, num_classes: int = 1000,
                 device=None):
        super().__init__()
        if layers not in self.CONFIGS:
            raise ValueError(
                f"DenseNet layers must be one of "
                f"{sorted(self.CONFIGS)}, got {layers}")
        block_cfg, default_growth, ch = self.CONFIGS[layers]
        growth_rate = growth_rate or default_growth
        feats = [nn.Conv2D(3, ch, 7, stride=2, padding=3,
                           bias_attr=False),
                 nn.BatchNorm2D(ch), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        for bi, n in enumerate(block_cfg):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth_rate, bn_size))
                ch += growth_rate
            if bi != len(block_cfg) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch //= 2
        feats += [nn.BatchNorm2D(ch), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(ch, num_classes)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.avgpool(self.features(x))
        return self.classifier(x.reshape(x.shape[0], -1))


def densenet121(**kw):
    return DenseNet(121, **kw)


def densenet161(**kw):
    return DenseNet(161, **kw)


def densenet169(**kw):
    return DenseNet(169, **kw)


def densenet201(**kw):
    return DenseNet(201, **kw)


def densenet264(**kw):
    return DenseNet(264, **kw)


# ---------------------------------------------------------------------------
# GoogLeNet / Inception v1 (ref: vision/models/googlenet.py)
# ---------------------------------------------------------------------------

class Inception(nn.Layer):
    def __init__(self, in_ch, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(in_ch, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(in_ch, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1),
                                nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(in_ch, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2),
                                nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(in_ch, pp, 1), nn.ReLU())

    def forward(self, x):
        return torch.cat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], dim=1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes: int = 1000, device=None):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
        self.blocks = nn.Sequential(
            Inception(192, 64, 96, 128, 16, 32, 32),
            Inception(256, 128, 128, 192, 32, 96, 64),
            nn.MaxPool2D(3, stride=2, padding=1),
            Inception(480, 192, 96, 208, 16, 48, 64),
            Inception(512, 160, 112, 224, 24, 64, 64),
            Inception(512, 128, 128, 256, 24, 64, 64),
            Inception(512, 112, 144, 288, 32, 64, 64),
            Inception(528, 256, 160, 320, 32, 128, 128),
            nn.MaxPool2D(3, stride=2, padding=1),
            Inception(832, 256, 160, 320, 32, 128, 128),
            Inception(832, 384, 192, 384, 48, 128, 128))
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.dropout = nn.Dropout(0.2)
        self.fc = nn.Linear(1024, num_classes)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.avgpool(self.blocks(self.stem(x)))
        return self.fc(self.dropout(x.reshape(x.shape[0], -1)))


def googlenet(**kw):
    return GoogLeNet(**kw)


# ---------------------------------------------------------------------------
# ShuffleNetV2 (ref: vision/models/shufflenetv2.py)
# ---------------------------------------------------------------------------

def channel_shuffle(x, groups: int):
    b, c, h, w = x.shape
    x = x.reshape(b, groups, c // groups, h, w)
    x = x.permute(0, 2, 1, 3, 4)
    return x.reshape(b, c, h, w)


class _ShuffleUnit(nn.Layer):
    def __init__(self, in_ch, out_ch, stride, act: str = "relu"):
        super().__init__()
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        self.stride = stride
        branch_ch = out_ch // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                          groups=in_ch, bias_attr=False),
                nn.BatchNorm2D(in_ch),
                nn.Conv2D(in_ch, branch_ch, 1, bias_attr=False),
                nn.BatchNorm2D(branch_ch), act_layer())
            b2_in = in_ch
        else:
            self.branch1 = None
            b2_in = in_ch // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch_ch, 1, bias_attr=False),
            nn.BatchNorm2D(branch_ch), act_layer(),
            nn.Conv2D(branch_ch, branch_ch, 3, stride=stride, padding=1,
                      groups=branch_ch, bias_attr=False),
            nn.BatchNorm2D(branch_ch),
            nn.Conv2D(branch_ch, branch_ch, 1, bias_attr=False),
            nn.BatchNorm2D(branch_ch), act_layer())

    def forward(self, x):
        if self.stride == 1:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)],
                                  dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    # ref: shufflenetv2.py stage_out_channels per scale (x0_25 ... x2_0)
    SCALES = {0.25: (24, 48, 96, 512), 0.33: (32, 64, 128, 512),
              0.5: (48, 96, 192, 1024), 1.0: (116, 232, 464, 1024),
              1.5: (176, 352, 704, 1024), 2.0: (244, 488, 976, 2048)}

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 act: str = "relu", device=None):
        super().__init__()
        c2, c3, c4, c5 = self.SCALES[scale]
        act_layer = nn.Swish if act == "swish" else nn.ReLU
        self.stem = nn.Sequential(
            nn.Conv2D(3, 24, 3, stride=2, padding=1, bias_attr=False),
            nn.BatchNorm2D(24), act_layer(),
            nn.MaxPool2D(3, stride=2, padding=1))
        stages = []
        in_ch = 24
        for out_ch, repeat in ((c2, 4), (c3, 8), (c4, 4)):
            stages.append(_ShuffleUnit(in_ch, out_ch, 2, act=act))
            for _ in range(repeat - 1):
                stages.append(_ShuffleUnit(out_ch, out_ch, 1, act=act))
            in_ch = out_ch
        self.stages = nn.Sequential(*stages)
        self.head = nn.Sequential(
            nn.Conv2D(in_ch, c5, 1, bias_attr=False),
            nn.BatchNorm2D(c5), act_layer(), nn.AdaptiveAvgPool2D(1))
        self.fc = nn.Linear(c5, num_classes)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.head(self.stages(self.stem(x)))
        return self.fc(x.reshape(x.shape[0], -1))


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_33(**kw):
    return ShuffleNetV2(0.33, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(2.0, **kw)


def shufflenet_v2_swish(**kw):
    return ShuffleNetV2(1.0, act="swish", **kw)


# ---------------------------------------------------------------------------
# InceptionV3 (ref: vision/models/inceptionv3.py — factorized
# convolutions, 299x299 input, 2048-d head)
# ---------------------------------------------------------------------------

class _BasicConv2d(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_features):
        super().__init__()
        self.b1 = _BasicConv2d(in_c, 64, 1)
        self.b5 = nn.Sequential(_BasicConv2d(in_c, 48, 1),
                                _BasicConv2d(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_BasicConv2d(in_c, 64, 1),
                                _BasicConv2d(64, 96, 3, padding=1),
                                _BasicConv2d(96, 96, 3, padding=1))
        self.pool_proj = _BasicConv2d(in_c, pool_features, 1)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)

    def forward(self, x):
        return torch.cat(
            [self.b1(x), self.b5(x), self.b3(x),
             self.pool_proj(self.pool(x))], dim=1)


class _InceptionB(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = _BasicConv2d(in_c, 384, 3, stride=2)
        self.b3dbl = nn.Sequential(_BasicConv2d(in_c, 64, 1),
                                   _BasicConv2d(64, 96, 3, padding=1),
                                   _BasicConv2d(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat(
            [self.b3(x), self.b3dbl(x), self.pool(x)], dim=1)


class _InceptionC(nn.Layer):
    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _BasicConv2d(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _BasicConv2d(in_c, c7, 1),
            _BasicConv2d(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv2d(c7, 192, (7, 1), padding=(3, 0)))
        self.b7dbl = nn.Sequential(
            _BasicConv2d(in_c, c7, 1),
            _BasicConv2d(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv2d(c7, c7, (1, 7), padding=(0, 3)),
            _BasicConv2d(c7, c7, (7, 1), padding=(3, 0)),
            _BasicConv2d(c7, 192, (1, 7), padding=(0, 3)))
        self.pool_proj = _BasicConv2d(in_c, 192, 1)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)

    def forward(self, x):
        return torch.cat(
            [self.b1(x), self.b7(x), self.b7dbl(x),
             self.pool_proj(self.pool(x))], dim=1)


class _InceptionD(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_BasicConv2d(in_c, 192, 1),
                                _BasicConv2d(192, 320, 3, stride=2))
        self.b7x3 = nn.Sequential(
            _BasicConv2d(in_c, 192, 1),
            _BasicConv2d(192, 192, (1, 7), padding=(0, 3)),
            _BasicConv2d(192, 192, (7, 1), padding=(3, 0)),
            _BasicConv2d(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat(
            [self.b3(x), self.b7x3(x), self.pool(x)], dim=1)


class _InceptionE(nn.Layer):
    def __init__(self, in_c):
        super().__init__()
        self.b1 = _BasicConv2d(in_c, 320, 1)
        self.b3_stem = _BasicConv2d(in_c, 384, 1)
        self.b3_a = _BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.b3dbl_stem = nn.Sequential(
            _BasicConv2d(in_c, 448, 1),
            _BasicConv2d(448, 384, 3, padding=1))
        self.b3dbl_a = _BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.b3dbl_b = _BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.pool_proj = _BasicConv2d(in_c, 192, 1)
        self.pool = nn.AvgPool2D(3, stride=1, padding=1)

    def forward(self, x):
        s = self.b3_stem(x)
        d = self.b3dbl_stem(x)
        return torch.cat(
            [self.b1(x),
             self.b3_a(s), self.b3_b(s),
             self.b3dbl_a(d), self.b3dbl_b(d),
             self.pool_proj(self.pool(x))], dim=1)


class InceptionV3(nn.Layer):
    """ref: vision/models/inceptionv3.py InceptionV3(num_classes,
    with_pool). 299x299 input canonical; any size >= 75 works."""

    def __init__(self, num_classes: int = 1000, with_pool: bool = True,
                 device=None):
        super().__init__()
        self.stem = nn.Sequential(
            _BasicConv2d(3, 32, 3, stride=2),
            _BasicConv2d(32, 32, 3),
            _BasicConv2d(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            _BasicConv2d(64, 80, 1),
            _BasicConv2d(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64),
            _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048))
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.dropout(x.reshape(x.shape[0], -1))
            x = self.fc(x)
        return x


def inception_v3(**kw):
    return InceptionV3(**kw)
