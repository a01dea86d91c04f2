"""MobileNet v1/v2/v3 (the port's counterpart of
``paddle_tpu/models/mobilenet.py``; ref: python/paddle/vision/models/
mobilenetv1.py, mobilenetv2.py, mobilenetv3.py). Depthwise convolutions
(groups == channels) are cuDNN's through ``F.conv2d``.
"""

from __future__ import annotations

from .. import nn
from ..nn import functional as F
from ..core.device import resolve_device


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, kernel, stride=1, padding=0, groups=1,
                 act="relu"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "relu6":
            x = F.relu6(x)
        elif self.act == "hardswish":
            x = F.hardswish(x)
        return x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, mid_c, out_c, stride, scale=1.0):
        super().__init__()
        mid_c, out_c = int(mid_c * scale), int(out_c * scale)
        self.depthwise = ConvBNLayer(in_c, mid_c, 3, stride=stride,
                                     padding=1, groups=in_c)
        self.pointwise = ConvBNLayer(mid_c, out_c, 1)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class MobileNetV1(nn.Layer):
    """ref: vision/models/mobilenetv1.py MobileNetV1(scale, num_classes).
    Parameters are drawn on the CPU and moved to ``device``, the GPU
    unless the caller passes ``device="cpu"`` (every model here)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = lambda c: int(c * scale)  # noqa: E731
        self.conv1 = ConvBNLayer(3, s(32), 3, stride=2, padding=1)
        cfg = [  # in, mid, out, stride
            (s(32), 32, 64, 1), (s(64), 64, 128, 2),
            (s(128), 128, 128, 1), (s(128), 128, 256, 2),
            (s(256), 256, 256, 1), (s(256), 256, 512, 2),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 512, 1),
            (s(512), 512, 512, 1), (s(512), 512, 1024, 2),
            (s(1024), 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, m, o, st, scale) for i, m, o, st in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten()(x))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand_ratio):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        hidden = int(round(in_c * expand_ratio))
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(in_c, hidden, 1, act="relu6"))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6"),
            ConvBNLayer(hidden, out_c, 1, act=None),
        ]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    """ref: vision/models/mobilenetv2.py MobileNetV2(scale, num_classes)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [  # t (expand), c, n (repeats), s (stride)
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = _make_divisible(32 * scale)
        self.conv1 = ConvBNLayer(3, in_c, 3, stride=2, padding=1,
                                 act="relu6")
        blocks = []
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                blocks.append(InvertedResidual(
                    in_c, out_c, s if i == 0 else 1, t))
                in_c = out_c
        self.blocks = nn.Sequential(*blocks)
        self.out_c = _make_divisible(1280 * max(1.0, scale))
        self.conv2 = ConvBNLayer(in_c, self.out_c, 1, act="relu6")
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = nn.Sequential(nn.Dropout(0.2),
                                    nn.Linear(self.out_c, num_classes))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.conv2(self.blocks(self.conv1(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(nn.Flatten()(x))
        return x


def mobilenet_v1(scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


# ---------------------------------------------------------------------------
# MobileNetV3 (ref: vision/models/mobilenetv3.py — inverted residuals
# with squeeze-excitation and hardswish; Small/Large configs)
# ---------------------------------------------------------------------------

class _SEModule(nn.Layer):
    """Squeeze-excitation with the MBV3 gating (relu → hardsigmoid)."""

    def __init__(self, ch, reduction=4):
        super().__init__()
        mid = _make_divisible(ch // reduction)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc1 = nn.Conv2D(ch, mid, 1)
        self.fc2 = nn.Conv2D(mid, ch, 1)

    def forward(self, x):
        s = F.relu(self.fc1(self.pool(x)))
        return x * F.hardsigmoid(self.fc2(s))


class _InvertedResidualV3(nn.Layer):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if exp_c != in_c:
            layers.append(ConvBNLayer(in_c, exp_c, 1, act=act))
        layers.append(ConvBNLayer(exp_c, exp_c, kernel, stride=stride,
                                  padding=kernel // 2, groups=exp_c,
                                  act=act))
        if use_se:
            layers.append(_SEModule(exp_c))
        layers.append(ConvBNLayer(exp_c, out_c, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


# (kernel, expanded, out, SE, act, stride) — mobilenetv3.py cfg tables
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class _MobileNetV3(nn.Layer):
    def __init__(self, cfg, last_exp, hidden, scale=1.0,
                 num_classes: int = 1000, device=None):
        super().__init__()
        in_c = _make_divisible(16 * scale)
        feats = [ConvBNLayer(3, in_c, 3, stride=2, padding=1,
                             act="hardswish")]
        for k, exp, out, se, act, s in cfg:
            exp_c = _make_divisible(exp * scale)
            out_c = _make_divisible(out * scale)
            feats.append(_InvertedResidualV3(in_c, exp_c, out_c, k, s,
                                             se, act))
            in_c = out_c
        last_c = _make_divisible(last_exp * scale)
        feats.append(ConvBNLayer(in_c, last_c, 1, act="hardswish"))
        self.features = nn.Sequential(*feats)
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.head = nn.Sequential(
            nn.Linear(last_c, hidden), nn.Hardswish(),
            nn.Dropout(0.2), nn.Linear(hidden, num_classes))
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.pool(self.features(x))
        return self.head(x.reshape(x.shape[0], -1))


class MobileNetV3Large(_MobileNetV3):
    """ref: mobilenetv3.py MobileNetV3Large(scale, num_classes)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 device=None):
        super().__init__(_V3_LARGE, 960, 1280, scale, num_classes, device)


class MobileNetV3Small(_MobileNetV3):
    """ref: mobilenetv3.py MobileNetV3Small(scale, num_classes)."""

    def __init__(self, scale: float = 1.0, num_classes: int = 1000,
                 device=None):
        super().__init__(_V3_SMALL, 576, 1024, scale, num_classes, device)


def mobilenet_v3_large(scale=1.0, **kw):
    return MobileNetV3Large(scale=scale, **kw)


def mobilenet_v3_small(scale=1.0, **kw):
    return MobileNetV3Small(scale=scale, **kw)
