"""VGG family (the port's counterpart of ``paddle_tpu/models/vgg.py``;
ref: python/paddle/vision/models/vgg.py — make_layers + vgg11/13/16/19
with optional batch_norm)."""

from __future__ import annotations

from .. import nn
from ..core.device import resolve_device

CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
          512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm: bool = False) -> nn.Sequential:
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
        else:
            layers.append(nn.Conv2D(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(nn.BatchNorm2D(v))
            layers.append(nn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    """ref: vision/models/vgg.py VGG(features, num_classes). Parameters
    are drawn on the CPU and moved to ``device``, the GPU unless the
    caller passes ``device="cpu"``."""

    def __init__(self, features: nn.Layer, num_classes: int = 1000,
                 with_pool: bool = True, device=None):
        super().__init__()
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes),
            )
        self.to(resolve_device(device))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = nn.Flatten()(x)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, **kwargs):
    return VGG(make_layers(CFGS[cfg], batch_norm=batch_norm), **kwargs)


def vgg11(batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
