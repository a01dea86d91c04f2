"""LeNet (the port's counterpart of ``paddle_tpu/models/lenet.py``;
ref: python/paddle/vision/models/lenet.py)."""

from __future__ import annotations

from .. import nn
from ..core.device import resolve_device


class LeNet(nn.Layer):
    """LeNet-5 for MNIST: input [N, 1, 28, 28] -> logits [N, num_classes].
    Parameters are drawn on the CPU and moved to ``device``, the GPU
    unless the caller passes ``device="cpu"``."""

    def __init__(self, num_classes: int = 10, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Flatten(),
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )
        self.to(resolve_device(device))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x)
        return x
