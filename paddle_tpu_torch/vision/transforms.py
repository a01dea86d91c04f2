"""Image transforms (the port's copy of
``paddle_tpu/vision/transforms.py``; ref: python/paddle/vision/
transforms/transforms.py — Compose, Resize, RandomCrop / CenterCrop,
RandomHorizontalFlip, Normalize, ToTensor, RandomResizedCrop...).

Host-side numpy preprocessing, run in DataLoader workers while the card
computes the previous batch. Draws go through Python's ``random`` in the
JAX package's calls and order, so one ``random.seed`` gives the same
crops and flips in both packages. Arrays are HWC uint8 / float in, CHW
float32 out of ToTensor (reference convention)."""

from __future__ import annotations

import numbers
import random
from typing import Callable, Sequence, Tuple

import numpy as np


def _size2d(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    return int(size[0]), int(size[1])


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(np.asarray(img))


class Resize(BaseTransform):
    """Bilinear resize to (h, w) (ref: transforms.Resize)."""

    def __init__(self, size, interpolation: str = "bilinear"):
        self.size = _size2d(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        h_out, w_out = self.size
        h_in, w_in = img.shape[0], img.shape[1]
        if (h_in, w_in) == (h_out, w_out):
            return img
        img = img.astype(np.float32)
        ys = np.linspace(0, h_in - 1, h_out)
        xs = np.linspace(0, w_in - 1, w_out)
        if self.interpolation == "nearest":
            return img[np.round(ys).astype(int)[:, None],
                       np.round(xs).astype(int)[None, :]]
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h_in - 1)
        x1 = np.minimum(x0 + 1, w_in - 1)
        wy = (ys - y0)[:, None]
        wx = (xs - x0)[None, :]
        if img.ndim == 3:
            wy = wy[..., None]
            wx = wx[..., None]
        top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
        bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
        return top * (1 - wy) + bot * wy


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = _size2d(size)

    def _apply_image(self, img):
        th, tw = self.size
        h, w = img.shape[:2]
        i = max(0, (h - th) // 2)
        j = max(0, (w - tw) // 2)
        return img[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, pad_if_needed: bool = True):
        self.size = _size2d(size)
        self.pad_if_needed = pad_if_needed

    def _apply_image(self, img):
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            ph, pw = max(0, th - h), max(0, tw - w)
            pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pad)
            h, w = img.shape[:2]
        i = random.randint(0, h - th)
        j = random.randint(0, w - tw)
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomResizedCrop(BaseTransform):
    """ref: transforms.RandomResizedCrop (scale/ratio jittered crop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = _size2d(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            ar = np.exp(random.uniform(np.log(self.ratio[0]),
                                       np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = random.randint(0, h - ch)
                j = random.randint(0, w - cw)
                crop = img[i:i + ch, j:j + cw]
                return Resize(self.size)._apply_image(crop)
        return Resize(self.size)._apply_image(CenterCrop(
            min(h, w))._apply_image(img))


class Normalize(BaseTransform):
    """CHW float normalize (ref: transforms.Normalize; expects ToTensor
    first when data_format='CHW')."""

    def __init__(self, mean, std, data_format: str = "CHW"):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = img.astype(np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1] (ref: transforms.ToTensor)."""

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        orig_dtype = img.dtype
        img = img.astype(np.float32)
        # scale iff the input was uint8 (dtype-based, like the
        # reference) — never from the data values, and not for 16/32-bit
        # integer images whose range isn't 0..255
        if orig_dtype == np.uint8:
            img = img / 255.0
        return np.ascontiguousarray(img.transpose(2, 0, 1))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        return np.ascontiguousarray(img.transpose(self.order))


# -- round-4 surface completion (tools/api_coverage.py) ---------------------
from .transforms_fill import *  # noqa: E402,F401,F403
