"""vision.transforms' functional API and the remaining transforms (the
port's copy of ``paddle_tpu/vision/transforms_fill.py``; ref:
python/paddle/vision/transforms/{transforms,functional}.py). Host-side
numpy (see transforms.py): HWC arrays, uint8 or float.

The geometric family (rotate / affine / perspective) shares one
inverse-warp bilinear sampler in numpy, with no PIL or cv2 dependency.
"""

from __future__ import annotations

import math
import numbers
import random

import numpy as np

from .transforms import BaseTransform, _size2d

# ---------------------------------------------------------------------------
# functional API (ref: vision/transforms/functional.py)
# ---------------------------------------------------------------------------


def to_tensor(pic, data_format="CHW"):
    pic = np.asarray(pic)
    img = pic.astype(np.float32)
    if pic.dtype == np.uint8:
        img = img / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if data_format == "CHW":
        img = img.transpose(2, 0, 1)
    return img


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    img = np.asarray(img).astype(np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        return (img - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    return (img - mean.reshape(1, 1, -1)) / std.reshape(1, 1, -1)


def resize(img, size, interpolation="bilinear"):
    from .transforms import Resize
    return Resize(size, interpolation)(img)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    img = np.asarray(img)
    th, tw = _size2d(output_size)
    h, w = img.shape[:2]
    return crop(img, (h - th) // 2, (w - tw) // 2, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    img = np.asarray(img)
    if isinstance(padding, numbers.Number):
        l = r = t = b = int(padding)
    elif len(padding) == 2:
        l = r = int(padding[0])
        t = b = int(padding[1])
    else:
        l, t, r, b = (int(p) for p in padding)
    pads = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
    if padding_mode == "constant":
        return np.pad(img, pads, constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    return np.pad(img, pads, mode=mode)


def to_grayscale(img, num_output_channels=1):
    """ITU-R 601-2 luma (the reference/PIL convert("L") weights)."""
    img = np.asarray(img).astype(np.float32)
    if img.ndim == 2 or img.shape[-1] == 1:
        g = img if img.ndim == 2 else img[..., 0]
    else:
        g = (img[..., 0] * 0.299 + img[..., 1] * 0.587
             + img[..., 2] * 0.114)
    out = np.repeat(g[..., None], num_output_channels, axis=-1)
    return out


def adjust_brightness(img, brightness_factor):
    img = np.asarray(img)
    hi = 255.0 if img.dtype == np.uint8 else None
    out = img.astype(np.float32) * brightness_factor
    if hi:
        return np.clip(out, 0, hi).astype(img.dtype)
    return out


def adjust_contrast(img, contrast_factor):
    img = np.asarray(img)
    hi = 255.0 if img.dtype == np.uint8 else None
    f = img.astype(np.float32)
    mean = to_grayscale(f)[..., 0].mean()
    out = mean + contrast_factor * (f - mean)
    if hi:
        return np.clip(out, 0, hi).astype(img.dtype)
    return out


def adjust_saturation(img, saturation_factor):
    img = np.asarray(img)
    hi = 255.0 if img.dtype == np.uint8 else None
    f = img.astype(np.float32)
    gray = to_grayscale(f, 3)
    out = gray + saturation_factor * (f - gray)
    if hi:
        return np.clip(out, 0, hi).astype(img.dtype)
    return out


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) through the
    HSV round-trip the reference does in PIL."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    img = np.asarray(img)
    dtype = img.dtype
    f = img.astype(np.float32) / (255.0 if dtype == np.uint8 else 1.0)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    maxc = f[..., :3].max(-1)
    minc = f[..., :3].min(-1)
    v = maxc
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
    safe_c = np.maximum(c, 1e-12)
    h = np.select(
        [maxc == r, maxc == g],
        [((g - b) / safe_c) % 6.0, (b - r) / safe_c + 2.0],
        (r - g) / safe_c + 4.0) / 6.0
    h = np.where(c > 0, h, 0.0)
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    fpart = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * fpart)
    t = v * (1.0 - s * (1.0 - fpart))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1)
    if dtype == np.uint8:
        return np.clip(out * 255.0, 0, 255).astype(np.uint8)
    return out.astype(dtype)


def _warp(img, inv: np.ndarray, fill=0.0):
    """Inverse-warp with bilinear sampling: out(y, x) = img(inv @ (x,
    y, 1)). ``inv`` is 3x3 (projective) mapping OUTPUT pixel coords to
    INPUT coords."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w = img.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ones = np.ones_like(xs)
    pts = np.stack([xs, ys, ones], 0).reshape(3, -1).astype(np.float64)
    src = inv @ pts
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    dx = (sx - x0)[:, None]
    dy = (sy - y0)[:, None]
    valid = ((sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h))[:, None]

    def at(yy, xx):
        inb = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[:, None]
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(
            np.float64).reshape(len(xx), -1)
        return np.where(inb, v, fill)

    out = (at(y0, x0) * (1 - dx) * (1 - dy) + at(y0, x0 + 1) * dx * (1 - dy)
           + at(y0 + 1, x0) * (1 - dx) * dy + at(y0 + 1, x0 + 1) * dx * dy)
    out = np.where(valid, out, fill)
    out = out.reshape(h, w, img.shape[2])
    if img.dtype == np.uint8:
        out = np.clip(out, 0, 255)
    out = out.astype(img.dtype)
    return out[..., 0] if squeeze else out


def _affine_inv(center, angle, translate, scale, shear):
    """Inverse affine matrix for output→input mapping (the reference's
    PIL convention: rotate about center, then translate)."""
    cx, cy = center
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    # forward = T(center) R S Shear T(-center) T(translate)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    fwd = np.array([[a * scale, b * scale, 0.0],
                    [c * scale, d * scale, 0.0],
                    [0.0, 0.0, 1.0]])
    t_pre = np.array([[1, 0, cx + translate[0]], [0, 1, cy + translate[1]],
                      [0, 0, 1.0]])
    t_post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
    return np.linalg.inv(t_pre @ fwd @ t_post)


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    img = np.asarray(img)
    h, w = img.shape[:2]
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    center = center or ((w - 1) * 0.5, (h - 1) * 0.5)
    return _warp(img, _affine_inv(center, angle, translate, scale,
                                  shear), fill)


def rotate(img, angle, interpolation="nearest", expand=False,
           center=None, fill=0):
    img = np.asarray(img)
    h, w = img.shape[:2]
    if expand:
        rad = math.radians(angle)
        nw = int(abs(w * math.cos(rad)) + abs(h * math.sin(rad)) + 0.5)
        nh = int(abs(h * math.cos(rad)) + abs(w * math.sin(rad)) + 0.5)
        padded = np.zeros((nh, nw) + img.shape[2:], img.dtype)
        oy, ox = (nh - h) // 2, (nw - w) // 2
        padded[oy:oy + h, ox:ox + w] = img
        img, h, w = padded, nh, nw
        center = None
    center = center or ((w - 1) * 0.5, (h - 1) * 0.5)
    return _warp(img, _affine_inv(center, angle, (0, 0), 1.0,
                                  (0.0, 0.0)), fill)


def _perspective_coeffs(startpoints, endpoints):
    """Solve the 8-dof homography mapping endpoints→startpoints (the
    output→input direction _warp wants)."""
    a = []
    b = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        a.append([ex, ey, 1, 0, 0, 0, -sx * ex, -sx * ey])
        a.append([0, 0, 0, ex, ey, 1, -sy * ex, -sy * ey])
        b += [sx, sy]
    coef = np.linalg.solve(np.asarray(a, np.float64),
                           np.asarray(b, np.float64))
    return np.array([[coef[0], coef[1], coef[2]],
                     [coef[3], coef[4], coef[5]],
                     [coef[6], coef[7], 1.0]])


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    return _warp(np.asarray(img),
                 _perspective_coeffs(startpoints, endpoints), fill)


def erase(img, i, j, h, w, v, inplace=False):
    img = np.asarray(img)
    out = img if inplace else img.copy()
    if img.ndim == 3 and img.shape[0] <= 4:   # CHW
        out[:, i:i + h, j:j + w] = v
    else:
        out[i:i + h, j:j + w] = v
    return out


# ---------------------------------------------------------------------------
# transform classes (ref: vision/transforms/transforms.py)
# ---------------------------------------------------------------------------

class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if random.random() < self.prob else img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding, self.fill = padding, fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value):
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Randomly-ordered brightness/contrast/saturation/hue jitter
    (ref: transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation),
                   HueTransform(hue)]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.ts[i]._apply_image(img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.expand, self.center, self.fill = expand, center, fill

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, expand=self.expand,
                      center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees, self.translate = degrees, translate
        self.scale, self.shear = scale, shear
        self.fill, self.center = fill, center

    def _apply_image(self, img):
        h, w = np.asarray(img).shape[:2]
        angle = random.uniform(*self.degrees)
        tx = ty = 0
        if self.translate:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        sc = random.uniform(*self.scale) if self.scale else 1.0
        sh = (0.0, 0.0)
        if self.shear is not None:
            s = self.shear
            if isinstance(s, numbers.Number):
                s = (-s, s)
            sh = (random.uniform(s[0], s[1]), 0.0)
        return affine(np.asarray(img), angle, (tx, ty), sc, sh,
                      fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        h, w = np.asarray(img).shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)

        def jitter(px, py, sx, sy):
            return (px + random.randint(0, dx) * sx,
                    py + random.randint(0, dy) * sy)

        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [jitter(0, 0, 1, 1), jitter(w - 1, 0, -1, 1),
               jitter(w - 1, h - 1, -1, -1), jitter(0, h - 1, 1, -1)]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    """Random rectangle erasing (ref: transforms.RandomErasing; Zhong
    et al.)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False):
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        img = np.asarray(img)
        chw = img.ndim == 3 and img.shape[0] <= 4
        h, w = (img.shape[1:3] if chw else img.shape[:2])
        area = h * w
        for _ in range(10):
            target = random.uniform(*self.scale) * area
            ar = math.exp(random.uniform(math.log(self.ratio[0]),
                                         math.log(self.ratio[1])))
            eh = int(round(math.sqrt(target * ar)))
            ew = int(round(math.sqrt(target / ar)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                v = (np.random.standard_normal(
                    ((img.shape[0], eh, ew) if chw else
                     (eh, ew) + img.shape[2:])).astype(np.float32)
                    if self.value == "random" else self.value)
                return erase(img, i, j, eh, ew, v, self.inplace)
        return img
