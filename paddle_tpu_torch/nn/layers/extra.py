"""Long-tail layers (the port's counterpart of
``paddle_tpu/nn/layers/extra.py``): wrappers over ``nn.functional`` and
the few ops defined here (pixel shuffle, fold, local response norm,
pairwise distance, alpha dropout, CELU, maxout), which
``nn.functional`` re-exports. ``RReLU``'s slopes and ``AlphaDropout``'s
mask are drawn with JAX's threefry on the key stream, so that a seeded
draw equals the JAX package's."""

from __future__ import annotations

import torch

from ...core import rng, threefry
from .. import functional as F
from .. import initializer as I
from ..layer import Layer
from .common import Pad2D, Upsample, _act_layer


# -- functional forms (exported through nn.functional too) ------------------

def celu(x, alpha: float = 1.0):
    return torch.clamp(x, min=0) + torch.clamp(
        alpha * torch.expm1(x / alpha), max=0)


def thresholded_relu(x, threshold: float = 1.0):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def maxout(x, groups: int, axis: int = 1):
    axis = axis % x.dim()
    c = x.shape[axis]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by {groups}")
    shape = list(x.shape)
    shape[axis:axis + 1] = [c // groups, groups]
    return x.reshape(shape).amax(dim=axis + 1)


def pixel_shuffle(x, upscale_factor: int, data_format: str = "NCHW"):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor: int, data_format: str = "NCHW"):
    r = downscale_factor
    if data_format != "NCHW":
        raise NotImplementedError("NHWC pixel_unshuffle")
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, c * r * r, h // r, w // r)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0,
         dilations=1):
    """col2im, the inverse of ``unfold``: ``[N, C * kh * kw, L]`` to
    ``[N, C, H, W]``, overlaps summed."""
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    oh, ow = output_sizes
    n, ckk, length = x.shape
    c = ckk // (kh * kw)
    lh = (oh + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    lw = (ow + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    assert lh * lw == length, (lh, lw, length)
    cols = x.reshape(n, c, kh, kw, lh, lw)
    out = torch.zeros((n, c, oh + 2 * ph, ow + 2 * pw), dtype=x.dtype,
                      device=x.device)
    for i in range(kh):
        for j in range(kw):
            out[:, :, i * dh:i * dh + lh * sh:sh,
                j * dw:j * dw + lw * sw:sw] += cols[:, :, i, j]
    return out[:, :, ph:ph + oh, pw:pw + ow]


def local_response_norm(x, size: int = 5, alpha: float = 1e-4,
                        beta: float = 0.75, k: float = 1.0):
    """Cross-channel window on dim 1, any rank 3-5."""
    sq = x.square()
    c = x.shape[1]
    half = size // 2
    pads = [0, 0] * (x.dim() - 2) + [half, size - half - 1]
    padded = torch.nn.functional.pad(sq, pads)
    win = sum(padded[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * win / size, beta)


def pairwise_distance(x, y, p: float = 2.0, epsilon: float = 1e-6,
                      keepdim: bool = False):
    return torch.linalg.vector_norm(x - y + epsilon, ord=p, dim=-1,
                                    keepdim=keepdim)


def alpha_dropout(x, p: float = 0.5, training: bool = True):
    """SELU-preserving dropout; the keep mask is ``uniform(next_key()) <
    1 - p`` under threefry, as ``jax.random.bernoulli`` draws it."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.7580993408473766
    mask = threefry.uniform(rng.next_key(), x.shape, device=x.device) < 1 - p
    a = (1 - p + p * alpha_p ** 2) ** -0.5
    b = -a * p * alpha_p
    return a * torch.where(mask, x, torch.full_like(x, alpha_p)) + b


# -- layer wrappers ---------------------------------------------------------

CELU = _act_layer("CELU", celu)
ThresholdedReLU = _act_layer("ThresholdedReLU", thresholded_relu)
Tanhshrink = _act_layer("Tanhshrink", F.tanhshrink)
Hardshrink = _act_layer("Hardshrink", F.hardshrink)
Softshrink = _act_layer("Softshrink", F.softshrink)
Hardtanh = _act_layer("Hardtanh", F.hardtanh)
GLU = _act_layer("GLU", F.glu)
LocalResponseNorm = _act_layer("LocalResponseNorm", local_response_norm)


class RReLU(Layer):
    """Randomized leaky ReLU: slopes drawn from ``uniform(next_key(),
    [lower, upper))`` under threefry when training, their mean in
    eval."""

    def __init__(self, lower: float = 1 / 8., upper: float = 1 / 3.):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if self.training:
            slope = threefry.uniform(rng.next_key(), x.shape, self.lower,
                                     self.upper, device=x.device) \
                .to(x.dtype)
        else:
            slope = (self.lower + self.upper) / 2
        return torch.where(x >= 0, x, slope * x)


class Maxout(Layer):
    def __init__(self, groups: int, axis: int = 1):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return maxout(x, self.groups, self.axis)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor: int, data_format: str = "NCHW"):
        super().__init__()
        self.r = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return pixel_shuffle(x, self.r, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor: int, data_format: str = "NCHW"):
        super().__init__()
        self.r = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return pixel_unshuffle(x, self.r, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1,
                 paddings=0, dilations=1):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return fold(x, self.output_sizes, *self.args)


class Pad1D(Pad2D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL"):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad2D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW"):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW"):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis: int = 1, eps: float = 1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p: float = 2.0, epsilon: float = 1e-6,
                 keepdim: bool = False):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Bilinear(Layer):
    """out[k] = x1 W_k x2 + b."""

    def __init__(self, in1_features: int, in2_features: int,
                 out_features: int, weight_attr=None, bias_attr=None):
        super().__init__()
        init = weight_attr if callable(weight_attr) else I.XavierUniform()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], initializer=init)
        self.bias = None if bias_attr is False else \
            self.create_parameter([out_features],
                                  initializer=I.Constant(0.0))

    def forward(self, x1, x2):
        out = torch.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        if self.bias is not None:
            out = out + self.bias
        return out


class AlphaDropout(Layer):
    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        return alpha_dropout(x, self.p, training=self.training)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, mode="bilinear",
                         align_corners=True, data_format=data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW"):
        super().__init__(size, scale_factor, mode="nearest",
                         data_format=data_format)
