"""Detection ops (the port's counterpart of ``paddle_tpu/vision/ops.py``):
nms, roi_align, roi_pool, psroi_pool, temporal_shift, yolo_box,
deform_conv2d (ref: python/paddle/vision/ops.py).

The JAX package computes these with ``jnp`` / ``lax`` outside any
Pallas kernel; here they are batched torch ops on the inputs' device,
never a Python loop of per-element launches:

- ``nms``: the [N, N] IoU matrix is one vectorized op on the device; the
  greedy scan runs over a host copy of the [N, N] suppression mask (a
  row operation a kept box).
- ``roi_align``: bilinear sampling as four gathers a sample point over
  every roi at once; the adaptive mode counts its samples per roi on the
  host in float64 (``ceil(roi / bin)``, the JAX count) and runs each
  group of rois with the same count together.
- ``roi_pool`` / ``psroi_pool``: the bins' pixel bounds on the host in
  float64, as the JAX package computes them, then masked max / mean
  reductions over chunks of rois.
- ``deform_conv2d``: the bilinear deformable unfold of every tap, then
  one matmul over ``C * kh * kw``.

A tensor argument keeps its device; anything else lands on the device
``paddle_tpu_torch.set_device`` chose.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import device as _device
from ..core.xla_math import div as _div

# elements of the largest intermediate a chunk of rois may build
_CHUNK_ELEMS = 1 << 26


def _t(x, dtype=None, device=None):
    """``x`` as a tensor: a tensor stays on its device (or moves to
    ``device``), anything else lands on ``device`` or the flat API's."""
    if isinstance(x, torch.Tensor):
        x = x if device is None else x.to(device)
        return x if dtype is None else x.to(dtype)
    dev = device if device is not None else _device.current_device()
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _iou_matrix(boxes):
    """[N, 4] xyxy -> [N, N] IoU."""
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(boxes, iou_threshold: float = 0.3, scores=None,
        category_idxs=None, categories=None, top_k: Optional[int] = None):
    """Greedy non-maximum suppression (ref: vision/ops.py:1440 nms).
    Returns kept indices sorted by score (a stable sort: of equal scores
    the lower index first). With ``category_idxs``, suppression only
    applies within a category (the coordinate-offset trick)."""
    boxes = _t(boxes, torch.float32)
    dev = boxes.device
    n = boxes.shape[0]
    if scores is None:
        order = torch.arange(n, device=dev)
    else:
        order = torch.argsort(-_t(scores, device=dev), stable=True)
    if category_idxs is not None:
        # offset each category into a disjoint coordinate range so
        # cross-category IoU is exactly 0 (torchvision's batched trick)
        span = (boxes.max() - boxes.min()) + 1.0
        off = _t(category_idxs, torch.float32, dev)[:, None] * span
        iou = _iou_matrix(boxes + off)
    else:
        iou = _iou_matrix(boxes)
    # in score order; box j is suppressed iff it overlaps an earlier kept
    # box i: entry (j, i) of the mask, row i of its transpose
    sup_t = np.ascontiguousarray(
        (iou[order][:, order] > iou_threshold).cpu().numpy().T)
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~sup_t[i, i + 1:]
    kept = order.cpu().numpy()[keep]
    if top_k is not None:
        kept = kept[:top_k]
    return torch.as_tensor(kept, device=dev)


def _bilinear(xt, img, y, x):
    """Sample ``xt`` ([N, H, W, C]) at float ``(y, x)`` ([R, S] each) in
    image ``img`` ([R]) with zero padding: [R, S, C]."""
    h, w = xt.shape[1], xt.shape[2]
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    rows = img[:, None].expand_as(y0)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = xt[rows, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)

    return (tap(y0, x0) * wy0[..., None] * wx0[..., None]
            + tap(y0, x1) * wy0[..., None] * wx1[..., None]
            + tap(y1, x0) * wy1[..., None] * wx0[..., None]
            + tap(y1, x1) * wy1[..., None] * wx1[..., None])


def _image_index(boxes_num, r: int, device):
    num = _t(boxes_num, torch.int64, device)
    return torch.repeat_interleave(torch.arange(num.shape[0], device=device),
                                   num, output_size=r)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _chunks(r: int, per_roi: int):
    step = max(1, _CHUNK_ELEMS // max(per_roi, 1))
    return [(i, min(r, i + step)) for i in range(0, r, step)]


def _roi_align_group(xt, boxes, img, ph, pw, ratio_h, ratio_w,
                     spatial_scale, offset, aligned):
    """roi_align of rois that all take ``ratio_h x ratio_w`` samples a
    bin: [R, C, ph, pw]."""
    b = boxes * spatial_scale - offset
    bx1, by1, bx2, by2 = (b[:, i] for i in range(4))
    rw = bx2 - bx1
    rh = by2 - by1
    if not aligned:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bin_h, bin_w = _div(rh, ph), _div(rw, pw)
    dev = boxes.device
    i_h = torch.arange(ph, device=dev)[None, :, None, None, None]
    i_w = torch.arange(pw, device=dev)[None, None, :, None, None]
    k_h = torch.arange(ratio_h, device=dev)[None, None, None, :, None]
    k_w = torch.arange(ratio_w, device=dev)[None, None, None, None, :]
    bh = bin_h[:, None, None, None, None]
    bw = bin_w[:, None, None, None, None]
    iy = i_h * bh + by1[:, None, None, None, None] + \
        _div((k_h + 0.5) * bh, ratio_h)
    ix = i_w * bw + bx1[:, None, None, None, None] + \
        _div((k_w + 0.5) * bw, ratio_w)
    shape = (boxes.shape[0], ph, pw, ratio_h, ratio_w)
    ys = iy.expand(shape).reshape(boxes.shape[0], -1)
    xs = ix.expand(shape).reshape(boxes.shape[0], -1)
    vals = _bilinear(xt, img, ys, xs)                  # [R, S, C]
    vals = vals.reshape(boxes.shape[0], ph, pw, ratio_h * ratio_w, -1)
    return vals.mean(dim=3).permute(0, 3, 1, 2)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True):
    """ref: vision/ops.py:1133 roi_align. ``x`` [N, C, H, W]; ``boxes``
    [R, 4] xyxy in input coords; ``boxes_num`` [N] rois per image."""
    x = _t(x, torch.float32)
    dev = x.device
    boxes = _t(boxes, torch.float32, dev)
    ph, pw = _pair(output_size)
    offset = 0.5 if aligned else 0.0
    r, c = boxes.shape[0], x.shape[1]
    img = _image_index(boxes_num, r, dev)
    xt = x.permute(0, 2, 3, 1)                          # [N, H, W, C]
    out = x.new_empty((r, c, ph, pw))
    if sampling_ratio > 0:
        groups = {(sampling_ratio, sampling_ratio): np.arange(r)}
    else:
        # adaptive mode (reference default): ceil(roi_size / output_size)
        # sample points a bin, counted on the host in float64
        b_np = _host(boxes).astype(np.float64) * spatial_scale - offset
        rh_np = b_np[:, 3] - b_np[:, 1]
        rw_np = b_np[:, 2] - b_np[:, 0]
        if not aligned:
            rh_np = np.maximum(rh_np, 1.0)
            rw_np = np.maximum(rw_np, 1.0)
        gh = np.maximum(1, np.ceil(rh_np / ph)).astype(np.int64)
        gw = np.maximum(1, np.ceil(rw_np / pw)).astype(np.int64)
        groups = {}
        for k in range(r):
            groups.setdefault((int(gh[k]), int(gw[k])), []).append(k)
    for (sh, sw), rows in groups.items():
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        for lo, hi in _chunks(rows.shape[0], c * ph * pw * sh * sw * 4):
            sel = rows[lo:hi]
            out[sel] = _roi_align_group(xt, boxes[sel], img[sel], ph, pw,
                                        sh, sw, spatial_scale, offset,
                                        aligned)
    return out


def _bin_masks(lo, hi, n, device):
    """[R, bins, n] bool: pixel p of bin b of roi r lies in [lo, hi)."""
    p = torch.arange(n, device=device)
    lo = torch.as_tensor(lo, device=device)[..., None]
    hi = torch.as_tensor(hi, device=device)[..., None]
    return (p >= lo) & (p < hi)


def _roi_bins(ph, pw, h, w, y1, x1, rh, rw, pre):
    """Each bin's clipped pixel bounds, as the JAX package computes them
    (``pre``: True for roi_pool's ``floor(i * rh / ph) + y1``, False for
    psroi_pool's ``floor(y1 + i * rh / ph)``)."""
    i = np.arange(ph, dtype=np.float64)[None]
    j = np.arange(pw, dtype=np.float64)[None]
    y1, x1, rh, rw = (v[:, None] for v in (y1, x1, rh, rw))
    if pre:
        hs = np.floor(i * rh / ph) + y1
        he = np.ceil((i + 1) * rh / ph) + y1
        ws = np.floor(j * rw / pw) + x1
        we = np.ceil((j + 1) * rw / pw) + x1
    else:
        hs = np.floor(y1 + i * rh / ph)
        he = np.ceil(y1 + (i + 1) * rh / ph)
        ws = np.floor(x1 + j * rw / pw)
        we = np.ceil(x1 + (j + 1) * rw / pw)
    clip = lambda v, n: np.clip(v, 0, n).astype(np.int64)  # noqa: E731
    return clip(hs, h), clip(he, h), clip(ws, w), clip(we, w)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0):
    """Quantized max-pool RoI pooling (ref: vision/ops.py roi_pool).
    Empty bins yield 0."""
    x = _t(x, torch.float32)
    dev = x.device
    ph, pw = _pair(output_size)
    _, c, h, w = x.shape
    b_np = np.round(_host(boxes).astype(np.float64) * spatial_scale)
    img = np.repeat(np.arange(len(_host(boxes_num))), _host(boxes_num))
    r = b_np.shape[0]
    rh = np.maximum(b_np[:, 3] - b_np[:, 1] + 1, 1.0)
    rw = np.maximum(b_np[:, 2] - b_np[:, 0] + 1, 1.0)
    hs, he, ws, we = _roi_bins(ph, pw, h, w, b_np[:, 1], b_np[:, 0], rh, rw,
                               pre=True)
    out = x.new_zeros((r, c, ph, pw))
    neg = torch.tensor(float("-inf"), device=dev)
    for lo, hi in _chunks(r, c * h * w * max(ph, pw)):
        feat = x[torch.as_tensor(img[lo:hi], device=dev)]   # [Rc, C, H, W]
        mw = _bin_masks(ws[lo:hi], we[lo:hi], w, dev)        # [Rc, pw, W]
        mh = _bin_masks(hs[lo:hi], he[lo:hi], h, dev)        # [Rc, ph, H]
        colmax = torch.where(mw[:, None, None], feat[:, :, :, None], neg) \
            .amax(dim=-1)                                    # [Rc, C, H, pw]
        binmax = torch.where(mh[:, None, :, :, None],
                             colmax[:, :, None], neg).amax(dim=3)
        empty = torch.as_tensor((he[lo:hi] <= hs[lo:hi])[:, :, None]
                                | (we[lo:hi] <= ws[lo:hi])[:, None, :],
                                device=dev)
        out[lo:hi] = torch.where(empty[:, None], 0.0, binmax)
    return out


def psroi_pool(x, boxes, boxes_num, output_size,
               spatial_scale: float = 1.0, output_channels=None):
    """Position-sensitive RoI average pooling (ref: vision/ops.py
    psroi_pool): input channels are out_c * ph * pw; output bin (i, j)
    of channel c averages input channel c*ph*pw + i*pw + j over the
    bin."""
    x = _t(x, torch.float32)
    dev = x.device
    ph, pw = _pair(output_size)
    c_in, h, w = x.shape[1], x.shape[2], x.shape[3]
    if output_channels is None:
        output_channels = c_in // (ph * pw)
    if output_channels * ph * pw != c_in:
        raise ValueError(
            f"psroi_pool: channels {c_in} != out_c*{ph}*{pw}")
    b_np = _host(boxes).astype(np.float64) * spatial_scale
    img = np.repeat(np.arange(len(_host(boxes_num))), _host(boxes_num))
    r = b_np.shape[0]
    # the roi rounded to bin edges on the feature map
    x1, y1 = np.floor(b_np[:, 0]), np.floor(b_np[:, 1])
    x2, y2 = np.ceil(b_np[:, 2]), np.ceil(b_np[:, 3])
    rh = np.maximum(y2 - y1, 0.1)
    rw = np.maximum(x2 - x1, 0.1)
    hs, he, ws, we = _roi_bins(ph, pw, h, w, y1, x1, rh, rw, pre=False)
    count = np.maximum(he - hs, 0)[:, :, None] * \
        np.maximum(we - ws, 0)[:, None, :]                   # [R, ph, pw]
    out = x.new_zeros((r, output_channels, ph, pw))
    for lo, hi in _chunks(r, c_in * h * w):
        feat = x[torch.as_tensor(img[lo:hi], device=dev)].reshape(
            hi - lo, output_channels, ph, pw, h, w)
        mh = _bin_masks(hs[lo:hi], he[lo:hi], h, dev).to(x.dtype)
        mw = _bin_masks(ws[lo:hi], we[lo:hi], w, dev).to(x.dtype)
        s = torch.einsum("rcijhw,rih,rjw->rcij", feat, mh, mw)
        cnt = torch.as_tensor(count[lo:hi], device=dev)[:, None]
        out[lo:hi] = torch.where(cnt > 0, s / cnt.clamp(min=1).to(x.dtype),
                                 0.0)
    return out


def temporal_shift(x, seg_num: int, shift_ratio: float = 0.25,
                   data_format: str = "NCHW"):
    """TSM channel shift along time (ref: legacy_api.yaml
    temporal_shift). x: [N*T, C, H, W]; the first C*ratio channels take
    their value from t-1, the next C*ratio from t+1, the rest stay, zero
    padded at the sequence ends."""
    x = _t(x)
    if data_format == "NHWC":
        x = x.movedim(-1, 1)
    nt, c, h, w = x.shape
    n = nt // seg_num
    xr = x.reshape(n, seg_num, c, h, w)
    c1 = int(c * shift_ratio)
    c2 = int(c * 2 * shift_ratio)
    zero = xr.new_zeros((n, 1, c, h, w))
    fwd = torch.cat([zero[:, :, :c1], xr[:, :-1, :c1]], dim=1)     # t-1
    bwd = torch.cat([xr[:, 1:, c1:c2], zero[:, :, c1:c2]], dim=1)  # t+1
    out = torch.cat([fwd, bwd, xr[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    if data_format == "NHWC":
        out = out.movedim(1, -1)
    return out


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float,
             downsample_ratio: int, clip_bbox: bool = True,
             scale_x_y: float = 1.0):
    """YOLOv3 box decode (ref: vision/ops.py yolo_box). x: [N,
    an*(5+class_num), H, W]; img_size: [N, 2] (h, w). Returns (boxes
    [N, H*W*an, 4] xyxy in image coords, scores [N, H*W*an, class_num]);
    predictions below ``conf_thresh`` get score 0."""
    x = _t(x, torch.float32)
    dev = x.device
    n, _, h, w = x.shape
    an = len(anchors) // 2
    aw = torch.as_tensor(list(anchors[0::2]), dtype=torch.float32,
                         device=dev)
    ah = torch.as_tensor(list(anchors[1::2]), dtype=torch.float32,
                         device=dev)
    feats = x.reshape(n, an, 5 + class_num, h, w)
    tx, ty, tw, th, tconf = (feats[:, :, i] for i in range(5))
    tcls = feats[:, :, 5:]                      # [N, an, cls, H, W]
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :,
                                                           None]
    bias = 0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(tx) * scale_x_y - bias + gx) / w
    cy = (torch.sigmoid(ty) * scale_x_y - bias + gy) / h
    input_w = float(downsample_ratio) * w
    input_h = float(downsample_ratio) * h
    bw = torch.exp(tw) * aw[None, :, None, None] / input_w
    bh = torch.exp(th) * ah[None, :, None, None] / input_h
    size = _t(img_size, torch.float32, dev)
    img_h = size[:, 0][:, None, None, None]
    img_w = size[:, 1][:, None, None, None]
    x1 = (cx - bw / 2) * img_w
    y1 = (cy - bh / 2) * img_h
    x2 = (cx + bw / 2) * img_w
    y2 = (cy + bh / 2) * img_h
    if clip_bbox:
        x1 = torch.minimum(torch.clamp(x1, min=0), img_w - 1)
        y1 = torch.minimum(torch.clamp(y1, min=0), img_h - 1)
        x2 = torch.minimum(torch.clamp(x2, min=0), img_w - 1)
        y2 = torch.minimum(torch.clamp(y2, min=0), img_h - 1)
    conf = torch.sigmoid(tconf)
    keep = conf > conf_thresh
    scores = torch.sigmoid(tcls) * torch.where(keep, conf, 0.0)[:, :, None]
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)     # [N, an, H, W, 4]
    boxes = boxes.permute(0, 2, 3, 1, 4).reshape(n, -1, 4)
    scores = scores.permute(0, 3, 4, 1, 2).reshape(n, -1, class_num)
    return boxes, scores


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups: int = 1, groups: int = 1,
                  mask=None):
    """ref: vision/ops.py:512 deform_conv2d (v1; v2 when ``mask`` is
    given). The deformable unfold (each tap bilinear-sampled at its
    learned offset) of every tap and image at once, then one matmul over
    ``C * kh * kw``."""
    if groups != 1 or deformable_groups != 1:
        raise NotImplementedError(
            "deform_conv2d: groups/deformable_groups > 1 not supported")
    x = _t(x, torch.float32)
    dev = x.device
    weight = _t(weight, device=dev)
    n, c, h, w = x.shape
    oc, _, kh, kw = weight.shape
    s, p, d = _pair(stride), _pair(padding), _pair(dilation)
    oh = (h + 2 * p[0] - d[0] * (kh - 1) - 1) // s[0] + 1
    ow = (w + 2 * p[1] - d[1] * (kw - 1) - 1) // s[1] + 1
    k = kh * kw
    # offset: [N, 2*kh*kw, oh, ow] (y, x interleaved per tap)
    off = _t(offset, torch.float32, dev).reshape(n, k, 2, oh, ow)
    ky = torch.arange(k, device=dev) // kw
    kx = torch.arange(k, device=dev) % kw
    base_y = (torch.arange(oh, device=dev) * s[0] - p[0])[None, :, None]
    base_x = (torch.arange(ow, device=dev) * s[1] - p[1])[None, None, :]
    yy = (base_y + (ky * d[0])[:, None, None])[None] + off[:, :, 0]
    xx = (base_x + (kx * d[1])[:, None, None])[None] + off[:, :, 1]
    img = torch.arange(n, device=dev)
    v = _bilinear(x.permute(0, 2, 3, 1), img, yy.reshape(n, -1),
                  xx.reshape(n, -1))                 # [N, K*oh*ow, C]
    v = v.reshape(n, k, oh * ow, c)
    if mask is not None:
        msk = _t(mask, torch.float32, dev).reshape(n, k, oh * ow)
        v = v * msk[..., None]
    col = v.permute(0, 2, 3, 1).reshape(n, oh * ow, c * k)
    out = col @ weight.reshape(oc, -1).t()           # [N, oh*ow, OC]
    out = out.transpose(1, 2).reshape(n, oc, oh, ow)
    if bias is not None:
        out = out + _t(bias, device=dev)[None, :, None, None]
    return out


from .ops_fill import (  # noqa: E402,F401
    DeformConv2D, PSRoIPool, RoIAlign, RoIPool, decode_jpeg,
    distribute_fpn_proposals, generate_proposals, read_file, yolo_loss)
