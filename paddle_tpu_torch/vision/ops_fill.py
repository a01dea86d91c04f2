"""The rest of vision.ops (the port's counterpart of
``paddle_tpu/vision/ops_fill.py``; ref: python/paddle/vision/ops.py
__all__): layer wrappers over the functional detection ops, the YOLOv3
loss, RPN proposal generation, FPN routing and PIL-backed image IO.

Proposal generation and FPN routing are host-side numpy, as in the JAX
package (data preparation, not a training loop); the YOLOv3 loss is
torch ops on the input's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..nn import initializer as I
from ..nn.layer import Layer
from .ops import (_host, _t, deform_conv2d, nms, psroi_pool, roi_align,
                  roi_pool)


class RoIAlign(Layer):
    """ref: vision/ops.py RoIAlign (layer form of roi_align)."""

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


class DeformConv2D(Layer):
    """ref: vision/ops.py DeformConv2D (layer form of deform_conv2d)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        k = (kernel_size,) * 2 if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        scale = 1.0 / math.sqrt(in_channels * k[0] * k[1])
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, *k],
            initializer=I.Uniform(-scale, scale))
        self.bias = None if bias_attr is False else \
            self.create_parameter([out_channels],
                                  initializer=I.Uniform(-scale, scale))
        self.stride, self.padding = stride, padding
        self.dilation = dilation
        self.deformable_groups, self.groups = deformable_groups, groups

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self.stride, self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def _out_device(x):
    return x.device if isinstance(x, torch.Tensor) else None


def distribute_fpn_proposals(fpn_rois, min_level, max_level,
                             refer_level, refer_scale,
                             pixel_offset=False, rois_num=None,
                             name=None):
    """Route each RoI to its FPN level by sqrt(area) (ref:
    operators/detection/distribute_fpn_proposals_op; FPN eq. 1).
    Returns (rois_per_level, restore_index, rois_num_per_level)."""
    dev = _out_device(fpn_rois)
    rois = _host(fpn_rois)
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-12))
    lvl = np.floor(np.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = np.clip(lvl, min_level, max_level).astype(int)
    outs, idxs, nums = [], [], []
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl == level)[0]
        outs.append(_t(rois[sel], device=dev))
        idxs.append(sel)
        nums.append(len(sel))
    order = np.concatenate(idxs) if idxs else np.empty(0, int)
    restore = np.argsort(order)
    return outs, _t(restore, device=dev), _t(np.asarray(nums), device=dev)


def generate_proposals(scores, bbox_deltas, img_size, anchors,
                       variances, pre_nms_top_n=6000,
                       post_nms_top_n=1000, nms_thresh=0.5,
                       min_size=0.1, eta=1.0, pixel_offset=False,
                       return_rois_num=False, name=None):
    """RPN proposal generation (ref:
    operators/detection/generate_proposals_v2_op): decode anchor
    deltas, clip to the image, filter small boxes, NMS. Host-side
    numpy like the reference's CPU kernel; the NMS runs on the host."""
    dev = _out_device(scores)
    scores = _host(scores)
    deltas = _host(bbox_deltas)
    anchors = _host(anchors).reshape(-1, 4)
    variances = _host(variances).reshape(-1, 4)
    n = scores.shape[0]
    all_rois, all_probs, nums = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for i in range(n):
        s = scores[i].transpose(1, 2, 0).reshape(-1)
        d = deltas[i].transpose(1, 2, 0).reshape(-1, 4)
        order = np.argsort(-s)[:pre_nms_top_n]
        s, d, a, v = s[order], d[order], anchors[order], variances[order]
        aw = a[:, 2] - a[:, 0] + off
        ah = a[:, 3] - a[:, 1] + off
        acx = a[:, 0] + aw * 0.5
        acy = a[:, 1] + ah * 0.5
        cx = v[:, 0] * d[:, 0] * aw + acx
        cy = v[:, 1] * d[:, 1] * ah + acy
        w = aw * np.exp(np.minimum(v[:, 2] * d[:, 2], 10.0))
        h = ah * np.exp(np.minimum(v[:, 3] * d[:, 3], 10.0))
        boxes = np.stack([cx - w * 0.5, cy - h * 0.5,
                          cx + w * 0.5 - off, cy + h * 0.5 - off], 1)
        ih, iw = _host(img_size)[i][:2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, iw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ih - off)
        keep = ((boxes[:, 2] - boxes[:, 0] >= min_size)
                & (boxes[:, 3] - boxes[:, 1] >= min_size))
        boxes, s = boxes[keep], s[keep]
        kept = nms(torch.from_numpy(np.ascontiguousarray(boxes)),
                   nms_thresh, scores=torch.from_numpy(s),
                   top_k=post_nms_top_n).numpy()
        all_rois.append(boxes[kept])
        all_probs.append(s[kept])
        nums.append(len(kept))
    rois = np.concatenate(all_rois) if all_rois else np.zeros((0, 4))
    probs = np.concatenate(all_probs) if all_probs else np.zeros((0,))
    rois, probs = _t(rois, device=dev), _t(probs, device=dev)
    if return_rois_num:
        return rois, probs, _t(np.asarray(nums), device=dev)
    return rois, probs


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 detection loss for one scale (ref:
    operators/detection/yolov3_loss_op.h): coordinate BCE / L1 on
    responsible anchors, objectness BCE with an ignore band, class
    BCE. Decoding mirrors ``yolo_box``."""
    x = _t(x)
    dev = x.device
    gt_box = _t(gt_box, torch.float32, dev)   # [N, B, 4] cx,cy,w,h (0-1)
    gt_label = _t(gt_label, device=dev)       # [N, B]
    n, _, h, w = x.shape
    na = len(anchor_mask)
    an_all_np = np.asarray(anchors, np.float32).reshape(-1, 2)
    an_all = torch.as_tensor(an_all_np, device=dev)
    an = an_all_np[np.asarray(anchor_mask)]
    in_h, in_w = h * downsample_ratio, w * downsample_ratio
    pred = x.reshape(n, na, 5 + class_num, h, w)
    tx, ty = pred[:, :, 0], pred[:, :, 1]
    tw, th = pred[:, :, 2], pred[:, :, 3]
    tobj = pred[:, :, 4]
    tcls = pred[:, :, 5:]

    gx = gt_box[..., 0]                            # [N, B]
    gy = gt_box[..., 1]
    gw = gt_box[..., 2]
    gh = gt_box[..., 3]
    valid = (gw > 0) & (gh > 0)
    gi = torch.clamp((gx * w).to(torch.int64), 0, w - 1)
    gj = torch.clamp((gy * h).to(torch.int64), 0, h - 1)

    # responsible anchor: best wh-IoU among ALL anchors of this layer
    gwp = gw * in_w
    ghp = gh * in_h
    inter = (torch.minimum(gwp[..., None], an_all[:, 0])
             * torch.minimum(ghp[..., None], an_all[:, 1]))
    union = gwp[..., None] * ghp[..., None] \
        + an_all[:, 0] * an_all[:, 1] - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), -1)  # [N, B]
    mask_pos = torch.as_tensor([int(m) for m in anchor_mask], device=dev)
    resp = best[..., None] == mask_pos             # [N, B, na]
    responsible = resp & valid[..., None]

    # targets on the grid through flat scatters
    zeros = x.new_zeros((n, na, h, w), dtype=torch.float32)
    bb = torch.arange(n, device=dev)[:, None, None].expand(responsible.shape)
    aa = torch.arange(na, device=dev)[None, None, :].expand(
        responsible.shape)
    jj = gj[..., None].expand(responsible.shape)
    ii = gi[..., None].expand(responsible.shape)
    cell = (((bb * na + aa) * h + jj) * w + ii).reshape(-1)
    wgt = responsible.to(torch.float32)
    obj_mask = zeros.reshape(-1).scatter_reduce(
        0, cell, wgt.reshape(-1), reduce="amax").reshape(zeros.shape)
    score = (_t(gt_score, torch.float32, dev) if gt_score is not None
             else torch.ones_like(gx))

    def scatter(vals):
        v = vals[..., None].expand(responsible.shape) * wgt
        return zeros.reshape(-1).index_add(0, cell, v.reshape(-1)) \
            .reshape(zeros.shape)

    t_x = scatter(gx * w - gi)
    t_y = scatter(gy * h - gj)
    anw = torch.as_tensor(an[:, 0], device=dev).reshape(1, na, 1, 1)
    anh = torch.as_tensor(an[:, 1], device=dev).reshape(1, na, 1, 1)
    t_w = scatter(torch.log(torch.clamp(gwp, min=1e-9))) \
        - obj_mask * torch.log(anw)
    t_h = scatter(torch.log(torch.clamp(ghp, min=1e-9))) \
        - obj_mask * torch.log(anh)
    t_score = scatter(score)
    box_scale = 2.0 - scatter(gw * gh)             # small-box up-weight

    def bce(logit, target):
        return -(target * TF.logsigmoid(logit)
                 + (1 - target) * TF.logsigmoid(-logit))

    loss_xy = obj_mask * box_scale * (bce(tx, t_x) + bce(ty, t_y))
    loss_wh = obj_mask * box_scale * 0.5 * (torch.abs(tw - t_w)
                                            + torch.abs(th - t_h))

    # objectness: positives -> score; negatives with best-IoU above
    # ignore_thresh are excluded (the ignore band)
    px = (torch.sigmoid(tx)
          + torch.arange(w, device=dev).reshape(1, 1, 1, w)) / w
    py = (torch.sigmoid(ty)
          + torch.arange(h, device=dev).reshape(1, 1, h, 1)) / h
    pw = torch.exp(torch.clamp(tw, -10, 10)) * anw / in_w
    ph = torch.exp(torch.clamp(th, -10, 10)) * anh / in_h

    pl, pr = px - pw / 2, px + pw / 2
    pt, pb = py - ph / 2, py + ph / 2
    gl, gr = gx - gw / 2, gx + gw / 2
    gt_, gb = gy - gh / 2, gy + gh / 2

    ix = (torch.minimum(pr[..., None], gr[:, None, None, None, :])
          - torch.maximum(pl[..., None], gl[:, None, None, None, :]))
    iy = (torch.minimum(pb[..., None], gb[:, None, None, None, :])
          - torch.maximum(pt[..., None], gt_[:, None, None, None, :]))
    inter = torch.clamp(ix, min=0) * torch.clamp(iy, min=0)
    uni = (pw * ph)[..., None] + (gw * gh)[:, None, None, None, :] - inter
    iou = inter / torch.clamp(uni, min=1e-9)
    best_iou = torch.where(valid[:, None, None, None, :], iou, 0.0) \
        .amax(-1)
    noobj = (1.0 - obj_mask) * (best_iou < ignore_thresh)
    loss_obj = obj_mask * t_score * bce(tobj, torch.ones_like(tobj)) \
        + noobj * bce(tobj, torch.zeros_like(tobj))

    smooth = 1.0 / class_num if use_label_smooth else 0.0
    classes = torch.arange(class_num, device=dev)
    onehot = (gt_label[..., None] == classes).to(torch.float32)  # [N, B, C]
    onehot = onehot * (1.0 - smooth) + smooth / 2.0
    cls_cell = ((((bb * na + aa)[..., None] * class_num + classes) * h
                 + jj[..., None]) * w + ii[..., None]).reshape(-1)
    cls_vals = onehot[:, :, None].expand(responsible.shape + (class_num,)) \
        * wgt[..., None]
    cls_target = x.new_zeros((n * na * class_num * h * w,),
                             dtype=torch.float32).index_add(
        0, cls_cell, cls_vals.reshape(-1)).reshape(n, na, class_num, h, w)
    loss_cls = obj_mask[:, :, None] * bce(tcls, cls_target)

    return (loss_xy.sum((1, 2, 3)) + loss_wh.sum((1, 2, 3))
            + loss_obj.sum((1, 2, 3)) + loss_cls.sum((1, 2, 3, 4)))


def read_file(filename, name=None):
    """Raw file bytes as a uint8 tensor (ref: vision/ops.py read_file),
    on the device ``set_device`` chose."""
    with open(filename, "rb") as f:
        data = f.read()
    return _t(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG decode through PIL on the host (ref: vision/ops.py
    decode_jpeg). Returns CHW uint8 on ``x``'s device."""
    import io

    from PIL import Image

    img = Image.open(io.BytesIO(_host(x).tobytes()))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return _t(np.array(arr), device=_out_device(x))   # a writable copy
