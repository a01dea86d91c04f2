"""The port's detection ops (``paddle_tpu_torch/vision/ops.py`` and
``ops_fill.py``) against the JAX package's on the same numpy inputs:
kept boxes and indices exactly equal, float32 outputs within ``1e-6 +
1e-5 |jax|``, and a layer form's parameters carried across by state
dict key."""

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.vision import ops as jops  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.vision import ops as tops  # noqa: E402

ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdevice.set_current(None)


def _close(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(n, seed=0, size=100.0):
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, size, (n, 2))
    wh = rs.uniform(2, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,thr", [(60, 0.3), (300, 0.5), (300, 0.7)])
def test_nms_matches_jax(n, thr):
    boxes = _boxes(n)
    scores = np.random.RandomState(1).rand(n).astype(np.float32)
    got = tops.nms(_t(boxes), thr, scores=_t(scores))
    want = jops.nms(jnp.asarray(boxes), thr, scores=jnp.asarray(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nms_ties_keep_the_lower_index_first():
    """Equal scores sort stably (the lower index first), as
    ``jnp.argsort`` does; no scores keeps the input order."""
    boxes = _boxes(40, seed=2)
    scores = np.round(np.random.RandomState(3).rand(40), 1) \
        .astype(np.float32)
    got = tops.nms(_t(boxes), 0.4, scores=_t(scores))
    want = jops.nms(jnp.asarray(boxes), 0.4, scores=jnp.asarray(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tops.nms(_t(boxes), 0.4).numpy(),
        np.asarray(jops.nms(jnp.asarray(boxes), 0.4)))


def test_nms_categories_and_top_k_match_jax():
    boxes = _boxes(200, seed=4)
    scores = np.random.RandomState(5).rand(200).astype(np.float32)
    cats = np.random.RandomState(6).randint(0, 5, 200)
    for top_k in (None, 7):
        got = tops.nms(_t(boxes), 0.3, scores=_t(scores),
                       category_idxs=_t(cats), categories=list(range(5)),
                       top_k=top_k)
        want = jops.nms(jnp.asarray(boxes), 0.3, scores=jnp.asarray(scores),
                        category_idxs=jnp.asarray(cats),
                        categories=list(range(5)), top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _rois(seed=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 6, 20, 24).astype(np.float32)
    boxes = np.array([[1.0, 1.0, 30.0, 25.0], [3.5, 2.0, 9.0, 7.5],
                      [0.0, 0.0, 47.0, 39.0], [10.2, 4.4, 11.0, 5.0],
                      [-3.0, -2.0, 12.0, 50.0]], np.float32)
    return x, boxes, np.array([3, 2])


@pytest.mark.parametrize("ratio,aligned", [(2, True), (-1, True),
                                           (-1, False), (3, False)])
def test_roi_align_matches_jax(ratio, aligned):
    x, boxes, num = _rois()
    got = tops.roi_align(_t(x), _t(boxes), _t(num), (3, 4), 0.5, ratio,
                         aligned)
    want = jops.roi_align(jnp.asarray(x), jnp.asarray(boxes), num, (3, 4),
                          0.5, ratio, aligned)
    assert tuple(got.shape) == (5, 6, 3, 4)
    _close(got, want)


def test_roi_pool_and_psroi_pool_match_jax():
    x, boxes, num = _rois()
    _close(tops.roi_pool(_t(x), _t(boxes), _t(num), 3, 0.5),
           jops.roi_pool(jnp.asarray(x), jnp.asarray(boxes), num, 3, 0.5))
    xp = np.random.RandomState(8).randn(2, 2 * 3 * 2, 20, 24) \
        .astype(np.float32)
    _close(tops.psroi_pool(_t(xp), _t(boxes), _t(num), (3, 2), 0.5),
           jops.psroi_pool(jnp.asarray(xp), jnp.asarray(boxes), num,
                           (3, 2), 0.5))


@pytest.mark.parametrize("masked,stride,dilation",
                         [(False, 1, 1), (True, 1, 1), (True, 2, 2)])
def test_deform_conv2d_matches_jax(masked, stride, dilation):
    rs = np.random.RandomState(9)
    x = rs.randn(2, 4, 9, 11).astype(np.float32)
    w = rs.randn(5, 4, 3, 3).astype(np.float32) * 0.2
    b = rs.randn(5).astype(np.float32)
    oh = (9 + 2 - dilation * 2 - 1) // stride + 1
    ow = (11 + 2 - dilation * 2 - 1) // stride + 1
    off = rs.randn(2, 18, oh, ow).astype(np.float32) * 1.5
    mask = rs.rand(2, 9, oh, ow).astype(np.float32) if masked else None
    got = tops.deform_conv2d(_t(x), _t(off), _t(w), _t(b), stride, 1,
                             dilation, mask=None if mask is None
                             else _t(mask))
    want = jops.deform_conv2d(jnp.asarray(x), jnp.asarray(off),
                              jnp.asarray(w), jnp.asarray(b), stride, 1,
                              dilation, mask=None if mask is None
                              else jnp.asarray(mask))
    _close(got, want)


def test_deform_conv2d_layer_matches_jax():
    from paddle_tpu.vision.ops import DeformConv2D as JD
    from paddle_tpu_torch.interop import load_reference_state
    jl, tl = JD(4, 6, 3, padding=1), tops.DeformConv2D(4, 6, 3, padding=1)
    load_reference_state(tl, {k: np.asarray(v) for k, v in
                              jl.state_dict().items()})
    rs = np.random.RandomState(10)
    x = rs.randn(1, 4, 7, 7).astype(np.float32)
    off = rs.randn(1, 18, 7, 7).astype(np.float32)
    _close(tl(_t(x), _t(off)), jl(jnp.asarray(x), jnp.asarray(off)))


def test_yolo_box_matches_jax():
    rs = np.random.RandomState(11)
    anchors = [10, 13, 16, 30, 33, 23]
    x = rs.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    size = np.array([[320, 416], [200, 160]], np.int64)
    for clip in (True, False):
        got = tops.yolo_box(_t(x), _t(size), anchors, 4, 0.4, 32, clip, 1.1)
        want = jops.yolo_box(jnp.asarray(x), jnp.asarray(size), anchors, 4,
                             0.4, 32, clip, 1.1)
        _close(got[0], want[0], "boxes")
        _close(got[1], want[1], "scores")


@pytest.mark.parametrize("n", [4])
def test_yolo_loss_matches_jax(n):
    """The JAX ``yolo_loss`` broadcasts an unused ``[n, 1, 1]`` index to
    ``[n, boxes, anchors, classes]``, which only 1 or ``class_num``
    images fit (ROADMAP Queue C), so the batch here is 4 images of 4
    classes; the port takes any batch (3 images below)."""
    rs = np.random.RandomState(12)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    mask = [0, 1, 2]
    x = rs.randn(n, 3 * (5 + 4), 6, 6).astype(np.float32)
    gt = np.concatenate([rs.uniform(0.1, 0.9, (n, 4, 2)),
                         rs.uniform(0.05, 0.4, (n, 4, 2))], -1) \
        .astype(np.float32)
    gt[0, 3] = 0.0                       # an empty slot
    lab = rs.randint(0, 4, (n, 4))
    score = rs.uniform(0.5, 1.0, (n, 4)).astype(np.float32)
    for smooth, sc in ((True, None), (False, score)):
        got = tops.yolo_loss(_t(x), _t(gt), _t(lab), anchors, mask, 4, 0.5,
                             32, gt_score=None if sc is None else _t(sc),
                             use_label_smooth=smooth)
        want = jops.yolo_loss(jnp.asarray(x), jnp.asarray(gt),
                              jnp.asarray(lab), anchors, mask, 4, 0.5, 32,
                              gt_score=None if sc is None
                              else jnp.asarray(sc), use_label_smooth=smooth)
        assert tuple(got.shape) == (n,)
        _close(got, want)
    odd = tops.yolo_loss(_t(x[:1].repeat(3, 0)), _t(gt[:1].repeat(3, 0)),
                         _t(lab[:1].repeat(3, 0)), anchors, mask, 4, 0.5, 32)
    assert tuple(odd.shape) == (3,) and torch.isfinite(odd).all()


def test_generate_proposals_matches_jax():
    rs = np.random.RandomState(13)
    a, h, w = 3, 6, 8
    scores = rs.rand(2, a, h, w).astype(np.float32)
    deltas = (rs.randn(2, 4 * a, h, w) * 0.2).astype(np.float32)
    anchors = np.concatenate([_boxes(h * w * a, seed=14, size=60.0)])
    var = np.ones_like(anchors)
    size = np.array([[64, 80], [50, 70]], np.float32)
    got = tops.generate_proposals(_t(scores), _t(deltas), _t(size),
                                  _t(anchors), _t(var), pre_nms_top_n=100,
                                  post_nms_top_n=20, nms_thresh=0.5,
                                  return_rois_num=True)
    want = jops.generate_proposals(scores, deltas, size, anchors, var,
                                   pre_nms_top_n=100, post_nms_top_n=20,
                                   nms_thresh=0.5, return_rois_num=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    _close(got[0], want[0], "rois")
    _close(got[1], want[1], "probs")


def test_distribute_fpn_proposals_matches_jax():
    rois = _boxes(50, seed=15, size=400.0)
    got = tops.distribute_fpn_proposals(_t(rois), 2, 5, 4, 224)
    want = jops.distribute_fpn_proposals(rois, 2, 5, 4, 224)
    assert len(got[0]) == len(want[0]) == 4
    for g, w_ in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_temporal_shift_matches_jax(fmt):
    x = np.random.RandomState(16).randn(6, 8, 3, 4).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(
        tops.temporal_shift(_t(x), 3, 0.25, fmt).numpy(),
        np.asarray(jops.temporal_shift(jnp.asarray(x), 3, 0.25, fmt)))


def test_roi_layers_are_the_functions():
    """The layer forms give their functions' outputs (the functions are
    held to the JAX package's above)."""
    x, boxes, num = _rois()
    args = (_t(x), _t(boxes), _t(num))
    torch.testing.assert_close(tops.RoIAlign(3, 0.5)(*args),
                               tops.roi_align(*args, 3, 0.5), rtol=0,
                               atol=0)
    torch.testing.assert_close(tops.RoIPool(3, 0.5)(*args),
                               tops.roi_pool(*args, 3, 0.5), rtol=0, atol=0)
    xp = _t(np.random.RandomState(8).randn(2, 2 * 9, 20, 24)
            .astype(np.float32))
    torch.testing.assert_close(tops.PSRoIPool(3, 0.5)(xp, *args[1:]),
                               tops.psroi_pool(xp, *args[1:], 3, 0.5),
                               rtol=0, atol=0)


def test_read_file_and_decode_jpeg_match_jax(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(17)
    img = rs.randint(0, 255, (12, 10, 3), dtype=np.uint8)
    path = str(tmp_path / "x.jpg")
    pil.fromarray(img).save(path)
    raw = tops.read_file(path)
    np.testing.assert_array_equal(raw.numpy(),
                                  np.asarray(jops.read_file(path)))
    for mode in ("unchanged", "gray", "rgb"):
        np.testing.assert_array_equal(
            tops.decode_jpeg(raw, mode).numpy(),
            np.asarray(jops.decode_jpeg(jops.read_file(path), mode)))
