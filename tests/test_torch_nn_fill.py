"""The port's ``nn/functional_fill.py`` and ``nn/layers/fill_r4.py``
against the JAX package's (float32 on the CPU, the same numpy inputs,
the JAX layers' randomized weights carried across).

Outputs and the gradients of ``sum(out * r)`` with respect to every
float input (and every parameter) are held to 1e-5 (summation order
only); max-pool masks, unpooled maps, ``gather_tree``, the class
sampler and beam search's ids, parents and lengths exactly; the
dropout3d mask bit for bit and ``rrelu``'s slopes to 2 float32 ulps
(XLA fuses the draw's scale and shift), both from threefry on the same
key."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from torch_nn_common import both, carry, check_layer, close, rand  # noqa

TOL = 1e-5


def _ints(*shape, hi, seed=0, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape)


def _pm1(n, seed=0):
    return np.where(np.random.RandomState(seed).rand(n) > 0.5, 1.0,
                    -1.0).astype(np.float32)


def _probs(*shape, seed=0):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32) + 0.1
    return x / x.sum(-1, keepdims=True)


def _csr(b, h, s, seed=0):
    """A random CSR pattern a (b, h): each row attends to itself and up
    to two other columns."""
    rs = np.random.RandomState(seed)
    offs, cols = [], []
    for _ in range(b * h):
        o, c = [0], []
        for r in range(s):
            row = sorted({r, *rs.randint(0, s, 2).tolist()})
            c += row
            o.append(len(c))
        offs.append(o)
        cols.append(c)
    n = max(len(c) for c in cols)
    cols = [c + [0] * (n - len(c)) for c in cols]
    return (np.asarray(offs, np.int32).reshape(b, h, s + 1),
            np.asarray(cols, np.int32).reshape(b, h, n))


# name -> (fn(F, *args), inputs, indices of the float inputs to
# differentiate)
CASES = {
    "conv1d_transpose": (
        lambda F, x, w, b: F.conv1d_transpose(x, w, b, stride=2, padding=1,
                                              output_padding=1),
        lambda: [rand(2, 3, 7), rand(3, 4, 3, seed=1),
                 rand(4, seed=2)], (0, 1, 2)),
    "conv1d_transpose_nlc_size": (
        lambda F, x, w: F.conv1d_transpose(x, w, stride=2,
                                           output_size=[12],
                                           data_format="NLC"),
        lambda: [rand(2, 7, 3), rand(3, 2, 3, seed=1)], (0, 1)),
    "conv1d_transpose_dilation": (
        lambda F, x, w: F.conv1d_transpose(x, w, dilation=2),
        lambda: [rand(2, 4, 5), rand(4, 3, 3, seed=1)], (0, 1)),
    "diag_embed": (lambda F, x: F.diag_embed(x), lambda: [rand(2, 3, 4)],
                   (0,)),
    "diag_embed_offset_dims": (
        lambda F, x: F.diag_embed(x, offset=1, dim1=0, dim2=2),
        lambda: [rand(2, 3, 4)], (0,)),
    "diag_embed_negative": (
        lambda F, x: F.diag_embed(x, offset=-2, dim1=-1, dim2=1),
        lambda: [rand(3, 4)], (0,)),
    "zeropad2d": (lambda F, x: F.zeropad2d(x, [1, 2, 0, 3]),
                  lambda: [rand(1, 2, 3, 4)], (0,)),
    "zeropad2d_nhwc": (lambda F, x: F.zeropad2d(x, 1, "NHWC"),
                       lambda: [rand(1, 3, 4, 2)], (0,)),
    "bilinear": (lambda F, a, b, w, c: F.bilinear(a, b, w, c),
                 lambda: [rand(6, 3), rand(6, 4, seed=1),
                          rand(5, 3, 4, seed=2), rand(5, seed=3)],
                 (0, 1, 2, 3)),
    "adaptive_max_pool3d": (lambda F, x: F.adaptive_max_pool3d(x, (2, 2, 3)),
                            lambda: [rand(2, 3, 4, 4, 6)], (0,)),
    "cosine_embedding_loss": (
        lambda F, a, b, y: F.cosine_embedding_loss(a, b, y, margin=0.2),
        lambda: [rand(8, 5), rand(8, 5, seed=1), _pm1(8)], (0, 1)),
    "cosine_embedding_loss_none": (
        lambda F, a, b, y: F.cosine_embedding_loss(a, b, y,
                                                   reduction="none"),
        lambda: [rand(8, 5), rand(8, 5, seed=1), _pm1(8, 1)], (0, 1)),
    "hinge_embedding_loss": (
        lambda F, x, y: F.hinge_embedding_loss(x, y, margin=0.5),
        lambda: [rand(4, 6), _pm1(24).reshape(4, 6)], (0,)),
    "margin_ranking_loss": (
        lambda F, a, b, y: F.margin_ranking_loss(a, b, y, 0.1, "sum"),
        lambda: [rand(10), rand(10, seed=1), _pm1(10)], (0, 1)),
    "multi_label_soft_margin_loss": (
        lambda F, x, y, w: F.multi_label_soft_margin_loss(x, y, w),
        lambda: [rand(4, 6), (_pm1(24).reshape(4, 6) > 0).astype(
            np.float32), rand(6, seed=3)], (0,)),
    "triplet_margin_loss": (
        lambda F, a, p, n: F.triplet_margin_loss(a, p, n, p=1.5),
        lambda: [rand(6, 4), rand(6, 4, seed=1), rand(6, 4, seed=2)],
        (0, 1, 2)),
    "triplet_margin_loss_swap": (
        lambda F, a, p, n: F.triplet_margin_loss(a, p, n, swap=True,
                                                 reduction="none"),
        lambda: [rand(6, 4), rand(6, 4, seed=1), rand(6, 4, seed=2)],
        (0, 1, 2)),
    "triplet_margin_with_distance_loss": (
        lambda F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, margin=0.5, swap=True),
        lambda: [rand(6, 4), rand(6, 4, seed=1), rand(6, 4, seed=2)],
        (0, 1, 2)),
    "triplet_margin_with_custom_distance": (
        lambda F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, distance_function=lambda u, v: ((u - v) ** 2).sum(-1)),
        lambda: [rand(6, 4), rand(6, 4, seed=1), rand(6, 4, seed=2)],
        (0, 1, 2)),
    "dice_loss": (lambda F, x, y: F.dice_loss(x, y),
                  lambda: [_probs(4, 5, 3), _ints(4, 5, 1, hi=3)], (0,)),
    "npair_loss": (lambda F, a, p, y: F.npair_loss(a, p, y),
                   lambda: [rand(6, 4), rand(6, 4, seed=1),
                            np.array([0, 1, 0, 2, 1, 2])], (0, 1)),
    "sigmoid_focal_loss": (
        lambda F, x, y: F.sigmoid_focal_loss(x, y, normalizer=None),
        lambda: [rand(5, 3), (rand(5, 3, seed=1) > 0).astype(np.float32)],
        (0,)),
    "sigmoid_focal_loss_normalized": (
        lambda F, x, y, n: F.sigmoid_focal_loss(x, y, n, 0.5, 1.5, "mean"),
        lambda: [rand(5, 3), (rand(5, 3, seed=1) > 0).astype(np.float32),
                 np.asarray([4.0], np.float32)], (0,)),
    "hsigmoid_loss": (
        lambda F, x, y, w, b: F.hsigmoid_loss(x, y, 7, w, b),
        lambda: [rand(5, 4), _ints(5, hi=7), rand(6, 4, seed=1),
                 rand(6, seed=2)], (0, 2, 3)),
    "hsigmoid_loss_custom_tree": (
        lambda F, x, y, w, t, c: F.hsigmoid_loss(x, y, 4, w, None, t, c),
        lambda: [rand(3, 4), _ints(3, hi=4), rand(3, 4, seed=1),
                 np.array([[0, 1, -1], [0, 2, -1], [0, 1, 2]]),
                 np.array([[1, 0, 0], [0, 1, 0], [1, 1, 0]])], (0, 2)),
    "margin_cross_entropy": (
        lambda F, x, y: F.margin_cross_entropy(x, y, scale=8.0),
        lambda: [np.tanh(rand(4, 6)), _ints(4, hi=6)], (0,)),
    "margin_cross_entropy_softmax": (
        lambda F, x, y: F.margin_cross_entropy(
            x, y, 0.9, 0.3, 0.1, 4.0, return_softmax=True,
            reduction="none"),
        lambda: [np.tanh(rand(4, 6)), _ints(4, hi=6, seed=1)], (0,)),
    "ctc_loss": (
        lambda F, lp, lab, il, ll: F.ctc_loss(lp, lab, il, ll),
        lambda: [rand(9, 3, 5), _ints(3, 4, hi=5, lo=1),
                 np.array([9, 7, 8]), np.array([4, 2, 3])], (0,)),
    "ctc_loss_sum_blank_repeats": (
        lambda F, lp, lab, il, ll: F.ctc_loss(lp, lab, il, ll, blank=4,
                                              reduction="sum"),
        lambda: [rand(8, 2, 5), np.array([[1, 1, 2], [3, 3, 3]]),
                 np.array([8, 8]), np.array([3, 2])], (0,)),
    "ctc_loss_none_norm": (
        lambda F, lp, lab, il, ll: F.ctc_loss(lp, lab, il, ll,
                                              reduction="none",
                                              norm_by_times=True),
        lambda: [rand(6, 2, 4), np.array([[1, 2], [2, 0]]),
                 np.array([6, 5]), np.array([2, 1])], (0,)),
    "sparse_attention": (
        lambda F, q, k, v, o, c: F.sparse_attention(q, k, v, o, c),
        lambda: [rand(2, 2, 5, 4), rand(2, 2, 5, 4, seed=1),
                 rand(2, 2, 5, 4, seed=2), *_csr(2, 2, 5)], (0, 1, 2)),
    "sparse_attention_padding": (
        lambda F, q, k, v, o, c, kp: F.sparse_attention(
            q, k, v, o, c, key_padding_mask=kp),
        lambda: [rand(1, 2, 4, 4), rand(1, 2, 4, 4, seed=1),
                 rand(1, 2, 4, 4, seed=2), *_csr(1, 2, 4, seed=3),
                 np.array([[1, 1, 1, 0]], np.float32)], (0, 1, 2)),
    "relu_": (lambda F, x: F.relu_(x), lambda: [rand(3, 4)], (0,)),
    "elu_": (lambda F, x: F.elu_(x, 0.7), lambda: [rand(3, 4)], (0,)),
    "softmax_": (lambda F, x: F.softmax_(x, axis=0), lambda: [rand(3, 4)],
                 (0,)),
    "tanh_": (lambda F, x: F.tanh_(x), lambda: [rand(3, 4)], (0,)),
}


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_fill_matches_jax(name):
    fn, make, diff = CASES[name]
    args = make()
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(np.array(a)) for a in args]
    for i in diff:
        targs[i].requires_grad_(True)
    jout = _flat(fn(JF, *jargs))
    tout = _flat(fn(TF, *targs))
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        close(a, b, TOL, "output")
    rs = [rand(*np.shape(o), seed=50 + i) for i, o in enumerate(jout)]

    def scalar(*xs):
        full = list(jargs)
        for i, x in zip(diff, xs):
            full[i] = x
        return sum(jnp.sum(o * r) for o, r in zip(_flat(fn(JF, *full)), rs))
    jg = jax.jit(jax.grad(scalar, argnums=tuple(range(len(diff)))))(
        *[jargs[i] for i in diff])
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(tout, rs)) \
        .backward()
    for i, g in zip(diff, jg):
        close(targs[i].grad, g, TOL, f"grad of input {i}")


@pytest.mark.parametrize("nd, kernel, stride, padding, shape", [
    (1, 3, 2, 1, (2, 3, 9)),
    (1, 2, None, 0, (1, 2, 8)),
    (2, 2, None, 0, (2, 3, 6, 6)),
    (2, 3, 2, 1, (2, 2, 7, 5)),
    (2, (3, 2), (1, 2), (1, 0), (1, 2, 5, 6)),
    (3, 2, None, 0, (1, 2, 4, 4, 4)),
    (3, 3, 2, 1, (1, 2, 5, 4, 6)),
])
def test_max_pool_mask_and_unpool_exact(nd, kernel, stride, padding,
                                        shape):
    """Values, masks (int32 flat indices) and the unpooled maps equal
    the JAX package's; the unpool's gradient too (duplicated values
    included)."""
    x = rand(*shape)
    x[..., 0] = x[..., 1]     # ties: the window's first maximum wins
    pool = {1: "max_pool1d", 2: "max_pool2d", 3: "max_pool3d"}[nd]
    unpool = {1: "max_unpool1d", 2: "max_unpool2d", 3: "max_unpool3d"}[nd]
    jv, jm = getattr(JF, pool)(jnp.asarray(x), kernel, stride, padding,
                               return_mask=True)
    tv, tm = getattr(TF, pool)(torch.from_numpy(x), kernel, stride,
                               padding, return_mask=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.dtype == torch.int32 and jm.dtype == jnp.int32
    ju = getattr(JF, unpool)(jv, jm, kernel, stride, padding,
                             output_size=shape)
    tvg = tv.detach().requires_grad_(True)
    tu = getattr(TF, unpool)(tvg, tm, kernel, stride, padding,
                             output_size=shape)
    np.testing.assert_array_equal(tu.detach().numpy(), np.asarray(ju))
    r = rand(*shape, seed=9)
    jg = jax.grad(lambda v: jnp.sum(getattr(JF, unpool)(
        v, jm, kernel, stride, padding, output_size=shape) * r))(jv)
    (tu * torch.from_numpy(r)).sum().backward()
    close(tvg.grad, jg, TOL)


def test_conv1d_transpose_groups_match_torch():
    """Groups (which the JAX package's ``conv2d_transpose`` refuses:
    ROADMAP Queue C) against torch's own transposed convolution."""
    x, w = torch.from_numpy(rand(2, 4, 5)), torch.from_numpy(rand(4, 3, 3))
    close(TF.conv1d_transpose(x, w, stride=2, padding=1, groups=2),
          torch.nn.functional.conv_transpose1d(x, w, stride=2, padding=1,
                                               groups=2).numpy())


def test_max_pool_return_mask_refuses_channels_last():
    x = torch.from_numpy(rand(1, 4, 4, 2))
    with pytest.raises(ValueError, match="NCHW only"):
        TF.max_pool2d(x, 2, return_mask=True, data_format="NHWC")
    with pytest.raises(NotImplementedError, match="max_pool3d"):
        TF.adaptive_max_pool3d(torch.from_numpy(rand(1, 1, 2, 2, 2)), 1,
                               return_mask=True)


@pytest.mark.parametrize("fmt", ["NCDHW", "NDHWC"])
def test_dropout3d_draws_the_jax_mask(fmt):
    x = rand(4, 6, 2, 3, 3) if fmt == "NCDHW" else rand(4, 2, 3, 3, 6)
    jrng.seed(11)
    trng.seed(11)
    want = np.asarray(JF.dropout3d(jnp.asarray(x), 0.4, data_format=fmt))
    got = TF.dropout3d(torch.from_numpy(x), 0.4, data_format=fmt).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).mean() < 1
    assert TF.dropout3d(torch.from_numpy(x), 0.4, training=False) \
        .numpy() is not None
    jrng.seed(11)
    trng.seed(11)
    jl, tl = both("Dropout3D", 0.4, fmt)
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl(jnp.asarray(x))))
    tl.eval()
    np.testing.assert_array_equal(tl(torch.from_numpy(x)).numpy(), x)


def test_rrelu_draws_the_jax_slopes():
    x = -np.abs(rand(4, 64)) - 0.1
    jrng.seed(3)
    trng.seed(3)
    want = np.asarray(JF.rrelu(jnp.asarray(x), 0.1, 0.3))
    got = TF.rrelu(torch.from_numpy(x), 0.1, 0.3).numpy()
    np.testing.assert_array_max_ulp(got, want, maxulp=2)
    close(TF.rrelu(torch.from_numpy(x), training=False),
          JF.rrelu(jnp.asarray(x), training=False))


@pytest.mark.parametrize("seed", [0, 7])
def test_class_center_sample_draws_jax_classes(seed):
    y = np.array([3, 17, 3, 42, 8, 17])
    jrng.seed(seed)
    trng.seed(seed)
    jy, js = JF.class_center_sample(y, 64, 12)
    ty, ts = TF.class_center_sample(torch.from_numpy(y), 64, 12)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert len(ts) == 12 and set(y) <= set(ts.tolist())


def test_gather_tree_exact():
    ids = _ints(5, 2, 3, hi=9, seed=1)
    parents = _ints(5, 2, 3, hi=3, seed=2)
    np.testing.assert_array_equal(
        TF.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
        .numpy(), np.asarray(JF.gather_tree(jnp.asarray(ids),
                                            jnp.asarray(parents))))


# -- the layer classes --------------------------------------------------------

LAYERS = [("LogSigmoid", (), [rand(2, 5)]),
          ("Silu", (), [rand(2, 5)]),
          ("Softmax2D", (), [rand(2, 3, 4, 4)]),
          ("Softmax2D", (), [rand(3, 4, 2)]),
          ("ChannelShuffle", (2,), [rand(2, 6, 3, 3)]),
          ("ChannelShuffle", (3, "NHWC"), [rand(2, 3, 3, 6)]),
          ("Conv1DTranspose", (3, 4, 3, 2, 1, 1), [rand(2, 3, 6)]),
          ("Conv1DTranspose", (4, 6, 2, 1, 0, 0, 1, 2), [rand(1, 4, 5)]),
          ("Conv3DTranspose", (2, 3, 2, 2), [rand(1, 2, 3, 3, 3)]),
          ("Conv3DTranspose", (2, 4, 3, 1, 1), [rand(1, 2, 4, 3, 3)]),
          ("InstanceNorm1D", (3,), [rand(2, 3, 7)]),
          ("InstanceNorm3D", (2,), [rand(2, 2, 3, 4, 5)]),
          ("AdaptiveMaxPool3D", (2,), [rand(1, 2, 4, 4, 4)]),
          ("CosineEmbeddingLoss", (0.1,), [rand(6, 4), rand(6, 4, seed=1),
                                           _pm1(6)]),
          ("HingeEmbeddingLoss", (0.7, "sum"), [rand(5), _pm1(5)]),
          ("MarginRankingLoss", (0.2,), [rand(5), rand(5, seed=1),
                                         _pm1(5)]),
          ("MultiLabelSoftMarginLoss", (), [rand(3, 4), (rand(
              3, 4, seed=1) > 0).astype(np.float32)]),
          ("TripletMarginLoss", (0.5, 3.0), [rand(4, 3), rand(4, 3, seed=1),
                                             rand(4, 3, seed=2)]),
          ("TripletMarginWithDistanceLoss", (None, 0.3, True),
           [rand(4, 3), rand(4, 3, seed=1), rand(4, 3, seed=2)]),
          ("HSigmoidLoss", (4, 6), [rand(5, 4), _ints(5, hi=6)]),
          ("CTCLoss", (0, "sum"), [rand(7, 2, 4), np.array([[1, 2, 2],
                                                            [3, 1, 0]]),
                                   np.array([7, 6]), np.array([3, 2])])]


@pytest.mark.parametrize("name, args, inputs", LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYERS)])
def test_fill_layers_match_jax(name, args, inputs):
    jl, tl = both(name, *args)
    check_layer(jl, tl, inputs)


@pytest.mark.parametrize("name", ["MaxUnPool1D", "MaxUnPool2D",
                                  "MaxUnPool3D"])
def test_unpool_layers_invert_pooling_like_jax(name):
    nd = int(name[-2])
    shape = (2, 3) + (4,) * nd
    x = rand(*shape)
    pool = {1: "max_pool1d", 2: "max_pool2d", 3: "max_pool3d"}[nd]
    jv, jm = getattr(JF, pool)(jnp.asarray(x), 2, return_mask=True)
    tv, tm = getattr(TF, pool)(torch.from_numpy(x), 2, return_mask=True)
    jl, tl = both(name, 2)
    np.testing.assert_array_equal(tl(tv, tm).numpy(),
                                  np.asarray(jl(jv, jm)))


def test_parameter_list_and_rnn_cell_base():
    tl = tnn.ParameterList([torch.ones(2), np.zeros(3, np.float32)])
    jl = jnn.ParameterList([jnp.ones(2), np.zeros(3, np.float32)])
    assert len(tl) == len(jl) == 2
    assert [tuple(p.shape) for p in tl] == [tuple(p.shape) for p in jl]
    tl.append(torch.full((4,), 2.0))
    assert len(tl) == 3 and tl[2].shape == (4,)
    assert sorted(dict(tl.named_parameters())) == ["0", "1", "2"]
    assert tnn.RNNCellBase is tnn.layers.rnn.RNNCellBase


@pytest.mark.parametrize("shape, dim, iters", [((6, 4), 0, 1),
                                               ((3, 4, 5), 1, 3)])
def test_spectral_norm_layer_matches_jax(shape, dim, iters):
    jl, tl = both("SpectralNorm", shape, dim, iters)
    # threefry's bits are equal; XLA's and torch's erfinv differ by a
    # few ulps
    for k in ("weight_u", "weight_v"):
        np.testing.assert_allclose(getattr(tl, k).numpy(),
                                   np.asarray(getattr(jl, k)), rtol=1e-6)
    w = rand(*shape)
    check_layer(jl, tl, [w], perturb=False)


@pytest.mark.parametrize("cell, beam, end", [("GRUCell", 3, 2),
                                             ("LSTMCell", 4, 5),
                                             ("SimpleRNNCell", 2, 0)])
def test_beam_search_decode_exact(cell, beam, end):
    """``dynamic_decode`` with a ``BeamSearchDecoder`` over each RNN
    cell: token ids, parents (through ``gather_tree``) and lengths equal
    the JAX package's exactly, batch-major and time-major."""
    vocab, hidden, batch = 7, 8, 2
    jc, tc = both(cell, 6, hidden)
    carry(jc, tc)
    je, te = both("Embedding", vocab, 6)
    carry(je, te)
    jo, to = both("Linear", hidden, vocab)
    carry(jo, to, scale=2.0)
    out = {}
    for name, c, e, o, nn in (("jax", jc, je, jo, jnn),
                              ("torch", tc, te, to, tnn)):
        dec = nn.BeamSearchDecoder(c, start_token=1, end_token=end,
                                   beam_size=beam, embedding_fn=e,
                                   output_fn=o)
        init = c.get_initial_states(batch)
        for major in (False, True):
            ids, lengths = nn.dynamic_decode(dec, inits=init,
                                             max_step_num=6,
                                             output_time_major=major)
            out[(name, major)] = (np.asarray(ids), np.asarray(lengths))
    for major in (False, True):
        (ji, jlen), (ti, tlen) = out[("jax", major)], out[("torch", major)]
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tlen, jlen)
    assert out[("torch", False)][0].shape[:2] == (batch, beam)
    with pytest.raises(ValueError, match="initial states"):
        tnn.dynamic_decode(tnn.BeamSearchDecoder(tc, 1, end, beam), inits=())
