"""The port's nn layers (``paddle_tpu_torch/nn/layers/{common,conv,
norm,loss,pooling}.py``), the functional ops under them and the layer
API (``nn/layer.py``) against the JAX package's, on the same numpy
inputs with the JAX layer's randomized weights carried across by state
dict key: the counterpart of ``tests/test_layers.py``. Tolerance 1e-5 on
outputs, buffers and parameter gradients: both sides compute in float32
on the CPU and differ in summation order only. Random draws (Gumbel
noise) are compared bit for bit."""

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
from torch_nn_common import TOL, both, check_layer, close, rand  # noqa

X4 = (2, 3, 8, 8)

ACTIVATIONS = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "GELU", "SiLU", "Swish",
               "Mish", "Hardswish", "Hardsigmoid", "Softplus", "Softsign",
               "ELU", "SELU", "LeakyReLU", "Softmax", "LogSoftmax",
               "Identity", "Flatten"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_parameterless_layers_match_jax(name):
    jl, tl = both(name)
    check_layer(jl, tl, [rand(*X4, scale=3)])


@pytest.mark.parametrize("args", [(), (0.2,)], ids=["default", "slope"])
def test_act_layer_positional_args(args):
    jl, tl = both("ELU", *args)
    check_layer(jl, tl, [rand(4, 5, scale=2)])


@pytest.mark.parametrize("n", [1, 3])
def test_prelu_matches_jax(n):
    jl, tl = both("PReLU", n)
    check_layer(jl, tl, [rand(*X4, scale=2)])


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pad2d_matches_jax(mode, fmt):
    jl, tl = both("Pad2D", [1, 2, 2, 1], mode=mode, value=0.5,
                  data_format=fmt)
    check_layer(jl, tl, [rand(2, 4, 5, 3)])


UPSAMPLE = [dict(size=(13, 6), mode="nearest"),
            dict(scale_factor=2, mode="nearest"),
            dict(size=(13, 6), mode="bilinear"),
            dict(size=(3, 5), mode="bilinear"),
            dict(size=(11, 9), mode="bicubic"),
            dict(size=(4, 3), mode="bicubic"),
            dict(size=(13, 6), mode="bilinear", align_corners=True),
            dict(scale_factor=3, mode="bilinear", align_corners=True)]


@pytest.mark.parametrize("kw", UPSAMPLE, ids=[str(i) for i in
                                              range(len(UPSAMPLE))])
def test_upsample_matches_jax(kw):
    jl, tl = both("Upsample", **kw)
    check_layer(jl, tl, [rand(2, 3, 7, 8)])


CONVS = [("Conv1D", (3, 4, 3), dict(stride=2, padding=1), (2, 3, 11)),
         ("Conv1D", (3, 4, 3), dict(data_format="NLC"), (2, 11, 3)),
         ("Conv2D", (3, 8, 3), dict(stride=2, padding=1), (2, 3, 9, 9)),
         ("Conv2D", (4, 6, 3), dict(groups=2, dilation=2), (2, 4, 9, 9)),
         ("Conv2D", (3, 5, (3, 2)), dict(padding="SAME", stride=2),
          (2, 3, 8, 7)),
         ("Conv2D", (3, 5, 3), dict(data_format="NHWC", padding=1),
          (2, 6, 6, 3)),
         ("Conv3D", (2, 4, 3), dict(padding=1), (1, 2, 5, 6, 5)),
         ("Conv2DTranspose", (4, 6, 3),
          dict(stride=2, padding=1, output_padding=1), (2, 4, 5, 5)),
         ("Conv2DTranspose", (4, 6, (3, 2)), dict(stride=(2, 1)),
          (2, 4, 4, 5))]


@pytest.mark.parametrize("name, args, kw, shape", CONVS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVS)])
def test_conv_matches_jax(name, args, kw, shape):
    jl, tl = both(name, *args, **kw)
    assert tuple(tl.weight.shape) == tuple(jl.weight.shape)
    check_layer(jl, tl, [rand(*shape)])


POOLS = [("MaxPool1D", (3, 2, 1), (2, 3, 10)),
         ("AvgPool1D", (3, 2, 1), (2, 3, 10)),
         ("MaxPool2D", (3, 2, 1), X4),
         ("AvgPool2D", (3, 2, 1), X4),
         ("AvgPool2D", (3, 2, 1, False), X4),
         ("MaxPool2D", (2,), X4),
         ("MaxPool3D", (2, 2, 1), (1, 2, 5, 6, 4)),
         ("AvgPool3D", (3, 2, 1, False), (1, 2, 5, 6, 4)),
         ("AdaptiveAvgPool1D", (5,), (2, 3, 10)),
         ("AdaptiveMaxPool1D", (2,), (2, 3, 10)),
         ("AdaptiveAvgPool2D", (4,), X4),
         ("AdaptiveAvgPool2D", ((3, 5),), (2, 3, 7, 9)),
         ("AdaptiveAvgPool2D", (1,), (2, 3, 7, 7)),
         ("AdaptiveMaxPool2D", (2,), X4),
         ("AdaptiveAvgPool3D", (2,), (1, 2, 4, 6, 4))]


@pytest.mark.parametrize("name, args, shape", POOLS,
                         ids=[f"{p[0]}-{i}" for i, p in enumerate(POOLS)])
def test_pool_matches_jax(name, args, shape):
    jl, tl = both(name, *args)
    check_layer(jl, tl, [rand(*shape)])


def test_adaptive_avg_pool_nhwc_bins():
    x = rand(2, 7, 9, 3)
    close(TF.adaptive_avg_pool2d(torch.from_numpy(x), (3, 5), "NHWC"),
          JF.adaptive_avg_pool2d(jnp.asarray(x), (3, 5), "NHWC"))


NORMS = [("BatchNorm1D", (5,), (6, 5)),
         ("BatchNorm1D", (3,), (4, 3, 7)),
         ("BatchNorm2D", (3,), X4),
         ("BatchNorm3D", (2,), (2, 2, 3, 4, 3)),
         ("SyncBatchNorm", (3,), X4),
         ("GroupNorm", (2, 4), (2, 4, 5, 5)),
         ("InstanceNorm2D", (3,), X4),
         ("LayerNorm", (8,), (2, 3, 8))]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name, args, shape", NORMS,
                         ids=[f"{n[0]}-{i}" for i, n in enumerate(NORMS)])
def test_norm_matches_jax(name, args, shape, training):
    jl, tl = both(name, *args)
    check_layer(jl, tl, [rand(*shape, scale=2) + 1], training=training)


def test_batchnorm_running_stats_follow_paddle_momentum():
    """running = 0.9 running + 0.1 batch over three training steps, the
    buffers named _mean / _variance, then eval on them."""
    jl, tl = both("BatchNorm2D", 3)
    assert [k for k, _ in tl.named_buffers()] == ["_mean", "_variance"]
    for i in range(3):
        x = rand(*X4, seed=i, scale=2) + i
        jl(jnp.asarray(x))
        tl(torch.from_numpy(x))
    close(tl._mean, jl._mean)
    close(tl._variance, jl._variance)
    tl.eval()
    jl.eval()
    x = rand(*X4, seed=5)
    close(tl(torch.from_numpy(x)), jl(jnp.asarray(x)))


def test_convert_sync_batchnorm():
    net = tnn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4))
    net[1]._mean.fill_(0.5)
    tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(net[1], tnn.SyncBatchNorm)
    assert float(net[1]._mean[0]) == 0.5


LOSSES = [("CrossEntropyLoss", {}, "cls"),
          ("CrossEntropyLoss", dict(label_smoothing=0.1), "cls"),
          ("NLLLoss", {}, "logp"),
          ("NLLLoss", dict(reduction="sum", ignore_index=1), "logp"),
          ("MSELoss", {}, "reg"),
          ("L1Loss", dict(reduction="none"), "reg"),
          ("SmoothL1Loss", dict(delta=0.5), "reg"),
          ("KLDivLoss", {}, "kl"),
          ("BCELoss", {}, "prob"),
          ("BCEWithLogitsLoss", {}, "bin"),
          ("BCEWithLogitsLoss", dict(reduction="sum"), "bin")]


def _loss_inputs(kind):
    rs = np.random.RandomState(3)
    x = rs.randn(6, 5).astype(np.float32)
    if kind == "cls":
        return x, rs.randint(0, 5, (6,))
    if kind == "logp":
        return np.asarray(jax.nn.log_softmax(x)), rs.randint(0, 5, (6,))
    if kind == "reg":
        return x, rs.randn(6, 5).astype(np.float32)
    if kind == "kl":
        p = rs.rand(6, 5).astype(np.float32)
        return np.asarray(jax.nn.log_softmax(x)), p / p.sum(-1,
                                                             keepdims=True)
    y = (rs.rand(6, 5) > 0.5).astype(np.float32)
    return (1 / (1 + np.exp(-x)) if kind == "prob" else x), y


@pytest.mark.parametrize("name, kw, kind", LOSSES,
                         ids=[f"{n[0]}-{i}" for i, n in enumerate(LOSSES)])
def test_loss_layers_match_jax(name, kw, kind):
    x, y = _loss_inputs(kind)
    jl, tl = both(name, **kw)
    got = tl(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y)))
    close(got, jl(jnp.asarray(x), jnp.asarray(y)))


def test_functional_losses_with_weights_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(8, 4).astype(np.float32)
    lab = rs.randint(0, 4, (8,))
    lab[2] = -100
    w = rs.rand(4).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(x))
    t = torch.from_numpy
    close(TF.nll_loss(t(logp), t(lab), t(w)),
          JF.nll_loss(jnp.asarray(logp), jnp.asarray(lab), jnp.asarray(w)))
    y = (rs.rand(8, 4) > 0.5).astype(np.float32)
    pw = rs.rand(4).astype(np.float32) + 0.5
    close(TF.binary_cross_entropy_with_logits(t(x), t(y), t(w), "mean",
                                              t(pw)),
          JF.binary_cross_entropy_with_logits(
              jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), "mean",
              jnp.asarray(pw)))
    p = 1 / (1 + np.exp(-x))
    close(TF.log_loss(t(p), t(y)), JF.log_loss(jnp.asarray(p),
                                               jnp.asarray(y)))
    close(TF.square_error_cost(t(x), t(y)),
          JF.square_error_cost(jnp.asarray(x), jnp.asarray(y)))


def _j(*a):
    return [jnp.asarray(v) for v in a]


def _t(*a):
    return [torch.from_numpy(np.array(v)) for v in a]


FUNCTIONAL = {
    "leaky_relu": lambda F, x: F.leaky_relu(x, 0.2),
    "hardtanh": lambda F, x: F.hardtanh(x, -0.5, 2.0),
    "softshrink": lambda F, x: F.softshrink(x, 0.3),
    "hardshrink": lambda F, x: F.hardshrink(x, 0.3),
    "tanhshrink": lambda F, x: F.tanhshrink(x),
    "glu": lambda F, x: F.glu(x, 1),
    "log_sigmoid": lambda F, x: F.log_sigmoid(x),
    "gelu_tanh": lambda F, x: F.gelu_tanh(x),
    "log_softmax": lambda F, x: F.log_softmax(x, 1),
    "normalize": lambda F, x: F.normalize(x, 2, 1),
    "normalize_p1": lambda F, x: F.normalize(x, 1, -1),
    "group_norm": lambda F, x: F.group_norm(x, 3),
    "instance_norm": lambda F, x: F.instance_norm(x),
    "pad_reflect_wide": lambda F, x: F.pad(x, [9, 2], "reflect"),
    "pad_nhwc": lambda F, x: F.pad(x, [1, 0, 2, 1], "replicate",
                                   data_format="NHWC"),
    "pad_last_dims": lambda F, x: F.pad(x, [0, 1, 2, 0, 1, 1]),
    "unfold": lambda F, x: F.unfold(x, 3, 2, 1, 1),
    "unfold_dilated": lambda F, x: F.unfold(x, 2, 1, 0, 2),
    "channel_shuffle": lambda F, x: F.channel_shuffle(x, 3),
    "channel_shuffle_nhwc": lambda F, x: F.channel_shuffle(x, 2, "NHWC"),
    "cosine_similarity": lambda F, x: F.cosine_similarity(x, x * 0.5 + 1,
                                                          axis=1),
    "conv_valid": lambda F, x: F.conv2d(x, x[:2, :, :3, :3], None, 1,
                                        "VALID"),
    "max_pool1d_nlc": lambda F, x: F.max_pool1d(x[:, 0], 2, 1, 1,
                                                data_format="NLC"),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONAL))
def test_functional_ops_match_jax(name):
    x = rand(2, 6, 7, 8, scale=2)
    fn = FUNCTIONAL[name]
    close(fn(TF, torch.from_numpy(x)), fn(JF, jnp.asarray(x)))


def test_one_hot_and_sequence_mask_match_jax():
    ids = np.array([[0, 3, -1], [4, 2, 1]])
    close(TF.one_hot(torch.from_numpy(ids), 4),
          JF.one_hot(jnp.asarray(ids), 4))
    lens = np.array([3, 0, 5])
    assert np.array_equal(TF.sequence_mask(torch.from_numpy(lens)).numpy(),
                          np.asarray(JF.sequence_mask(jnp.asarray(lens))))
    close(TF.sequence_mask(torch.from_numpy(lens), 6, "float32"),
          JF.sequence_mask(jnp.asarray(lens), 6, "float32"))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mode, padding", [
    ("bilinear", "zeros"), ("bilinear", "border"),
    ("bilinear", "reflection"), ("nearest", "zeros")])
def test_affine_grid_and_grid_sample_match_jax(align, mode, padding):
    rs = np.random.RandomState(6)
    theta = (np.eye(2, 3)[None] + rs.randn(2, 2, 3) * 0.4).astype(
        np.float32)
    x = rand(2, 3, 6, 7)
    jg = JF.affine_grid(jnp.asarray(theta), (2, 3, 5, 4), align)
    tg = TF.affine_grid(torch.from_numpy(theta), (2, 3, 5, 4), align)
    close(tg, jg)
    grid = np.asarray(jg) * 1.3
    close(TF.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode,
                         padding, align),
          JF.grid_sample(jnp.asarray(x), jnp.asarray(grid), mode, padding,
                         align))


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_draws_jax_noise(hard):
    """The Gumbel noise comes from threefry on the same key: the soft
    outputs agree to float32 rounding and the hard one-hots exactly."""
    x = rand(4, 7)
    jrng.seed(11)
    trng.seed(11)
    want = JF.gumbel_softmax(jnp.asarray(x), 0.5, hard)
    got = TF.gumbel_softmax(torch.from_numpy(x), 0.5, hard)
    close(got, want)
    if hard:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_prelu_channel_axis_nhwc():
    x = rand(2, 4, 4, 3)
    w = np.array([0.1, 0.2, 0.3], np.float32)
    close(TF.prelu(torch.from_numpy(x), torch.from_numpy(w), "NHWC"),
          JF.prelu(jnp.asarray(x), jnp.asarray(w), "NHWC"))


def test_int8_conv_accumulates_exactly():
    rs = np.random.RandomState(8)
    x = rs.randint(-128, 127, (1, 4, 6, 6)).astype(np.int8)
    w = rs.randint(-128, 127, (3, 4, 3, 3)).astype(np.int8)
    want = JF.conv_nd(jnp.asarray(x), jnp.asarray(w),
                      preferred_element_type=jnp.int32)
    got = TF.conv_nd(torch.from_numpy(x), torch.from_numpy(w),
                     preferred_element_type=torch.int32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- the layer API (nn/layer.py) ---------------------------------------------

def test_parameter_registers_axes_and_trainability():
    layer = tnn.Layer()
    layer.w = tnn.Parameter(np.ones((3, 4), np.float32), axes=("embed",
                                                                 "mlp"))
    layer.frozen = tnn.Parameter(np.zeros(2, np.float32), trainable=False)
    meta = layer.param_meta()
    assert meta["w"].axes == ("embed", "mlp") and meta["w"].trainable
    assert not meta["frozen"].trainable
    assert [k for k, _ in layer.named_parameters()] == ["w", "frozen"]
    import copy
    clone = copy.deepcopy(layer)
    assert clone.param_meta()["w"].axes == ("embed", "mlp")


def test_layer_dict_and_state_names_match_jax():
    jd = jnn.LayerDict({"a": jnn.Linear(3, 4), "b": jnn.LayerNorm(4)})
    td = tnn.LayerDict({"a": tnn.Linear(3, 4), "b": tnn.LayerNorm(4)})
    assert list(td.keys()) == list(jd.keys())
    assert list(td.state_dict()) == list(jd.state_dict())
    td["c"] = tnn.ReLU()
    assert "c" in td and isinstance(td["c"], tnn.ReLU)


def test_hooks_and_remove_helper():
    """Pre-hooks replace the arguments, post-hooks the output;
    ``remove`` detaches them, as in the JAX package."""
    results = []
    for nn_, arr in ((jnn, jnp.asarray), (tnn, torch.from_numpy)):
        layer = nn_.Linear(3, 3)
        h1 = layer.register_forward_pre_hook(lambda l, a: (a[0] * 0,))
        h2 = layer.register_forward_post_hook(lambda l, a, o: o + 1)
        x = arr(np.ones((1, 3), np.float32))
        before = np.asarray(layer(x).detach() if nn_ is tnn else layer(x))
        h1.remove()
        h2.remove()
        after = layer(x)
        after = np.asarray(after.detach() if nn_ is tnn else after)
        results.append((before, after))
    assert isinstance(h1, tnn.layer.HookRemoveHelper)
    np.testing.assert_array_equal(results[1][0], np.ones((1, 3)))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert not np.array_equal(results[1][1], results[1][0])


def test_functional_call_is_pure_and_returns_buffers():
    jl, tl = both("BatchNorm1D", 3)
    x = rand(10, 3, scale=2) + 1
    jp, jb = jnn.split_state(jl)
    tp, tb = tnn.split_state(tl)
    assert list(tp) == list(jp) and list(tb) == list(jb)
    jout, jnew = jnn.functional_call(jl, jp, jb, jnp.asarray(x),
                                     training=True)
    tout, tnew = tnn.functional_call(tl, tp, tb, torch.from_numpy(x),
                                     training=True)
    close(tout, jout)
    for k in jnew:
        close(tnew[k], jnew[k])
    np.testing.assert_array_equal(tl._mean.numpy(), 0.0)
    assert tl.training  # the mode is restored


def test_functional_call_gradients_match_jax():
    jl, tl = both("Linear", 4, 2)
    check_layer(jl, tl, [rand(3, 4)])
    jp, _ = jnn.split_state(jl)
    tp = {k: v.detach().clone().requires_grad_() for k, v
          in tnn.split_state(tl)[0].items()}
    x = rand(3, 4, seed=2)
    out, _ = tnn.functional_call(tl, tp, {}, torch.from_numpy(x))
    (out ** 2).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jnn.functional_call(
        jl, p, {}, jnp.asarray(x))[0] ** 2))(jp)
    for k in jg:
        close(tp[k].grad, jg[k])
