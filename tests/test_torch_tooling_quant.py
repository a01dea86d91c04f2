"""The port's ``quant``, ``incubate.asp``, ``incubate.data_generator``
and ``testing`` against the JAX package's.

int8 weights and scales equal; ``fake_quant`` values and straight-through
gradients equal; the int8-activation ``QuantizedLinear`` and
``QuantizedConv2D`` sum int8 products into exact int32 accumulators, so
their accumulators equal the JAX ``preferred_element_type=int32``
results and their outputs agree within float32 rounding (``1e-6 +
1e-6 |jax|``); a 3 x 3 conv over 512 channels sums past 2^24, where
float32 is no longer exact. ``fold_conv_bn`` folds ResNet-18's 20
BatchNorms and keeps its eval output within ``1e-4 + 1e-4 |before|``.
ASP masks, ``MultiSlotDataGenerator`` lines and ``testing.check_grad``
verdicts equal."""

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import quant as jq  # noqa: E402
from paddle_tpu import testing as jtesting  # noqa: E402
from paddle_tpu.incubate import asp as jasp  # noqa: E402
from paddle_tpu.incubate import data_generator as jdg  # noqa: E402
from paddle_tpu_torch import quant as tq  # noqa: E402
from paddle_tpu_torch import testing as ttesting  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.incubate import asp as tasp  # noqa: E402
from paddle_tpu_torch.incubate import data_generator as tdg  # noqa: E402


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _w(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 0, (1, 2, 3)],
                         ids=["tensor", "out_channel", "conv_channel"])
def test_quantize_weight_equals_jax(axis):
    w = _w((6, 5, 3, 3) if axis == (1, 2, 3) else (12, 7))
    jqv, js = jq.quantize_weight(jnp.asarray(w), axis=axis)
    tqv, ts = tq.quantize_weight(torch.as_tensor(w), axis=axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_weight(tqv, ts).numpy(),
        np.asarray(jq.dequantize_weight(jqv, js)))


def test_fake_quant_values_and_grads_equal_jax():
    x = _w((64,)) * 3
    scale = 0.02
    jval, jvjp = jax.vjp(lambda v: jq.fake_quant(v, scale), jnp.asarray(x))
    g = _w((64,), 1)
    (jgrad,) = jvjp(jnp.asarray(g))
    tx = torch.as_tensor(x).requires_grad_()
    tval = tq.fake_quant(tx, scale)
    (tgrad,) = torch.autograd.grad(tval, tx, torch.as_tensor(g))
    np.testing.assert_array_equal(tval.detach().numpy(), np.asarray(jval))
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    assert (tgrad == 0).any() and (tgrad != 0).any()   # clip boundary


def _linear_pair(i, o, seed):
    jpt.seed(seed)
    jl = jpt.nn.Linear(i, o)
    tl = tpt.nn.Linear(i, o)
    tl.load_state_dict({k: torch.as_tensor(np.asarray(v))
                        for k, v in jl.state_dict().items()})
    return jl, tl


def test_quantized_linear_int8_activations_equal_jax():
    jl, tl = _linear_pair(96, 40, 0)
    x = _w((16, 96), 2)
    act = float(np.abs(x).max()) / 127
    jql = jq.QuantizedLinear.from_linear(jl, act_scale=act)
    tql = tq.QuantizedLinear.from_linear(tl, act_scale=act)
    np.testing.assert_array_equal(tql.qweight.numpy(),
                                  np.asarray(jql.qweight))
    qx = tq._quantize_act(torch.as_tensor(x), tql.act_scale, 8)
    acc = tq._int8_matmul_i32(qx, tql.qweight)
    jqx = jnp.clip(jnp.round(jnp.asarray(x) / jql.act_scale), -127,
                   127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jqx, jql.qweight, (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tql(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jql(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    wonly = tq.QuantizedLinear.from_linear(tl)
    jwonly = jq.QuantizedLinear.from_linear(jl)
    np.testing.assert_allclose(wonly(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jwonly(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin,hw", [(8, 6), (512, 3)],
                         ids=["small", "512ch_past_2_24"])
def test_quantized_conv_int32_equal_jax(cin, hw):
    jpt.seed(1)
    jc = jpt.nn.Conv2D(cin, 4, 3, padding=1)
    tc = tpt.nn.Conv2D(cin, 4, 3, padding=1)
    tc.load_state_dict({k: torch.as_tensor(np.asarray(v))
                        for k, v in jc.state_dict().items()})
    # an input of constant sign pushes the sums to their reach
    x = np.abs(_w((2, cin, hw, hw), 3)) + 1.0
    act = float(x.max()) / 127
    jqc = jq.QuantizedConv2D(jc, act_scale=act)
    tqc = tq.QuantizedConv2D(tc, act_scale=act)
    tqc.qweight = torch.full_like(tqc.qweight, 127)
    jqc.qweight = jnp.full(jqc.qweight.shape, 127, jnp.int8)
    qx = tq._quantize_act(torch.as_tensor(x), tqc.act_scale, 8)
    acc = tpt.nn.functional.conv_nd(qx, tqc.qweight, None, 1, 1,
                                    preferred_element_type=torch.int32)
    jqx = jnp.clip(jnp.round(jnp.asarray(x) / jqc.act_scale), -127,
                   127).astype(jnp.int8)
    jacc = jpt.nn.functional.conv_nd(jqx, jqc.qweight, None, 1, 1,
                                     preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    if cin == 512:
        assert int(acc.max()) > 2 ** 24
    np.testing.assert_allclose(tqc(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jqc(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_qat_linear_and_convert_equal_jax():
    jl, tl = _linear_pair(24, 8, 2)
    jnet = jpt.nn.Sequential(jl)
    tnet = tpt.nn.Sequential(tl)
    assert jq.prepare_qat(jnet) == tq.prepare_qat(tnet) == 1
    xs = [_w((4, 24), s) for s in (5, 6)]
    for x in xs:                     # two training forwards: the EMA
        jy = jnet(jnp.asarray(x))
        ty = tnet(torch.as_tensor(x))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tnet[0].act_absmax),
                               float(jnet[0].act_absmax), rtol=1e-6)
    assert jq.convert(jnet) == tq.convert(tnet) == 1
    jnet.eval()
    tnet.eval()
    np.testing.assert_allclose(
        tnet(torch.as_tensor(xs[0])).detach().numpy(),
        np.asarray(jnet(jnp.asarray(xs[0]))), rtol=1e-6, atol=1e-6)


def test_post_training_swaps_and_calibrates():
    tpt.seed(0)
    net = tpt.nn.Sequential(tpt.nn.Linear(8, 16), tpt.nn.ReLU(),
                            tpt.nn.Linear(16, 4))
    x = torch.as_tensor(_w((5, 8), 7))
    with torch.no_grad():
        ref = net(x)
    calib = [x]
    assert tq.quantize_post_training(net, calibration_batches=calib) == 2
    assert isinstance(net[0], tq.QuantizedLinear)
    assert float(net[0].act_scale) == pytest.approx(
        float(x.abs().max()) / 127)
    with torch.no_grad():
        got = net(x)
    assert float((got - ref).abs().max()) < 0.05 * float(ref.abs().max())
    with pytest.raises(ValueError, match="calibration_batches"):
        tq.quantize_post_training(net, quant_act=True)


def test_fold_conv_bn_on_resnet18():
    tpt.seed(0)
    net = tpt.models.resnet18(num_classes=10, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in net.modules():           # statistics away from 0 / 1
            if isinstance(m, tpt.nn.layers.norm._BatchNormBase):
                m._mean.uniform_(-0.5, 0.5, generator=g)
                m._variance.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
    net.eval()
    x = torch.as_tensor(_w((2, 3, 32, 32), 8))
    with torch.no_grad():
        before = net(x)
    assert tq.fold_conv_bn(net, x) == 20
    assert not any(isinstance(m, tpt.nn.layers.norm._BatchNormBase)
                   for m in net.modules())
    with torch.no_grad():
        after = net(x)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_asp_masks_equal_jax():
    for shape, seed in (((8, 16), 0), ((4, 3, 2, 2), 1), ((6, 8), 2)):
        w = _w(shape, seed)
        w[0, :4] = 0.5                      # ties inside a group
        np.testing.assert_array_equal(
            tasp.create_mask(torch.as_tensor(w)).numpy(),
            np.asarray(jasp.create_mask(jnp.asarray(w))))
    assert tasp.create_mask(torch.ones(3, 5)) is None
    w = _w((8, 16), 3)
    assert tasp.check_sparsity(w) == jasp.check_sparsity(w)
    assert tasp.calculate_density(w) == jasp.calculate_density(w)


def test_asp_prune_and_decorate_keep_zeros():
    tpt.seed(0)
    net = tpt.nn.Sequential(tpt.nn.Linear(8, 16), tpt.nn.ReLU(),
                            tpt.nn.Linear(16, 4))
    masks = tasp.prune_model(net)
    assert sorted(masks) == ["0.weight", "2.weight"]
    opt = tasp.decorate(tpt.optimizer.SGD(learning_rate=0.5,
                                          parameters=net))
    m = tpt.Model(net)
    m.prepare(opt, tpt.nn.CrossEntropyLoss())
    x = _w((6, 8), 9)
    y = np.random.RandomState(0).randint(0, 4, (6, 1))
    for _ in range(2):
        m.train_batch([x], [y])
    loss = net(torch.as_tensor(x)).sum()
    loss.backward()
    opt.step()
    for name, mask in masks.items():
        w = net.get_parameter(name).detach()
        assert tasp.check_sparsity(w) and not w[~mask].any()
    tasp.reset(net)


class _Gen:
    def generate_sample(self, line):
        def it():
            ids = [int(t) for t in line.split()]
            yield [("words", ids), ("label", [ids[0] % 2]),
                   ("score", [0.5, 1e-3])]
        return it


def test_data_generator_lines_equal_jax(tmp_path):
    lines = ["3 1 4 1 5", "9 2 6", "5"]
    src = tmp_path / "in.txt"
    src.write_text("\n".join(lines) + "\n")
    outs = []
    for mod in (jdg, tdg):
        gen = type("G", (_Gen, mod.MultiSlotDataGenerator), {})()
        out = tmp_path / f"{mod.__name__}.txt"
        gen.run_from_files([str(src)], str(out))
        sample = next(gen.generate_sample(lines[0])())
        outs.append((out.read_text(), gen.to_csv(sample),
                     mod.parse_multislot_line(
                         gen._gen_str(sample), ["words", "label", "score"])))
    assert outs[0] == outs[1]
    with pytest.raises(ValueError, match="trailing"):
        tdg.parse_multislot_line("1 5 2", ["a"])


class _BadTanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.tanh(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (1 + torch.tanh(x) ** 2)       # sign error


@jax.custom_vjp
def _jbad_tanh(x):
    return jnp.tanh(x)


_jbad_tanh.defvjp(lambda x: (jnp.tanh(x), x),
                  lambda x, g: (g * (1 + jnp.tanh(x) ** 2),))


def _specs(m, testing, bad):
    def np_softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)
    return [
        testing.OpSpec("tanh", m.tanh, np.tanh, (testing.arr((4, 6)),)),
        testing.OpSpec("matmul", m.matmul, np.matmul,
                       (testing.arr((4, 6)), testing.arr((6, 3), seed=1)),
                       grad_wrt=(0, 1)),
        testing.OpSpec("softmax", m.nn.functional.softmax, np_softmax,
                       (testing.arr((3, 5), seed=2),)),
        testing.OpSpec("exp", m.exp, np.exp, (testing.arr((5,), seed=3),)),
        testing.OpSpec("bad_tanh", bad, np.tanh,
                       (testing.arr((4, 6), seed=4),)),
    ]


def _verdicts(m, testing, bad):
    out = []
    for spec in _specs(m, testing, bad):
        row = []
        for check in (testing.check_forward, testing.check_grad,
                      testing.check_forward_bf16):
            try:
                check(spec)
                row.append(True)
            except AssertionError:
                row.append(False)
        out.append((spec.name, row))
    return out


def test_check_grad_verdicts_equal_jax():
    want = _verdicts(jpt, jtesting, _jbad_tanh)
    got = _verdicts(tpt, ttesting, _BadTanh.apply)
    assert got == want
    assert dict(got)["bad_tanh"] == [True, False, True]
    assert ttesting.arr((3,)).tolist() == jtesting.arr((3,)).tolist()
