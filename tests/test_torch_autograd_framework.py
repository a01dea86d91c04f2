"""The port's ``autograd``, ``framework``, ``compat_fill``, ``regularizer``
and ``device`` against the JAX package's, and the slice as a whole: one
Paddle-style script run through both packages.

float32 results within ``1e-6 + 1e-5 |jax|`` (the script's losses over
20 SGD steps too), draws bit for bit, files and generator states
crossing between the packages in both directions."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu_torch as T  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402

import paddle_tpu as J  # noqa: E402
from torch_tensor_cases import _np, check  # noqa: E402

F32 = np.float32


@pytest.fixture(autouse=True)
def _on_cpu():
    T.set_device("cpu")
    yield
    tdev.set_current(None)


def _x(seed=0, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape or (3,)) \
        .astype(F32)


def _mlp(m, x, w1, w2):
    return m.sum(m.tanh(m.matmul(m.tanh(m.matmul(x, w1)), w2)) ** 2)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def test_vjp_and_jvp():
    x = _x(1, 4)
    v = _x(2, 4)

    def f(m):
        return lambda a: m.sin(a) * a
    jout, jv = J.autograd.vjp(f(J), jnp.asarray(x), jnp.asarray(v))
    tout, tv = T.autograd.vjp(f(T), torch.tensor(x), torch.tensor(v))
    check([tout, tv], [jout, jv])
    check(T.autograd.vjp(f(T), torch.tensor(x))[1],
          J.autograd.vjp(f(J), jnp.asarray(x))[1])
    check(list(T.autograd.jvp(f(T), torch.tensor(x), torch.tensor(v))),
          list(J.autograd.jvp(f(J), jnp.asarray(x), jnp.asarray(v))))

    def g(m):
        return lambda a, b: a * b + m.exp(a)
    check(list(T.autograd.vjp(g(T), [torch.tensor(x), torch.tensor(v)])[1]),
          list(J.autograd.vjp(g(J), [jnp.asarray(x), jnp.asarray(v)])[1]))
    check(list(T.autograd.jvp(g(T), [torch.tensor(x), torch.tensor(v)])),
          list(J.autograd.jvp(g(J), [jnp.asarray(x), jnp.asarray(v)])))


def test_jacobian_and_hessian_of_an_mlp():
    w1, w2 = _x(3, 4, 5), _x(4, 5, 2)

    def f(m, w1, w2):
        return lambda x: m.tanh(m.matmul(m.tanh(m.matmul(x, w1)), w2))

    def s(m, w1, w2):
        return lambda x: _mlp(m, x, w1, w2)
    x = _x(5, 4)
    jw = [jnp.asarray(w1), jnp.asarray(w2)]
    tw = [torch.tensor(w1), torch.tensor(w2)]
    jj = J.autograd.Jacobian(f(J, *jw), jnp.asarray(x))
    tj = T.autograd.Jacobian(f(T, *tw), torch.tensor(x))
    assert tj.shape == tuple(jj.shape)
    check([tj[:], tj[0], np.asarray(tj)], [jj[:], jj[0], np.asarray(jj)])
    jh = J.autograd.Hessian(s(J, *jw), jnp.asarray(x))
    th = T.autograd.Hessian(s(T, *tw), torch.tensor(x))
    check(th[:], jh[:])
    xb = _x(6, 3, 4)
    check(T.autograd.Jacobian(f(T, *tw), torch.tensor(xb), True)[:],
          J.autograd.Jacobian(f(J, *jw), jnp.asarray(xb), True)[:])
    check(T.autograd.Hessian(s(T, *tw), torch.tensor(xb), True)[:],
          J.autograd.Hessian(s(J, *jw), jnp.asarray(xb), True)[:])
    check(T.incubate.Jacobian(f(T, *tw), torch.tensor(x))[:], jj[:])
    check([T.autograd.jacobian(f(T, *tw))(torch.tensor(x)),
           T.autograd.hessian(s(T, *tw))(torch.tensor(x)),
           T.autograd.grad(s(T, *tw))(torch.tensor(x))],
          [J.autograd.jacobian(f(J, *jw))(jnp.asarray(x)),
           J.autograd.hessian(s(J, *jw))(jnp.asarray(x)),
           J.autograd.grad(s(J, *jw))(jnp.asarray(x))])


def _cube(pkg, m):
    class Cube(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x)
            ctx.attrs["scale"] = 3.0
            return x ** 3 + y

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensor()
            return g * ctx.attrs["scale"] * x ** 2 * 2.0   # a custom rule
    return Cube


def test_pylayer_custom_backward():
    x, y = _x(7, 5), _x(8, 5)
    jc, tc = _cube(J, J), _cube(T, T)
    jg = jax.grad(lambda a, b: jnp.sum(jc.apply(a, b)), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = torch.tensor(x, requires_grad=True), torch.tensor(
        y, requires_grad=True)
    out = tc.apply(tx, ty)
    out.sum().backward()
    # an argument backward gives no gradient: zeros in JAX, None in torch
    check([out, tx.grad, torch.zeros_like(ty) if ty.grad is None
           else ty.grad], [jc.apply(jnp.asarray(x), jnp.asarray(y)), *jg])


def _two_layers(pkg):
    a = pkg.nn.Linear(3, 4, weight_attr=pkg.nn.initializer.Constant(0.3))
    b = pkg.nn.Linear(4, 1, weight_attr=pkg.nn.initializer.Constant(-0.2))
    return a, b


def test_record_grads_by_name_and_backward():
    x = _x(9, 6, 3)
    ja, jb = _two_layers(J)
    ta, tb = _two_layers(T)
    jt = J.autograd.record(ja, jb)
    tt = T.autograd.record(ta, tb)
    jl = jt.run(lambda: J.mean(jb(J.tanh(ja(J.to_tensor(x)))) ** 2))
    tl = tt.run(lambda: T.mean(tb(T.tanh(ta(T.to_tensor(x)))) ** 2))
    assert sorted(tt.backward()) == sorted(jt.backward())
    check([tl] + [tt.grads[k] for k in sorted(jt.grads)],
          [jl] + [jt.grads[k] for k in sorted(jt.grads)])
    check(tt.layer_grads(1)["weight"], jt.layer_grads(1)["weight"])
    with pytest.raises(RuntimeError):
        T.autograd.record(ta).backward()
    with pytest.raises(ValueError):
        T.autograd.record()
    # backward: torch's tape (the JAX package has none and raises)
    w = torch.tensor(x, requires_grad=True)
    T.autograd.backward(T.sum(w * w), retain_graph=True)
    check(w.grad, 2 * x)
    with pytest.raises(RuntimeError):
        J.autograd.backward(None)


# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------

def test_grad_and_value_and_grad_conventions():
    x = _x(10, 5)

    def f(m):
        return lambda a, b: m.sum(m.sin(a) * b)
    check(T.grad(f(T))(torch.tensor(x), torch.tensor(x)),
          J.grad(f(J))(jnp.asarray(x), jnp.asarray(x)))
    check(list(T.grad(f(T), argnums=(0, 1))(torch.tensor(x),
                                              torch.tensor(x))),
          list(J.grad(f(J), argnums=(0, 1))(jnp.asarray(x),
                                             jnp.asarray(x))))
    tv, tg = T.value_and_grad(f(T))(torch.tensor(x), torch.tensor(x))
    jv, jg = J.value_and_grad(f(J))(jnp.asarray(x), jnp.asarray(x))
    check([tv, tg], [jv, jg])

    def h(m):
        return lambda a: (m.sum(a * a), a * 2)
    (tv, taux), tg = T.value_and_grad(h(T), has_aux=True)(torch.tensor(x))
    (jv, jaux), jg = J.value_and_grad(h(J), has_aux=True)(jnp.asarray(x))
    check([tv, taux, tg], [jv, jaux, jg])


def test_no_grad_jit_and_compile():
    assert T.is_grad_enabled() and J.is_grad_enabled()
    with T.no_grad(), J.no_grad():
        assert not T.is_grad_enabled() and not J.is_grad_enabled()
        w = torch.ones(2, requires_grad=True)
        assert not (w * 2).requires_grad
    assert T.is_grad_enabled()
    x = _x(11, 4)

    def f(m):
        return lambda a: m.exp(a) + 1.0
    for tf, jf in ((T.compile(f(T)), J.compile(f(J))),
                   (T.framework.jit()(f(T)), J.framework.jit()(f(J))),
                   (T.framework.to_static(f(T)),
                    J.framework.to_static(f(J)))):
        check(tf(torch.tensor(x)), jf(jnp.asarray(x)))


def _tree(m, seed):
    return {"w": m.to_tensor(_x(seed, 2, 3)),
            "nested": {"b": m.to_tensor(_x(seed + 1, 3)),
                       "ids": m.to_tensor(np.arange(4))},
            "list": [m.to_tensor(_x(seed + 2, 2)), 7], "none": None}


def _flat(tree):
    return [tree["w"], tree["nested"]["b"], tree["nested"]["ids"],
            tree["list"][0], tree["list"][1], tree["none"] is None]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages(tmp_path, writer):
    path = str(tmp_path / "sub" / "state.pdparams")
    if writer == "jax":
        J.save(_tree(J, 1), path)
        got, want = T.load(path), J.load(path)
        assert isinstance(got["w"], torch.Tensor)
    else:
        T.save(_tree(T, 1), path)
        got, want = T.load(path), J.load(path)
        assert isinstance(want["w"], np.ndarray)
    check(_flat(got), _flat(want))
    check(_flat(got), _flat(_tree(J, 1)))


def test_save_a_layer_as_its_state_dict(tmp_path):
    ta, _ = _two_layers(T)
    ja, _ = _two_layers(J)
    T.save(ta, str(tmp_path / "t.pd"))
    J.save(ja, str(tmp_path / "j.pd"))
    tj, jt = J.load(str(tmp_path / "t.pd")), T.load(str(tmp_path / "j.pd"))
    assert sorted(tj) == sorted(jt) == ["bias", "weight"]
    check([jt["weight"], jt["bias"]], [tj["weight"], tj["bias"]])


# ---------------------------------------------------------------------------
# compat_fill
# ---------------------------------------------------------------------------

def test_rng_state_crosses_packages_both_ways():
    J.seed(5)
    T.seed(99)
    J.rand([3])
    J.tensor.standard_normal([2])
    T.set_cuda_rng_state(J.get_cuda_rng_state())
    check(T.rand([4]), J.rand([4]), exact=True)
    T.seed(6)
    T.randn([5])
    state = T.get_cuda_rng_state()
    assert state["key"].dtype == np.uint32
    J.set_cuda_rng_state(state)
    check(T.randint(0, 50, [8]), J.randint(0, 50, [8]), exact=True)
    saved = T.get_cuda_rng_state()
    a = T.rand([3])
    T.set_cuda_rng_state(saved)
    check(T.rand([3]), a, exact=True)


def test_compat_surface():
    attr = T.ParamAttr(name="w", initializer=T.nn.initializer.Constant(2.0),
                       trainable=False)
    p = T.create_parameter([2, 3], "float32", attr=attr)
    jp = J.create_parameter([2, 3], "float32", attr=J.ParamAttr(
        initializer=J.nn.initializer.Constant(2.0)))
    check(p.detach(), jp)
    assert not p.requires_grad
    assert T.create_parameter([4], is_bias=True).abs().sum() == 0
    assert T.Tensor is torch.Tensor and T.bool is torch.bool

    def reader():
        yield from range(7)
    assert list(T.batch(reader, 3)()) == list(J.batch(reader, 3)())
    assert list(T.batch(reader, 3, drop_last=True)()) == [[0, 1, 2],
                                                          [3, 4, 5]]
    T.check_shape([2, 3])
    T.check_shape(torch.tensor([2, 3]))
    for bad in ((2.0, 3), "ab", torch.tensor([1.0])):
        with pytest.raises(TypeError):
            T.check_shape(bad)
    T.disable_signal_handler()
    assert T.in_dynamic_mode()
    T.enable_static()
    assert not T.in_dynamic_mode()
    T.disable_static()
    assert T.in_dynamic_mode()
    T.set_grad_enabled(False)
    assert not T.is_grad_enabled()
    T.set_grad_enabled(True)
    with T.set_grad_enabled(False):
        assert not torch.is_grad_enabled()
    assert torch.is_grad_enabled()
    assert repr(T.CPUPlace()) == repr(J.CPUPlace())


def test_regularizers():
    params = {"w": _x(12, 3, 2), "b": [_x(13, 2)]}
    grads = {"w": _x(14, 3, 2), "b": [_x(15, 2)]}

    def conv(m, tree):
        return {"w": m.to_tensor(tree["w"]), "b": [m.to_tensor(tree["b"][0])]}
    for cls in ("L1Decay", "L2Decay"):
        jr, tr = getattr(J.regularizer, cls)(0.1), \
            getattr(T.regularizer, cls)(0.1)
        jg = jr.grad_transform(conv(J, grads), conv(J, params))
        tg = tr.grad_transform(conv(T, grads), conv(T, params))
        check([tr.penalty(conv(T, params)), tg["w"], tg["b"][0]],
              [jr.penalty(conv(J, params)), jg["w"], jg["b"][0]])


# ---------------------------------------------------------------------------
# device, dtypes and the top-level names
# ---------------------------------------------------------------------------

def test_device_api():
    assert T.set_device("cpu") == "cpu"
    assert T.device.set_device(T.CPUPlace()) == "cpu"
    assert T.device.get_device() == "cpu"
    for bad in ("tpu", "npu:0", "xpu"):
        with pytest.raises(ValueError):
            T.set_device(bad)
    if not torch.cuda.is_available():
        for gpu in ("gpu", "gpu:0", "cuda:1"):
            with pytest.raises(ValueError, match="not available"):
                T.set_device(gpu)
        assert T.device.get_available_device() == ["cpu"]
        assert T.device.get_all_device_type() == ["cpu"]
    assert T.device_count() == torch.cuda.device_count()
    assert T.is_compiled_with_cuda() and T.device.is_compiled_with_cuda()
    assert not T.is_compiled_with_tpu()
    for probe in ("rocm", "xpu", "npu", "mlu", "ipu", "cinn"):
        assert getattr(T.device, f"is_compiled_with_{probe}")() is False
    assert T.device.get_all_custom_device_type() == []
    assert T.device.get_available_custom_device() == []
    v = T.device.get_cudnn_version()
    assert v is None or isinstance(v, int)
    assert T.CUDAPlace(1) == T.CUDAPlace(1) != T.CUDAPlace(0)
    assert repr(T.CPUPlace()) == "CPUPlace"
    assert T.device.TPUPlace(2).get_device_id() == 2
    assert {T.device.XPUPlace(0), T.device.XPUPlace(0)} == {
        T.device.XPUPlace(0)}
    start, end = T.device.Event(), T.device.Event()
    start.record()
    with T.device.Stream() as s:
        T.zeros([8]) + 1
        s.synchronize()
    end.record()
    T.device.synchronize()
    end.synchronize()
    assert start.elapsed_time(end) >= 0.0
    with pytest.raises(RuntimeError):
        T.device.Event().elapsed_time(end)


def test_dtypes_flags_and_info():
    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "bfloat16", "float32", "float64", "complex64",
                 "complex128", "bf16", "fp32"):
        assert T.dtype(name) is getattr(torch, str(T.dtype(name)).split(
            ".")[1])
        assert str(T.dtype(name)).split(".")[1] == str(J.dtype(name))
    assert T.dtype(np.float32) is torch.float32
    assert T.dtype(float) is torch.float64
    assert T.dtype(T.complex64) is torch.complex64
    with pytest.raises(TypeError):
        T.dtype("float8")
    assert T.get_default_dtype() is torch.float32
    T.set_default_dtype("float64")
    J.set_default_dtype("float64")
    try:
        assert T.zeros([2]).dtype is torch.float64
        assert T.get_flags("default_dtype") == {"default_dtype": "float64"}
    finally:
        T.set_default_dtype(torch.float32)
        J.set_default_dtype("float32")
    T.set_flags({"default_dtype": "float32"})
    assert T.iinfo("int32").max == J.iinfo("int32").max
    assert T.iinfo(T.int64).min == np.iinfo(np.int64).min
    assert T.finfo("bfloat16").eps == float(J.finfo(jnp.bfloat16).eps)
    assert T.finfo(T.float32).tiny == float(J.finfo(jnp.float32).tiny)
    assert T.float32 is torch.float32 and T.bool_ is torch.bool


# ---------------------------------------------------------------------------
# the slice as a whole: one Paddle-style script through both packages
# ---------------------------------------------------------------------------

def _script(pt):
    """Draw a regression, fit it by SGD through ``autograd.record`` with
    an L2 penalty's gradient, then solve it in closed form and check the
    gradient there."""
    pt.seed(7)
    x = pt.randn([64, 3])
    w_true = pt.to_tensor(np.array([[1.5], [-2.0], [0.5]], F32))
    y = pt.matmul(x, w_true) + pt.normal(0.0, 0.1, [64, 1])
    net = pt.nn.Linear(3, 1, weight_attr=pt.nn.initializer.Constant(0.0))
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=net)
    reg = pt.regularizer.L2Decay(1e-3)
    losses = []
    for _ in range(20):
        tape = pt.autograd.record(net)
        loss = tape.run(lambda: pt.mean(pt.square(net(x) - y)))
        opt.step(reg.grad_transform(tape.backward(),
                                    dict(net.named_parameters())))
        losses.append(float(loss))
    w_star = pt.linalg.solve(pt.matmul(x, x, transpose_x=True),
                             pt.matmul(x, y, transpose_x=True))

    def mse(w):
        return pt.mean(pt.square(pt.matmul(x, w) - y))
    g = pt.grad(mse)(w_star)
    return x, y, losses, w_star, g, net.weight, net.bias


def test_slice_as_a_whole_script():
    jx, jy, jl, jw, jg, jwt, jb = _script(J)
    tx, ty, tl, tw, tg, twt, tb = _script(T)
    check([tx, ty], [jx, jy], exact=True)          # the same draws
    check([np.asarray(tl, F32), tw, twt.detach(), tb.detach()],
          [np.asarray(jl, F32), jw, jwt, jb])
    assert tl[-1] < 0.05 * tl[0]
    assert float(np.abs(_np(tg)).max()) < 1e-5
    assert float(np.abs(np.asarray(jg)).max()) < 1e-5
    assert math.isfinite(tl[-1])
