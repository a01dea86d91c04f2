"""The port's other optimizers (Momentum, Adagrad, RMSProp, Adadelta,
Adamax, Lamb, Adafactor, LarsMomentum), the rest of ``nn/initializer.py``
and ``dropout2d`` against the JAX package's.

Tolerances, each with its reason:
- 5 steps of ``apply_gradients`` from the same float32 values and
  gradients: 1e-5 relative (the same elementwise formulas; step-counter
  corrections are host doubles rounded to float32 here and float32
  arithmetic in JAX, ~1 ulp a step), 1e-6 absolute for entries near 0;
  bfloat16 parameters under ``multi_precision``: the float32 master
  copies at the same limits, the bf16 parameters within one bf16 ulp
  (2^-7 relative);
- the counter on the device (as under the numeric guard) against the
  host counter: equal, bit for bit;
- ``.pdopt`` crossing: the next step's loss 1e-5 relative;
- deterministic initializers (Constant, Assign, Dirac, Bilinear):
  equal; random ones by their law (bounds, mean and std within 4
  standard errors, Orthogonal's Q^T Q = I within 1e-5);
- ``dropout2d`` masks and values: equal, bit for bit."""

import os
import tempfile

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.core import rng as jrng  # noqa: E402
from paddle_tpu.nn import clip as jclip  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
from paddle_tpu_torch.core import rng as trng  # noqa: E402
from paddle_tpu_torch.nn import clip as tclip  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn import initializer as TI  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _clip(m):
    return jclip if m is jpt.optimizer else tclip


OPTIMIZERS = {
    "momentum": lambda m: m.Momentum(0.05, momentum=0.9),
    "momentum-nesterov-wd": lambda m: m.Momentum(
        0.05, momentum=0.9, use_nesterov=True, weight_decay=0.01),
    "adagrad": lambda m: m.Adagrad(0.1, initial_accumulator_value=0.1),
    "rmsprop": lambda m: m.RMSProp(0.01),
    "rmsprop-centered-momentum": lambda m: m.RMSProp(
        0.01, momentum=0.9, centered=True, weight_decay=0.01),
    "adadelta": lambda m: m.Adadelta(1.0),
    "adamax": lambda m: m.Adamax(0.01, weight_decay=0.01),
    "lamb": lambda m: m.Lamb(0.01),
    "lamb-exclude": lambda m: m.Lamb(
        0.01, exclude_from_weight_decay_fn=lambda n: n.endswith("b")),
    "adafactor": lambda m: m.Adafactor(),
    "adafactor-beta1-lr-wd": lambda m: m.Adafactor(
        0.01, beta1=0.9, weight_decay=0.01, scale_parameter=False),
    "lars": lambda m: m.LarsMomentum(0.1, lars_coeff=0.01),
    "lamb-global-clip": lambda m: m.Lamb(
        0.01, grad_clip=_clip(m).ClipGradByGlobalNorm(0.05)),
    "momentum-value-clip": lambda m: m.Momentum(
        0.05, grad_clip=_clip(m).ClipGradByValue(0.05)),
}


def _tree(seed=0):
    r = np.random.RandomState(seed)
    params = {"w": r.randn(6, 5).astype(np.float32),
              "conv": r.randn(4, 3, 2, 2).astype(np.float32),
              "b": r.randn(5).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(5)]
    return params, grads


def _run(pkg, make, params, grads, half=False, device_t=False):
    opt = make(pkg.optimizer)
    if pkg is jpt:
        dt = jnp.bfloat16 if half else jnp.float32
        p = {k: jnp.asarray(v, dt) for k, v in params.items()}
        gs = [{k: jnp.asarray(v) for k, v in g.items()} for g in grads]
    else:
        dt = torch.bfloat16 if half else torch.float32
        p = {k: torch.from_numpy(v).to(dt) for k, v in params.items()}
        gs = [{k: torch.from_numpy(v) for k, v in g.items()}
              for g in grads]
    st = opt.init_state(p)
    if device_t:
        st = {k: torch.tensor(v, dtype=torch.int32) if k == "t" else v
              for k, v in st.items()}
    for step, g in enumerate(gs):
        p, st = opt.apply_gradients(p, g, st, step)
    return p, st


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """5 steps of apply_gradients, then every parameter and every state
    tensor under the JAX package's names and shapes."""
    params, grads = _tree(1)
    jp, js = _run(jpt, OPTIMIZERS[name], params, grads)
    tp, ts = _run(tpt, OPTIMIZERS[name], params, grads)
    for k in params:
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert sorted(ts) == sorted(js)
    for group, val in js.items():
        if group == "t":
            assert int(ts["t"]) == int(val) == len(grads)
            continue
        for k in params:
            assert tuple(ts[group][k].shape) == tuple(val[k].shape), \
                (group, k)
            np.testing.assert_allclose(_np(ts[group][k]), _np(val[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{group}.{k}")


@pytest.mark.parametrize("name", ["momentum", "lamb", "adafactor",
                                  "adamax"])
def test_multi_precision_matches_jax(name):
    """bfloat16 parameters: float32 master copies in the state, the bf16
    values cast from them."""
    params, grads = _tree(2)
    jp, js = _run(jpt, OPTIMIZERS[name], params, grads, half=True)
    tp, ts = _run(tpt, OPTIMIZERS[name], params, grads, half=True)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        assert ts["master"][k].dtype == torch.float32
        np.testing.assert_allclose(_np(ts["master"][k]),
                                   _np(js["master"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=2 ** -7,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["adamax", "lamb", "adafactor"])
def test_device_counter_equals_host_counter(name):
    """The step counter as a 0-dim int32 tensor (the numeric guard's
    form) gives the host counter's numbers bit for bit."""
    params, grads = _tree(3)
    hp, hs = _run(tpt, OPTIMIZERS[name], params, grads)
    dp, ds = _run(tpt, OPTIMIZERS[name], params, grads, device_t=True)
    assert isinstance(ds["t"], torch.Tensor) and int(ds["t"]) == hs["t"]
    for k in params:
        assert torch.equal(hp[k], dp[k]), k


def test_adam_device_counter_equals_host_counter():
    params, grads = _tree(4)
    for name in ("adam", "adamw"):
        make = {"adam": lambda m: m.Adam(0.01, weight_decay=0.1),
                "adamw": lambda m: m.AdamW(0.01, weight_decay=0.1)}[name]
        hp, _ = _run(tpt, make, params, grads)
        dp, _ = _run(tpt, make, params, grads, device_t=True)
        for k in params:
            assert torch.equal(hp[k], dp[k]), (name, k)


def test_adafactor_stacked_slices_match_jax():
    """A 3-D parameter with slices of 2^20 elements is updated slice by
    slice (clip and scale per slice), as the JAX package updates
    scan-stacked layers."""
    r = np.random.RandomState(5)
    params = {"stack": r.randn(2, 1024, 1024).astype(np.float32)}
    grads = [{"stack": (r.randn(2, 1024, 1024) * 0.1).astype(np.float32)}
             for _ in range(2)]
    make = OPTIMIZERS["adafactor"]
    jp, js = _run(jpt, make, params, grads)
    tp, ts = _run(tpt, make, params, grads)
    np.testing.assert_allclose(_np(tp["stack"]), _np(jp["stack"]),
                               rtol=RTOL, atol=ATOL)
    for g in ("vr", "vc"):
        np.testing.assert_allclose(_np(ts[g]["stack"]), _np(js[g]["stack"]),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# .pdopt crossing
# ---------------------------------------------------------------------------

class _JNet(jpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jpt.nn.Linear(8, 16)
        self.fc2 = jpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(jnp.tanh(self.fc1(x)))


class _TNet(tpt.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tpt.nn.Linear(8, 16)
        self.fc2 = tpt.nn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _jce(logits, label):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         label, axis=-1))


def _tce(logits, label):
    return -torch.log_softmax(logits, -1).gather(-1, label).mean()


def _batches(n, seed=3):
    r = np.random.RandomState(seed)
    return [(r.randn(4, 8).astype(np.float32), r.randint(0, 4, (4, 1)))
            for _ in range(n)]


def _model(pkg, name):
    pkg.seed(0)
    net = _JNet() if pkg is jpt else _TNet()
    m = pkg.Model(net)
    m.prepare(OPTIMIZERS[name](pkg.optimizer),
              _jce if pkg is jpt else _tce)
    return m


@pytest.mark.parametrize("name", ["adafactor-beta1-lr-wd", "lamb",
                                  "rmsprop-centered-momentum"])
@pytest.mark.parametrize("src", ["jax", "torch"])
def test_pdopt_crosses_both_ways(name, src):
    """Two steps in one package, save, load into the other, one more
    step in both: the third losses agree."""
    from paddle_tpu_torch.interop import load_reference_state
    b = _batches(3)
    jm, tm = _model(jpt, name), _model(tpt, name)
    load_reference_state(tm.network, {k: np.asarray(v) for k, v in
                                      jm.network.state_dict().items()})
    first, second = (jm, tm) if src == "jax" else (tm, jm)
    for x, y in b[:2]:
        first.train_batch([x], [y])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ck")
        first.save(path)
        second.load(path)
    assert second._step_count == 2
    got = float(tm.train_batch([b[2][0]], [b[2][1]])["loss"])
    want = float(jm.train_batch([b[2][0]], [b[2][1]])["loss"])
    np.testing.assert_allclose(got, want, rtol=RTOL)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", [
    ("Constant", (3, 4)), ("Assign", (2, 3)), ("Dirac", (4, 2, 3, 3)),
    ("Dirac-groups", (4, 4, 3)), ("Bilinear", (3, 2, 4, 4)),
    ("Bilinear-odd", (2, 2, 3, 5))])
def test_deterministic_initializers_equal_jax(name, shape):
    kind = name.split("-")[0]
    arg = {"Constant": (0.25,),
           "Assign": (np.arange(6, dtype=np.float32).reshape(2, 3),),
           "Dirac": (), "Bilinear": ()}[kind]
    kw = {"groups": 2} if name == "Dirac-groups" else {}
    want = np.asarray(getattr(JI, kind)(*arg, **kw)(shape, jnp.float32))
    got = getattr(TI, kind)(*arg, **kw)(shape, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_assign_refuses_another_shape():
    with pytest.raises(ValueError, match="shape"):
        TI.Assign(np.zeros((2, 2)))((3, 2), torch.float32)


@pytest.mark.parametrize("name,shape,law", [
    ("Uniform", (64, 256), ("uniform", -1.0, 1.0)),
    ("TruncatedNormal", (64, 256), ("truncnorm", 0.0, 1.0)),
    ("XavierNormal", (128, 256), ("normal", 0.0, (2 / 384) ** 0.5)),
    ("XavierUniform", (16, 8, 3, 3), ("uniform", -(6 / 216) ** 0.5,
                                      (6 / 216) ** 0.5)),
    ("KaimingUniform", (8, 16, 3, 3), ("uniform", -(6 / 144) ** 0.5,
                                       (6 / 144) ** 0.5)),
    ("KaimingNormal", (256, 128), ("normal", 0.0, (2 / 256) ** 0.5)),
])
def test_random_initializers_follow_their_law(name, shape, law):
    """Bounds, mean and std against the law's, within 4 standard errors
    (the JAX package's fans: conv kernels [out, in, *k])."""
    g = torch.Generator().manual_seed(0)
    x = getattr(TI, name)()(shape, torch.float32, generator=g).double()
    assert tuple(x.shape) == shape
    n = x.numel()
    kind, a, b = law
    if kind == "uniform":
        assert a <= x.min() and x.max() < b
        mean, std = (a + b) / 2, (b - a) / 12 ** 0.5
    elif kind == "truncnorm":
        assert -2.0 <= x.min() and x.max() <= 2.0
        mean, std = a, b * 0.8796   # sd of N(0,1) truncated to [-2, 2]
    else:
        mean, std = a, b
    assert abs(float(x.mean()) - mean) <= 4 * std / n ** 0.5
    assert abs(float(x.std()) - std) <= 4 * std / (2 * n) ** 0.5
    # the JAX initializer follows the same law
    want = np.asarray(getattr(JI, name)()(shape, jnp.float32), np.float64)
    assert abs(want.mean() - mean) <= 4 * std / n ** 0.5


@pytest.mark.parametrize("shape", [(16, 16), (8, 32), (32, 8),
                                   (4, 3, 6)])
def test_orthogonal_is_orthogonal(shape):
    q = TI.Orthogonal(gain=1.0)(shape, torch.float32).reshape(-1,
                                                               shape[-1])
    rows, cols = q.shape
    qq = q.t() @ q if rows >= cols else q @ q.t()
    torch.testing.assert_close(qq, torch.eye(min(rows, cols)), rtol=0,
                               atol=1e-5)
    want = np.asarray(JI.Orthogonal()(shape, jnp.float32)).reshape(
        -1, shape[-1])
    assert want.shape == tuple(q.shape)
    assert TI.calculate_gain("tanh") == JI.calculate_gain("tanh")


def test_global_initializer_reaches_linear():
    TI.set_global_initializer(TI.Constant(0.5), TI.Constant(0.25))
    try:
        lin = tpt.nn.Linear(3, 2)
        assert torch.equal(lin.weight, torch.full((3, 2), 0.5))
        assert torch.equal(lin.bias, torch.full((2,), 0.25))
    finally:
        TI.set_global_initializer(None, None)
    assert TI.get_global_initializer() is None


# ---------------------------------------------------------------------------
# dropout2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,p", [("NCHW", 0.5), ("NHWC", 0.3)])
def test_dropout2d_equals_jax(fmt, p):
    """Whole channels dropped on the key ``next_key()`` of a stream
    rooted at the same key: the JAX package's masks and values."""
    x = np.random.RandomState(0).randn(4, 6, 5, 3).astype(np.float32)
    jpt.seed(7)
    tpt.seed(7)
    with jrng.key_guard(jax.random.PRNGKey(3)):
        want = np.asarray(JF.dropout2d(jnp.asarray(x), p,
                                       data_format=fmt))
    from paddle_tpu_torch.core import threefry
    with trng.key_guard(threefry.prng_key(3)):
        got = TF.dropout2d(torch.from_numpy(x), p, data_format=fmt)
    np.testing.assert_array_equal(got.numpy(), want)
    chan = (0, 1) if fmt == "NCHW" else (0, 3)
    red = tuple(i for i in range(4) if i not in chan)
    zero = (got == 0).all(dim=red)
    assert zero.any() and (~zero).any()
    layer = tpt.nn.Dropout2D(p, data_format=fmt)
    assert torch.equal(layer.eval()(torch.from_numpy(x)),
                       torch.from_numpy(x))
