"""The vision zoo of the port (``paddle_tpu_torch/models/{resnet,vgg,
mobilenet,lenet,vision_extra}.py``) against the JAX package's, cut into
files of at most 26 tests by ``tests/torch_parts.py``
(``test_torch_vision_models*.py``).

Every constructor of ``tests/test_models_vision.py`` plus resnet18 / 34
/ 50, vgg11, MobileNet v1 / v2 and LeNet, at that file's input sizes
(2 x 3 x 64^2, 75^2 for InceptionV3, 224^2 for AlexNet and VGG, 1 x
28^2 for LeNet): the port's model (its own seeded initialisation, the
BatchNorm statistics and affine parameters randomized) carries its state
into the JAX model through numpy; the eval forward is held to the JAX
forward, and, for five models of different block families, one
``Model.train_batch`` step (SGD 0.01, cross entropy, both key streams
seeded alike for the dropouts) to the JAX step.
float32 throughout. The limits are relative to a tensor's scale, not to
each element, and were set from measurement: two conv libraries sum in
different orders through up to 169 layers, and a logit near zero then
sits up to 2.3x over ``1e-6 + 1e-5 |jax|`` while every logit is within
1.7e-6 of the largest; so every logit within ``1e-5 max |logits|``.
The five steps: the loss within 1e-5 relative (2.1e-6 measured), the
step's update of all parameters together within 1e-3 in relative norm
(1.1e-4, mobilenet_v1, whose BatchNorms see 2 x 2 pixels of 2 images
at the end) and every BatchNorm buffer within ``1e-4 max |buffer|``
(1.6e-5). The JAX models
are built with a constant initializer (their weights are replaced
anyway), which keeps their construction off the random-init path that
compiles a kernel a shape.
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpt
import paddle_tpu_torch as tpt
from paddle_tpu import models as jmodels
from paddle_tpu.core import rng as jrng
from paddle_tpu.nn import initializer as JI
from paddle_tpu.nn.layer import functional_call as jcall
from paddle_tpu.nn.layer import split_state as jsplit
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import rng as trng
from torch_parts import split

LOGIT_TOL = 1e-5      # a logit, over the logits' max |.|
BUFFER_TOL = 1e-4     # a BatchNorm buffer after a step, over its max |.|
LOSS_RTOL = 1e-5
UPDATE_RTOL = 1e-3    # the step's update, all parameters, relative norm
CLASSES = 10

# (constructor, kwargs, input shape); the JAX tests' sizes
MODELS = [
    ("resnet18", {}, (2, 3, 64, 64)),
    ("resnet34", {}, (2, 3, 64, 64)),
    ("resnet50", {}, (2, 3, 64, 64)),
    ("vgg11", {}, (2, 3, 224, 224)),
    ("mobilenet_v1", {"scale": 0.25}, (2, 3, 64, 64)),
    ("mobilenet_v2", {"scale": 0.5}, (2, 3, 64, 64)),
    ("LeNet", {}, (2, 1, 28, 28)),
    ("alexnet", {}, (2, 3, 224, 224)),
    ("squeezenet1_1", {}, (2, 3, 64, 64)),
    ("densenet121", {}, (2, 3, 64, 64)),
    ("googlenet", {}, (2, 3, 64, 64)),
    ("shufflenet_v2_x0_5", {}, (2, 3, 64, 64)),
    ("resnext50_32x4d", {}, (2, 3, 64, 64)),
    ("wide_resnet50_2", {}, (2, 3, 64, 64)),
    ("mobilenet_v3_small", {}, (2, 3, 64, 64)),
    ("mobilenet_v3_large", {}, (2, 3, 64, 64)),
    ("shufflenet_v2_x0_25", {}, (2, 3, 64, 64)),
    ("shufflenet_v2_swish", {}, (2, 3, 64, 64)),
    ("densenet169", {}, (2, 3, 64, 64)),
    ("inception_v3", {}, (2, 3, 75, 75)),
]
_BY_NAME = {m[0]: m for m in MODELS}


def _close_to_scale(got, want, tol, what=""):
    """Every element within ``tol`` of the tensor's largest."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               atol=tol * np.abs(want).max(), rtol=0,
                               err_msg=what)


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randint(0, CLASSES, (shape[0], 1)).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _state(name):
    """The port's seeded initial state, BatchNorm randomized: numpy."""
    _, kw, _ = _BY_NAME[name]
    tpt.seed(0)
    net = getattr(tmodels, name)(num_classes=CLASSES, device="cpu", **kw)
    state = {k: v.detach().numpy().copy() for k, v in
             net.state_dict().items()}
    rs = np.random.RandomState(1)
    for k, v in state.items():
        if k.endswith("_mean"):
            state[k] = rs.randn(*v.shape).astype(np.float32) * 0.1
        elif k.endswith("_variance"):
            state[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
    bn = {k.rsplit(".", 1)[0] for k in state if k.endswith("_mean")}
    for k, v in state.items():
        layer, leaf = k.rsplit(".", 1)
        if layer in bn and leaf == "weight":
            state[k] = rs.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif layer in bn and leaf == "bias":
            state[k] = rs.randn(*v.shape).astype(np.float32) * 0.1
    return state


def _jax_net(name):
    _, kw, _ = _BY_NAME[name]
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        net = getattr(jmodels, name)(num_classes=CLASSES, **kw)
    finally:
        JI.set_global_initializer(None, None)
    net.set_state_dict(_state(name))
    return net


def _port_net(name):
    from paddle_tpu_torch.interop import load_reference_state
    _, kw, _ = _BY_NAME[name]
    net = getattr(tmodels, name)(num_classes=CLASSES, device="cpu", **kw)
    return load_reference_state(net, _state(name))


@functools.lru_cache(maxsize=None)
def _jax_forward(name):
    """The JAX model's eval logits and its state's (key, shape) list."""
    net = _jax_net(name)
    keys = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    params, bufs = jsplit(net)
    x, _ = _inputs(_BY_NAME[name][2])
    fwd = jax.jit(lambda p, b, x: jcall(net, p, b, x, training=False)[0])
    return np.asarray(fwd(params, bufs, jnp.asarray(x))), keys


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    net = _jax_net(name)
    model = jpt.Model(net)
    model.prepare(optimizer=jpt.optimizer.SGD(learning_rate=0.01,
                                              parameters=net),
                  loss=jpt.nn.CrossEntropyLoss())
    x, y = _inputs(_BY_NAME[name][2], seed=2)
    jrng.seed(3)
    loss = float(model.train_batch([x], [y])["loss"])
    model.sync_weights()
    return loss, {k: np.asarray(v) for k, v in net.state_dict().items()}


def forward_matches(name):
    """The state-dict keys and shapes (BatchNorm's ``_mean`` /
    ``_variance`` among them) and the eval forward of the port's model
    == the JAX model's."""
    net = _port_net(name)
    want, keys = _jax_forward(name)
    assert sorted((k, tuple(v.shape)) for k, v in
                  net.state_dict().items()) == sorted(keys)
    net.eval()
    x, _ = _inputs(_BY_NAME[name][2])
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert tuple(out.shape) == (x.shape[0], CLASSES)
    _close_to_scale(out, want, LOGIT_TOL, "logits")


def train_step_matches(name):
    """One SGD ``train_batch`` step: the loss, the update of the
    parameters and every BatchNorm buffer after it against the JAX
    step's (limits in the module docstring)."""
    net = _port_net(name)
    model = tpt.Model(net)
    model.prepare(optimizer=tpt.optimizer.SGD(learning_rate=0.01,
                                              parameters=net),
                  loss=tpt.nn.CrossEntropyLoss())
    x, y = _inputs(_BY_NAME[name][2], seed=2)
    trng.seed(3)
    loss = float(model.train_batch([x], [y])["loss"])
    want_loss, want = _jax_step(name)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    start, got = _state(name), net.state_dict()
    assert sorted(got) == sorted(want)
    upd_got, upd_want = [], []
    for k, v in want.items():
        if k.endswith(("_mean", "_variance")):
            _close_to_scale(got[k], v, BUFFER_TOL, k)
        else:
            upd_got.append(got[k].numpy().ravel() - start[k].ravel())
            upd_want.append(v.ravel() - start[k].ravel())
    upd_got, upd_want = np.concatenate(upd_got), np.concatenate(upd_want)
    rel = np.linalg.norm(upd_got - upd_want) / np.linalg.norm(upd_want)
    assert rel <= UPDATE_RTOL, rel


def resnet50_param_count():
    """resnet50() has torchvision / paddle's 25 557 032 parameters."""
    net = tmodels.resnet50(device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 25_557_032


def batchnorm_buffers_move_in_training():
    """A port train step moves every BatchNorm's running statistics
    (``train_step_matches`` holds their values to the JAX step's)."""
    net = _port_net("resnet18")
    model = tpt.Model(net)
    model.prepare(optimizer=tpt.optimizer.SGD(learning_rate=0.01,
                                              parameters=net),
                  loss=tpt.nn.CrossEntropyLoss())
    x, y = _inputs(_BY_NAME["resnet18"][2], seed=2)
    model.train_batch([x], [y])
    start = _state("resnet18")
    after = net.state_dict()
    stats = [k for k in start if k.endswith(("_mean", "_variance"))]
    assert len(stats) == 40
    assert all(not np.allclose(start[k], after[k].numpy()) for k in stats)


def channel_shuffle_matches():
    """``channel_shuffle`` permutes channels as the JAX one does."""
    from paddle_tpu.models.vision_extra import channel_shuffle as jcs
    from paddle_tpu_torch.models.vision_extra import channel_shuffle as tcs
    x = np.arange(2 * 12 * 2 * 3, dtype=np.float32).reshape(2, 12, 2, 3)
    for g in (2, 3, 4):
        np.testing.assert_array_equal(
            tcs(torch.from_numpy(x), g).numpy(),
            np.asarray(jcs(jnp.asarray(x), g)))


def make_divisible_matches():
    from paddle_tpu.models.mobilenet import _make_divisible as jmd
    from paddle_tpu_torch.models.mobilenet import _make_divisible as tmd
    for v in (3, 8, 15.5, 16 * 0.25, 32 * 0.75, 1280 * 1.3, 96):
        assert tmd(v) == jmd(v)


def default_device_is_the_card():
    """With no ``device`` a model goes to the card, and without one it
    raises rather than run on the CPU."""
    import pytest
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for ctor in (tmodels.resnet18, tmodels.LeNet, tmodels.squeezenet1_1):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor()


_NAMES = [m[0] for m in MODELS]
# train steps held to the JAX step: the JAX test's train model
# (squeezenet1_1) and four more of different block families, the
# cheapest JAX compiles (5-15 s each). A JAX train step of the deeper
# families takes 25-90 s of compilation (densenet121 86 s) and adds
# nothing these five and the forwards do not hold: the backward is
# torch's autograd through the layers the forwards already hold, and
# the chip phase holds a train step on the card to the CPU
_TRAIN = ["resnet18", "vgg11", "mobilenet_v1", "LeNet", "squeezenet1_1"]

# three files of about equal JAX compile time (xdist runs each file in
# one worker): the train steps with the light forwards, then two sets
# of heavier forwards
_FORWARDS_A = ["resnet18", "resnet34", "vgg11", "LeNet", "alexnet"]
_FORWARDS_B = ["densenet169", "mobilenet_v3_large", "resnet50",
               "mobilenet_v1", "mobilenet_v2", "squeezenet1_1",
               "shufflenet_v2_x0_5"]
_FORWARDS_C = [n for n in _NAMES if n not in _FORWARDS_A + _FORWARDS_B]

TESTS = [
    ("test_train_step_matches_jax", train_step_matches,
     [(n,) for n in _TRAIN], _TRAIN),
    ("test_resnet50_param_count", resnet50_param_count, None, None),
    ("test_batchnorm_buffers_move_in_training",
     batchnorm_buffers_move_in_training, None, None),
    ("test_channel_shuffle_matches_jax", channel_shuffle_matches, None,
     None),
    ("test_make_divisible_matches_jax", make_divisible_matches, None,
     None),
    ("test_default_device_is_the_card", default_device_is_the_card, None,
     None),
    ("test_forward_matches_jax", forward_matches,
     [(n,) for n in _FORWARDS_A], _FORWARDS_A),
]
TESTS_B = [("test_forward_matches_jax", forward_matches,
            [(n,) for n in _FORWARDS_B], _FORWARDS_B)]
TESTS_C = [("test_forward_matches_jax", forward_matches,
            [(n,) for n in _FORWARDS_C], _FORWARDS_C)]

PARTS = split(TESTS, 1) + split(TESTS_B, 1) + split(TESTS_C, 1)
