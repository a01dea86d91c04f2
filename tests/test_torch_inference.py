"""The port's native predictor (``paddle_tpu_torch.inference``: the
libtorch runner of ``native/predictor.cc`` behind the ctypes facade)
against the JAX package's forward.

The JAX package's LeNet at [2, 1, 28, 28], ``resnet18(num_classes=10)``
at [1, 3, 64, 64] and the GPT of ``tests/test_inference_native.py``
(vocab 128, width 32, 2 layers, 2 heads, 16 positions) carry their
weights into the port's models (``interop.load_reference_state``); the
port's ``jit.save`` writes the artifact, and
``create_predictor(Config(dir, device="cpu")).run`` serves it. The
served logits are held to the JAX forward within ``1e-5 + 1e-4 |ref|``
and to the port's ``jit.load`` bit for bit: the runner calls the same
ATen kernels. The JAX models are built under a constant initializer
(their weights are replaced), which keeps them off the random-init path
that compiles a kernel a shape; their forwards are shared through
``lru_cache``. Also: 4 threads x 12 requests on the MLP of
``tests/test_inference_serving.py`` equal to the serial runs, a fresh
process that imports neither JAX nor the JAX package, the input checks
(a wrong shape raises ``ValueError``; int32 ids run as the program's
int64), a bfloat16 artifact, the handle-style API, and the refusals: no
card for the default device, an encrypted artifact."""

import atexit
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu.nn import initializer as JI  # noqa: E402
from paddle_tpu.nn.layer import functional_call as jcall  # noqa: E402
from paddle_tpu.nn.layer import split_state as jsplit  # noqa: E402
from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _tmpdir(prefix):
    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, True)
    return d


def _gpt_cfg(m):
    return m.models.gpt.GPTConfig(
        vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=16, hidden_dropout=0.0,
        attention_dropout=0.0, use_flash=False)


# name -> (JAX constructor, port constructor, input, InputSpec)
MODELS = {
    "lenet": (lambda: jmodels.LeNet(num_classes=10),
              lambda: tpt.models.LeNet(num_classes=10, device="cpu"),
              lambda: np.random.RandomState(0).randn(2, 1, 28, 28)
              .astype(np.float32),
              ([None, 1, 28, 28], "float32")),
    "resnet18": (lambda: jmodels.resnet18(num_classes=10),
                 lambda: tpt.models.resnet18(num_classes=10, device="cpu"),
                 lambda: np.random.RandomState(0).randn(1, 3, 64, 64)
                 .astype(np.float32),
                 ([None, 3, 64, 64], "float32")),
    "gpt": (lambda: jmodels.gpt.GPTForCausalLM(_gpt_cfg(jpt)),
            lambda: tpt.models.gpt.GPTForCausalLM(_gpt_cfg(tpt),
                                                  device="cpu"),
            lambda: np.random.RandomState(0).randint(0, 128, (2, 16))
            .astype(np.int64),
            ([None, None], "int64")),
}


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX model's state (seeded numpy, BatchNorm statistics
    randomized) and its eval forward on the model's input."""
    jctor, tctor, make_x, _ = MODELS[name]
    tpt.seed(0)
    state = {k: v.detach().numpy().copy()
             for k, v in tctor().state_dict().items()}
    rs = np.random.RandomState(1)
    for k, v in state.items():
        if k.endswith("_mean"):
            state[k] = rs.randn(*v.shape).astype(np.float32) * 0.1
        elif k.endswith("_variance"):
            state[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
    JI.set_global_initializer(JI.Constant(0.0), JI.Constant(0.0))
    try:
        net = jctor()
    finally:
        JI.set_global_initializer(None, None)
    net.set_state_dict(state)
    net.eval()
    params, bufs = jsplit(net)
    fwd = jax.jit(lambda p, b, x: jcall(net, p, b, x, training=False)[0])
    want = np.asarray(fwd(params, bufs, jnp.asarray(make_x())))
    return {k: np.asarray(v) for k, v in net.state_dict().items()}, want


@functools.lru_cache(maxsize=None)
def _artifact(name):
    """The port's model carrying the JAX weights, saved by jit.save."""
    _, tctor, _, (shape, dtype) = MODELS[name]
    net = load_reference_state(tctor(), _jax(name)[0])
    net.eval()
    d = _tmpdir(f"infer_{name}_")
    tjit.save(net, d, input_spec=[tjit.InputSpec(shape, dtype)])
    return d


@functools.lru_cache(maxsize=None)
def _predictor(name):
    return inference.create_predictor(
        inference.Config(_artifact(name), device="cpu"))


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_predictor_matches_jax_forward(name):
    out = _predictor(name).run([MODELS[name][2]()])
    assert len(out) == 1
    _close(out[0], _jax(name)[1])


@pytest.mark.parametrize("name", list(MODELS))
def test_predictor_equals_jit_load_bit_for_bit(name):
    x = MODELS[name][2]()
    got = _predictor(name).run([x])[0]
    with torch.no_grad():
        want = tjit.load(_artifact(name), device="cpu")(torch.from_numpy(x))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.numpy())


def test_gpt_other_lengths_equal_jit_load():
    """The symbolic batch and length dims take other sizes than the
    traced ones."""
    pred = _predictor("gpt")
    loaded = tjit.load(_artifact("gpt"), device="cpu")
    for shape in ((1, 16), (3, 5), (5, 2)):
        ids = np.random.RandomState(sum(shape)).randint(0, 128, shape)
        np.testing.assert_array_equal(
            pred.run([ids])[0], loaded(torch.as_tensor(ids)).numpy())


def test_symbolic_size_arithmetic_equals_jit_load(tmp_path):
    """A forward that reshapes by products of symbolic sizes (the graph's
    ``_operator.mul`` of ``sym_size`` nodes) at sizes other than the
    traced ones."""
    class Flat(tpt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.l = tpt.nn.Linear(8, 4)

        def forward(self, x):
            b, s, h = x.shape
            return self.l(x.reshape(b * s, h)).reshape(b, s * 4)

    tpt.seed(0)
    net = Flat().eval()
    tjit.save(net, str(tmp_path), input_spec=[tjit.InputSpec([None, None, 8],
                                                             "float32")])
    pred = inference.create_predictor(
        inference.Config(str(tmp_path), device="cpu"))
    loaded = tjit.load(str(tmp_path), device="cpu")
    for shape in ((3, 5, 8), (2, 9, 8)):
        x = np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)
        got = pred.run([x])[0]
        assert got.shape == (shape[0], shape[1] * 4)
        np.testing.assert_array_equal(got,
                                      loaded(torch.from_numpy(x)).numpy())


def _mlp_artifact():
    """The MLP of tests/test_inference_serving.py, saved at [4, 16]."""
    class MLP(tpt.nn.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = tpt.nn.Linear(16, 64)
            self.l2 = tpt.nn.Linear(64, 8)

        def forward(self, x):
            return self.l2(tpt.nn.functional.relu(self.l1(x)))

    tpt.seed(0)
    net = MLP()
    net.eval()
    d = _tmpdir("infer_mlp_")
    tjit.save(net, d, input_spec=[tjit.InputSpec([4, 16], "float32")])
    return net, d


def test_threads_match_serial_runs():
    """4 threads x 12 requests on one predictor: each result equals the
    same request run alone (each call owns its result)."""
    net, d = _mlp_artifact()
    pred = inference.create_predictor(inference.Config(d, device="cpu"))
    rng = np.random.RandomState(0)
    xs = [rng.randn(4, 16).astype(np.float32) for _ in range(48)]
    serial = [pred.run([x])[0] for x in xs]
    with torch.no_grad():
        _close(serial[0], net(torch.from_numpy(xs[0])).numpy())
    outs, errs = [None] * len(xs), []

    def worker(t):
        try:
            for i in range(t, len(xs), 4):
                outs[i] = pred.run([xs[i]])[0]
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errs, errs
    for o, s in zip(outs, serial):
        np.testing.assert_array_equal(o, s)


def test_fresh_process_without_jax_serves_lenet():
    d = _artifact("lenet")
    x = MODELS["lenet"][2]()
    xpath = os.path.join(d, "x_fresh.npy")
    np.save(xpath, x)
    code = (
        "import sys, json, numpy as np\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from paddle_tpu_torch import inference\n"
        "p = inference.create_predictor(inference.Config(sys.argv[1], "
        "device='cpu'))\n"
        "out = p.run([np.load(sys.argv[2])])[0]\n"
        "np.save(sys.argv[3], out)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'paddle_tpu.')) or m == 'paddle_tpu')))\n")
    opath = os.path.join(d, "out_fresh.npy")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, d, xpath, opath],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    np.testing.assert_array_equal(np.load(opath),
                                  _predictor("lenet").run([x])[0])
    _close(np.load(opath), _jax("lenet")[1])


def test_wrong_shape_raises_value_error():
    pred = _predictor("lenet")
    with pytest.raises(ValueError, match="expected shape"):
        pred.run([np.zeros((2, 1, 27, 28), np.float32)])
    with pytest.raises(ValueError, match="expected shape"):
        pred.run([np.zeros((1, 28, 28), np.float32)])
    with pytest.raises(ValueError, match="expected 1 inputs"):
        pred.run([np.zeros((2, 1, 28, 28), np.float32)] * 2)
    with pytest.raises(ValueError, match="expected shape"):
        _predictor("gpt").run([np.zeros((4,), np.int64)])


def test_int32_ids_run_as_int64():
    ids = MODELS["gpt"][2]()
    pred = _predictor("gpt")
    np.testing.assert_array_equal(pred.run([ids.astype(np.int32)])[0],
                                  pred.run([ids])[0])


def test_handle_api_matches_run():
    pred = _predictor("lenet")
    x = MODELS["lenet"][2]()
    assert pred.get_input_names() == ["input_0"]
    assert pred.get_output_names() == ["output_0"]
    pred.get_input_handle("input_0").copy_from_cpu(x)
    pred.run()
    np.testing.assert_array_equal(
        pred.get_output_handle("output_0").copy_to_cpu(),
        pred.run([x])[0])


def test_bfloat16_artifact_equals_jit_load(tmp_path):
    """bfloat16 state is written as float32 and cast back to the traced
    dtype at create; a bfloat16 output comes back widened to float32."""
    _, tctor, make_x, (shape, dtype) = MODELS["gpt"]
    net = load_reference_state(tctor(), _jax("gpt")[0])
    net = net.to(torch.bfloat16).eval()
    tjit.save(net, str(tmp_path), input_spec=[tjit.InputSpec(shape, dtype)])
    ids = make_x()
    got = inference.create_predictor(
        inference.Config(str(tmp_path), device="cpu")).run([ids])[0]
    want = tjit.load(str(tmp_path), device="cpu")(torch.as_tensor(ids))
    assert want.dtype == torch.bfloat16 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want.float().numpy())


def test_default_device_is_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device serves")
    assert inference.Config(_artifact("lenet")).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.create_predictor(inference.Config(_artifact("lenet")))


def test_encrypted_artifact_refused(tmp_path):
    _, tctor, _, (shape, dtype) = MODELS["lenet"]
    net = load_reference_state(tctor(), _jax("lenet")[0]).eval()
    tjit.save(net, str(tmp_path), input_spec=[tjit.InputSpec(shape, dtype)],
              encrypt_key=bytes(range(32)))
    with pytest.raises(RuntimeError, match="plaintext artifacts only"):
        inference.create_predictor(
            inference.Config(str(tmp_path), device="cpu"))


def test_missing_model_dir_and_options_refused(tmp_path):
    with pytest.raises(ValueError, match="model_dir"):
        inference.create_predictor(inference.Config(device="cpu"))
    cfg = inference.Config(_artifact("lenet"), device="cpu")
    cfg.set_pjrt_plugin(inference.default_plugin(), "threads=i:2")
    with pytest.raises(RuntimeError, match="unknown option"):
        inference.create_predictor(cfg)
    cfg.set_pjrt_plugin(inference.default_plugin(), "num_threads=i:2")
    threads = torch.get_num_threads()
    try:
        pred = inference.create_predictor(cfg)
        assert torch.get_num_threads() == 2
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(
        pred.run([MODELS["lenet"][2]()])[0],
        _predictor("lenet").run([MODELS["lenet"][2]()])[0])


def test_lazy_llm_names():
    from paddle_tpu_torch.inference import llm, prefix_cache
    assert inference.LLMEngine is llm.LLMEngine
    assert inference.serve_llm is llm.serve_llm
    assert inference.PrefixCache is prefix_cache.PrefixCache
    with pytest.raises(AttributeError):
        inference.NoSuchName  # noqa: B018
