"""Kernel B1's op as C++ defines it (``csrc/torch_ops.cc``), ``ptserve``
(``native/predictor_main.cc``) and the native builds.

The op ``paddle_tpu_torch::flash_attention_fwd`` is defined once, in
C++: its CPU impl (the plain twin in ATen) gives the bits of
``ops/flash_attention.py::flash_attention_fwd_torch`` at head dims 64
and 80, causal or not, with GQA 4:1, and holds the Pallas kernel in
interpret mode within the flash tests' f32 limit (1e-5); the fake
(shapes under ``FakeTensorMode``) and the FLOP formula stay in Python;
B1's launch counter lives in the op library and reads through
``launches``. ``ptserve --parse-only`` reads the four NPY cases of
``tests/test_inference_serving.py``; a CPU run on a tiny GPT artifact
prints the ``out0_sum`` of ``Predictor`` and B1's launches (0 on the
CPU); on ``cuda`` with no card it exits non-zero. A source that does not
compile raises with the compiler's output."""

import importlib
import json
import math
import os
import re
import subprocess

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch import inference  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.core import native_build  # noqa: E402
from paddle_tpu_torch.ops import flash_attention as tfa  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")

# (q shape, k shape, causal): head dims 64 and 80, GQA 4:1
OP_CASES = {
    "d64-causal-gqa4": ((2, 33, 8, 64), (2, 33, 2, 64), True),
    "d80-causal": ((1, 40, 2, 80), (1, 40, 2, 80), True),
    "d64": ((1, 17, 2, 64), (1, 29, 2, 64), False),
    "d80-gqa4": ((2, 24, 4, 80), (2, 31, 1, 80), False),
    "d80-causal-gqa4-cross": ((1, 19, 4, 80), (1, 45, 1, 80), True),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _qkv(qs, ks, seed=0, dtype=torch.float32):
    r = np.random.RandomState(seed)
    return [torch.from_numpy(r.randn(*s).astype(np.float32)).to(dtype)
            for s in (qs, ks, ks)]


@pytest.mark.parametrize("case", list(OP_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_cpu_impl_gives_the_twins_bits(case, dtype):
    """One thread: bfloat16 CPU products are not reproducible across
    thread splits, even between two calls of the same function."""
    qs, ks, causal = OP_CASES[case]
    q, k, v = _qkv(qs, ks, dtype=getattr(torch, dtype))
    scale = 1.0 / math.sqrt(qs[-1])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        o, lse = torch.ops.paddle_tpu_torch.flash_attention_fwd(
            q, k, v, scale, causal)
        wo, wlse = tfa.flash_attention_fwd_torch(q, k, v, scale, causal)
    finally:
        torch.set_num_threads(threads)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (qs[0], qs[2], qs[1])
    assert torch.equal(o, wo) and torch.equal(lse, wlse)


def test_op_matches_pallas_interpret():
    qs, ks, causal = (1, 128, 4, 64), (1, 128, 2, 64), True
    q, k, v = _qkv(qs, ks, seed=3)
    want = jfa.flash_attention(*[jnp.asarray(x.numpy()) for x in (q, k, v)],
                               causal=causal, interpret=True)
    o, _ = tfa.flash_attention_fwd_op(q, k, v, 1.0 / math.sqrt(64), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)


def test_op_defined_once_in_cpp():
    """The op has a C++ CPU kernel and no Python definition; its fake
    gives the shapes and its FLOP formula counts the twin's products."""
    from torch._library import custom_ops
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    name = "paddle_tpu_torch::flash_attention_fwd"
    assert name not in custom_ops.OPDEFS
    assert torch._C._dispatch_has_kernel_for_dispatch_key(name, "CPU")
    with FakeTensorMode():
        q, k = torch.empty(2, 5, 4, 64), torch.empty(2, 7, 2, 64)
        o, lse = tfa.flash_attention_fwd_op(q, k, k, 0.125, True)
    assert tuple(o.shape) == (2, 5, 4, 64) and tuple(lse.shape) == (2, 4, 5)
    q, k, v = _qkv((2, 5, 4, 64), (2, 7, 2, 64))
    with FlopCounterMode(display=False) as fc:
        tfa.flash_attention_fwd_op(q, k, v, 0.125, True)
    assert fc.get_total_flops() == 2 * 2 * 2 * 4 * 5 * 7 * 64


def test_launch_counter_lives_in_the_op_library():
    before = dict(tfa.launches)
    try:
        tfa.launches["flash_attention_fwd"] = 7
        assert tfa._ops.ptop_b1_launches() == 7
        tfa._ops.ptop_add_b1_launches(2)     # the eager wrapper's add
        assert tfa.launches["flash_attention_fwd"] == 9
        for k in tfa.launches:
            tfa.launches[k] = 0
        assert dict(tfa.launches) == {"flash_attention_fwd": 0,
                                      "flash_attention_bwd_dq": 0,
                                      "flash_attention_bwd_dkv": 0}
        with pytest.raises(KeyError):
            tfa.launches["nope"] = 1
        # the twins (the op's CPU impl) launch nothing
        tfa.flash_attention_fwd_op(*_qkv((1, 4, 2, 64), (1, 4, 2, 64)),
                                   0.125, False)
        assert tfa.launches["flash_attention_fwd"] == 0
    finally:
        for k, v in before.items():
            tfa.launches[k] = v


def test_impl_switch_reaches_the_op_library():
    assert tfa.impl == "kernel"
    try:
        tfa.impl = "plain"
        assert tfa.__dict__["impl"] == "plain" and tfa.impl == "plain"
    finally:
        tfa.impl = "kernel"
    assert tfa.impl == "kernel"


def test_native_sources_include_no_jax_xla_or_pjrt():
    srcs = [os.path.join(ROOT, "paddle_tpu_torch", d, f)
            for d in ("csrc", "native")
            for f in os.listdir(os.path.join(ROOT, "paddle_tpu_torch", d))
            if f.endswith((".cc", ".cu", ".h"))]
    assert len(srcs) >= 6
    for path in srcs:
        with open(path) as f:
            incs = re.findall(r"#include\s*[<\"]([^>\"]+)", f.read())
        assert not [i for i in incs if re.search(r"xla|pjrt|jax", i)], path


@pytest.fixture(scope="module")
def ptserve():
    return inference.build_ptserve()


def test_ptserve_parse_only_reads_npy_headers(ptserve, tmp_path):
    cases = {"a": np.ones((8, 16), np.float32),
             "b": np.arange(6, dtype=np.int64),
             "c": np.zeros((2, 3, 4), np.float64),
             "d": np.zeros((5,), np.int32)}
    paths = []
    for name, arr in cases.items():
        p = str(tmp_path / f"{name}.npy")
        np.save(p, arr)
        paths.append((p, arr))
    proc = subprocess.run([ptserve, "x", "", "y"] + [p for p, _ in paths] +
                          ["--parse-only"], capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.strip().splitlines()]
    codes = {np.float32: 0, np.float64: 1, np.int32: 2, np.int64: 3}
    for (p, arr), rec in zip(paths, lines):
        assert rec["dims"] == list(arr.shape), (p, rec)
        assert rec["nbytes"] == arr.nbytes, (p, rec)
        assert rec["dtype_code"] == codes[arr.dtype.type]


@pytest.fixture(scope="module")
def tiny_gpt(tmp_path_factory):
    """A tiny GPT whose head dim (64) takes the flash op, saved by
    jit.save, and ids for it."""
    tpt.set_device("cpu")
    try:
        cfg = tpt.models.gpt.gpt_config(
            "gpt2-small", num_layers=2, hidden_size=128, num_heads=2,
            vocab_size=128, max_position_embeddings=16, hidden_dropout=0.0,
            attention_dropout=0.0)
        tpt.seed(0)
        net = tpt.models.gpt.GPTForCausalLM(cfg, device="cpu").eval()
        d = str(tmp_path_factory.mktemp("ptserve_gpt"))
        tjit.save(net, d, input_spec=[tjit.InputSpec([None, None],
                                                     "int64")])
    finally:
        tdev.set_current(None)
    ids = np.random.RandomState(4).randint(0, 128, (3, 11)).astype(np.int64)
    np.save(os.path.join(d, "ids.npy"), ids)
    return d, ids


def test_ptserve_cpu_sum_equals_predictor(ptserve, tiny_gpt):
    d, ids = tiny_gpt
    with open(os.path.join(d, "program.pt2"), "rb") as f:
        assert b"paddle_tpu_torch.flash_attention_fwd" in f.read()
    proc = subprocess.run([ptserve, "cpu", "", d,
                           os.path.join(d, "ids.npy"), "--threads", "3",
                           "--iters", "2"], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["requests"] == 6 and out["threads"] == 3
    assert out["b1_launches"] == 0    # the CPU runs the op's twin
    pred = inference.create_predictor(inference.Config(d, device="cpu"))
    want = float(pred.run([ids])[0].astype(np.float64).sum())
    assert abs(out["out0_sum"] - want) <= 1e-6 * abs(want) + 5e-7


def test_ptserve_without_card_fails(ptserve, tiny_gpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d, _ = tiny_gpt
    proc = subprocess.run([ptserve, "cuda", "", d,
                           os.path.join(d, "ids.npy")], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "out0_sum" not in proc.stdout


def test_ptserve_bad_artifact_fails(ptserve, tiny_gpt, tmp_path):
    _, _ = tiny_gpt
    np.save(tmp_path / "x.npy", np.zeros((1, 4), np.int64))
    proc = subprocess.run([ptserve, "cpu", "", str(tmp_path),
                           str(tmp_path / "x.npy")], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 1 and "create failed" in proc.stderr


def test_runner_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken_runner.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    cflags, lflags = native_build.torch_flags()
    with pytest.raises(RuntimeError, match="broken_runner.cc failed"):
        native_build.build_native_lib(str(bad), cflags, lflags)


def test_torch_flags_follow_the_wheel():
    cflags, lflags = native_build.torch_flags()
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cflags
    assert "-std=c++20" in cflags
    assert ("-DPT_WITH_CUDA" in cflags) == bool(torch.version.cuda)
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    assert any(f.startswith("-L") and os.path.samefile(f[2:], torch_lib)
               for f in lflags)
    # the op library, the runner and ptserve live under build/
    for path in (tfa.ops_library_path(), inference.build_runner(),
                 inference.build_ptserve()):
        assert os.path.samefile(os.path.dirname(path),
                                native_build.BUILD_DIR)
