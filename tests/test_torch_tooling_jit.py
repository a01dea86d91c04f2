"""The port's ``jit`` and ``static`` against the JAX package's.

A tiny GPT (2 layers, hidden 128, 2 heads of d 64 so that the flash
path applies, vocab 128, seq 16) goes
through ``jit.save`` / ``jit.load`` (eager logits within ``1e-5 + 1e-4
|eager|`` at two input shapes, float32); the JAX package's saved
``params.pkl`` loads into the port's program, giving the JAX
``TranslatedLayer``'s logits within the same limit; ``params.pbin`` is
byte-equal to the JAX writer's for the same state; the exported graph
holds the ``paddle_tpu_torch`` flash op and no einsum of the twin.
Static programs built after the same seed hold the JAX package's
parameters bit for bit; their fetches and gradient fetches within
``1e-6 + 1e-5 |jax|``. The JAX saves are shared through ``lru_cache``."""

import atexit
import functools
import json
import os
import pickle
import shutil
import tempfile

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu import jit as jjit  # noqa: E402
from paddle_tpu import static as jst  # noqa: E402
from paddle_tpu_torch import jit as tjit  # noqa: E402
from paddle_tpu_torch import static as tst  # noqa: E402
from paddle_tpu_torch.core import device as tdev  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402

SEQ, VOCAB = 16, 128


@pytest.fixture(autouse=True)
def _on_cpu():
    tpt.set_device("cpu")
    yield
    tdev.set_current(None)


def _cfg(m):
    return m.models.gpt.gpt_config(
        "gpt2-small", num_layers=2, hidden_size=128, num_heads=2,
        vocab_size=VOCAB, max_position_embeddings=SEQ, hidden_dropout=0.0,
        attention_dropout=0.0)


def _close(got, want, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@functools.lru_cache(maxsize=None)
def _jax_saved():
    """The JAX GPT's state, its jit.save directory and its logits on the
    ids below."""
    jpt.seed(0)
    net = jpt.models.gpt.GPTForCausalLM(_cfg(jpt))
    net.eval()
    d = _tmpdir("jax_jit_")
    jjit.save(net, d, input_spec=[jjit.InputSpec([None, SEQ], "int32")])
    ids = _ids((3, SEQ))
    want = np.asarray(jjit.load(d)(jnp.asarray(ids, jnp.int32)))
    state = {k: np.asarray(v) for k, v in net.state_dict().items()}
    return state, d, want


def _tmpdir(prefix):
    d = tempfile.mkdtemp(prefix=prefix)
    atexit.register(shutil.rmtree, d, True)
    return d


def _ids(shape, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


@functools.lru_cache(maxsize=None)
def _port_saved():
    state, _, _ = _jax_saved()
    net = tpt.models.gpt.GPTForCausalLM(_cfg(tpt), device="cpu")
    load_reference_state(net, state)
    net.eval()
    d = _tmpdir("port_jit_")
    tjit.save(net, d, input_spec=[tjit.InputSpec([None, None], "int64")])
    return net, d


@pytest.mark.parametrize("shape", [(2, SEQ), (3, 11)], ids=["2x16", "3x11"])
def test_save_load_round_trip_equals_eager(shape):
    net, d = _port_saved()
    loaded = tjit.load(d, device="cpu")
    ids = torch.as_tensor(_ids(shape, 1))
    with torch.no_grad():
        want = net(ids)
    _close(loaded(ids), want)


def test_bfloat16_state_round_trips(tmp_path):
    """numpy has no bfloat16: params.pkl holds float32, and load casts
    each tensor back to the dtype the program traced."""
    state, _, _ = _jax_saved()
    net = tpt.models.gpt.GPTForCausalLM(_cfg(tpt), device="cpu")
    load_reference_state(net, state)
    net = net.to(torch.bfloat16).eval()
    tjit.save(net, str(tmp_path), input_spec=[tjit.InputSpec([None, SEQ],
                                                              "int64")])
    with open(tmp_path / "params.pkl", "rb") as f:
        assert {v.dtype for v in pickle.load(f)["params"].values()} == \
            {np.dtype(np.float32)}
    loaded = tjit.load(str(tmp_path), device="cpu")
    assert {t.dtype for t in loaded.state_dict().values()} == \
        {torch.bfloat16}
    ids = torch.as_tensor(_ids((2, SEQ), 2))
    with torch.no_grad():
        want = net(ids)
    # eager runs the plain math at length 16, the program B1's twin:
    # bf16 roundings apart (chip_smoke's bf16 limit)
    _close(loaded(ids).float(), want.float(), rtol=2e-2, atol=2e-2)


def test_jax_params_pkl_runs_in_the_port_program():
    state, jd, want = _jax_saved()
    _, d = _port_saved()
    loaded = tjit.load(d, device="cpu")
    with open(os.path.join(jd, "params.pkl"), "rb") as f:
        jstate = pickle.load(f)
    flat = {**jstate["params"], **jstate["buffers"]}
    loaded.set_state_dict(flat)
    got = loaded(torch.as_tensor(_ids((3, SEQ))))
    _close(got, want)
    assert set(loaded.state_dict()) == set(flat)


def test_params_pbin_byte_equal_to_jax_writer():
    _, jd, _ = _jax_saved()
    _, d = _port_saved()
    with open(os.path.join(jd, "params.pbin"), "rb") as f:
        want = f.read()
    with open(os.path.join(d, "params.pbin"), "rb") as f:
        got = f.read()
    assert got == want
    rs = np.random.RandomState(0)
    named = [("a", rs.randn(3, 4).astype(np.float32)),
             ("b.i", rs.randint(0, 9, (5,)).astype(np.int64)),
             ("c", np.zeros((2, 0, 3), np.int8))]
    with tempfile.TemporaryDirectory() as t:
        jjit._write_pbin(os.path.join(t, "j"), named)
        tjit._write_pbin(os.path.join(t, "t"), named)
        assert open(os.path.join(t, "j"), "rb").read() == \
            open(os.path.join(t, "t"), "rb").read()


def test_meta_json_has_the_jax_keys():
    _, jd, _ = _jax_saved()
    _, d = _port_saved()
    jm = json.load(open(os.path.join(jd, "meta.json")))
    tm = json.load(open(os.path.join(d, "meta.json")))
    assert set(tm) == set(jm)
    assert tm["n_state_args"] == jm["n_state_args"]
    assert tm["format_version"] == jm["format_version"] == 2
    assert tm["input_spec"] == [{"shape": [None, None], "dtype": "int64"}]
    assert tm["platforms"] == ["cpu"]
    assert tm["outputs"][0]["shape"][-1] == VOCAB
    assert all(isinstance(x, str) for x in
               tm["exported_inputs"][0]["shape"])


def test_exported_graph_runs_the_flash_op_not_the_twin():
    _, d = _port_saved()
    loaded = tjit.load(d, device="cpu")
    targets = [str(n.target) for n in loaded._exported.graph.nodes
               if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_attention_fwd" in t
               for t in targets) == 2            # one a layer
    assert not any("einsum" in t for t in targets)
    assert not any(t.startswith("aten.bmm") for t in targets)


def test_encrypted_save_refusals(tmp_path):
    net, _ = _port_saved()
    key = bytes(range(32))
    spec = [tjit.InputSpec([None, SEQ], "int64")]
    tjit.save(net, str(tmp_path / "e"), input_spec=spec, encrypt_key=key)
    assert "params.pbin" not in os.listdir(tmp_path / "e")
    with pytest.raises(ValueError, match="pass decrypt_key"):
        tjit.load(str(tmp_path / "e"), device="cpu")
    with pytest.raises(Exception):
        tjit.load(str(tmp_path / "e"), decrypt_key=bytes(32), device="cpu")
    ids = torch.as_tensor(_ids((2, SEQ)))
    with torch.no_grad():
        want = net(ids)
    _close(tjit.load(str(tmp_path / "e"), decrypt_key=key,
                     device="cpu")(ids), want)
    tjit.save(net, str(tmp_path / "p"), input_spec=spec)
    with pytest.raises(ValueError, match="NOT encrypted"):
        tjit.load(str(tmp_path / "p"), decrypt_key=key, device="cpu")


def test_to_static_and_markers(tmp_path):
    net, _ = _port_saved()
    sf = tjit.to_static(net, input_spec=[tjit.InputSpec([None, SEQ],
                                                        "int64")])
    ids = torch.as_tensor(_ids((2, SEQ)))
    with torch.no_grad():
        assert torch.equal(sf(ids), net(ids))
    tjit.save(sf, str(tmp_path / "s"))
    assert sorted(os.listdir(tmp_path / "s")) == [
        "meta.json", "params.pbin", "params.pkl", "program.pt2"]

    @tjit.not_to_static
    def f(x):
        return x + 1
    assert tjit.to_static(f) is f
    tjit.ProgramTranslator.get_instance().enable(False)
    try:
        assert tjit.to_static(net) is net
    finally:
        tjit.ProgramTranslator.get_instance().enable(True)
    out, traced = tjit.TracedLayer.trace(net, [ids])
    traced.save_inference_model(str(tmp_path / "t"))
    _close(tst.load_inference_model(str(tmp_path / "t"), device="cpu")(ids),
           out.detach())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            tjit.load(str(tmp_path / "t"))


# ---------------------------------------------------------------------------
# static programs
# ---------------------------------------------------------------------------

def _program(st, m, build):
    """Build ``build(st)`` in a fresh program after seeding ``m``; fetch
    its outputs and every parameter's gradient."""
    m.seed(0)
    main = st.Program()
    with st.program_guard(main):
        outs, loss, feed = build(st)
        grads = st.append_backward(loss)
    res = st.Executor().run(main, feed=feed,
                            fetch_list=list(outs) + [g for _, g in grads])
    return main, res


def _mlp(st):
    x = st.data("x", [4, 16])
    h = st.nn.fc(x, 8, activation="tanh")
    p = st.nn.sequence_softmax(h)
    y = st.nn.sequence_pool(p, "max")
    feed = {"x": np.random.RandomState(3).randn(4, 16).astype(np.float32)}
    return [h, p, y], y, feed


def _conv(st):
    x = st.data("img", [2, 3, 8, 8])
    c = st.nn.conv2d(x, 4, 3, padding=1)
    p = st.nn.sequence_pool(c, "max")
    feed = {"img": np.random.RandomState(4).randn(2, 3, 8, 8)
            .astype(np.float32)}
    return [c, p], p, feed


def _bn(st):
    x = st.data("x", [4, 3, 5])
    b = st.nn.batch_norm(x)
    f = st.nn.fc(b, 2, activation="relu")
    feed = {"x": np.random.RandomState(7).randn(4, 3, 5).astype(np.float32)}
    return [b, f], f, feed


def _embed(st):
    ids = st.data("ids", [3, 6], dtype="int64")
    e = st.nn.embedding(ids, [20, 8], padding_idx=0)
    ln = st.nn.layer_norm(e, begin_norm_axis=2)
    pooled = st.nn.sequence_pool(ln, "average")
    feed = {"ids": np.random.RandomState(5).randint(0, 20, (3, 6))}
    return [e, ln, pooled], pooled, feed


@pytest.mark.parametrize("build", [_mlp, _conv, _bn, _embed],
                         ids=["fc_softmax", "conv_pool", "bn_fc",
                              "embedding_ln"])
def test_static_program_equals_jax(build):
    jmain, want = _program(jst, jpt, build)
    tmain, got = _program(tst, tpt, build)
    assert len(tmain.state) == len(jmain.state)
    for t, j in zip(tmain.state.values(), jmain.state.values()):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))  # threefry
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-6)


def test_static_serialization_round_trip(tmp_path):
    main, _ = _program(tst, tpt, _mlp)
    prefix = str(tmp_path / "m")
    tst.save(main, prefix)
    other = tst.Program()
    tst.load(other, prefix)
    assert all(torch.equal(other.state[k], main.state[k])
               for k in main.state)
    state = tst.load_program_state(prefix)
    assert set(state) == set(main.state)
    prog = tst.deserialize_program(tst.serialize_program(program=main))
    assert [v.name for v in prog.list_vars()] == \
        [v.name for v in main.list_vars()]


def _control_flow(st, m, tensor):
    x = tensor([3.0])
    return [
        float(st.nn.cond(x > 2, lambda: x * 2, lambda: x - 1)[0]),
        float(st.nn.cond(False, lambda: x * 2, lambda: x - 1)[0]),
        [float(v) for v in st.nn.while_loop(
            lambda i, s: i < 5, lambda i, s: (i + 1, s + i),
            [tensor(0.0), tensor(0.0)])],
        float(st.nn.case([(x < 1, lambda: x), (x < 4, lambda: x * 10)],
                         default=lambda: x * 0)[0]),
        [float(st.nn.switch_case(tensor(i), [lambda: x, lambda: x + 1],
                                 default=lambda: x * 7)[0])
         for i in (0, 1, 5)],
        float(st.nn.switch_case(tensor(9), {1: lambda: x, 4: lambda: x + 4})
              [0]),
    ]


class _Gated(tpt.nn.Layer):
    """static.nn's control flow on tensor predicates inside a forward."""

    def __init__(self):
        super().__init__()
        self.lin = tpt.nn.Linear(4, 4)

    def forward(self, x):
        h = self.lin(x)
        a = tst.nn.cond(h.sum() > 0, lambda: h * 2, lambda: h - 1)
        i, s = tst.nn.while_loop(
            lambda i, s: i < 3, lambda i, s: (i + 1, s + a),
            [torch.zeros((), dtype=torch.long), torch.zeros_like(a)])
        return tst.nn.switch_case(i, [lambda: s, lambda: s * 3],
                                  default=lambda: s + 100)


def test_tensor_predicates_export_as_control_flow(tmp_path):
    tpt.seed(0)
    net = _Gated().eval()
    tjit.save(net, str(tmp_path), input_spec=[tjit.InputSpec([None, 4])])
    loaded = tjit.load(str(tmp_path), device="cpu")
    targets = [str(n.target) for n in loaded._exported.graph.nodes
               if n.op == "call_function"]
    assert "cond" in targets and "while_loop" in targets
    for sign in (1.0, -1.0):                     # both branches
        x = torch.full((3, 4), 5.0 * sign)
        with torch.no_grad():
            assert torch.equal(loaded(x), net(x))


def test_control_flow_equals_jax():
    got = _control_flow(tst, tpt, lambda v: torch.tensor(v))
    want = _control_flow(jst, jpt, lambda v: jnp.asarray(v))
    assert got == want


SEQ_OPS = [
    ("pool_sum", lambda nn, x, ln: nn.sequence_pool(x, "sum", length=ln)),
    ("pool_max", lambda nn, x, ln: nn.sequence_pool(x, "max", length=ln)),
    ("pool_sqrt", lambda nn, x, ln: nn.sequence_pool(x, "sqrt", length=ln)),
    ("pool_last", lambda nn, x, ln: nn.sequence_last_step(x, length=ln)),
    ("softmax", lambda nn, x, ln: nn.sequence_softmax(x, length=ln)),
    ("reverse", lambda nn, x, ln: nn.sequence_reverse(x, length=ln)),
    ("pad", lambda nn, x, ln: nn.sequence_pad(x, -1.0, length=ln)[0]),
    ("reshape", lambda nn, x, ln: nn.sequence_reshape(x, 2)),
    ("slice", lambda nn, x, ln: nn.sequence_slice(x, np.array([0, 1, 2]),
                                                  np.array([2, 3, 1]))),
    ("enumerate", lambda nn, x, ln: nn.sequence_enumerate(x, 3)),
]


@pytest.mark.parametrize("name,op", SEQ_OPS, ids=[n for n, _ in SEQ_OPS])
def test_sequence_ops_equal_jax(name, op):
    x = np.random.RandomState(6).randn(3, 5, 4).astype(np.float32)
    ln = np.array([5, 2, 3])
    if name == "enumerate":
        x = np.random.RandomState(6).randint(0, 9, (3, 5))
    want = op(jst.nn, jnp.asarray(x), ln)
    got = op(tst.nn, torch.as_tensor(x), ln)
    np.testing.assert_allclose(np.asarray(got.numpy(), np.float64),
                               np.asarray(want, np.float64),
                               rtol=1e-6, atol=1e-6)
