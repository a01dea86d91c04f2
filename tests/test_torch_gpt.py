"""The port's GPT against the JAX package's on the same weights, carried
across by ``load_reference_state``: tiny gpt2 (learned positions,
LayerNorm, gelu, tied head) and tiny llama (GQA + RoPE + RMSNorm +
SwiGLU, untied head). Logits within 1e-4: float32 on both sides, with
differences from summation order compounding over two layers and the
vocab projection."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

TOL = 1e-4
TINY = {
    "gpt2": lambda m: m.gpt_config(
        "gpt2-small", num_layers=2, hidden_size=64, num_heads=4,
        vocab_size=97, max_position_embeddings=96, hidden_dropout=0.0,
        attention_dropout=0.0),
    "llama": lambda m: m.llama_config(
        hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        vocab_size=97, max_position_embeddings=96, ffn_hidden_size=128),
}


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX net, port net with the JAX net's weights), built once per
    module; no test changes the weights."""
    jpt.seed(0)
    jnet = jgpt.GPTForCausalLM(TINY[name](jgpt))
    tpt.seed(0)
    tnet = tgpt.GPTForCausalLM(TINY[name](tgpt), device="cpu")
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    return jnet.eval(), tnet.eval()


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_state_dict_keys_and_shapes_identical(name):
    jnet, tnet = pair(name)
    jstate, tstate = jnet.state_dict(), tnet.state_dict()
    assert list(tstate) == list(jstate)
    for k in jstate:
        assert tuple(tstate[k].shape) == tuple(jstate[k].shape), k


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_logits_match_jax(name):
    jnet, tnet = pair(name)
    ids = np.random.RandomState(0).randint(0, 97, (2, 10))
    want = np.asarray(jnet(jnp.asarray(ids)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_cached_forward_matches_jax(name):
    """The dense KV-cache path: a prompt, then one token at its
    absolute position."""
    jnet, tnet = pair(name)
    ids = np.random.RandomState(1).randint(0, 97, (1, 7))
    jl, jc = jnet(jnp.asarray(ids), caches=jnet.init_caches(1, 8))
    jl2, _ = jnet(jnp.asarray([[5]]), position_ids=jnp.asarray([[7]]),
                  caches=jc)
    with torch.no_grad():
        tl, tc = tnet(torch.from_numpy(ids), caches=tnet.init_caches(1, 8))
        tl2, _ = tnet(torch.tensor([[5]]), position_ids=torch.tensor([[7]]),
                      caches=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("sampling", [False, True],
                         ids=["greedy", "top-k"])
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_generate_token_identical(name, sampling):
    jnet, tnet = pair(name)
    prompt = np.random.RandomState(2).randint(0, 97, (2, 5))
    kw = dict(temperature=0.8, top_k=5, seed=3) if sampling else {}
    want = np.asarray(jnet.generate(jnp.asarray(prompt),
                                    max_new_tokens=6, **kw))
    got = tnet.generate(torch.from_numpy(prompt), max_new_tokens=6, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_load_reference_state_raises_on_mismatch():
    jnet, tnet = pair("gpt2")
    state = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    missing = dict(state)
    missing.pop("gpt.ln_f.bias")
    with pytest.raises(ValueError, match="missing"):
        load_reference_state(tnet, missing)
    with pytest.raises(ValueError, match="unexpected"):
        load_reference_state(tnet, {**state, "gpt.extra": np.zeros(2)})
    bad = dict(state)
    bad["gpt.ln_f.bias"] = np.zeros(65, np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_reference_state(tnet, bad)
    load_reference_state(tnet, missing, strict=False)   # partial is ok


@pytest.mark.parametrize("flag", ["sequence_parallel", "scan_layers",
                                  "remat", "fused_loss"])
def test_unported_config_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgpt.gpt_config("gpt2-small", **{flag: True})


def test_entry_point_needs_a_card_or_an_explicit_cpu():
    cfg = TINY["gpt2"](tgpt)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.GPTForCausalLM(cfg)
