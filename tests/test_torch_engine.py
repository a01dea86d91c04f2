"""The port's ``LLMEngine`` on the CPU against the JAX package's engine in
the same mode (``mixed_tick=False``, ``decode_ticks_per_dispatch=1``,
``prefix_cache=False``: the alternating prefill-chunk / decode-step
loop), on the same weights. Greedy streams and nonce-pinned
``temperature > 0`` streams must be token-identical: both engines key
every token on fold_in(fold_in(PRNGKey(seed), nonce), position) with
the same threefry recipe, and their logits agree to ~1e-6."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

TINY = {
    "gpt2": lambda m: m.gpt_config(
        "gpt2-small", num_layers=2, hidden_size=64, num_heads=4,
        vocab_size=97, max_position_embeddings=96, hidden_dropout=0.0,
        attention_dropout=0.0),
    "llama": lambda m: m.llama_config(
        hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
        vocab_size=97, max_position_embeddings=96, ffn_hidden_size=128),
}
ENGINE = dict(max_seqs=4, page_size=4, num_pages=128, prefill_chunk=8)
PROMPTS = [np.random.RandomState(i).randint(0, 97, n).tolist()
           for i, n in enumerate((5, 11, 3, 17))]
TEMPS = [0.0, 0.8, 0.0, 0.8]
NONCES = [10, 11, 12, 2 ** 31 - 1]


@functools.lru_cache(maxsize=None)
def pair(name):
    """(JAX net, port net with the JAX net's weights)."""
    jpt.seed(0)
    jnet = jgpt.GPTForCausalLM(TINY[name](jgpt))
    tpt.seed(0)
    tnet = tgpt.GPTForCausalLM(TINY[name](tgpt), device="cpu")
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _run(eng, prompts=PROMPTS, temps=TEMPS, nonces=NONCES, n=8):
    with eng:
        futs = [eng.submit(p, max_new_tokens=n, temperature=t, nonce=k)
                for p, t, k in zip(prompts, temps, nonces)]
        return [f.result(timeout=300) for f in futs]


def _jax_engine(jnet, **kw):
    return jllm.LLMEngine(jnet, mixed_tick=False,
                          decode_ticks_per_dispatch=1, prefix_cache=False,
                          **{**ENGINE, **kw})


def _torch_engine(tnet, **kw):
    return tllm.LLMEngine(tnet, device="cpu", **{**ENGINE, **kw})


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_streams_token_identical_to_jax_engine(name, kv_dtype):
    jnet, tnet = pair(name)
    want = _run(_jax_engine(jnet, kv_dtype=kv_dtype))
    got = _run(_torch_engine(tnet, kv_dtype=kv_dtype))
    for g, w in zip(got, want):
        assert g["output_ids"] == w["output_ids"]
        assert g["prompt_ids"] == w["prompt_ids"]
        assert not g["truncated"]
        assert g["ttft_s"] is not None and g["latency_s"] > 0


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_greedy_stream_equals_dense_generate(name):
    _, tnet = pair(name)
    p = PROMPTS[1]
    want = tnet.generate(torch.tensor([p]), max_new_tokens=8)[0, len(p):]
    got = _run(_torch_engine(tnet), [p], [0.0], [0])[0]
    assert got["output_ids"] == want.tolist()


@pytest.mark.parametrize("impl", ["plain", "reference"])
def test_attention_impls_agree_on_cpu(impl):
    _, tnet = pair("llama")
    want = [o["output_ids"] for o in _run(_torch_engine(tnet))]
    got = [o["output_ids"]
           for o in _run(_torch_engine(tnet, attention_impl=impl))]
    assert got == want


def test_pool_exhaustion_truncates_like_jax():
    """3 usable pages of 4 tokens: the request ends early with
    truncated=True, at the same token as the JAX engine."""
    jnet, tnet = pair("gpt2")
    kw = dict(max_seqs=1, num_pages=4)
    want = _run(_jax_engine(jnet, **kw), [[1, 2, 3, 4, 5]], [0.0], [0],
                n=40)[0]
    got = _run(_torch_engine(tnet, **kw), [[1, 2, 3, 4, 5]], [0.0], [0],
               n=40)[0]
    assert got["truncated"] and 0 < len(got["output_ids"]) < 40
    assert got["output_ids"] == want["output_ids"]


def test_eos_ends_the_stream():
    _, tnet = pair("gpt2")
    first = _run(_torch_engine(tnet), PROMPTS[:1], [0.0], [0])[0]
    eos = first["output_ids"][2]
    got = _run(_torch_engine(tnet, eos_token_id=eos), PROMPTS[:1], [0.0],
               [0])[0]
    assert got["output_ids"] == first["output_ids"][
        :first["output_ids"].index(eos) + 1]


@pytest.mark.parametrize("kw", [
    dict(draft_net=object()), dict(mixed_tick=True),
    dict(decode_ticks_per_dispatch=2), dict(lookahead=1),
    dict(prefix_cache=True)],
    ids=["draft_net", "mixed_tick", "decode_slab", "lookahead",
         "prefix_cache"])
def test_unported_knobs_raise(kw):
    _, tnet = pair("gpt2")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tllm.LLMEngine(tnet, device="cpu", **kw)


def test_bad_arguments_raise():
    _, tnet = pair("gpt2")
    with pytest.raises(ValueError, match="attention_impl"):
        tllm.LLMEngine(tnet, device="cpu", attention_impl="xla")
    with pytest.raises(ValueError, match="kv_dtype"):
        tllm.LLMEngine(tnet, device="cpu", kv_dtype="fp8")
    with _torch_engine(tnet) as eng:
        for bad in (dict(prompt_ids=[]),
                    dict(prompt_ids=[1] * 90, max_new_tokens=10),
                    dict(prompt_ids=[1], nonce=2 ** 31)):
            with pytest.raises(ValueError):
                eng.submit(**bad)
    with pytest.raises(tllm.EngineClosed):
        eng.submit([1, 2])


def test_prompt_that_never_fits_fails_its_future():
    _, tnet = pair("gpt2")
    with _torch_engine(tnet, num_pages=3) as eng:
        fut = eng.submit(list(range(20)), max_new_tokens=2)
        with pytest.raises(ValueError, match="cannot fit"):
            fut.result(timeout=60)


def test_device_error_fails_the_affected_futures():
    """An error inside a step resolves the in-flight requests with that
    error, never with a result, and the engine keeps serving."""
    _, tnet = pair("gpt2")
    with _torch_engine(tnet) as eng:
        real = eng._decode.forward

        def broken(*a, **k):
            raise RuntimeError("injected device fault")
        eng._decode.forward = broken
        fut = eng.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected device fault"):
            fut.result(timeout=60)
        eng._decode.forward = real
        out = eng.submit(PROMPTS[0], max_new_tokens=4).result(timeout=60)
        assert len(out["output_ids"]) == 4
        assert len(eng._free_pages) + sum(
            int(p > 0) for p in eng.block_tables.ravel()) == 127


def test_engine_needs_a_card_or_an_explicit_cpu():
    _, tnet = pair("gpt2")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllm.LLMEngine(tnet)


def test_jax_weights_keep_their_values_in_the_engine():
    """The engine serves the module it is given (moved to its device,
    in eval mode), not a copy with other weights."""
    jnet, tnet = pair("gpt2")
    with _torch_engine(tnet) as eng:
        w = eng.net.gpt.ln_f.weight.detach().numpy()
        np.testing.assert_array_equal(
            w, np.asarray(jnet.state_dict()["gpt.ln_f.weight"]))
        assert not eng.net.training
