"""The port's default ``LLMEngine`` (prefix cache, mixed tick) and its
decode slab and lookahead knobs on the CPU against the JAX engine with
the same knobs, on the same weights.

The slab and the mixed tick change which ticks run in one dispatch,
never what a tick computes: each row's math is independent of the
others and sampling keys fold (nonce, position) only, so streams,
``truncated`` flags and ``n_cached_tokens`` must equal the reference's
exactly, greedy and nonce-pinned ``temperature > 0`` alike. The JAX runs
are shared through ``lru_cache``."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.core import flags as tflags  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402

from test_torch_engine import NONCES, PROMPTS, TEMPS, pair  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

ENGINE = dict(max_seqs=4, page_size=4, num_pages=128, prefill_chunk=8)
# one sampled request through a tight pool (the reference's pressure case)
TIGHT = ([np.random.RandomState(3).randint(0, 97, 5).tolist()], [0.8], [5])


def _run(eng, prompts=PROMPTS, temps=TEMPS, nonces=NONCES, n=10):
    with eng:
        futs = [eng.submit(p, max_new_tokens=n, temperature=t, nonce=k)
                for p, t, k in zip(prompts, temps, nonces)]
        outs = [f.result(timeout=300) for f in futs]
    # the pool is whole after close: no page leaked through the cache
    assert len(eng._free_pages) == eng.num_pages - 1
    return [(o["output_ids"], o["truncated"]) for o in outs]


def _key(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax(name, kw_key, n=10, tight=False):
    """The JAX engine's (stream, truncated) pairs with the default knobs
    plus ``kw_key``, on PROMPTS or on TIGHT."""
    jnet, _ = pair(name)
    return _run(jllm.LLMEngine(jnet, **{**ENGINE, **dict(kw_key)}),
                *(TIGHT if tight else ()), n=n)


def _torch(name, n=10, tight=False, **kw):
    _, tnet = pair(name)
    eng = tllm.LLMEngine(tnet, device="cpu", **{**ENGINE, **kw})
    return _run(eng, *(TIGHT if tight else ()), n=n), eng


def test_defaults_match_the_reference():
    _, tnet = pair("gpt2")
    eng = tllm.LLMEngine(tnet, device="cpu")
    with eng:
        assert eng._cache is not None and eng.mixed_tick
        assert eng.decode_ticks_per_dispatch == 1 and eng.lookahead == 0
    assert tflags.get_flag("mixed_tick") is True


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("name", ["gpt2", "llama", "gpt2-d80"])
def test_default_engine_token_identical_to_jax(name, kv_dtype):
    kw = dict(kv_dtype=kv_dtype) if kv_dtype != "f32" else {}
    got, eng = _torch(name, **kw)
    assert got == _jax(name, _key(kw))
    assert not any(t for _, t in got)
    assert eng.n_mixed_slabs > 0
    assert eng.n_dispatched_ticks >= eng.n_decode_ticks > 0


@pytest.mark.parametrize("n_ticks", [1, 3, 4])
def test_slab_token_identical_to_jax(n_ticks):
    """max_new_tokens 10 is no multiple of 3 or 4: the last slab runs
    with partial budgets and masked ticks."""
    kw = dict(decode_ticks_per_dispatch=n_ticks) if n_ticks > 1 else {}
    got, eng = _torch("gpt2", **kw)
    want = _jax("gpt2", _key(kw))
    assert got == want
    assert all(len(s) == 10 for s, _ in got)
    assert eng.n_dispatched_ticks >= eng.n_decode_ticks


def test_mid_slab_eos_matches_jax():
    """An EOS taken from a sampled stream ends streams inside a slab:
    the ticks after it are masked on the device and never surface."""
    base = _jax("gpt2", _key({}))
    eos = base[1][0][5]
    kw = dict(decode_ticks_per_dispatch=4, eos_token_id=eos)
    got, _ = _torch("gpt2", **kw)
    assert got == _jax("gpt2", _key(kw))
    assert got[1][0][-1] == eos and len(got[1][0]) == 6
    legacy, _ = _torch("gpt2", mixed_tick=False, prefix_cache=False,
                       eos_token_id=eos)
    assert got == legacy


@pytest.mark.parametrize("num_pages", [None, 9, 16],
                         ids=["page-boundary", "shrink-9", "shrink-16"])
def test_page_boundaries_and_pressure_match_jax(num_pages):
    """Pages of 2 tokens: every slab of 4 crosses page boundaries. In a
    pool of 9 or 16 pages a slab cannot reserve its whole span, shrinks
    to what it can cover, and the stream truncates exactly where the
    reference's does, and where the alternating loop's does."""
    kw = dict(decode_ticks_per_dispatch=4, page_size=2)
    if num_pages:
        kw.update(num_pages=num_pages, prefix_cache=False)
    tight = num_pages is not None
    got, _ = _torch("gpt2", n=20, tight=tight, **kw)
    assert got == _jax("gpt2", _key(kw), n=20, tight=tight)
    if tight:
        legacy, _ = _torch("gpt2", n=20, tight=True, page_size=2,
                           num_pages=num_pages, prefix_cache=False,
                           mixed_tick=False)
        assert got == legacy
    if num_pages == 9:
        assert got[0][1] and len(got[0][0]) < 20


def test_mixed_matches_legacy_loop():
    """The mixed tick against the alternating loop in the port itself,
    at N = 1 and 4, cache on and off."""
    legacy, _ = _torch("llama", mixed_tick=False, prefix_cache=False)
    for n_ticks in (1, 4):
        for cache in (True, False):
            got, eng = _torch("llama", decode_ticks_per_dispatch=n_ticks,
                              prefix_cache=cache)
            assert got == legacy, (n_ticks, cache)
            assert eng.n_mixed_slabs > 0


def test_mixed_eos_under_page_pressure_matches_jax():
    """Four requests, an EOS from a sampled stream and a pool of 11
    usable 2-token pages: mixed slabs of 4 truncate and stop where the
    reference's do (the alternating loop hands out pages in another
    order, so there it truncates elsewhere, in both packages)."""
    base = _jax("gpt2", _key({}))
    eos = base[3][0][4]
    kw = dict(eos_token_id=eos, page_size=2, num_pages=12,
              prefix_cache=False, decode_ticks_per_dispatch=4)
    got, _ = _torch("gpt2", n=20, **kw)
    assert got == _jax("gpt2", _key(kw), n=20)
    assert got[3][0][-1] == eos and any(t for _, t in got)


def test_lookahead_matches_jax_and_legacy():
    """lookahead=2 issues decode steps two ahead of the fetch; the flag's
    mixed-tick default yields to it, as in the reference."""
    kw = dict(lookahead=2)
    got, eng = _torch("gpt2", **kw)
    assert not eng.mixed_tick
    assert got == _jax("gpt2", _key(kw))
    legacy, _ = _torch("gpt2", mixed_tick=False)
    assert got == legacy


@pytest.mark.parametrize("kw, match", [
    (dict(decode_ticks_per_dispatch=2, lookahead=1),
     "decode_ticks_per_dispatch"),
    (dict(mixed_tick=True, lookahead=1), "mixed_tick")],
    ids=["slab-lookahead", "explicit-mixed-lookahead"])
def test_knob_conflicts_raise_as_the_reference_does(kw, match):
    jnet, tnet = pair("gpt2")
    with pytest.raises(ValueError, match=match):
        jllm.LLMEngine(jnet, **ENGINE, **kw)
    with pytest.raises(ValueError, match=match):
        tllm.LLMEngine(tnet, device="cpu", **ENGINE, **kw)
