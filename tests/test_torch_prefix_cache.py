"""The port's prefix cache (``paddle_tpu_torch/inference/prefix_cache.py``)
against the JAX package's, and the port's cache-aware ``LLMEngine`` on
the CPU against the JAX engine on the same weights.

Digests must be byte-identical (a later KV-transfer wire format keys
pages by them). Engine streams are token-identical with the cache on or
off, and ``n_cached_tokens`` equals the reference's: shared pages hold
the KV the suffix prefill would have computed, and sampling keys depend
only on (nonce, position). The JAX runs are shared through
``lru_cache``."""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from paddle_tpu.inference import prefix_cache as jpc  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.inference import prefix_cache as tpc  # noqa: E402

from test_torch_engine import pair  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

ENGINE = dict(page_size=4, prefill_chunk=8)


@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_digests_byte_identical_to_jax(page_size):
    rng = np.random.RandomState(page_size)
    for n in (0, page_size - 1, 3 * page_size, 3 * page_size + 1, 50):
        tokens = rng.randint(0, 50304, n).tolist()
        assert tpc.page_digests(tokens, page_size) == \
            jpc.page_digests(tokens, page_size)
    assert tpc.chain_digest(tpc._SEED, [1, 2, 3]) == \
        jpc.chain_digest(jpc._SEED, [1, 2, 3])


def test_page_digests_roll_and_diverge():
    ps = 4
    a = list(range(10))                   # 2 full pages + tail
    b = a[:6] + [99, 98, 97, 96]          # diverges mid page 1
    da, db = tpc.page_digests(a, ps), tpc.page_digests(b, ps)
    assert len(da) == 2 and len(db) == 2
    assert da[0] == db[0] and da[1] != db[1]
    # rolling: a digest commits to the history, not its own chunk only
    c = [5, 5, 5, 5] + a[4:8]
    assert tpc.page_digests(c, ps)[1] != da[1]


def _cache_story(mod):
    """The reference test's refcount / LRU / eviction sequence, as the
    list of every observable result."""
    c = mod.PrefixCache(4)
    d = mod.page_digests(list(range(12)), 4)
    out = [c.lookup(d), c.register(d[0], 7), c.register(d[1], 8),
           c.lookup(d), c.shared_page_count, c.evictable_count]
    c.acquire(7), c.acquire(8)
    c.release(7), c.release(8)            # owner done, a holder left
    out.append(c.evictable_count)
    c.release(7), c.release(8)
    out += [c.evictable_count, c.lookup(d), c.is_evictable(7),
            c.register(d[0], 9),          # duplicate digest: private
            c.evict_one(), c.lookup(d), c.n_evicted, c.flush(),
            c.shared_page_count, c.evictable_count]
    with pytest.raises(KeyError):
        c.evict_one()
    return out


def test_refcounts_lru_and_eviction_match_jax():
    want = _cache_story(jpc)
    assert _cache_story(tpc) == want
    assert want == [[], True, True, [7, 8], 2, 0, 0, 2, [7, 8], True,
                    False, 7, [], 1, [8], 0, 0]


def _shared_prefix_prompts():
    rng = np.random.RandomState(0)
    common = rng.randint(0, 97, 16).tolist()
    return [common + rng.randint(0, 97, 3 + i).tolist() for i in range(4)]


def _sequential(eng, prompts, temps, n=8):
    """Submit one request at a time (each waits for the last), so every
    later request can hit the pages the first one registered."""
    with eng:
        outs = [eng.submit(p, max_new_tokens=n, temperature=t,
                           nonce=100 + i).result(timeout=300)
                for i, (p, t) in enumerate(zip(prompts, temps))]
        stats = (eng.n_cached_tokens, eng.n_prompt_tokens)
    return [o["output_ids"] for o in outs], stats


TEMPS = [0.0, 0.8, 0.0, 0.8]


@functools.lru_cache(maxsize=None)
def _jax_shared_prefix(kv_dtype):
    jnet, _ = pair("gpt2")
    return _sequential(jllm.LLMEngine(jnet, max_seqs=2, num_pages=128,
                                      kv_dtype=kv_dtype, **ENGINE),
                       _shared_prefix_prompts(), TEMPS)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_cache_on_matches_jax_and_cache_off(kv_dtype):
    """A shared 16-token prefix, requests one after another: the port's
    default engine gives the JAX engine's streams and the same
    ``n_cached_tokens`` (3 x 16), and the cache off gives the same
    streams with nothing cached. The pool is whole after close."""
    _, tnet = pair("gpt2")
    want, (jcached, jprompt) = _jax_shared_prefix(kv_dtype)
    prompts = _shared_prefix_prompts()
    eng = tllm.LLMEngine(tnet, device="cpu", max_seqs=2, num_pages=128,
                         kv_dtype=kv_dtype, **ENGINE)
    got, (cached, n_prompt) = _sequential(eng, prompts, TEMPS)
    assert len(eng._free_pages) == eng.num_pages - 1
    assert got == want
    assert (cached, n_prompt) == (jcached, jprompt) and cached == 3 * 16
    off, (cached_off, _) = _sequential(
        tllm.LLMEngine(tnet, device="cpu", max_seqs=2, num_pages=128,
                       kv_dtype=kv_dtype, prefix_cache=False, **ENGINE),
        prompts, TEMPS)
    assert off == want and cached_off == 0


def _divergence_run(eng):
    rng = np.random.RandomState(2)
    a = rng.randint(0, 97, 9).tolist()
    b = a[:6] + [(t + 1) % 97 for t in a[6:]]
    hits, outs = [], []
    with eng:
        for p in (a, b, a):
            outs.append(eng.submit(p, max_new_tokens=6).result(
                timeout=300)["output_ids"])
            hits.append(eng.n_cached_tokens)
    return outs, hits


def test_copy_on_write_divergence_mid_page_matches_jax():
    """Prompts that diverge inside page 1 share only page 0 (4 tokens);
    repeating the first prompt hits both of its full pages (8)."""
    jnet, tnet = pair("gpt2")
    want = _divergence_run(jllm.LLMEngine(jnet, max_seqs=2, num_pages=64,
                                          **ENGINE))
    got = _divergence_run(tllm.LLMEngine(tnet, device="cpu", max_seqs=2,
                                         num_pages=64, **ENGINE))
    assert got == want
    assert got[1] == [0, 4, 12]
    assert got[0][2] == got[0][0]


def _eviction_run(eng):
    """A's two full pages stay cached at refcount 0, BIG needs 4 of 5
    usable pages and evicts them, A again misses."""
    rng = np.random.RandomState(3)
    a = rng.randint(0, 97, 8).tolist()
    big = rng.randint(0, 97, 16).tolist()
    with eng:
        out_a = eng.submit(a, max_new_tokens=4).result(timeout=300)
        state = [eng._cache.shared_page_count, eng._cache.evictable_count]
        out_big = eng.submit(big, max_new_tokens=4).result(timeout=300)
        state.append(eng._cache.n_evicted)
        out_a2 = eng.submit(a, max_new_tokens=4).result(timeout=300)
        state.append(eng.n_cached_tokens)
    return [o["output_ids"] for o in (out_a, out_big, out_a2)], state


def test_eviction_reclaims_dead_pages_like_jax():
    jnet, tnet = pair("gpt2")
    kw = dict(max_seqs=1, num_pages=6, **ENGINE)
    want = _eviction_run(jllm.LLMEngine(jnet, **kw))
    got = _eviction_run(tllm.LLMEngine(tnet, device="cpu", **kw))
    assert got == want
    outs, (shared, evictable, evicted, cached) = got
    assert (shared, evictable) == (2, 2) and evicted >= 1 and cached == 0
    assert outs[2] == outs[0]


def test_live_shared_pages_are_never_evicted():
    """A decodes while BIG starves the pool: BIG truncates (or finishes
    short) and A's stream is untouched: the streams and flags equal the
    JAX engine's."""
    jnet, tnet = pair("gpt2")
    rng = np.random.RandomState(3)
    a = rng.randint(0, 97, 8).tolist()
    big = rng.randint(0, 97, 16).tolist()
    kw = dict(max_seqs=2, num_pages=6, **ENGINE)

    def run(eng):
        with eng:
            fa = eng.submit(a, max_new_tokens=4)
            fb = eng.submit(big, max_new_tokens=8)
            return [(o["output_ids"], o["truncated"])
                    for o in (fa.result(timeout=300),
                              fb.result(timeout=300))]
    want = run(jllm.LLMEngine(jnet, **kw))
    assert run(tllm.LLMEngine(tnet, device="cpu", **kw)) == want
