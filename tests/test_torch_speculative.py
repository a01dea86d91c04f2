"""The port's speculative decoding on the CPU against the JAX package's,
on the same weights: the accept rule ``_spec_accept``, the verify pass
``_PagedVerify`` (and the legacy path's dense ``_PagedPrefill``), and
``LLMEngine(draft_net=...)`` in both modes, the on-device spec slab and
the legacy host-paced round.

Models: the reference tests' tiny target (``test_torch_engine.pair``:
2 layers, hidden 64, vocab 97) and a 1-layer hidden-32 draft whose
random weights carry added noise (std ``DRAFT_NOISE``), so that it
disagrees with the target often enough to exercise rejection, the
residual sample and the bonus token. With the draft's plain initial
weights both models mostly repeat their last input token and every
proposal is accepted.

What must hold: ``out`` and ``n_acc`` of ``_spec_accept`` identical to
the JAX function's (both key every draw on the same threefry folds);
verify logits within ``TOL_LOGITS`` of the JAX layer's; engine streams,
``truncated`` flags and the spec counters identical to the JAX engine's
with the same knobs; greedy streams identical to the target-only
engine's whatever the draft; a self-draft accepting every greedy
proposal. The JAX engine runs are shared through ``lru_cache``."""

import functools
import importlib

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.models import gpt as jgpt  # noqa: E402
from paddle_tpu.nn.layer import functional_call, split_state  # noqa: E402
from paddle_tpu_torch.core import flags as tflags  # noqa: E402
from paddle_tpu_torch.core import threefry  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402

from test_torch_engine import NONCES, PROMPTS, TEMPS, pair  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

DRAFT_NOISE = 0.1
# f32 logits of one forward: the two packages differ in summation order
TOL_LOGITS = 2e-5
ENGINE = dict(max_seqs=4, page_size=4, num_pages=128, prefill_chunk=8,
              spec_tokens=3)
GREEDY = [0.0] * len(PROMPTS)


def _draft_cfg(m):
    return m.gpt_config("gpt2-small", num_layers=1, hidden_size=32,
                        num_heads=2, vocab_size=97,
                        max_position_embeddings=96, hidden_dropout=0.0,
                        attention_dropout=0.0)


@functools.lru_cache(maxsize=None)
def draft_pair():
    """(JAX draft, port draft) with the same noisy weights."""
    jpt.seed(123)
    jd = jgpt.GPTForCausalLM(_draft_cfg(jgpt))
    r = np.random.RandomState(7)
    state = {k: np.asarray(v) + DRAFT_NOISE * r.standard_normal(
        np.shape(v)).astype(np.float32) for k, v in jd.state_dict().items()}
    jd.set_state_dict(state)
    tpt.seed(123)
    td = tgpt.GPTForCausalLM(_draft_cfg(tgpt), device="cpu")
    load_reference_state(td, state)
    return jd, td


def _counters(eng):
    return (eng.n_spec_rounds, eng.n_spec_proposed, eng.n_spec_accepted)


def _run(eng, temps=TEMPS, prompts=PROMPTS, n=10, first_alone=False):
    """(stream, truncated) pairs and the spec counters. ``first_alone``:
    the first request runs to completion before the rest are submitted,
    so that theirs can hit its cached pages."""
    with eng:
        futs = []
        for i, (p, t, k) in enumerate(zip(prompts, temps, NONCES)):
            futs.append(eng.submit(p, max_new_tokens=n, temperature=t,
                                   nonce=k))
            if first_alone and i == 0:
                futs[0].result(timeout=300)
        outs = [f.result(timeout=300) for f in futs]
    # the pool is whole after close: no page leaked
    assert len(eng._free_pages) == eng.num_pages - 1
    return [(o["output_ids"], o["truncated"]) for o in outs], _counters(eng)


def _key(kw):
    return tuple(sorted(kw.items()))


@functools.lru_cache(maxsize=None)
def _jax(kw_key, temps=tuple(TEMPS), prompts=None, first_alone=False):
    jnet, _ = pair("gpt2")
    jd, _ = draft_pair()
    eng = jllm.LLMEngine(jnet, draft_net=jd, **{**ENGINE, **dict(kw_key)})
    return _run(eng, list(temps), prompts or PROMPTS,
                first_alone=first_alone)


def _torch(temps=TEMPS, prompts=PROMPTS, first_alone=False, draft=None,
           n=10, **kw):
    _, tnet = pair("gpt2")
    eng = tllm.LLMEngine(tnet, draft_net=draft or draft_pair()[1],
                         device="cpu", **{**ENGINE, **kw})
    got, counters = _run(eng, temps, prompts, n, first_alone)
    return got, counters, eng


@functools.lru_cache(maxsize=None)
def _target_only(temps=tuple(TEMPS)):
    """The port's target-only engine (greedy rows are what every
    speculative engine must reproduce)."""
    _, tnet = pair("gpt2")
    kw = {k: v for k, v in ENGINE.items() if k != "spec_tokens"}
    return _run(tllm.LLMEngine(tnet, device="cpu", **kw), list(temps))[0]


# ---------------------------------------------------------------------------
# the accept rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_accept_matches_jax(mode):
    """Proposals right for a prefix of 0..K-1 tokens, then random; half
    the rows (or none) at temperature > 0."""
    B, K, V = 32, 4, 11
    r = np.random.RandomState(0)
    vlg = (2.0 * r.randn(B, K, V)).astype(np.float32)
    dlg = (2.0 * r.randn(B, K - 1, V)).astype(np.float32)
    greedy = vlg.argmax(-1)
    toks = r.randint(0, V, (B, K))
    for b in range(B):
        n = b % K
        toks[b, 1:1 + n] = greedy[b, :n]
        if n < K - 1:
            toks[b, 1 + n] = (greedy[b, n] + 1) % V
    temps = np.zeros(B, np.float32)
    if mode == "sampled":
        temps[1::2] = r.uniform(0.5, 2.0, B // 2)
    nonces = 100 + np.arange(B)
    positions = r.randint(5, 50, B)
    jout, jacc = jllm._spec_accept(
        jnp.asarray(toks, jnp.int32), jnp.asarray(dlg), jnp.asarray(vlg),
        jnp.asarray(temps), jnp.asarray(nonces, jnp.int32),
        jnp.asarray(positions, jnp.int32), jax.random.PRNGKey(3))
    args = (torch.from_numpy(toks), torch.from_numpy(dlg),
            torch.from_numpy(vlg), torch.from_numpy(temps),
            torch.from_numpy(nonces), torch.from_numpy(positions),
            threefry.prng_key(3))
    out, n_acc = tllm._spec_accept(*args, any_sampled=mode == "sampled")
    assert n_acc.tolist() == np.asarray(jacc).tolist()
    assert out.tolist() == np.asarray(jout).tolist()
    if mode == "greedy":
        # prefix acceptance, whatever the draft logits; skipping the
        # draws changes nothing
        assert n_acc.tolist() == [b % K for b in range(B)]
        full, full_acc = tllm._spec_accept(*args, any_sampled=True)
        assert torch.equal(full, out) and torch.equal(full_acc, n_acc)
    else:
        hot = n_acc[1::2]
        # the sampled rows both accept and reject
        assert (hot > 0).any() and (hot < K - 1).any()


# ---------------------------------------------------------------------------
# the verify pass and the legacy prefill
# ---------------------------------------------------------------------------

PS, NP, P = 4, 32, 8   # page size, pool pages, pages per sequence


@torch.no_grad()
@pytest.mark.parametrize("name", ["gpt2", "llama"], ids=["mha", "gqa"])
def test_verify_matches_jax_and_sequential_decode(name):
    """One verify pass over [t0, g1, g2, g3] sees what K sequential
    decode steps see: the same greedy tokens and the same pages; its
    logits agree with the JAX layer's. The pools start from the legacy
    prefill, which agrees with the JAX ``_PagedPrefill``."""
    jnet, tnet = pair(name)
    cfg = tnet.cfg
    prompt, K = [3, 1, 4, 1, 5], 4
    n = len(prompt)
    tables = np.arange(1, P + 1, dtype=np.int32)[None]
    shape = (cfg.num_layers, NP, PS, cfg.num_kv_heads, cfg.head_dim)
    ids = np.zeros((1, 16), np.int64)
    ids[0, :n] = prompt

    prefill = jllm._PagedPrefill(jnet)
    (jt0, jk, jv), _ = functional_call(
        prefill, *split_state(prefill), jnp.asarray(ids, jnp.int32),
        jnp.int32(n), jnp.asarray(tables[0]), jnp.zeros(shape),
        jnp.zeros(shape), jnp.float32(0.0), jnp.int32(0),
        jax.random.PRNGKey(0), training=False)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    t0 = tllm._PagedPrefill(tnet)(
        torch.from_numpy(ids), n, torch.from_numpy(tables[0]), tk, tv,
        torch.tensor(0.0), torch.tensor(0), threefry.prng_key(0))
    assert int(t0) == int(jt0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)

    def pools():
        return (torch.from_numpy(np.array(jk)),
                torch.from_numpy(np.array(jv)))

    ttables = torch.from_numpy(tables)
    dk, dv = pools()
    decode = tllm._PagedDecode(tnet)
    toks = [int(t0)]
    for j in range(K):
        nxt = decode(torch.tensor([toks[-1]]), torch.tensor([n + j]),
                     ttables, torch.tensor([n + j + 1], dtype=torch.int32),
                     dk, dv, torch.zeros(1), torch.zeros(1, dtype=torch.long),
                     threefry.prng_key(9), any_sampled=False)
        toks.append(int(nxt[0]))

    vk, vv = pools()
    logits = tllm._PagedVerify(tnet)(torch.tensor([toks[:K]]),
                                     torch.tensor([n]), ttables, vk, vv)
    assert logits.shape == (1, K, cfg.vocab_size)
    assert logits.argmax(-1)[0].tolist() == toks[1:]
    torch.testing.assert_close(vk, dk, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(vv, dv, atol=1e-6, rtol=1e-6)

    verify = jllm._PagedVerify(jnet)
    (jlg, jk2, jv2), _ = functional_call(
        verify, *split_state(verify), jnp.asarray([toks[:K]], jnp.int32),
        jnp.asarray([n], jnp.int32), jnp.asarray(tables), jk, jv,
        training=False)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlg),
                               atol=TOL_LOGITS, rtol=TOL_LOGITS)
    np.testing.assert_allclose(vk.numpy(), np.asarray(jk2), atol=1e-5)


@torch.no_grad()
def test_verify_window_past_the_table_writes_scratch():
    """A window that runs past the table's end (base 6 of an 8-position
    table, K 4) sends its overflow rows to scratch page 0: the table's
    pages hold what the first rows wrote, and those rows' logits are the
    JAX layer's."""
    jnet, tnet = pair("gpt2")
    cfg = tnet.cfg
    shape = (cfg.num_layers, NP, PS, cfg.num_kv_heads, cfg.head_dim)
    r = np.random.RandomState(4)
    k0 = r.randn(*shape).astype(np.float32)
    v0 = r.randn(*shape).astype(np.float32)
    tables = np.array([[3, 5]], np.int32)
    toks = [[7, 8, 9, 10]]
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    logits = tllm._PagedVerify(tnet)(torch.tensor(toks), torch.tensor([6]),
                                     torch.from_numpy(tables), tk, tv)
    verify = jllm._PagedVerify(jnet)
    (jlg, jk, _), _ = functional_call(
        verify, *split_state(verify), jnp.asarray(toks, jnp.int32),
        jnp.asarray([6], jnp.int32), jnp.asarray(tables), jnp.asarray(k0),
        jnp.asarray(v0), training=False)
    np.testing.assert_allclose(logits[:, :2].numpy(),
                               np.asarray(jlg)[:, :2], atol=TOL_LOGITS,
                               rtol=TOL_LOGITS)
    live = [p for p in range(NP) if p != 0]
    np.testing.assert_allclose(tk.numpy()[:, live],
                               np.asarray(jk)[:, live], atol=1e-5)


# ---------------------------------------------------------------------------
# the engine: the spec slab
# ---------------------------------------------------------------------------

SLAB_CASES = {
    "f32-cache-n1": {},
    "f32-nocache-n3": dict(prefix_cache=False, decode_ticks_per_dispatch=3),
    "f32-cache-n3-alternating": dict(decode_ticks_per_dispatch=3,
                                     mixed_tick=False),
    "int8-cache-n3": dict(kv_dtype="int8", decode_ticks_per_dispatch=3),
}


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_spec_slab_token_identical_to_jax(case):
    """Greedy and T 0.8 rows: streams and the round / proposal /
    acceptance counters equal the JAX engine's."""
    kw = SLAB_CASES[case]
    got, counters, eng = _torch(**kw)
    want, want_counters = _jax(_key(kw))
    assert got == want
    assert counters == want_counters
    assert eng.spec_slab and eng.n_spec_rounds > 0
    assert 0 < eng.n_spec_accepted < eng.n_spec_proposed
    if kw.get("kv_dtype") != "int8":
        # the speculative identity: greedy rows are the target's own
        for i, t in enumerate(TEMPS):
            if t == 0.0:
                assert got[i] == _target_only()[i]


def test_spec_slab_prefix_cache_hits_match_jax():
    """Requests that map the first one's cached prompt pages read the
    draft KV the first one wrote there: T > 0 streams (whose acceptance
    reads the draft's distribution) and counters equal the JAX
    engine's, and equal a run without the cache."""
    base = np.random.RandomState(9).randint(0, 97, 16).tolist()
    prompts = tuple(tuple(base + [i + 1] * (i + 1)) for i in range(4))
    temps = (0.8, 0.8, 0.0, 0.8)
    kw = dict(decode_ticks_per_dispatch=3)
    got, counters, eng = _torch(list(temps), [list(p) for p in prompts],
                                first_alone=True, **kw)
    assert eng.n_cached_tokens == 3 * 16
    assert (got, counters) == _jax(_key(kw), temps, prompts,
                                   first_alone=True)
    nocache, _, _ = _torch(list(temps), [list(p) for p in prompts],
                           first_alone=True, prefix_cache=False, **kw)
    assert nocache == got


@pytest.mark.parametrize("spec_slab", [True, False], ids=["slab", "legacy"])
def test_eos_inside_a_round_matches_jax(spec_slab):
    """An EOS taken from stream 1 ends it inside a round: the tokens the
    round committed after it never surface, on the device (slab) or the
    host (legacy), as in the JAX engine."""
    temps = tuple(TEMPS) if spec_slab else tuple(GREEDY)
    base = _jax(_key({} if spec_slab else dict(spec_slab=False)),
                temps)[0]
    eos = base[1][0][4]
    kw = dict(eos_token_id=eos, spec_slab=spec_slab)
    if spec_slab:
        kw["decode_ticks_per_dispatch"] = 3
    got, counters, _ = _torch(list(temps), **kw)
    assert (got, counters) == _jax(_key(kw), temps)
    assert got[1][0][-1] == eos and len(got[1][0]) <= 5


@pytest.mark.parametrize("spec_slab", [True, False], ids=["slab", "legacy"])
def test_self_draft_accepts_every_greedy_proposal(spec_slab):
    """9 tokens at K 4: the first from the prompt, then two rounds of 4
    that no budget clamps, so every proposal can be committed (a round
    cut short by the budget counts K - 1 proposals and commits fewer)."""
    _, tnet = pair("gpt2")
    got, _, eng = _torch(GREEDY, draft=tnet, spec_slab=spec_slab,
                         spec_tokens=4, n=9)
    # K - 1 proposals for each request in each of its two rounds
    assert eng.n_spec_accepted == eng.n_spec_proposed == \
        3 * 2 * len(PROMPTS)
    assert [g for g, _ in got] == \
        [g[:9] for g, _ in _target_only(tuple(GREEDY))]


# ---------------------------------------------------------------------------
# the engine: the legacy inline round
# ---------------------------------------------------------------------------

def test_legacy_round_token_identical_to_jax():
    kw = dict(spec_slab=False)
    got, counters, eng = _torch(GREEDY, **kw)
    assert (got, counters) == _jax(_key(kw), tuple(GREEDY))
    assert not eng.spec_slab and eng.n_spec_rounds > 0
    assert 0 < eng.n_spec_accepted < eng.n_spec_proposed
    assert got == _target_only(tuple(GREEDY))


def test_legacy_round_at_max_len_clamps_acceptance():
    """A round whose window cannot fit K positions (max_len reached)
    still completes exactly like plain decoding, untruncated."""
    _, tnet = pair("gpt2")
    prompt = np.random.RandomState(5).randint(0, 97, 13).tolist()
    want = tnet.generate(torch.tensor([prompt]), max_new_tokens=3)[0, 13:]
    for slab in (False, True):
        eng = tllm.LLMEngine(tnet, draft_net=tnet, spec_tokens=4,
                             spec_slab=slab, max_seqs=1, page_size=4,
                             num_pages=64, prefill_buckets=(16,),
                             max_len=16, device="cpu")
        with eng:
            out = eng.generate([prompt], max_new_tokens=3)[0]
        assert out["output_ids"] == want.tolist()
        assert not out["truncated"]


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_constructor_and_submit_guards_match_the_reference():
    _, tnet = pair("gpt2")
    _, td = draft_pair()
    assert tflags.get_flag("spec_slab") is True
    with pytest.raises(ValueError, match="spec_tokens"):
        tllm.LLMEngine(tnet, draft_net=td, spec_tokens=1, device="cpu")
    other = tgpt.GPTForCausalLM(tgpt.gpt_config(
        "gpt2-small", num_layers=1, hidden_size=32, num_heads=2,
        vocab_size=50, max_position_embeddings=96), device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        tllm.LLMEngine(tnet, draft_net=other, device="cpu")
    with pytest.raises(ValueError, match="lookahead"):
        tllm.LLMEngine(tnet, draft_net=td, lookahead=2, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        tllm.LLMEngine(tnet, draft_net=td, kv_dtype="int8", spec_slab=False,
                       device="cpu")
    with tllm.LLMEngine(tnet, draft_net=td, device="cpu") as eng:
        # the slab rides the cache and the mixed tick, any length, T > 0
        assert eng.spec_slab and eng.mixed_tick and eng._cache is not None
        assert eng.spec_k == 4 and eng.draft_k_pages is not None
    with tllm.LLMEngine(tnet, draft_net=td, spec_slab=False,
                        decode_ticks_per_dispatch=4, prefill_buckets=(8,),
                        device="cpu") as eng:
        assert eng.decode_ticks_per_dispatch == 1
        assert not eng.mixed_tick and eng._cache is None
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit([1, 2], max_new_tokens=4, temperature=0.9)
        with pytest.raises(ValueError, match="prefill bucket"):
            eng.submit(list(range(20)), max_new_tokens=2)
    with tllm.LLMEngine(tnet, device="cpu") as eng:
        assert eng.spec_k == 0 and not eng.spec_slab
