"""KV-page migration between the JAX engine and the port's on the CPU.

The ``kv_pages/v1`` wire format of the port (``inference/kv_transfer.py``,
a copy of the JAX package's) encodes byte-identical payloads and
rejects exactly the corruptions it claims to. Pages exported by the JAX
engine install in the port's and the reverse, f32 and int8 (both
packages lay pages out as [L, num_pages, page_size, kv_heads, d] and an
int8 pool's scales as [L, num_pages, page_size] f32): the continuation
is token-identical to a recompute by the port (itself pinned to the JAX
engine's streams by ``test_torch_engine*.py``), and the importer's
``n_cached_tokens`` grows by exactly the migrated prefix. Engines in
``make_engine_from_spec``'s geometry."""

import importlib

import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference import kv_transfer as tkvt  # noqa: E402
from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.inference.prefix_cache import (  # noqa: E402
    _SEED, chain_digest, page_digests)
from paddle_tpu_torch.reliability import faults as tfaults  # noqa: E402

from test_torch_engine import pair  # noqa: E402
from test_torch_serving import SPEC_ENGINE  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")
jkvt = importlib.import_module("paddle_tpu.inference.kv_transfer")

PROMPTS = {"jax_to_port": list(range(1, 25)),      # 24 tokens, 6 pages
           "port_to_jax": list(range(60, 36, -1))}
CHAIN = (24 - 1) // 4       # 5 exportable pages a prompt


def port_engine(kv_dtype, **kw):
    ekw = dict(SPEC_ENGINE, kv_dtype=kv_dtype, **kw)
    return tllm.LLMEngine(pair("gpt2")[1], device="cpu", **ekw)


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX engine a pool dtype, shared by this file's tests (each
    direction uses its own prompt)."""
    engs = {}

    def get(kv_dtype):
        if kv_dtype not in engs:
            engs[kv_dtype] = jllm.LLMEngine(pair("gpt2")[0],
                                            kv_dtype=kv_dtype,
                                            **SPEC_ENGINE)
        return engs[kv_dtype]

    yield get
    for e in engs.values():
        e.close()


def leak_free(eng):
    return len(eng._free_pages) == eng.num_pages - 1


# -- wire format ----------------------------------------------------------


def _fake_chain(kvt, ps=4, n=3, kv_nbytes=32):
    """A self-consistent synthetic page chain (the verifier checks
    identity and geometry, not contents)."""
    recs, parent = [], _SEED
    for i in range(n):
        toks = list(range(i * ps, (i + 1) * ps))
        d = chain_digest(parent, toks)
        recs.append(kvt.encode_page(d, parent, toks, bytes([i]) * kv_nbytes,
                                    bytes([i + 100]) * kv_nbytes, b"", b""))
        parent = d
    return kvt.make_payload(recs, kv_dtype="float32", page_size=ps,
                            kv_shape=[2, ps, 4, 1])


def _verify(payload, **over):
    kw = dict(kv_dtype="float32", page_size=4, kv_shape=[2, 4, 4, 1],
              kv_nbytes=32, scale_nbytes=0, resident=lambda d: False)
    kw.update(over)
    return tkvt.verify_payload(payload, **kw)


def test_wire_payloads_are_byte_identical_and_verify_across():
    assert _fake_chain(tkvt) == _fake_chain(jkvt)
    acc, rej = _verify(_fake_chain(jkvt))
    assert rej == [] and [r.tokens for r in acc] == \
        [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11)]


def _tamper_tokens(p):
    p["pages"][1]["tokens"][0] = 77
    return p, 1, {"digest_mismatch", "orphan_parent"}


def _flip_byte(p):
    k = bytearray(tkvt._unb64(p["pages"][0]["k"]))
    k[5] ^= 0xFF
    p["pages"][0]["k"] = tkvt._b64(bytes(k))
    return p, 0, {"checksum_mismatch", "orphan_parent"}


def _orphan(p):
    p["pages"] = p["pages"][1:]        # chain starts mid-history
    return p, 0, {"orphan_parent"}


CORRUPTIONS = {"tokens": _tamper_tokens, "bytes": _flip_byte,
               "orphan": _orphan}


@pytest.mark.parametrize("mode", sorted(CORRUPTIONS))
def test_wire_rejects_each_corruption_mode(mode):
    p, n_ok, reasons = CORRUPTIONS[mode](_fake_chain(tkvt))
    acc, rej = _verify(p)
    assert len(acc) == n_ok
    assert {r["reason"] for r in rej} == reasons
    # the JAX package's verifier gives the same verdicts
    jacc, jrej = jkvt.verify_payload(
        p, kv_dtype="float32", page_size=4, kv_shape=[2, 4, 4, 1],
        kv_nbytes=32, scale_nbytes=0, resident=lambda d: False)
    assert jrej == rej and len(jacc) == n_ok


def test_wire_bad_length_and_geometry():
    acc, rej = _verify(_fake_chain(tkvt, kv_nbytes=16))
    assert acc == [] and rej[0]["reason"] == "bad_length"
    for over, what in ((dict(kv_dtype="int8"), "kv_dtype"),
                       (dict(page_size=8), "page_size"),
                       (dict(kv_shape=[2, 4, 4, 2]), "kv_shape")):
        with pytest.raises(ValueError, match=what):
            _verify(_fake_chain(tkvt), **over)


# -- engines: both directions, f32 and int8 --------------------------------


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("direction", sorted(PROMPTS))
def test_pages_cross_packages_token_identical(jax_engines, kv_dtype,
                                              direction):
    prompt = PROMPTS[direction]
    digs = page_digests(prompt, 4)[:CHAIN]
    jeng = jax_engines(kv_dtype)
    teng, tref = port_engine(kv_dtype), port_engine(kv_dtype)
    src, dst = (jeng, teng) if direction == "jax_to_port" else \
        (teng, jeng)
    try:
        want = tref.submit(prompt, max_new_tokens=8, temperature=0.8,
                           nonce=7).result(timeout=120)["output_ids"]
        src.submit(prompt, max_new_tokens=1).result(timeout=120)
        payload = src.export_pages(digs)
        assert payload["kv_dtype"] == kv_dtype
        assert len(payload["pages"]) == CHAIN
        assert ("k_scales" in payload["pages"][0]) == \
            (kv_dtype == "int8")
        res = dst.import_pages(payload)
        assert res == {"imported": CHAIN, "duplicates": 0,
                       "rejected": []}
        cached = dst.n_cached_tokens
        got = dst.submit(prompt, max_new_tokens=8, temperature=0.8,
                         nonce=7).result(timeout=120)
        assert got["output_ids"] == want
        assert dst.n_cached_tokens - cached == CHAIN * 4
        # a second import is pure duplicates
        assert dst.import_pages(payload)["duplicates"] == CHAIN
    finally:
        teng.close()
        tref.close()
    assert leak_free(teng) and leak_free(tref)


def test_import_pool_exhaustion_rejects_the_tail(jax_engines):
    jeng = jax_engines("float32")
    prompt = PROMPTS["jax_to_port"]
    jeng.submit(prompt, max_new_tokens=1).result(timeout=120)
    payload = jeng.export_pages(page_digests(prompt, 4)[:CHAIN])
    # scratch + 3 usable pages: fewer than the 5-page chain
    dst = port_engine("float32", num_pages=4)
    try:
        res = dst.import_pages(payload)
        assert res["imported"] == 3
        assert [r["reason"] for r in res["rejected"]] == \
            ["no_free_pages"] * 2
        assert dst._cache.migrated_page_count == 3
        assert dst._m["migrate_pages"].labels("rejected").value >= 2
    finally:
        dst.close()
    assert leak_free(dst)


def test_export_stops_at_chain_break_and_engine_fault_sites():
    src = port_engine("float32")
    prompt = PROMPTS["jax_to_port"]
    digs = page_digests(prompt, 4)[:CHAIN]
    try:
        src.submit(prompt, max_new_tokens=1).result(timeout=120)
        assert src.export_pages([digs[1], digs[0]])["pages"] == []
        fake = chain_digest(digs[-1], [1, 2, 3, 4])
        assert len(src.export_pages(digs[:2] + [fake] + digs[2:])
                   ["pages"]) == 2
        tfaults.enable(seed=3)
        tfaults.inject("kv.export", nth=(1,))
        with pytest.raises(tfaults.FaultInjected):
            src.export_pages(digs)
        payload = src.export_pages(digs)      # the second call is clean
        tfaults.inject("kv.import", nth=(1,))
        with pytest.raises(tfaults.FaultInjected):
            src.import_pages(payload)
    finally:
        tfaults.reset()
        src.close()
    assert leak_free(src)
