"""The port's ``serve_llm`` against the JAX package's, over real HTTP on
the CPU: both engines in the geometry of the JAX package's
``serving.replica.make_engine_from_spec({"vocab": 97, "layers": 2,
"hidden": 64})`` (max_seqs 4, page_size 4, 96 pages, bucket 16, seed
0), on the same weights, each behind its own ``serve_llm``. The same
bodies must give the same status codes, ``outcome`` fields,
``output_ids``, ``stream_digest`` and ``X-Engine-Knobs``.

Also the shared helpers of the control-plane tests
(``test_torch_reliability.py``, ``test_torch_kv_migration.py``,
``test_torch_observability.py``)."""

import importlib
import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

from paddle_tpu_torch.inference import llm as tllm  # noqa: E402
from paddle_tpu_torch.observability import audit as taudit  # noqa: E402

from test_torch_engine import pair  # noqa: E402

jllm = importlib.import_module("paddle_tpu.inference.llm")

# make_engine_from_spec's engine geometry
SPEC_ENGINE = dict(max_seqs=4, page_size=4, num_pages=96,
                   prefill_buckets=(16,), seed=0)


def make_engines(**kw):
    """(JAX engine, port engine on the CPU) on the same weights."""
    jnet, tnet = pair("gpt2")
    ekw = dict(SPEC_ENGINE, **kw)
    return (jllm.LLMEngine(jnet, **ekw),
            tllm.LLMEngine(tnet, device="cpu", **ekw))


def post(base, path, body, headers=None):
    """(status, headers, JSON body) of one POST."""
    req = Request(base + path, data=json.dumps(body).encode(),
                  headers={"Content-Type": "application/json",
                           **(headers or {})})
    try:
        with urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def wait_for(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.002)


@pytest.fixture(scope="module")
def served():
    """Both engines behind their own serve_llm, shared by this file's
    tests (each test restores any engine state it pokes)."""
    jeng, teng = make_engines()
    srvs = [jllm.serve_llm(jeng), tllm.serve_llm(teng)]
    bases = ["http://%s:%d" % s.server_address[:2] for s in srvs]
    yield (jeng, bases[0]), (teng, bases[1])
    for s in srvs:
        s.shutdown()
        s.server_close()
    jeng.close()
    teng.close()


BODIES = {
    "greedy": {"prompt_ids": [4, 5, 6, 7, 8], "max_new_tokens": 6,
               "nonce": 3},
    "sampled": {"prompt_ids": [11, 12, 13, 14, 15, 16, 17, 18, 19],
                "max_new_tokens": 7, "temperature": 0.9, "nonce": 4242},
}


@pytest.mark.parametrize("body", sorted(BODIES))
def test_generate_matches_the_jax_front(served, body):
    (_, jbase), (_, tbase) = served
    jc, jh, jout = post(jbase, "/generate", BODIES[body])
    tc, th, tout = post(tbase, "/generate", BODIES[body])
    assert jc == tc == 200, (jout, tout)
    assert tout["output_ids"] == jout["output_ids"]
    assert tout["stream_digest"] == jout["stream_digest"] == \
        th["X-Stream-Digest"] == taudit.chain_of(
            BODIES[body]["nonce"], tout["output_ids"]).hex()
    assert th["X-Engine-Knobs"] == jh["X-Engine-Knobs"]
    assert json.loads(th["X-Engine-Knobs"]) == tout["knobs"]
    assert isinstance(tout["request_id"], int)


def test_nonce_repeats_the_stream(served):
    _, (_, tbase) = served
    body = BODIES["sampled"]
    _, _, a = post(tbase, "/generate", body)
    _, _, b = post(tbase, "/generate", body)
    assert a["output_ids"] == b["output_ids"]
    assert a["stream_digest"] == b["stream_digest"]


def _shed_queue_full(eng, base):
    saved = eng.max_pending
    eng.max_pending = 0          # every submission is queue overflow
    try:
        return post(base, "/generate", {"prompt_ids": [1, 2]})
    finally:
        eng.max_pending = saved


def _shed_draining(eng, base):
    eng._health = "draining"     # the sticky latch, forced
    try:
        return post(base, "/generate", {"prompt_ids": [1, 2]})
    finally:
        eng.reset_health()


def _deadline(eng, base):
    return post(base, "/generate",
                {"prompt_ids": [1, 2, 3], "deadline_s": -1.0})


def _cancelled(eng, base):
    res = {}

    def client():
        res["resp"] = post(base, "/generate",
                           {"prompt_ids": [7, 8, 9, 10],
                            "max_new_tokens": 80})

    t = threading.Thread(target=client)
    t.start()
    wait_for(lambda: bool(eng._by_id))
    rid = list(eng._by_id)[0]
    code, _, out = post(base, "/cancel", {"request_id": rid})
    assert code == 200 and out["cancelled"] is True
    t.join(timeout=120)
    assert not t.is_alive()
    # cancelling a resolved request reports False, not an error
    assert post(base, "/cancel", {"request_id": rid})[2] == \
        {"cancelled": False}
    return res["resp"]


def _bad_request(eng, base):
    return post(base, "/generate", {"prompt_ids": []})


ERRORS = {429: _shed_queue_full, 503: _shed_draining, 504: _deadline,
          499: _cancelled, 400: _bad_request}


@pytest.mark.parametrize("code", sorted(ERRORS))
def test_error_map_matches_the_jax_front(served, code):
    outs = [ERRORS[code](eng, base) for eng, base in served]
    for c, hdrs, out in outs:
        assert c == code, (c, out)
        if code in (429, 503):
            assert hdrs["Retry-After"] == "1.0"
    (_, _, jout), (_, _, tout) = outs
    assert tout.get("outcome") == jout.get("outcome")
    assert tout.get("reason") == jout.get("reason")
    for eng, _ in served:
        assert eng.health == "healthy"
        wait_for(lambda: not any(eng._slots))
        assert len(eng._free_pages) + eng._cache.evictable_count == \
            eng.num_pages - 1


def test_traceparent_roots_the_request_tree(served):
    """A W3C traceparent parents the engine's llm.request span."""
    from paddle_tpu_torch.observability import tracing
    _, (_, tbase) = served
    tid, sid = "ab" * 16, "cd" * 8
    tracing.enable()
    try:
        tracing.clear()
        code, _, _ = post(tbase, "/generate",
                          {"prompt_ids": [3, 4, 5], "max_new_tokens": 2},
                          headers={"traceparent": f"00-{tid}-{sid}-01"})
        roots = [s for s in tracing.finished_spans()
                 if s["name"] == "llm.request"]
    finally:
        tracing.disable()
        tracing.clear()
    assert code == 200
    assert [(r["trace_id"], r["parent_id"]) for r in roots] == \
        [(tid, sid)]


def test_concurrent_posts_match_the_jax_front(served):
    """Four concurrent POSTs a front (greedy and sampled rows riding
    one batch) give the JAX front's streams."""
    rng = np.random.RandomState(7)
    bodies = [{"prompt_ids": rng.randint(0, 97, n).tolist(),
               "max_new_tokens": 5, "temperature": t, "nonce": 50 + i}
              for i, (n, t) in enumerate(((6, 0.0), (13, 0.9),
                                          (3, 0.0), (17, 0.9)))]
    outs = []
    for _, base in served:
        res = [None] * len(bodies)

        def client(i, base=base, res=res):
            res[i] = post(base, "/generate", bodies[i])

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(len(bodies))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert all(r is not None and r[0] == 200 for r in res), res
        outs.append([r[2]["output_ids"] for r in res])
    assert outs[1] == outs[0]
