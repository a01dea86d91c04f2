"""The port's serving fleet against the JAX package's, on the CPU: a
``Router`` over two port ``LocalReplica`` engines and a ``Router`` over
two JAX engines, every engine in ``make_engine_from_spec``'s geometry
(vocab 97, 2 layers, hidden 64; max_seqs 4, page_size 4, 96 pages,
bucket 16, seed 0) and on the JAX package's weights
(``interop.load_reference_state``).

Held equal: the replica each request is routed to, the streams (and
the request ids the router pins as nonces), failover through a replica
that dies on its first submit, nonce pinning whatever the engine's
schedule, the disaggregated prefill -> decode migration (f32 and int8)
against a unified JAX engine, the page audit after a page corrupted in
flight, the keys of ``/fleetz`` and the perf registry's token accrual
that ``ServiceTimeEstimator`` reads."""

import importlib

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

pytest.importorskip("torch")

from paddle_tpu_torch.interop import load_reference_state  # noqa: E402

SPEC = {"vocab": 97, "layers": 2, "hidden": 64}
PKGS = ("paddle_tpu", "paddle_tpu_torch")


def _mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(scope="module")
def fleet():
    """Per package: its serving module, kv_transfer, perf, and a
    ``engine(kv_dtype, i)`` factory of cached engines on one set of
    weights (the JAX package's, carried into the port)."""
    jnet = _mod("paddle_tpu", "serving").build_net_from_spec(SPEC)
    tnet = _mod("paddle_tpu_torch", "serving").build_net_from_spec(
        dict(SPEC, device="cpu"))
    load_reference_state(tnet, {k: np.asarray(v)
                                for k, v in jnet.state_dict().items()})
    nets = {"paddle_tpu": jnet, "paddle_tpu_torch": tnet}
    engines = {}

    def engine(root, kv_dtype="f32", i=0):
        key = (root, kv_dtype, i)
        if key not in engines:
            llm = _mod(root, "inference.llm")
            kw = dict(max_seqs=4, page_size=4, num_pages=96,
                      prefill_buckets=(16,), seed=0, kv_dtype=kv_dtype)
            if root == "paddle_tpu_torch":
                kw["device"] = "cpu"
            engines[key] = llm.LLMEngine(nets[root], **kw)
        return engines[key]

    yield engine
    for e in engines.values():
        e.close()


def serving(root):
    return _mod(root, "serving")


def prompt_for(root, target, names, length, seed):
    """A prompt whose affinity pick at page size 4 is ``target``."""
    router = _mod(root, "serving.router")
    rng = np.random.RandomState(seed)
    while True:
        p = rng.randint(0, 97, length).tolist()
        if router.rendezvous_pick(router.affinity_key(p, 4, 2),
                                  names) == target:
            return p


# ---------------------------------------------------------------------------
# routing: picks, streams, /fleetz
# ---------------------------------------------------------------------------

def _traffic():
    """Two prefix families of 8 shared tokens (2 pages, the affinity
    span) and short prompts, greedy and T 0.8."""
    rng = np.random.RandomState(0)
    fams = [rng.randint(0, 97, 8).tolist() for _ in range(2)]
    prompts = [fams[i % 2] + rng.randint(0, 97, n).tolist()
               for i, n in enumerate((3, 9, 14, 5, 20, 11))]
    prompts += [[5, 6, 7], [40, 41]]
    temps = [0.0, 0.8] * 4
    return prompts, temps


@pytest.fixture(scope="module")
def routed(fleet):
    """The traffic through each package's router over its two engines,
    submitted at once: outputs in request order, /fleetz, the counts."""
    prompts, temps = _traffic()
    out = {}
    for root in PKGS:
        s = serving(root)
        with s.Router({"r0": s.LocalReplica(fleet(root, i=0)),
                       "r1": s.LocalReplica(fleet(root, i=1))},
                      page_size=4, health_poll_interval=5.0) as r:
            futs = [r.submit(p, max_new_tokens=6, temperature=t)
                    for p, t in zip(prompts, temps)]
            res = [f.result(timeout=300) for f in futs]
            out[root] = {"outs": res, "fleetz": r._fleetz(),
                         "counts": (r.n_submitted, r.n_failovers,
                                    r.n_rebalanced, r.n_shed)}
    return prompts, out


def test_same_picks_as_reference(routed):
    prompts, out = routed
    router = _mod("paddle_tpu", "serving.router")
    want = [o["replica"] for o in out["paddle_tpu"]["outs"]]
    assert [o["replica"] for o in out["paddle_tpu_torch"]["outs"]] == want
    assert want == [router.rendezvous_pick(
        router.affinity_key(p, 4, 2), ["r0", "r1"]) for p in prompts]
    assert set(want) == {"r0", "r1"}
    assert out["paddle_tpu_torch"]["counts"] == \
        out["paddle_tpu"]["counts"]


def test_same_streams_as_reference(routed):
    _, out = routed
    key = lambda o: (o["request_id"], o["output_ids"])  # noqa: E731
    want = [key(o) for o in out["paddle_tpu"]["outs"]]
    assert [key(o) for o in out["paddle_tpu_torch"]["outs"]] == want
    assert all(len(ids) == 6 for _, ids in want)


def test_fleetz_keys_as_reference(routed):
    _, out = routed

    def shape(d):
        if isinstance(d, dict):
            return {k: shape(v) for k, v in d.items()}
        return type(d).__name__ if d is not None else None

    fz = {root: out[root]["fleetz"] for root in PKGS}
    assert set(fz["paddle_tpu_torch"]) == set(fz["paddle_tpu"])
    for name in ("r0", "r1"):
        assert set(fz["paddle_tpu_torch"]["replicas"][name]) == \
            set(fz["paddle_tpu"]["replicas"][name])
    assert shape(fz["paddle_tpu_torch"]["roles"]) == \
        shape(fz["paddle_tpu"]["roles"])
    assert fz["paddle_tpu_torch"]["submitted"] == \
        fz["paddle_tpu"]["submitted"] == 8


# ---------------------------------------------------------------------------
# failover and nonce pinning
# ---------------------------------------------------------------------------

class FlakyOnce:
    """A replica that dies on its first submit, as a crashed process
    does mid-request."""

    def __init__(self, inner, exc):
        self.inner, self.exc, self.tripped = inner, exc, False

    def submit(self, *a, **kw):
        if not self.tripped:
            self.tripped = True
            raise self.exc("simulated crash")
        return self.inner.submit(*a, **kw)

    def health(self):
        return self.inner.health()

    def cancel(self, rid):
        return self.inner.cancel(rid)

    def close(self):
        pass


def test_failover_token_identical_as_reference(fleet):
    got = {}
    for root in PKGS:
        s = serving(root)
        a, b = fleet(root, i=0), fleet(root, i=1)
        prompt = prompt_for(root, "a", ("a", "b"), 15, seed=0)
        flaky = FlakyOnce(s.LocalReplica(a), s.ReplicaUnavailable)
        with s.Router({"a": flaky, "b": s.LocalReplica(b)},
                      page_size=4, failover_budget=2,
                      health_poll_interval=5.0) as r:
            # replica b's own nonce counter moves on: identity must come
            # from the pinned nonce
            b.submit([3, 1, 4], max_new_tokens=2,
                     temperature=0.5).result(timeout=120)
            out = r.submit(prompt, max_new_tokens=8,
                           temperature=0.9).result(timeout=120)
            n_failovers = r.n_failovers
        ref = a.submit(prompt, max_new_tokens=8, temperature=0.9,
                       nonce=out["request_id"]).result(timeout=120)
        assert out["failovers"] == 1 == n_failovers
        assert out["replica"] == "b"
        assert ref["output_ids"] == out["output_ids"]
        got[root] = (out["request_id"], out["output_ids"])
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]


def test_nonce_pinning_schedule_independent_as_reference(fleet):
    got = {}
    for root in PKGS:
        a, b = fleet(root, i=0), fleet(root, i=1)
        prompt = list(range(30, 42))
        x = a.submit(prompt, max_new_tokens=6, temperature=0.8,
                     nonce=12345).result(timeout=120)
        for i in range(3):                  # another scheduler history
            b.submit([i, i + 1], max_new_tokens=2,
                     temperature=0.3).result(timeout=120)
        y = b.submit(prompt, max_new_tokens=6, temperature=0.8,
                     nonce=12345).result(timeout=120)
        assert x["output_ids"] == y["output_ids"]
        got[root] = x["output_ids"]
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]


# ---------------------------------------------------------------------------
# disaggregated prefill / decode
# ---------------------------------------------------------------------------

CHAIN = 5            # full pages of a 24-token prompt a decode may reuse


class Tampered:
    """A prefill client whose export flips one byte of page 1's K in
    flight."""

    def __init__(self, inner, kvt):
        self.inner, self.kvt = inner, kvt

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def export_pages(self, digests, trace_context=None):
        payload = self.inner.export_pages(digests,
                                          trace_context=trace_context)
        rec = payload["pages"][1]
        k = bytearray(self.kvt._unb64(rec["k"]))
        k[0] ^= 0x40
        rec["k"] = self.kvt._b64(bytes(k))
        return payload


def _disagg(fleet, root, kv_dtype, prompt, tamper):
    """One request through a router over a prefill replica (engine 2
    of the pool dtype) and a decode replica (engine 3): the output, the
    router's migration counts and the decode engine's page audit."""
    s = serving(root)
    pre, dec = fleet(root, kv_dtype, 2), fleet(root, kv_dtype, 3)
    client = s.LocalReplica(pre)
    if tamper:
        client = Tampered(client, _mod(root, "inference.kv_transfer"))
    cached0 = dec.n_cached_tokens
    with s.Router(page_size=4, disagg_threshold_tokens=8,
                  health_poll_interval=5.0) as r:
        r.attach("p0", client, role="prefill")
        r.attach("d0", s.LocalReplica(dec), role="decode")
        out = r.submit(prompt, max_new_tokens=8,
                       temperature=0.7).result(timeout=300)
        counts = (r.n_migrations, r.n_migrate_failed,
                  r.n_pages_migrated, r.n_pages_rejected)
    audit = (len(dec._free_pages) + dec._cache.shared_page_count + 1,
             dec.num_pages)
    return out, counts, dec.n_cached_tokens - cached0, audit


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_disaggregated_migration_as_unified_reference(fleet, kv_dtype):
    prompt = list(range(1, 25)) if kv_dtype == "f32" else \
        list(range(70, 46, -1))
    got = {}
    for root in PKGS:
        out, counts, cached, audit = _disagg(fleet, root, kv_dtype,
                                             prompt, tamper=False)
        assert out["replica"] == "d0" and out["prefill_replica"] == "p0"
        assert out["migrated_pages"] == CHAIN and cached == CHAIN * 4
        assert audit[0] == audit[1]
        got[root] = (out["request_id"], out["output_ids"], counts)
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    # a unified JAX engine of the same pool dtype, under the same nonce
    ref = fleet("paddle_tpu", kv_dtype, 0).submit(
        prompt, max_new_tokens=8, temperature=0.7,
        nonce=got["paddle_tpu"][0]).result(timeout=300)
    assert ref["output_ids"] == got["paddle_tpu_torch"][1]


def test_corrupted_page_rejected_no_leak_as_reference(fleet):
    prompt = list(range(90, 66, -1))
    got = {}
    for root in PKGS:
        out, counts, cached, audit = _disagg(fleet, root, "f32", prompt,
                                             tamper=True)
        # pages 0 installs; page 1 fails its digest and ends the run
        assert out["migrated_pages"] == 1 and counts[3] == CHAIN - 1
        assert cached == 4
        assert audit[0] == audit[1]             # no page leaked
        got[root] = (out["request_id"], out["output_ids"], counts)
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    ref = fleet("paddle_tpu", "f32", 0).submit(
        prompt, max_new_tokens=8, temperature=0.7,
        nonce=got["paddle_tpu"][0]).result(timeout=300)
    assert ref["output_ids"] == got["paddle_tpu_torch"][1]


# ---------------------------------------------------------------------------
# the perf registry the overload estimator reads
# ---------------------------------------------------------------------------

def test_perf_accrual_as_reference(fleet, routed):
    """After the same sequential request, each engine's llm program
    handles gained the same tokens by kind, with wall seconds beside
    them, so ``ServiceTimeEstimator.rates`` has history in both."""
    got = {}
    for root in PKGS:
        perf = _mod(root, "observability.perf")
        eng = fleet(root, i=0)

        def snap():
            acc = {}
            for h in perf.instance().programs():
                if h.component == "llm" and h.scope == eng._perf_scope:
                    s, t = acc.get(h.kind, (0.0, 0))
                    acc[h.kind] = (s + h.seconds, t + h.tokens)
            return acc

        before = snap()
        eng.submit(list(range(10, 40)), max_new_tokens=12,
                   temperature=0.0, nonce=7).result(timeout=300)
        after = snap()
        delta = {k: (v[0] - before.get(k, (0.0, 0))[0],
                     v[1] - before.get(k, (0.0, 0))[1])
                 for k, v in after.items()}
        assert all(s > 0 for s, t in delta.values() if t > 0)
        got[root] = {k: t for k, (s, t) in delta.items()}
        rates = serving(root).ServiceTimeEstimator(min_busy_s=0.0).rates()
        assert rates is not None and min(rates) > 0
    assert got["paddle_tpu_torch"] == got["paddle_tpu"]
    assert sum(got["paddle_tpu"].values()) > 0
