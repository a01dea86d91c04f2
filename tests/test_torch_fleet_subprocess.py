"""Port replicas as subprocesses on the CPU: ``spawn_replica`` with
``"device": "cpu"`` announces itself on the TCPStore roster, the router
attaches it from there, and its streams and weights equal those of an
in-process port engine built from the same spec; SIGTERM takes it off
the roster; a ``replica.crash`` rule kills it with exit code 137 and the
router fails its request over to a sibling process token-identically;
a replica asked for the GPU on a machine without one fails before its
READY line."""

import json
import time
from urllib.request import urlopen

import pytest

torch = pytest.importorskip("torch")

from paddle_tpu_torch.distributed import (TCPMembership,  # noqa: E402
                                          TCPStoreClient, TCPStoreServer)
from paddle_tpu_torch.serving import (HTTPReplica, ReplicaUnavailable,  # noqa: E402,E501
                                      Router, make_engine_from_spec,
                                      spawn_replica, terminate_replica)
from paddle_tpu_torch.serving.replica import state_digest  # noqa: E402
from paddle_tpu_torch.serving.router import (affinity_key,  # noqa: E402
                                             rendezvous_pick)

MODEL = {"vocab": 97, "layers": 2, "hidden": 64, "device": "cpu"}


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


@pytest.fixture(scope="module")
def store():
    srv = TCPStoreServer("127.0.0.1", 0)
    yield f"127.0.0.1:{srv.port}"
    srv.close()


@pytest.fixture(scope="module")
def local():
    """The in-process port engine of the replicas' spec."""
    eng = make_engine_from_spec(MODEL)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def r0(store):
    proc, info = spawn_replica(dict(MODEL, name="r0", store=store,
                                    beat_interval=0.1), timeout=120)
    yield proc, info
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)


def statusz(info):
    base = info["healthz"].rsplit("/healthz", 1)[0]
    with urlopen(base + "/statusz", timeout=30) as r:
        return json.loads(r.read())


def test_ready_reports_device_and_weights(r0, local):
    _, info = r0
    assert info["device"] == "cpu"
    assert info["state_digest"] == state_digest(local.net)


def test_router_attaches_from_roster_streams_as_local(r0, store, local):
    with Router(store_endpoint=store, page_size=4,
                health_poll_interval=0.1) as r:
        wait_for(lambda: "r0" in r.replica_names())
        outs = [r.submit(p, max_new_tokens=8, temperature=t)
                for p, t in (([5, 6, 7, 8, 9, 10], 0.0),
                             (list(range(20, 41)), 0.8))]
        outs = [f.result(timeout=120) for f in outs]
    for (p, t), out in zip((([5, 6, 7, 8, 9, 10], 0.0),
                            (list(range(20, 41)), 0.8)), outs):
        assert out["replica"] == "r0"
        want = local.submit(p, max_new_tokens=8, temperature=t,
                            nonce=out["request_id"]).result(timeout=120)
        assert out["output_ids"] == want["output_ids"]
    kern = statusz(r0[1])["providers"]["kernels"]
    # on the CPU the wrapper runs B4's twin: the counter stays at 0
    assert kern["device"] == "cpu" and kern["dispatched_ticks"] > 0
    assert kern["paged_attention_launches"] == 0 and kern["layers"] == 2


def test_crash_rule_exits_137_and_router_fails_over(r0, store, local):
    proc, info = spawn_replica(dict(
        MODEL, name="crash", faults={"seed": 0, "rules": [
            {"site": "replica.crash", "nth": [4]}]}), timeout=120)
    try:
        assert proc.wait(timeout=30) == 137
        prompt = next(p for p in ([i, i + 1, i + 2] for i in range(97))
                      if rendezvous_pick(affinity_key(p, 4, 2),
                                         ["crash", "r0"]) == "crash")
        clients = {n: HTTPReplica(i["generate"], i["healthz"])
                   for n, i in (("crash", info), ("r0", r0[1]))}
        with Router(clients, page_size=4, failover_budget=2,
                    health_poll_interval=5.0) as r:
            out = r.submit(prompt, max_new_tokens=8,
                           temperature=0.9).result(timeout=120)
            assert r.n_failovers == 1
    finally:
        if proc.poll() is None:
            proc.kill()
    assert out["failovers"] == 1 and out["replica"] == "r0"
    want = local.submit(prompt, max_new_tokens=8, temperature=0.9,
                        nonce=out["request_id"]).result(timeout=120)
    assert out["output_ids"] == want["output_ids"]


def test_sigterm_leaves_the_roster(r0, store):
    proc, _ = r0
    client = TCPStoreClient(store)
    assert "r0" in TCPMembership.list_members(client)
    assert terminate_replica(proc, timeout=30) == 0
    assert "r0" not in TCPMembership.list_members(client)


def test_gpu_replica_without_a_card_fails_before_ready():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(ReplicaUnavailable, match="no CUDA device"):
        spawn_replica(dict(MODEL, device=None, name="gpu0"), timeout=120)
