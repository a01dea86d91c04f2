"""The port's multi-node launcher (``launch --nnodes 2`` → ``NodeAgent``)
and its rendezvous stores, the counterparts of
``tests/test_multinode_elastic.py``: the file and tcp rendezvous units
(the same protocol as the JAX package's, driven step for step through
both packages' classes), an uninterrupted 2-node job, and — marked
``slow``, as the whole JAX file is — a whole-node loss that holds,
rejoins and resumes, two budget-free preemptions, a hard crash that
burns the budget, and the tcp backend with a preemption. Each "node" is
an agent process group of its own on this host; the ranks train
``tests/torch_multinode_worker.py`` data-parallel over gloo, and every
interrupted job's losses equal the uninterrupted job's bit for bit."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multinode_worker.py")
TOTAL = 8


def _env(extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               PADDLE_MASTER_HOST="127.0.0.1")
    env.update(extra or {})
    return env


def _agent(node_rank, workdir, rdzv, max_restarts=0, env_extra=None):
    """One node agent in its own session, so a 'node loss' can SIGKILL
    the agent and its ranks together, like a machine eviction."""
    backend = ["--rdzv_backend", "tcp", "--rdzv_endpoint", rdzv] \
        if rdzv.startswith("127.") else ["--rdzv_dir", rdzv]
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", "2", "--node_rank", str(node_rank),
         "--nproc_per_node", "1", *backend,
         "--max_restarts", str(max_restarts), "--node_timeout", "4",
         WORKER, workdir, str(TOTAL)],
        cwd=REPO, env=_env(env_extra), start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(proc, timeout=300):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"agent timed out:\n{out.decode()[-3000:]}")
    return proc.returncode, out.decode(errors="replace")


def _read_losses(path):
    """step → last written loss (re-run steps legitimately repeat)."""
    out = {}
    if os.path.exists(path):
        for line in open(path):
            s, v, _gen = line.split()
            out[int(s)] = float(v)
    return out


def _free_endpoint():
    from paddle_tpu_torch.distributed.launch import find_free_port
    return f"127.0.0.1:{find_free_port()}"


def _run_job(tmp_path, tag, backend="file", max_restarts=0,
             env_extra=None):
    work = str(tmp_path / f"work_{tag}")
    os.makedirs(work)
    rdzv = _free_endpoint() if backend == "tcp" else \
        str(tmp_path / f"rdzv_{tag}")
    agents = [_agent(n, work, rdzv, max_restarts, env_extra)
              for n in range(2)]
    results = [_wait(a) for a in agents]
    return work, rdzv, results


@pytest.fixture(scope="module")
def reference_losses(tmp_path_factory):
    """An uninterrupted 2-node run: the parity baseline and the
    happy-path completion test."""
    tmp = tmp_path_factory.mktemp("mn_ref")
    work, _, results = _run_job(tmp, "ref")
    for rc, out in results:
        assert rc == 0, out[-3000:]
    losses = _read_losses(os.path.join(work, "losses.txt"))
    assert sorted(losses) == list(range(TOTAL))
    return losses


def test_uninterrupted_multinode_completes(reference_losses):
    assert len(reference_losses) == TOTAL


def _assert_parity(work, reference_losses):
    final = _read_losses(os.path.join(work, "losses.txt"))
    assert sorted(final) == list(range(TOTAL))
    for s in range(TOTAL):
        assert final[s] == reference_losses[s], f"step {s} diverged"


def test_file_rendezvous_unit(tmp_path):
    """FileRendezvous derivation logic in both packages, step for step:
    generation stepping past flags, budget accounting by flag reason,
    staleness."""
    from paddle_tpu.distributed.multinode import FileRendezvous as JF
    from paddle_tpu_torch.distributed.multinode import FileRendezvous
    for cls, d in ((FileRendezvous, tmp_path / "t"), (JF, tmp_path / "j")):
        r0, r1 = cls(str(d), 0, 2), cls(str(d), 1, 2)
        try:
            assert r0.next_generation() == 0
            r0.publish(0, "127.0.0.1:1", 1)
            assert r1.read()["master"] == "127.0.0.1:1"
            r1.request_restart(0, "preempt", 67)
            assert r0.next_generation() == 1
            assert r0.burned_restarts(1) == 0          # preempt is free
            r0.publish(1, "127.0.0.1:2", 1)
            r0.request_restart(1, "peer-lost", -1)     # platform's fault
            r1.request_restart(1, "preempt", 67)
            assert r1.next_generation() == 2
            assert r1.burned_restarts(2) == 0
            r0.request_restart(2, "failure", 3)        # a crash burns
            r1.request_restart(2, "peer-lost", -1)
            assert r1.next_generation() == 3
            assert r1.burned_restarts(3) == 1
            r0.mark_done(3)
            assert not r0.all_done(3)
            r1.mark_done(3)
            assert r1.all_done(3)
            assert r0.stale_peers(timeout=60) == []    # both beating
            r1.stop()
            time.sleep(0.05)
            assert r0.stale_peers(timeout=1e-9) == [1]
        finally:
            r0.stop()
            r1.stop()
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))


def test_tcp_rendezvous_unit():
    """TCPRendezvous speaks FileRendezvous's protocol over the port's
    socket store: server-judged ages, generation stepping, budget
    accounting, completion; leader-hosted, and StoreUnavailable once
    the leader's server is gone."""
    from paddle_tpu_torch.distributed.tcp_store import (StoreUnavailable,
                                                        TCPRendezvous)
    r0 = TCPRendezvous("127.0.0.1:0", 0, 2)   # leader hosts the store
    r1 = TCPRendezvous(r0.endpoint, 1, 2)
    try:
        assert r0.peers_all_fresh(5.0) and r1.peers_all_fresh(5.0)
        assert r0.next_generation() == 0
        r0.publish(0, "127.0.0.1:1", 1)
        assert r1.read()["master"] == "127.0.0.1:1"
        r1.request_restart(0, "preempt", 67)
        assert r0.next_generation() == 1
        assert r0.burned_restarts(1) == 0
        r0.publish(1, "127.0.0.1:2", 1)
        r0.request_restart(1, "failure", 1)
        assert r1.next_generation() == 2
        assert r1.burned_restarts(2) == 1          # failure burns
        r0.mark_done(2)
        assert not r0.all_done(2)
        r1.mark_done(2)
        assert r1.all_done(2)
    finally:
        r1.stop()
        r0.stop()
    r1._cache.clear()
    with pytest.raises(StoreUnavailable):
        r1.read()


@pytest.mark.slow
def test_node_loss_hold_rejoin_resume_parity(tmp_path, reference_losses):
    """SIGKILL a whole node mid-training: the survivor flags peer-lost
    and HOLDs; a fresh agent for the node (same rendezvous dir) rotates
    the master and the job resumes from the newest checkpoint to the
    uninterrupted losses."""
    rdzv = str(tmp_path / "rdzv")
    work = str(tmp_path / "work")
    os.makedirs(work)
    a0 = _agent(0, work, rdzv)
    a1 = _agent(1, work, rdzv)
    loss_file = os.path.join(work, "losses.txt")
    deadline = time.time() + 240
    while time.time() < deadline:
        if len(_read_losses(loss_file)) >= 3:
            break
        time.sleep(0.2)
    else:
        for a in (a0, a1):
            os.killpg(a.pid, signal.SIGKILL)
        raise AssertionError("job never reached step 3")
    os.killpg(a1.pid, signal.SIGKILL)   # the node is gone, whole group
    a1.wait()
    time.sleep(5)                       # > --node_timeout: survivor
    assert a0.poll() is None, "survivor exited instead of holding"
    a1b = _agent(1, work, rdzv)         # the platform reschedules it
    for a in (a0, a1b):
        rc, out = _wait(a)
        assert rc == 0, out[-3000:]
    state = json.load(open(os.path.join(rdzv, "rdzv.json")))
    assert state["generation"] >= 1     # the rendezvous rotated
    _assert_parity(work, reference_losses)


@pytest.mark.slow
def test_two_consecutive_preemptions_budget_free(tmp_path,
                                                 reference_losses):
    """Preemption at generation 0 and again at generation 1 with
    max_restarts=0: both restarts are budget-free and the job completes
    losslessly (generation depth 2)."""
    work, rdzv, results = _run_job(tmp_path, "preempt",
                                   env_extra={"MN_PREEMPT": "2@0,4@1"})
    for rc, out in results:
        assert rc == 0, out[-3000:]
    state = json.load(open(os.path.join(rdzv, "rdzv.json")))
    assert state["generation"] == 2
    _assert_parity(work, reference_losses)


@pytest.mark.slow
def test_hard_crash_burns_budget_then_errors(tmp_path):
    """A non-preemption failure consumes the budget; with
    max_restarts=0 every agent exits non-zero, not loops."""
    _, _, results = _run_job(tmp_path, "crash",
                             env_extra={"MN_CRASH": "2@0,2@1,2@2"})
    assert all(rc != 0 for rc, _ in results), results


@pytest.mark.slow
def test_tcp_backend_job_with_preemption(tmp_path, reference_losses):
    """The same story over the leader's socket store (no shared
    filesystem for the rendezvous): one preemption, lossless."""
    work, _, results = _run_job(tmp_path, "tcp", backend="tcp",
                                env_extra={"MN_PREEMPT": "2@0"})
    for rc, out in results:
        assert rc == 0, out[-3000:]
    _assert_parity(work, reference_losses)
