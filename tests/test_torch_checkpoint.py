"""The port's ``io.checkpoint`` (``CheckpointManager``, ``digest_tree``,
``save_checkpoint``/``load_checkpoint``, ``AutoCheckpoint``),
``io.crypto`` and ``parallel.recompute`` against the JAX package's.

- Manifests: the params/opt/guard tree of a 2-layer GPT after one AdamW
  step (plus bf16 leaves, a list and a host-int counter) is saved by
  both packages' managers: the ``digests`` maps are equal key for key
  and digest for digest, the ``state`` bundles equal apart from ``ts``,
  and each package's ``latest_manifest_step`` reads the other's
  directory.
- Manager semantics: the scenarios of ``tests/test_preemption_resume.py``
  (unmanifested steps, GC, quarantine, byte rot, async failures,
  ``flush``, first-commit debris, duplicate saves, ``close`` after a
  flush timeout) run through both packages' managers to the same
  outcome.
- Crypto: each package decrypts the other's blob.
- Recompute: ``recompute``, ``RecomputeSequential`` and
  ``GradientMerge`` against the JAX package's over 3 Adam steps at lr
  1e-2, float32: losses within 1e-5 relative (two frameworks' float32
  autograd), parameters within 1e-5 relative plus 1e-6 absolute (lr ×
  1e-4: Adam's ``m / sqrt(v)`` turns the rounding of a near-zero
  gradient element into an update of up to lr); the port's recomputed
  run against its plain run: equal.
"""

import functools
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.io import checkpoint as jckpt  # noqa: E402
from paddle_tpu.io import crypto as jcrypto  # noqa: E402
from paddle_tpu.parallel.recompute import (  # noqa: E402
    GradientMerge as JGradientMerge, RecomputeSequential as JRecSeq)
from paddle_tpu.reliability.retry import Deadline as JDeadline  # noqa: E402
from paddle_tpu_torch.interop import load_reference_state  # noqa: E402
from paddle_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from paddle_tpu_torch.io import crypto as tcrypto  # noqa: E402
from paddle_tpu_torch.models import gpt as tgpt  # noqa: E402
from paddle_tpu_torch.parallel.recompute import (  # noqa: E402
    GradientMerge as TGradientMerge, RecomputeSequential as TRecSeq,
    recompute as trecompute)
from paddle_tpu_torch.reliability import guard as tguard  # noqa: E402
from paddle_tpu_torch.reliability.retry import \
    Deadline as TDeadline  # noqa: E402

RTOL = 1e-5


# -- the same tree in both packages ------------------------------------------

def _bf16_np(t):
    """A torch bf16 tensor as a numpy ``jnp.bfloat16`` array, bit for
    bit."""
    return t.contiguous().view(torch.int16).numpy().view(jnp.bfloat16)


def _to_numpy(tree):
    """The port's tree as the JAX package holds it: numpy arrays, bf16
    as ``jnp.bfloat16``, a host int counter as a 0-d int32."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return _bf16_np(t) if t.dtype == torch.bfloat16 else \
            t.numpy().copy()
    if isinstance(tree, int):
        return np.asarray(tree, np.int32)
    return tree


@functools.lru_cache(maxsize=None)
def _gpt_tree(guard: bool):
    """The port's checkpoint tree of a 2-layer GPT after one AdamW step
    (the guard armed or not: the counter ``t`` is a 0-d int32 device
    tensor or a host int), with bf16 leaves and a list added."""
    torch.manual_seed(0)
    tpt.seed(0)
    cfg = tgpt.gpt_config("gpt2-small", num_layers=2, hidden_size=64,
                          num_heads=1, vocab_size=61,
                          max_position_embeddings=32, hidden_dropout=0.0,
                          attention_dropout=0.0, fused_loss=True)
    net = tgpt.GPTForCausalLM(cfg, device="cpu")
    model = tpt.Model(net)
    model.prepare(tpt.optimizer.AdamW(1e-3, parameters=net),
                  tgpt.GPTFusedPretrainingCriterion(),
                  numeric_guard=tguard.GuardPolicy() if guard else None)
    ids = np.random.RandomState(0).randint(0, 61, (2, 33))
    model.train_batch([ids[:, :-1]], [ids[:, 1:]])
    model.drain_metrics()
    tree = model._state_tree()
    params = tree["params"]
    names = sorted(params)[:2]
    tree["half"] = {"wte": params[names[0]].detach().bfloat16()}
    tree["list"] = [params[names[1]].detach().bfloat16(),
                    {"count": 7, "scale": torch.tensor(0.5)}]
    return tree


@pytest.mark.parametrize("guard", [False, True], ids=["int_t", "device_t"])
def test_manifests_equal_jax(tmp_path, guard):
    tree = _gpt_tree(guard)
    t_counter = tree["opt"]["t"]
    assert isinstance(t_counter, torch.Tensor) == guard
    state = {"step": 1, "epoch": 0, "loader": {"pass": 0, "batch": 1},
             "rng": {"seed": 0, "key_data": [0, 0], "key_dtype": "uint32"}}
    dirs = {"jax": str(tmp_path / "jax"), "torch": str(tmp_path / "torch")}
    with jckpt.CheckpointManager(dirs["jax"], async_save=False) as m:
        m.save(1, _to_numpy(tree), state=state)
    with tckpt.CheckpointManager(dirs["torch"], async_save=True) as m:
        m.save(1, tree, state=state)
    man = {k: json.load(open(os.path.join(d, "manifest-1.json")))
           for k, d in dirs.items()}
    dj, dt = man["jax"]["digests"], man["torch"]["digests"]
    assert sorted(dj) == sorted(dt)
    assert "['opt']['t']" in dj and "['half']['wte']" in dj \
        and "['list'][1]['count']" in dj
    assert ("['guard']['ema']" in dj) == guard
    bad = {k: (dj[k], dt[k]) for k in dj if dj[k] != dt[k]}
    assert not bad, bad
    for m in man.values():
        m.pop("ts")
    assert man["jax"] == man["torch"]
    # the digest functions agree outside the managers too
    assert jckpt.digest_tree(_to_numpy(tree)) == tckpt.digest_tree(tree)
    # each package's manifest scan reads the other's directory
    assert jckpt.latest_manifest_step(dirs["torch"]) == 1
    assert tckpt.latest_manifest_step(dirs["jax"]) == 1


def test_restore_round_trips_exactly(tmp_path):
    """bf16, int32, float32 and the host-int counter come back bit for
    bit and of the same kinds; the restore verifies."""
    tree = _gpt_tree(False)
    with tckpt.CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(3, tree)
        back = m.restore(3)
    assert tckpt.digest_tree(back) == tckpt.digest_tree(tree)
    assert isinstance(back["opt"]["t"], int)
    assert isinstance(back["list"][1]["count"], int)
    assert back["half"]["wte"].dtype == torch.bfloat16
    assert torch.equal(back["half"]["wte"], tree["half"]["wte"])


def test_port_refuses_an_orbax_step_without_quarantining(tmp_path):
    """A step the JAX package committed (an orbax directory) is not
    readable by the port: restore raises NotImplementedError and leaves
    the step manifested."""
    d = str(tmp_path)
    with jckpt.CheckpointManager(d, async_save=False) as m:
        m.save(2, {"w": np.ones(3, np.float32)})
    mgr = tckpt.CheckpointManager(d, async_save=False)
    assert mgr.latest_step() == 2
    with pytest.raises(NotImplementedError, match="orbax"):
        mgr.restore()
    assert mgr.latest_step() == 2
    mgr.close()


def test_async_snapshot_is_a_copy(tmp_path):
    """The snapshot of a CPU tensor is not the tensor: an in-place
    update after ``save`` returns does not reach the committed step."""
    w = torch.zeros(64, 8)
    mgr = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    orig = mgr._commit
    gate = threading.Event()

    def slow(*a, **kw):
        gate.wait(timeout=10.0)
        return orig(*a, **kw)

    mgr._commit = slow
    mgr.save(1, {"w": w})
    w.add_(1.0)          # the next step's in-place update
    gate.set()
    mgr.wait_until_finished()
    mgr._commit = orig
    np.testing.assert_array_equal(np.asarray(mgr.restore(1)["w"]),
                                  np.zeros((64, 8), np.float32))
    mgr.close()


# -- manager semantics, both packages -----------------------------------------

PKGS = ["jax", "torch"]


def _ck(pkg):
    return jckpt if pkg == "jax" else tckpt


def _tree(pkg, v=0.0):
    w = np.full((32, 8), v, np.float32)
    b = np.arange(8, dtype=np.float32) + v
    if pkg == "jax":
        return {"w": w, "b": b}
    return {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}


def _deadline(pkg, s):
    return (JDeadline if pkg == "jax" else TDeadline).after(s)


def _w(tree):
    return np.asarray(tree["w"])


def _tamper_manifest(directory, step):
    """Rewrite one digest in the step's manifest: restore then succeeds
    at the byte level but fails integrity verification."""
    path = os.path.join(directory, f"manifest-{step}.json")
    man = json.load(open(path))
    key = sorted(man["digests"])[0]
    man["digests"][key] = "0" * 32
    json.dump(man, open(path, "w"))
    return key


@pytest.mark.parametrize("pkg", PKGS)
def test_manifest_state_rides_the_checkpoint(tmp_path, pkg):
    with _ck(pkg).CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(3, _tree(pkg, 1.0),
               state={"step": 3, "loader": {"pass": 0, "batch": 7}})
        tree, state = m.restore_with_state()
        assert state == {"step": 3, "loader": {"pass": 0, "batch": 7}}
        assert m.read_state(3) == state
        np.testing.assert_array_equal(_w(tree), _w(_tree("jax", 1.0)))


@pytest.mark.parametrize("pkg", PKGS)
def test_unmanifested_step_is_never_surfaced(tmp_path, pkg):
    """A committed data dir whose manifest never landed (a kill between
    the data commit and the manifest write) is invisible and swept: the
    kill costs that step and nothing more."""
    ck = _ck(pkg)
    with ck.CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(1, _tree(pkg))
        m.save(2, _tree(pkg))
    os.unlink(str(tmp_path / "manifest-2.json"))
    m = ck.CheckpointManager(str(tmp_path), async_save=False)
    assert m.latest_step() == 1
    assert ck.latest_manifest_step(str(tmp_path)) == 1
    assert not os.path.exists(str(tmp_path / "2"))
    m.save(2, _tree(pkg, 2.0))
    assert m.latest_step() == 2
    m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_gc_keeps_newest_verified_and_skips_quarantined(tmp_path, pkg):
    with _ck(pkg).CheckpointManager(str(tmp_path), max_to_keep=2,
                                    async_save=False) as m:
        for s in (1, 2, 3):
            m.save(s, _tree(pkg, float(s)), state={"step": s})
        _tamper_manifest(str(tmp_path), 3)
        _t, state = m.restore_with_state()
        assert state["step"] == 2 and m.latest_step() == 2
        for s in (4, 5):
            m.save(s, _tree(pkg, float(s)), state={"step": s})
        steps = m.all_steps()
        assert 4 in steps and 5 in steps and 1 not in steps
        assert m.latest_step() == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_explicit_corrupt_step_raises(tmp_path, pkg):
    ck = _ck(pkg)
    with ck.CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(1, _tree(pkg, 1.0))
        m.save(2, _tree(pkg, 2.0))
        key = _tamper_manifest(str(tmp_path), 2)
        with pytest.raises(ck.CheckpointCorrupt) as ei:
            m.restore(2)
        assert ei.value.step == 2 and key in ei.value.diff
        assert ei.value.diff[key]["expected"] == "0" * 32
        np.testing.assert_array_equal(_w(m.restore()),
                                      _w(_tree("jax", 1.0)))


@pytest.mark.parametrize("pkg", PKGS)
def test_byte_rot_falls_back(tmp_path, pkg):
    with _ck(pkg).CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(1, _tree(pkg, 1.0), state={"step": 1})
        m.save(2, _tree(pkg, 2.0), state={"step": 2})
        for f in glob.glob(str(tmp_path / "2" / "**"), recursive=True):
            if os.path.isfile(f):
                blob = bytearray(open(f, "rb").read())
                for i in range(0, len(blob), 32):
                    blob[i] ^= 0xFF
                open(f, "wb").write(bytes(blob))
        _t, state = m.restore_with_state()
        assert state["step"] == 1 and m.latest_step() == 1
        assert os.path.exists(str(tmp_path / "manifest-2.json.corrupt"))


@pytest.mark.parametrize("pkg", PKGS)
def test_async_commit_failure_surfaces_at_next_barrier(tmp_path, pkg):
    m = _ck(pkg).CheckpointManager(str(tmp_path), async_save=True)
    orig = m._commit
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk gone")
        return orig(*a, **kw)

    m._commit = flaky
    m.save(1, _tree(pkg))
    with pytest.raises(OSError):
        m.wait_until_finished()
    m.save(2, _tree(pkg))
    m.wait_until_finished()
    assert m.latest_step() == 2
    m._commit = orig
    m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_async_save_stall_bounded_by_snapshot(tmp_path, pkg):
    m = _ck(pkg).CheckpointManager(str(tmp_path), async_save=True)
    orig = m._commit
    m._commit = lambda *a, **kw: (time.sleep(0.3), orig(*a, **kw))[-1]
    t0 = time.perf_counter()
    m.save(1, _tree(pkg), state={"step": 1})
    stall = time.perf_counter() - t0
    m.wait_until_finished()
    assert stall < 0.15, f"async save stalled {stall:.3f}s"
    assert m.latest_step() == 1
    m._commit = orig
    m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_flush_outcomes(tmp_path, pkg):
    m = _ck(pkg).CheckpointManager(str(tmp_path), async_save=True)
    assert m.flush() == "noop"
    m.save(1, _tree(pkg), state={"step": 1})
    assert m.flush(_deadline(pkg, 30.0)) == "committed"
    orig = m._commit
    release = threading.Event()
    m._commit = lambda *a, **kw: (release.wait(5.0), orig(*a, **kw))[-1]
    m.save(2, _tree(pkg))
    assert m.flush(_deadline(pkg, 0.05)) == "timeout"
    assert m.latest_step() == 1
    release.set()
    m.wait_until_finished()
    assert m.latest_step() == 2
    m._commit = orig
    m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_sync_save_barriers_inflight_async(tmp_path, pkg):
    m = _ck(pkg).CheckpointManager(str(tmp_path), async_save=True)
    m.save(1, _tree(pkg, 1.0), state={"step": 1})
    m.save(2, _tree(pkg, 2.0), async_=False, state={"step": 2})
    assert sorted(m.all_steps()) == [1, 2] and m.latest_step() == 2
    m.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_quarantined_step_never_restores_as_legacy(tmp_path, pkg):
    ck = _ck(pkg)
    with ck.CheckpointManager(str(tmp_path), async_save=False) as m:
        m.save(1, _tree(pkg, 1.0))
        m.save(2, _tree(pkg, 2.0))
        _tamper_manifest(str(tmp_path), 2)
        m.restore()
        with pytest.raises(ck.CheckpointCorrupt):
            m.restore(2)
    d2 = str(tmp_path / "all_corrupt")
    with ck.CheckpointManager(d2, async_save=False) as m:
        m.save(1, _tree(pkg, 1.0))
        _tamper_manifest(d2, 1)
        with pytest.raises(ck.CheckpointCorrupt):
            m.restore()
        assert m.latest_step() is None
        with pytest.raises(ck.CheckpointCorrupt):
            m.restore()


@pytest.mark.parametrize("pkg", PKGS)
def test_gc_and_sweep_keep_legacy_steps(tmp_path, pkg):
    ck, d = _ck(pkg), str(tmp_path)
    with ck.CheckpointManager(d, async_save=False) as m:
        for s in (1, 2, 3):
            m.save(s, _tree(pkg, float(s)))
    for s in (1, 2, 3):
        os.unlink(os.path.join(d, f"manifest-{s}.json"))
    os.unlink(os.path.join(d, ".manifest-era"))
    with ck.CheckpointManager(d, max_to_keep=3, async_save=False) as m:
        assert m.latest_step() == 3
        m.save(5, _tree(pkg, 5.0))
        assert m.all_steps() == [2, 3, 5]
    with ck.CheckpointManager(d, max_to_keep=3, async_save=False) as m:
        assert m.all_steps() == [2, 3, 5] and m.latest_step() == 5


@pytest.mark.parametrize("pkg", PKGS)
def test_first_commit_crash_debris_not_legacy(tmp_path, pkg):
    ck, d = _ck(pkg), str(tmp_path)
    with ck.CheckpointManager(d, async_save=False) as m:
        m.save(1, _tree(pkg, 1.0))
    os.unlink(os.path.join(d, "manifest-1.json"))
    assert os.path.isdir(os.path.join(d, "1"))
    with ck.CheckpointManager(d, async_save=False) as m:
        assert m.latest_step() is None and m.all_steps() == []
        with pytest.raises(FileNotFoundError):
            m.restore()


@pytest.mark.parametrize("pkg", PKGS)
def test_duplicate_step_save_skips(tmp_path, pkg):
    with _ck(pkg).CheckpointManager(str(tmp_path), async_save=False) as m:
        assert m.save(1, _tree(pkg, 1.0)) is True
        assert m.save(1, _tree(pkg, 9.0)) is False
        np.testing.assert_array_equal(_w(m.restore(1)),
                                      _w(_tree("jax", 1.0)))
        assert m.save(1, _tree(pkg, 9.0), force=True) is True
        np.testing.assert_array_equal(_w(m.restore(1)),
                                      _w(_tree("jax", 9.0)))


@pytest.mark.parametrize("pkg", PKGS)
def test_close_does_not_reblock_after_flush_timeout(tmp_path, pkg):
    release = threading.Event()
    m = _ck(pkg).CheckpointManager(str(tmp_path), async_save=True)
    orig = m._dispatch_save

    def slow_dispatch(step, tree):
        release.wait(timeout=30.0)
        return orig(step, tree)

    m._dispatch_save = slow_dispatch
    try:
        m.save(1, _tree(pkg, 1.0))
        assert m.flush(_deadline(pkg, 0.2)) == "timeout"
        t0 = time.perf_counter()
        m.close()
        assert time.perf_counter() - t0 < 2.0
    finally:
        release.set()


def test_tmp_debris_of_either_package_is_swept(tmp_path):
    """An uncommitted tmp dir (a kill mid-write) is reclaimed at open,
    whichever package left it."""
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "4.orbax-checkpoint-tmp-123"))
    tckpt.CheckpointManager(d).close()
    assert os.listdir(d) == []
    with tckpt.CheckpointManager(d, async_save=False) as m:
        m.save(1, _tree("torch"))
    os.makedirs(os.path.join(d, f"2.{tckpt._TMP_TAG}-9-9"))
    jckpt.CheckpointManager(d).close()
    assert sorted(os.listdir(d)) == [".manifest-era", "1",
                                     "manifest-1.json"]


def test_verify_failure_dumps_flight_record(tmp_path):
    from paddle_tpu_torch.observability import flight
    rec = flight.FlightRecorder(str(tmp_path / "dumps")).install()
    try:
        with tckpt.CheckpointManager(str(tmp_path / "ck"),
                                     async_save=False) as m:
            m.save(1, _tree("torch", 1.0))
            m.save(2, _tree("torch", 2.0))
            key = _tamper_manifest(str(tmp_path / "ck"), 2)
            m.restore()
        dumps = glob.glob(str(tmp_path / "dumps" / "*ckpt_verify*"))
        assert len(dumps) == 1
        rows = [json.loads(line) for line in open(dumps[0])]
        extra = [r for r in rows if r.get("kind") == "extra"]
        assert extra and extra[0]["what"] == "checkpoint_verify_failure"
        assert extra[0]["step"] == 2 and key in extra[0]["digest_diff"]
    finally:
        rec.uninstall()


@pytest.mark.parametrize("site", ["ckpt.write", "ckpt.rename",
                                  "ckpt.snapshot", "ckpt.async_commit"])
def test_fault_sites_leave_the_directory_consistent(tmp_path, site):
    """An injected fault at each ``ckpt.*`` site: ``ckpt.write`` is
    retried and the step commits; the others fail the step, which is
    never surfaced; the previous step stands and the manager goes on."""
    from paddle_tpu_torch.reliability import faults
    m = tckpt.CheckpointManager(str(tmp_path), async_save=True)
    m.save(1, _tree("torch", 1.0))
    m.wait_until_finished()
    faults.reset()
    faults.enable(seed=3)
    faults.inject(site, nth=(1,), times=1)
    try:
        try:
            m.save(2, _tree("torch", 2.0))
            m.wait_until_finished()
        except faults.FaultInjected:
            pass
    finally:
        faults.reset()
    assert m.latest_step() == (2 if site == "ckpt.write" else 1)
    m.save(3, _tree("torch", 3.0))
    m.wait_until_finished()
    assert m.latest_step() == 3
    m.close()


# -- one-shot saves and AutoCheckpoint ---------------------------------------

def _net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 2))


def test_save_and_load_checkpoint(tmp_path):
    net = _net()
    opt = {"m": {"w": torch.ones(3)}, "t": 4}
    path = str(tmp_path / "one")
    tckpt.save_checkpoint(path, net, optimizer_state=opt, step=9,
                          extra={"note": np.arange(3)})
    other = _net()
    with torch.no_grad():
        for p in other.parameters():
            p.zero_()
    tree = tckpt.load_checkpoint(path, model=other)
    for a, b in zip(net.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert tree["step"].shape == () and int(tree["step"]) == 9
    assert tree["optimizer"]["t"] == 4
    np.testing.assert_array_equal(tree["extra"]["note"], np.arange(3))


def test_auto_checkpoint_for_model_resumes_epochs(tmp_path):
    """Two epochs committed, a fresh process-equivalent Model resumes at
    epoch 2 with the weights, moments and step counter of the first."""
    def build():
        net = _net()
        m = tpt.Model(net)
        m.prepare(tpt.optimizer.Adam(1e-2, parameters=net),
                  lambda out, y: ((out - y) ** 2).mean())
        return m

    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    y = torch.randn(8, 2, generator=torch.Generator().manual_seed(2))
    m = build()
    acp = tckpt.AutoCheckpoint.for_model(str(tmp_path), m)
    seen = []
    for epoch in acp.epochs(2):
        m.train_batch([x], [y])
        acp.commit(epoch)
        seen.append(epoch)
    assert seen == [0, 1]
    m2 = build()
    acp2 = tckpt.AutoCheckpoint.for_model(str(tmp_path), m2)
    assert list(acp2.epochs(4)) == [2, 3]
    assert m2._step_count == m._step_count == 2
    for a, b in zip(m.network.parameters(), m2.network.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(m2._opt_state["m"]["0.weight"],
                       m._opt_state["m"]["0.weight"])
    assert m2._opt_state["t"] == 2


# -- crypto ------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_crypto_blobs_cross(direction):
    key = bytes(range(32))
    data = np.random.RandomState(0).bytes(4099)
    enc, dec = (jcrypto, tcrypto) if direction == "jax_to_torch" \
        else (tcrypto, jcrypto)
    blob = enc.encrypt_bytes(data, key)
    assert dec.decrypt_bytes(blob, key) == data
    tampered = bytearray(blob)
    tampered[-1] ^= 1
    with pytest.raises(ValueError, match="authentication failed"):
        dec.decrypt_bytes(bytes(tampered), key)


def test_crypto_file_round_trip(tmp_path):
    path = str(tmp_path / "w.bin")
    open(path, "wb").write(b"weights" * 100)
    tcrypto.encrypt_file(path, b"k" * 16)
    assert tcrypto.is_encrypted(path) and jcrypto.is_encrypted(path)
    assert jcrypto.decrypt_file_bytes(path, b"k" * 16) == b"weights" * 100


# -- recompute and gradient merge --------------------------------------------

def _layers(pkg):
    nn = jpt.nn if pkg is jpt else tpt.nn
    return [nn.Linear(8, 16), None, nn.Linear(16, 16), None,
            nn.Linear(16, 4)]


class _JTanh(jpt.nn.Layer):
    def forward(self, x):
        return jnp.tanh(x)


class _TTanh(tpt.nn.Layer):
    def forward(self, x):
        return torch.tanh(x)


def _seq(pkg, segments):
    layers = [_JTanh() if (pkg is jpt and x is None) else
              _TTanh() if x is None else x for x in _layers(pkg)]
    return (JRecSeq if pkg is jpt else TRecSeq)(*layers, segments=segments)


def _data():
    rs = np.random.RandomState(4)
    return [(rs.randn(6, 8).astype(np.float32),
             rs.randn(6, 4).astype(np.float32)) for _ in range(3)]


def _mse(pkg):
    if pkg is jpt:
        return lambda out, y: jnp.mean((out - y) ** 2)
    return lambda out, y: ((out - y) ** 2).mean()


@functools.lru_cache(maxsize=None)
def _jax_recompute_run(segments, merge):
    jpt.seed(0)
    net = _seq(jpt, segments)
    init = {k: np.asarray(v) for k, v in net.state_dict().items()}
    opt = jpt.optimizer.Adam(1e-2, parameters=net)
    if merge:
        opt = JGradientMerge(opt, k_steps=2)
    m = jpt.Model(net)
    m.prepare(opt, _mse(jpt))
    losses = [float(np.asarray(m.train_batch([x], [y])["loss"]))
              for x, y in _data()]
    m.sync_weights()
    final = {k: np.asarray(v) for k, v in net.state_dict().items()}
    return init, losses, final


def _port_run(segments, merge, init, plain=False):
    net = _seq(tpt, segments)
    load_reference_state(net, init)
    if plain:   # the same layers without recomputation
        net.forward = lambda x, body=net.body: body(x)
    opt = tpt.optimizer.Adam(1e-2, parameters=net)
    if merge:
        opt = TGradientMerge(opt, k_steps=2)
    m = tpt.Model(net)
    m.prepare(opt, _mse(tpt))
    losses = [float(m.train_batch([x], [y])["loss"]) for x, y in _data()]
    final = {k: v.detach().numpy().copy()
             for k, v in net.state_dict().items()}
    return losses, final, m


@pytest.mark.parametrize("segments,merge", [(1, False), (2, False),
                                            (3, True)],
                         ids=["seg1", "seg2", "seg3_merge2"])
def test_recompute_matches_jax(segments, merge):
    init, losses, final = _jax_recompute_run(segments, merge)
    got, got_final, m = _port_run(segments, merge, init)
    np.testing.assert_allclose(got, losses, rtol=RTOL)
    for k, v in final.items():
        np.testing.assert_allclose(got_final[k], v, rtol=RTOL, atol=1e-6)
    plain, plain_final, _ = _port_run(segments, merge, init, plain=True)
    assert got == plain
    for k in final:
        np.testing.assert_array_equal(got_final[k], plain_final[k])
    if merge:
        # 3 calls at k_steps 2: one merged step, one gradient waiting
        assert m._opt_state["count"] == 1
        assert m._opt_state["inner"]["t"] == 1


def test_recompute_function_replays_dropout_keys():
    """``recompute`` of a dropout function: the backward's recompute
    draws the forward's masks, so gradients equal the plain call's."""
    x = torch.randn(4, 16, requires_grad=True)

    def fn(v):
        return tpt.nn.functional.dropout(v, 0.5, training=True) * 3.0

    grads = []
    for wrap in (False, True):
        x.grad = None
        with tpt.core.rng.key_guard(torch.tensor([0, 7])):
            y = trecompute(fn, x) if wrap else fn(x)
        y.sum().backward()
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])
