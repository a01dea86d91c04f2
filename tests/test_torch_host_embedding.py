"""The port's host-RAM table (``HostOffloadedEmbedding``) and its native
accessor against the JAX package's (``tests/test_host_embedding.py``'s
counterparts).

Rows initialize lazily from a hash of (seed, id, column) in both
packages, so the same ids pull the same rows bit for bit. The push
(the lookup's backward) merges duplicate ids and applies the per-row
rule: the rows after a step equal the JAX package's within 1e-6
relative (the same float32 formulas; the pooled gradients sum in
another order). The native accessor is held to its numpy twin within
1e-6, and a failed build raises. A lookup's tensors are O(batch),
whatever the table's size. ``.npz`` snapshots cross both ways."""

import numpy as np
import pytest
import torch
from torch_gc_barrier import collect_cycles  # noqa: F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import paddle_tpu as jpt  # noqa: E402
from paddle_tpu.nn.layer import functional_call, split_state  # noqa: E402
from paddle_tpu.nn.layers import host_embedding as jhe  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.nn.layers import host_embedding as the  # noqa: E402
from paddle_tpu_torch.nn.layers import native_accessor as na  # noqa: E402

HostOffloadedEmbedding = the.HostOffloadedEmbedding
TOL = 1e-6


def test_lookup_rows_equal_jax_and_lazy_init_order_free():
    a = HostOffloadedEmbedding(1000, 8, seed=7)
    b = HostOffloadedEmbedding(1000, 8, seed=7)
    ids1 = np.array([[5, 9], [3, 5]])
    ids2 = np.array([[3, 9], [5, 3]])
    out_a = a(ids1).detach().numpy()      # a touches 5, 9, 3 in order
    b(ids2)                               # b touches 3, 9, 5 first
    np.testing.assert_array_equal(out_a, b(ids1).detach().numpy())
    assert a.touched_rows == 3
    j = jhe.HostOffloadedEmbedding(1000, 8, seed=7)
    probe = np.array([3, 5, 9, 123456 % 1000])
    np.testing.assert_array_equal(a._pull(probe), j._pull(probe))
    np.testing.assert_allclose(out_a, np.asarray(j(ids1)), rtol=TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_backward_pushes_the_rule_like_jax(optimizer):
    """The gradient of a loss reaches the host table through the
    lookup's backward (the anchor's gradient is zero) and steps each
    touched row by the rule, as the JAX package's custom VJP does."""
    ids = np.array([[1, 2, 2, 0], [7, 1, 0, 0]])
    w = np.random.RandomState(0).randn(4).astype(np.float32)
    kw = dict(optimizer=optimizer, learning_rate=0.5, seed=1)
    t = HostOffloadedEmbedding(100, 4, **kw)
    out = t(ids)
    (out * torch.from_numpy(w)).sum().backward()
    assert t.push_anchor.grad is not None
    np.testing.assert_array_equal(t.push_anchor.grad.numpy(), [0.0])

    j = jhe.HostOffloadedEmbedding(100, 4, **kw)
    params, _ = split_state(j)

    def loss(p):
        o, _ = functional_call(j, p, {}, jnp.asarray(ids))
        return (o * jnp.asarray(w)).sum()
    g = jax.grad(loss)(params)
    jax.effects_barrier()
    np.testing.assert_array_equal(np.asarray(g["push_anchor"]), [0.0])
    probe = np.array([0, 1, 2, 7])
    np.testing.assert_allclose(t._pull(probe), j._pull(probe), rtol=TOL,
                               atol=TOL)
    # padding row 0 never trains
    fresh = HostOffloadedEmbedding(100, 4, **kw)
    np.testing.assert_array_equal(t._pull(np.array([0])),
                                  fresh._pull(np.array([0])))


def test_adagrad_rule_and_duplicate_merge():
    e = HostOffloadedEmbedding(100, 2, optimizer="adagrad",
                               learning_rate=0.1, initial_accumulator=0.1,
                               padding_idx=None)
    ids = np.array([3, 3, 4])
    before = e._pull(ids).copy()
    g = np.array([[1.0, 2.0], [1.0, 2.0], [0.5, 0.5]], np.float32)
    e._push(ids, g)
    merged = np.array([[2.0, 4.0], [0.5, 0.5]], np.float32)
    acc = 0.1 + merged ** 2
    want = before[[0, 2]] - 0.1 * merged / np.sqrt(acc)
    np.testing.assert_allclose(e._pull(np.array([3, 4])), want, rtol=1e-6)
    np.testing.assert_allclose(e._accum[3], acc[0], rtol=1e-6)
    j = jhe.HostOffloadedEmbedding(100, 2, optimizer="adagrad",
                                   learning_rate=0.1, padding_idx=None)
    j._pull(ids)
    j._push(ids, g)
    np.testing.assert_allclose(e._pull(np.array([3, 4])),
                               j._pull(np.array([3, 4])), rtol=TOL)


def _max_numel_of_step(n_table):
    """The largest tensor a train step of a host-table lookup and a
    linear head creates (every op's outputs, forward and backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Biggest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Biggest.most = max(Biggest.most, t.numel())
            return out
    e = HostOffloadedEmbedding(n_table, 16)
    fc = pt.nn.Linear(16, 1)
    ids = np.random.RandomState(0).randint(1, n_table, (8, 4))
    with Biggest():
        fc(e(ids)).sum().backward()
    return Biggest.most


def test_step_tensors_independent_of_table_size():
    """The table never becomes a tensor: a step's largest tensor is the
    same at 10^4 and 5 x 10^7 rows (the JAX package's invariant on its
    compiled step's memory)."""
    small, huge = _max_numel_of_step(10_000), _max_numel_of_step(50_000_000)
    assert small == huge <= 8 * 4 * 16


def test_widedeep_style_training_matches_jax_and_snapshot_roundtrip(
        tmp_path):
    """A host table and a dense tower trained by ``Model.train_batch``
    in both packages from the same weights: losses within 1e-5
    relative; the table trained; snapshot / restore lossless."""
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1_000_000, (64, 4))
    dense = rng.randn(64, 8).astype(np.float32)
    y = ((ids.sum(1, keepdims=True) % 7) > 3).astype(np.float32)

    def build(nn, cat):
        class WideDeep(nn.Layer):
            def __init__(self):
                super().__init__()
                self.sparse = nn.HostOffloadedEmbedding(
                    1_000_000, 8, optimizer="adagrad", learning_rate=0.1,
                    hash_ids=True)
                self.deep = nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                          nn.Linear(16, 1))

            def forward(self, ids, dense):
                return self.deep(dense) + self.sparse(ids).sum(
                    -1, keepdims=True) if cat == "jax" else \
                    self.deep(dense) + self.sparse(ids).sum(-1, keepdim=True)
        return WideDeep()
    jpt.seed(0)
    jnet = build(jpt.nn, "jax")
    tnet = build(pt.nn, "torch")
    from paddle_tpu_torch.interop import load_reference_state
    load_reference_state(tnet, {k: np.asarray(v) for k, v in
                                jnet.state_dict().items()})
    losses = {}
    for name, pkg, net in (("jax", jpt, jnet), ("torch", pt, tnet)):
        m = pkg.Model(net)
        m.prepare(optimizer=pkg.optimizer.Adam(
            learning_rate=5e-3, parameters=net),
            loss=pkg.nn.BCEWithLogitsLoss())
        losses[name] = [float(m.train_batch(
            [ids, dense] if name == "jax" else
            [torch.from_numpy(ids), torch.from_numpy(dense)],
            [y if name == "jax" else torch.from_numpy(y)])["loss"])
            for _ in range(10)]
    jax.effects_barrier()
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][-1] < losses["torch"][0]
    table = tnet.sparse
    folded = table._fold_ids(torch.from_numpy(ids[:4])).numpy()
    np.testing.assert_allclose(table._pull(folded),
                               jnet.sparse._pull(folded), rtol=1e-5,
                               atol=1e-7)
    snap = str(tmp_path / "table.npz")
    table.snapshot(snap)
    fresh = HostOffloadedEmbedding(1_000_000, 8, optimizer="adagrad",
                                   learning_rate=0.1, hash_ids=True)
    fresh.restore(snap)
    np.testing.assert_array_equal(fresh._pull(folded), table._pull(folded))
    with pytest.raises(ValueError, match="snapshot shape"):
        HostOffloadedEmbedding(999, 8).restore(snap)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshots_cross_between_the_packages(tmp_path, direction):
    ids = np.array([5, 17, 999, 5, 123])
    g = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    kw = dict(optimizer="adagrad", learning_rate=0.1, seed=3,
              hash_ids=True)
    src = (jhe if direction == "jax_to_port" else the) \
        .HostOffloadedEmbedding(10_000, 4, **kw)
    dst = (the if direction == "jax_to_port" else jhe) \
        .HostOffloadedEmbedding(10_000, 4, **kw)
    src._pull(ids)
    src._push(ids, g)
    path = str(tmp_path / "snap.npz")
    src.snapshot(path)
    dst.restore(path)
    np.testing.assert_array_equal(dst._pull(ids), src._pull(ids))
    assert dict(dst._accum.items()).keys() == dict(src._accum.items()).keys()
    for k, v in src._accum.items():
        np.testing.assert_array_equal(dst._accum[k], v)


def test_pool_index_survives_merges_and_growth():
    a = HostOffloadedEmbedding(10_000_000, 8, seed=3, padding_idx=None,
                               optimizer="sgd", learning_rate=1.0)
    rng = np.random.RandomState(7)
    seen = []
    for _ in range(12):                    # crosses the 1024 merge gate
        ids = rng.randint(1, 10_000_000, (64, 8))
        seen.append(ids)
        a._pull(ids)
    probe = np.concatenate([s.reshape(-1) for s in seen])[::17]
    b = jhe.HostOffloadedEmbedding(10_000_000, 8, seed=3, padding_idx=None)
    np.testing.assert_array_equal(a._pull(probe), b._pull(probe))
    dup_ids = np.full((32,), int(probe[0]), np.int64)
    before = a._pull(probe[:1])[0].copy()
    a._push(dup_ids, np.ones((32, 8), np.float32))
    np.testing.assert_allclose(a._pull(probe[:1])[0], before - 32.0,
                               rtol=1e-6)
    assert a._pool_acc is None and len(a._accum) == 0


def test_async_push_and_prefetch_bounded_staleness(tmp_path):
    e = HostOffloadedEmbedding(1000, 4, optimizer="sgd",
                               learning_rate=1.0, padding_idx=None,
                               async_push=True)
    ids = np.array([[1, 2]])
    before = e._pull(ids).copy()
    e.prefetch(ids)
    for slot in e._prefetched.values():   # the gather completes first
        slot["ev"].wait(timeout=30)
    e._push(ids, np.ones((2, 4), np.float32))
    e.flush()
    np.testing.assert_allclose(e._pull(ids), before, rtol=1e-6)   # stale
    np.testing.assert_allclose(e._pull(ids), before - 1.0, rtol=1e-6)
    e._push(ids, np.ones((2, 4), np.float32))
    e.snapshot(str(tmp_path / "t.npz"))   # flushes first
    z = np.load(str(tmp_path / "t.npz"))
    got = dict(zip(z["ids"].tolist(), z["values"]))
    np.testing.assert_allclose(got[1], before[0, 0] - 2.0, rtol=1e-6)


def test_geo_merge_averages_held_rows(tmp_path):
    a = HostOffloadedEmbedding(100, 2, seed=1)
    b = jhe.HostOffloadedEmbedding(100, 2, seed=2)
    a._rows = {1: np.array([1.0, 1.0], np.float32),
               2: np.array([2.0, 2.0], np.float32)}
    b._rows = {1: np.array([3.0, 3.0], np.float32),
               5: np.array([5.0, 5.0], np.float32)}
    b._accum = {1: np.array([0.5, 0.5], np.float32)}
    snap = str(tmp_path / "b.npz")
    b.snapshot(snap)                      # a JAX peer's snapshot
    a.geo_merge(snap)
    np.testing.assert_allclose(a._rows[1], [2.0, 2.0])
    np.testing.assert_allclose(a._rows[2], [2.0, 2.0])
    np.testing.assert_allclose(a._rows[5], [5.0, 5.0])
    np.testing.assert_allclose(a._accum[1], [0.5, 0.5])
    with pytest.raises(ValueError, match="mismatch"):
        HostOffloadedEmbedding(99, 2).geo_merge(snap)


def test_spill_dir_parity_files_and_snapshot(tmp_path):
    import os
    ids = np.asarray([3, 9, 500_001, 0, 77, 77, 12, 0])
    grads = np.random.RandomState(0).randn(8, 8).astype(np.float32)

    def run(spill):
        emb = HostOffloadedEmbedding(
            1_000_000, 8, optimizer="adagrad", learning_rate=0.1, seed=7,
            spill_dir=str(tmp_path / "spill") if spill else None)
        outs = []
        for _ in range(3):
            outs.append(emb._pull(ids).copy())
            emb._apply_push(ids, grads)
        return emb, np.stack(outs)
    emb_ram, ram = run(False)
    emb_spill, spill = run(True)
    np.testing.assert_array_equal(ram, spill)
    assert isinstance(emb_spill._pool_vals, np.memmap)
    assert isinstance(emb_spill._pool_acc, np.memmap)
    assert not isinstance(emb_ram._pool_vals, np.memmap)
    files = os.listdir(tmp_path / "spill")
    assert sum("pool_vals" in f for f in files) == 1, files
    assert sum("pool_acc" in f for f in files) == 1, files
    emb_spill.snapshot(str(tmp_path / "snap.npz"))
    again = HostOffloadedEmbedding(1_000_000, 8, optimizer="adagrad",
                                   learning_rate=0.1, seed=7,
                                   spill_dir=str(tmp_path / "s2"))
    again.restore(str(tmp_path / "snap.npz"))
    np.testing.assert_array_equal(again._pull(ids), emb_spill._pull(ids))
    assert isinstance(again._pool_vals, np.memmap)


def test_spill_dir_shared_and_dead_files_reaped(tmp_path):
    import os
    d = tmp_path / "shared"
    a = HostOffloadedEmbedding(10_000, 4, seed=1, spill_dir=str(d))
    b = HostOffloadedEmbedding(10_000, 4, seed=2, spill_dir=str(d))
    ids = np.arange(1, 300)   # grows both pools
    va1, vb1 = a._pull(ids).copy(), b._pull(ids).copy()
    np.testing.assert_array_equal(b._pull(ids), vb1)
    np.testing.assert_array_equal(a._pull(ids), va1)
    assert not np.allclose(va1, vb1)
    r = tmp_path / "reap"
    r.mkdir()
    dead = r / "pool_vals.p999999.i1.gen3.f32"
    live = r / f"pool_vals.p{os.getpid()}.i0.gen1.f32"
    other = r / "unrelated.bin"
    for f in (dead, live, other):
        f.write_bytes(b"x" * 16)
    HostOffloadedEmbedding(100, 4, spill_dir=str(r))
    assert not dead.exists()
    assert live.exists() and other.exists()


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_native_accessor_equals_its_numpy_twin(monkeypatch, optimizer):
    """The fused C++ push and the numpy rule give the same table, skip
    padding and never-pulled rows, and count which rule ran."""
    def run(native):
        if native:
            monkeypatch.delenv("PT_NATIVE_ACCESSOR", raising=False)
        else:
            monkeypatch.setenv("PT_NATIVE_ACCESSOR", "0")
        before = dict(na.counts)
        e = HostOffloadedEmbedding(100_000, 8, optimizer=optimizer,
                                   learning_rate=0.1, hash_ids=True,
                                   seed=11)
        rng = np.random.RandomState(2)
        ids = rng.randint(1, 100_000, (32, 4)).astype(np.int64)
        folded = e._fold_ids(torch.from_numpy(ids)).numpy()
        e._pull(folded)
        g = rng.randn(32 * 4, 8).astype(np.float32)
        for _ in range(4):
            e._push(folded, g)
        e._push(np.full((4, 1), 77777, np.int64),
                np.ones((4, 8), np.float32))
        ran = {k: na.counts[k] - before[k] for k in before}
        assert ran == ({"native": 5, "numpy": 0} if native
                       else {"native": 0, "numpy": 5}), ran
        return e._pull(folded)
    np.testing.assert_allclose(run(True), run(False), rtol=1e-6,
                               atol=1e-7)


def test_native_accessor_build_failure_raises(monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile raises where the
    rule is selected."""
    bad = tmp_path / "broken_accessor.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.delenv("PT_NATIVE_ACCESSOR", raising=False)
    monkeypatch.setattr(na, "SOURCE", str(bad))
    monkeypatch.setattr(na, "_LIB", None)
    from paddle_tpu_torch.core import native_build
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken_accessor.cc failed"):
        na.available()
    e = HostOffloadedEmbedding(100, 4, optimizer="sgd", padding_idx=None)
    e._pull(np.array([1]))
    with pytest.raises(RuntimeError):
        e._push(np.array([1]), np.ones((1, 4), np.float32))
    monkeypatch.setenv("PT_NATIVE_ACCESSOR", "0")
    assert not na.available()
