"""The port's key-sharded host table (``ShardedHostEmbedding``) on gloo
CPU ranks (``tests/torch_ctr_workers.py``) against one process's
``HostOffloadedEmbedding`` of the port and against the JAX package's
tables (``tests/test_sharded_embedding.py``'s counterparts).

dp rank d of W owns the ids with ``id % W == d``. The rows each rank
pulls equal one process's table bit for bit (the lazy init is a hash of
(seed, id, column) in both packages, and each row has one owner, so the
sum that routes it adds zeros), and the JAX package's pooled lookup
within 1e-6 (the pooling sums in another order). After one backward of
``sum`` (sgd, lr 1) the owners' rows equal one process's push bit for
bit: each update is applied once. Shard files re-key at another world
size."""

import functools
import glob
import os

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from paddle_tpu import parallel as jpar  # noqa: E402
from paddle_tpu.nn.layers import host_embedding as jhe  # noqa: E402
from paddle_tpu.nn.layers import sharded_embedding as jse  # noqa: E402
from paddle_tpu_torch import parallel as tpar  # noqa: E402
from paddle_tpu_torch.nn import (HostOffloadedEmbedding,  # noqa: E402
                                 ShardedHostEmbedding)
import torch_ctr_workers as CW  # noqa: E402
import torch_dist_workers as W  # noqa: E402

TOL = 1e-6
WORLDS = (2, 4)


def _ids():
    return np.random.RandomState(0).randint(1, 100_000, (16, 4))


def _pad_ids():
    return np.array([[5, 0, 9, 0], [3, 3, 0, 0],
                     [0, 0, 0, 0], [7, 1, 2, 4]] * 2)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    handles = {w: W.start_ranks(
        "sharded", w, tmp_path_factory.mktemp(f"sharded{w}"),
        {"ids": _ids().tolist(), "pad_ids": _pad_ids().tolist()},
        script=CW.__file__) for w in WORLDS}
    _jax_rows()   # the JAX side while the ranks run
    return {w: W.collect(h) for w, h in handles.items()}


@functools.lru_cache(maxsize=None)
def _jax_rows():
    """The JAX package's unsharded lookup of the ids and its dp=8
    sharded table's, and the unsharded rows after one push of ones."""
    ids = _ids()
    un = jhe.HostOffloadedEmbedding(100_000, 8, seed=5, optimizer="sgd",
                                    learning_rate=1.0, padding_idx=None)
    ref = np.asarray(un(ids))
    mesh = jpar.init_mesh(dp=8)
    try:
        sh = jse.ShardedHostEmbedding(100_000, 8, seed=5, optimizer="sgd",
                                      learning_rate=1.0, padding_idx=None)
        sharded = np.asarray(sh(jnp.asarray(ids)))
    finally:
        jpar.set_mesh(None)
    flat = np.unique(ids.reshape(-1))
    un._push(ids.reshape(-1), np.ones((ids.size, 8), np.float32))
    return ref, sharded, flat, un._pull(flat).copy()


def _one_process():
    un = HostOffloadedEmbedding(100_000, 8, seed=5, optimizer="sgd",
                                learning_rate=1.0, padding_idx=None)
    return un


@pytest.mark.parametrize("world", WORLDS)
def test_pulled_rows_equal_one_process_and_jax(jobs, world):
    ids = _ids()
    got = np.concatenate([r["pulled"] for r in jobs[world]])
    un = _one_process()
    np.testing.assert_array_equal(got, un(ids).detach().numpy())
    ref, sharded, _, _ = _jax_rows()
    np.testing.assert_allclose(sharded, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_push_applies_each_update_once_at_its_owner(jobs, world):
    ids = _ids()
    un = _one_process()
    flat = np.unique(ids.reshape(-1))
    un._pull(flat)
    un._push(ids.reshape(-1), np.ones((ids.size, 8), np.float32))
    _, _, jflat, jafter = _jax_rows()
    np.testing.assert_array_equal(jflat, flat)
    seen = []
    for r in jobs[world]:
        np.testing.assert_array_equal(r["owned_after_push"],
                                      un._pull(r["owned_ids"]))
        pos = np.searchsorted(flat, r["owned_ids"])
        np.testing.assert_allclose(r["owned_after_push"], jafter[pos],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["anchor_grad"], [0.0])
        # a rank stores only its share of the table
        assert r["touched_local"] == len(r["owned_ids"])
        seen.append(r["owned_ids"])
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)), flat)


@pytest.mark.parametrize("world", WORLDS)
def test_padding_and_combiners_match_unsharded(jobs, world):
    pads = _pad_ids()
    for combiner in ("sum", "mean", "sqrtn"):
        got = np.concatenate([r["combiners"][combiner]
                              for r in jobs[world]])
        un = HostOffloadedEmbedding(1000, 4, seed=2, combiner=combiner)
        np.testing.assert_allclose(got, un(pads).detach().numpy(),
                                   rtol=TOL, err_msg=combiner)
        jun = jhe.HostOffloadedEmbedding(1000, 4, seed=2,
                                         combiner=combiner)
        np.testing.assert_allclose(got, np.asarray(jun(pads)), rtol=TOL,
                                   atol=TOL, err_msg=combiner)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_over_spill_dir_equals_ram(jobs, world):
    for r in jobs[world]:
        (ram1, ram2), (sp1, sp2) = r["spill"]["ram"], r["spill"]["spill"]
        np.testing.assert_array_equal(sp1, ram1)
        np.testing.assert_array_equal(sp2, ram2)
        assert not np.allclose(sp1, sp2)   # the push updated the rows
        assert any("pool_vals" in f for f in r["spill_files"])


@pytest.mark.parametrize("world", WORLDS)
def test_host_budget_refuses_an_overfull_shard(jobs, world):
    for r in jobs[world]:
        assert "budget 4" in r["budget"]


@pytest.mark.parametrize("world", WORLDS)
def test_shards_restore_rekeyed_at_another_world_size(jobs, world):
    paths = [r["shard"] for r in jobs[world]]
    assert [os.path.basename(p) for p in paths] == [
        f"table.shard{r}of{world}.npz" for r in range(world)]
    ids = _ids()
    flat = np.unique(ids.reshape(-1))
    un = _one_process()
    un._pull(flat)
    un._push(ids.reshape(-1), np.ones((ids.size, 8), np.float32))
    # one process: every row, whichever rank held it
    one = ShardedHostEmbedding(100_000, 8, seed=5, padding_idx=None)
    one.restore_shards(paths)
    assert one.touched_rows_local == len(flat)
    np.testing.assert_array_equal(one._local._pull(flat), un._pull(flat))
    # rank 0 of a dp=3 mesh: the ids = 0 mod 3
    three = ShardedHostEmbedding(100_000, 8, seed=5, padding_idx=None)
    three.restore_shards(paths, mesh=tpar.DeviceMesh(devices=3, dp=3))
    assert three.touched_rows_local == int((flat % 3 == 0).sum())
    # the JAX package's table reads the port's shard files
    jt = jse.ShardedHostEmbedding(100_000, 8, seed=5, padding_idx=None)
    jpar.set_mesh(None)
    jt.restore_shards(paths)
    np.testing.assert_array_equal(jt._local._pull(flat), un._pull(flat))


def test_shard_files_refuse_a_mismatched_table(tmp_path):
    sh = ShardedHostEmbedding(10_000, 4, seed=1)
    sh(np.arange(1, 65).reshape(8, 8))
    assert sh.touched_rows_local == 64
    path = sh.snapshot_shard(str(tmp_path / "t"))
    assert path.endswith(".shard0of1.npz")
    with pytest.raises(ValueError, match="shape mismatch"):
        ShardedHostEmbedding(99, 4).restore_shards([path])
    with pytest.raises(ValueError, match="fold scheme"):
        ShardedHostEmbedding(10_000, 4, hash_ids=True).restore_shards(
            [path])
    assert glob.glob(str(tmp_path / "t.shard*")) == [path]


def test_no_live_axis_runs_the_local_table():
    tpar.set_mesh(None)
    sh = ShardedHostEmbedding(1000, 4, seed=3)
    un = HostOffloadedEmbedding(1000, 4, seed=3)
    ids = np.array([[1, 2, 3, 0]])
    np.testing.assert_array_equal(sh(ids).detach().numpy(),
                                  un(ids).detach().numpy())
    jun = jhe.HostOffloadedEmbedding(1000, 4, seed=3)
    np.testing.assert_allclose(sh(ids).detach().numpy(),
                               np.asarray(jun(ids)), rtol=TOL)
