"""The port's parameter-server datasets and tree index
(``paddle_tpu_torch/distributed/{dataset,index_dataset}.py``) against
the JAX package's: ``QueueDataset`` / ``InMemoryDataset`` over MultiSlot
files written to ``tmp_path`` give equal batches (values, dtypes,
padding) and, from the same seed, the same shuffled order; their
batches feed ``train_batch`` and ``fit`` in both packages to equal
losses (1e-5 relative: float32, summation order only); the admission
entries render the same attrs. ``TreeIndex`` and ``LayerwiseSampler``
as in tests/test_tree_index.py's six cases, the samples equal element
for element."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu.distributed import dataset as jds  # noqa: E402
from paddle_tpu.distributed import index_dataset as jidx  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import dataset as tds  # noqa: E402
from paddle_tpu_torch.distributed import index_dataset as tidx  # noqa

SLOTS = ["feat", "ids", "label"]


def _write_files(tmp_path, n_files=2, rows=11, seed=0):
    """MultiSlot lines: 4 float features, 1-3 int ids, one int label."""
    rs = np.random.RandomState(seed)
    paths = []
    for f in range(n_files):
        lines = []
        for _ in range(rows):
            feat = " ".join(f"{v:.4f}" for v in rs.randn(4))
            k = rs.randint(1, 4)
            ids = " ".join(str(v) for v in rs.randint(0, 50, k))
            lines.append(f"4 {feat} {k} {ids} 1 {rs.randint(0, 2)}")
        p = tmp_path / f"part-{f}.txt"
        p.write_text("\n".join(lines) + "\n\n")
        paths.append(str(p))
    return paths


def _both(kind, paths, batch_size=4):
    out = []
    for mod in (jds, tds):
        ds = getattr(mod, kind)()
        ds.init(batch_size=batch_size, use_var=SLOTS)
        ds.set_filelist(paths)
        out.append(ds)
    return out


def _same_batches(a, b, n_slots=len(SLOTS)):
    ba, bb = list(a), list(b)
    assert len(ba) == len(bb) > 0
    for x, y in zip(ba, bb):
        assert len(x) == len(y) == n_slots
        for u, v in zip(x, y):
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)
    return bb


@pytest.mark.parametrize("batch_size", [1, 4, 7])
def test_queue_dataset_batches_match_jax(tmp_path, batch_size):
    j, t = _both("QueueDataset", _write_files(tmp_path), batch_size)
    batches = _same_batches(j, t)
    assert sum(b[0].shape[0] for b in batches) == 22
    assert batches[0][1].shape[1] == max(
        (b[1] != 0).sum(1).max() for b in batches[:1])


@pytest.mark.parametrize("seed", [None, 0, 17])
def test_in_memory_shuffle_order_matches_jax(tmp_path, seed):
    j, t = _both("InMemoryDataset", _write_files(tmp_path))
    for ds in (j, t):
        ds.load_into_memory()
    assert t.get_memory_data_size() == j.get_memory_data_size() == 22
    _same_batches(j, t)
    if seed is None:
        j.global_shuffle()
        t.global_shuffle()
    else:
        j.local_shuffle(seed)
        t.local_shuffle(seed)
    _same_batches(j, t)
    t.release_memory()
    assert t.get_memory_data_size() == 0
    with pytest.raises(RuntimeError, match="load_into_memory"):
        t.local_shuffle(0)


def test_parse_fn_and_errors_match_jax(tmp_path):
    paths = _write_files(tmp_path, 1, 5)
    j, t = _both("QueueDataset", paths)
    for ds in (j, t):
        ds.set_parse_fn(lambda line: [[len(line)], [line.count(" ")]])
    _same_batches(j, t, 2)
    bad = tmp_path / "bad.txt"
    bad.write_text("2 1 2 3\n")
    for mod in (jds, tds):
        ds = mod.QueueDataset()
        ds.init(batch_size=2, use_var=["a"])
        ds.set_filelist([str(bad)])
        with pytest.raises(ValueError, match="trailing"):
            list(ds)


def test_entries_match_jax():
    for name, args in [("CountFilterEntry", (3,)),
                       ("ProbabilityEntry", (0.25,)),
                       ("ShowClickEntry", ("show", "click"))]:
        assert getattr(tds, name)(*args)._to_attr() == \
            getattr(jds, name)(*args)._to_attr()
        assert getattr(tdist, name) is getattr(tds, name)
    with pytest.raises(ValueError):
        tds.CountFilterEntry(-1)
    with pytest.raises(ValueError):
        tds.ProbabilityEntry(1.5)


def _net(nn_):
    class Net(nn_.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn_.Embedding(50, 4)
            self.fc = nn_.Linear(8, 2)

        def forward(self, feat, ids):
            pooled = self.emb(ids).sum(1)
            return self.fc(nn_.functional.relu(
                _cat(nn_, feat.astype("float32") if nn_ is jpt.nn else
                     feat.float(), pooled)))
    return Net()


def _cat(nn_, a, b):
    if nn_ is jpt.nn:
        import jax.numpy as jnp
        return jnp.concatenate([a, b], -1)
    return torch.cat([a, b], -1)


def _models():
    jnet, tnet = _net(jpt.nn), _net(tpt.nn)
    state = {k: np.asarray(v) for k, v in jnet.state_dict().items()}
    from paddle_tpu_torch.interop import load_reference_state
    load_reference_state(tnet, state)
    jm, tm = jpt.Model(jnet), tpt.Model(tnet)
    jm.prepare(jpt.optimizer.SGD(0.1, parameters=jnet),
               jpt.nn.CrossEntropyLoss())
    tm.prepare(tpt.optimizer.SGD(0.1, parameters=tnet),
               tpt.nn.CrossEntropyLoss())
    return jm, tm


@pytest.mark.parametrize("kind", ["QueueDataset", "InMemoryDataset"])
def test_batches_feed_train_batch_and_fit(tmp_path, kind):
    """Each batch ``[feat, ids, label]`` feeds ``train_batch`` as it is
    (the label column squeezed), and the records feed ``fit`` through an
    IterableDataset, in both packages."""
    j, t = _both(kind, _write_files(tmp_path), batch_size=4)
    if kind == "InMemoryDataset":
        for ds in (j, t):
            ds.load_into_memory()
            ds.local_shuffle(3)
    jm, tm = _models()
    losses = [[], []]
    for i, (m, ds) in enumerate(((jm, j), (tm, t))):
        for feat, ids, label in ds:
            losses[i].append(float(m.train_batch(
                [feat, ids], [label[:, 0]])["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)

    fits = [[], []]
    for i, (pkg, m, ds) in enumerate(((jpt, jm, j), (tpt, tm, t))):
        class Records(pkg.io.IterableDataset):
            def __iter__(self):
                for feat, ids, label in ds:
                    for r in range(feat.shape[0]):
                        yield feat[r], ids[r, :1], label[r, 0]

        class Record(pkg.callbacks.Callback):
            def on_train_batch_end(self, step, logs=None, out=fits[i]):
                out.append(float(logs["loss"]))
        m.fit(Records(), batch_size=4, epochs=1, shuffle=False, verbose=0,
              callbacks=[Record()])
    assert len(fits[1]) == len(fits[0]) == 6
    np.testing.assert_allclose(fits[1], fits[0], rtol=1e-5)


# -- TreeIndex / LayerwiseSampler (tests/test_tree_index.py's cases) --------

def _trees(*args, **kw):
    return jidx.TreeIndex.from_items(*args, **kw), \
        tidx.TreeIndex.from_items(*args, **kw)


def test_tree_structure_and_codes_match_jax():
    items = list(range(100, 110))
    j, t = _trees("t", items, branch=2)
    assert (t.branch(), t.height(), t.emb_size(), t.total_node_nums()) == \
        (j.branch(), j.height(), j.emb_size(), j.total_node_nums()) == \
        (2, 5, t.emb_size(), t.total_node_nums())
    assert [(n.id(), n.code(), n.is_leaf()) for n in t.get_all_leafs()] \
        == [(n.id(), n.code(), n.is_leaf()) for n in j.get_all_leafs()]
    for item in items:
        path = t.get_travel_codes(item)
        assert path == j.get_travel_codes(item) and path[-1] == 0
        assert t.get_travel_codes(item, 2) == j.get_travel_codes(item, 2)
        assert t.get_travel_path(path[0], path[2]) == \
            j.get_travel_path(path[0], path[2]) == [path[0], path[1]]
    for lv in range(t.height()):
        np.testing.assert_array_equal(t.get_layer_codes(lv),
                                      j.get_layer_codes(lv))
        assert t.get_ancestor_codes(items, lv) == \
            j.get_ancestor_codes(items, lv)
        assert sorted(t.get_children_codes(0, lv)) == \
            sorted(j.get_children_codes(0, lv))
    assert t.get_pi_relation(items[:3], 1) == j.get_pi_relation(items[:3],
                                                                 1)
    codes = t.get_layer_codes(3)
    assert [(n.id(), n.code(), n.is_leaf()) for n in t.get_nodes(codes)] \
        == [(n.id(), n.code(), n.is_leaf()) for n in j.get_nodes(codes)]


def test_tree_save_load_round_trip_crosses_packages(tmp_path):
    j, t = _trees("t", [5, 7, 9, 11], branch=3)
    pj, pt_ = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j.save(pj)
    t.save(pt_)
    for p in (pj, pt_):
        t2 = tidx.TreeIndex("t2", p)
        assert t2.height() == j.height()
        assert [n.id() for n in t2.get_all_leafs()] == [5, 7, 9, 11]
        assert t2.get_travel_codes(9) == j.get_travel_codes(9)
    assert jidx.TreeIndex("j2", pt_).get_travel_codes(11) == \
        t.get_travel_codes(11)


def test_embedding_tree_matches_jax():
    rs = np.random.RandomState(0)
    embs = np.concatenate([rs.randn(8, 4) * 0.1 + 5.0,
                           rs.randn(8, 4) * 0.1 - 5.0, rs.randn(5, 4)])
    for n, branch in ((21, 3), (16, 2)):
        ids = list(range(n))
        j = jidx.TreeIndex.from_embeddings("e", ids, embs[:n], branch)
        t = tidx.TreeIndex.from_embeddings("e", ids, embs[:n], branch)
        assert [n.id() for n in t.get_all_leafs()] == \
            [n.id() for n in j.get_all_leafs()]
    side = {i: t.get_ancestor_codes([i], 1)[0] for i in range(16)}
    assert len({side[i] for i in range(8)}) == 1
    assert {side[i] for i in range(8)} != {side[i] for i in range(8, 16)}


def test_layerwise_sample_matches_jax_element_for_element():
    items = list(range(200, 216))
    j, t = _trees("t", items, branch=2)
    for tree in (j, t):
        tree.init_layerwise_sampler([1, 2, 2, 3], start_sample_layer=1,
                                    seed=0)
    users = [[1, 2], [3, 4], [items[2], items[9]]]
    for hierarchy in (False, True):
        rows = t.layerwise_sample(users, [items[0], items[5], items[7]],
                                  with_hierarchy=hierarchy)
        assert rows == j.layerwise_sample(
            users, [items[0], items[5], items[7]], with_hierarchy=hierarchy)
    assert len(rows) == 3 * sum(1 + c for c in [1, 2, 2, 3])


def test_layerwise_sample_arrays_match_jax():
    items = list(range(32))
    j, t = _trees("t", items, branch=2)
    counts = [2, 4, 8, 8, 8][:t.height() - 1]
    for tree in (j, t):
        tree.init_layerwise_sampler(counts, seed=1)
    for batch in ([0, 17, 31], [5, 5, 6, 30]):
        for a, b in zip(t._layerwise_sampler.sample_arrays(
                np.asarray(batch)),
                j._layerwise_sampler.sample_arrays(np.asarray(batch))):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_sampler_validation_matches_jax():
    for mod in (jidx, tidx):
        t = mod.TreeIndex.from_items("t", list(range(8)), branch=2)
        with pytest.raises(ValueError, match="needs"):
            t.init_layerwise_sampler([1, 2])
        with pytest.raises(ValueError, match="init layerwise_sampler"):
            t.layerwise_sample([[1]], [0])
        with pytest.raises(ValueError, match="branch"):
            mod.TreeIndex.from_items("t", [1, 2], branch=1)
