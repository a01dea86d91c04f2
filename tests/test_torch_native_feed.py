"""The port's native data feed (``paddle_tpu_torch/native/datafeed.cc``
behind ``io.native_feed.FileDataFeed``) against the JAX package's, on
the same files: single-thread batches equal in order, multi-thread row
sets equal, the shuffle window from one seed equal, a partial last
batch, a missing file, schema rejection, ``squeeze_labels=False`` and
the ``incubate.data_generator`` CSV bridge; a failed build raises."""

import numpy as np
import pytest
from torch_gc_barrier import collect_around_module  # noqa: F401

pytest.importorskip("torch")

from paddle_tpu.incubate import data_generator as jdg  # noqa: E402
from paddle_tpu.io.native_feed import FileDataFeed as JFeed  # noqa: E402
from paddle_tpu_torch.core import native_build  # noqa: E402
from paddle_tpu_torch.incubate import data_generator as tdg  # noqa: E402
from paddle_tpu_torch.io import native_feed  # noqa: E402
from paddle_tpu_torch.io.native_feed import FileDataFeed as TFeed  # noqa: E402,E501


def _write_files(tmp_path, n_files=3, rows_per_file=50, width=4, seed=0):
    rs = np.random.RandomState(seed)
    files = []
    for i in range(n_files):
        p = tmp_path / f"part-{i}.csv"
        x = rs.randint(-4096, 4096, (rows_per_file, width)) / 64.0
        y = rs.randint(0, 7, rows_per_file)
        with open(p, "w") as f:
            for r, c in zip(x.tolist(), y.tolist()):
                f.write(",".join(map(str, r)) + f",{c}\n")
        files.append(str(p))
    return files


def _batches(feed_cls, files, **kw):
    return [tuple(a.copy() for a in b) for b in feed_cls(files, **kw)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _rows(batches):
    x = np.concatenate([b[0] for b in batches]).astype(np.float64)
    y = np.concatenate([b[1].reshape(len(b[1]), -1) for b in batches])
    rows = np.concatenate([x, y.astype(np.float64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def test_single_thread_batches_equal(tmp_path):
    files = _write_files(tmp_path)
    kw = dict(schema="f32:4,i64:1", batch_size=16, num_threads=1)
    _assert_batches_equal(_batches(TFeed, files, **kw),
                          _batches(JFeed, files, **kw))


def test_multi_thread_row_sets_equal(tmp_path):
    files = _write_files(tmp_path, n_files=6, rows_per_file=37)
    kw = dict(schema="f32:4,i64:1", batch_size=32, num_threads=4)
    got, want = _batches(TFeed, files, **kw), _batches(JFeed, files, **kw)
    assert sum(len(b[0]) for b in got) == 6 * 37
    np.testing.assert_array_equal(_rows(got), _rows(want))


def test_shuffle_window_from_one_seed_equal(tmp_path):
    files = _write_files(tmp_path, n_files=1, rows_per_file=200)
    kw = dict(schema="f32:4,i64:1", batch_size=50, num_threads=1,
              shuffle_window=64, seed=3)
    got = _batches(TFeed, files, **kw)
    _assert_batches_equal(got, _batches(JFeed, files, **kw))
    plain = _batches(TFeed, files, schema="f32:4,i64:1", batch_size=50,
                     num_threads=1)
    assert not np.array_equal(np.concatenate([b[0] for b in got]),
                              np.concatenate([b[0] for b in plain]))
    np.testing.assert_array_equal(_rows(got), _rows(plain))


def test_partial_last_batch(tmp_path):
    files = _write_files(tmp_path, n_files=1, rows_per_file=10)
    kw = dict(schema="f32:4,i64:1", batch_size=8, num_threads=1)
    got = _batches(TFeed, files, **kw)
    assert [len(b[0]) for b in got] == [8, 2]
    _assert_batches_equal(got, _batches(JFeed, files, **kw))


def test_missing_file_skipped(tmp_path):
    files = _write_files(tmp_path, n_files=1, rows_per_file=5)
    files.append(str(tmp_path / "nope.csv"))
    kw = dict(schema="f32:4,i64:1", batch_size=4, num_threads=2)
    got, want = _batches(TFeed, files, **kw), _batches(JFeed, files, **kw)
    assert sum(len(b[0]) for b in got) == 5
    np.testing.assert_array_equal(_rows(got), _rows(want))


def test_schema_rejected_as_reference():
    for schema in ("f16:4,i64:1", "u8:2"):
        with pytest.raises(ValueError) as want:
            JFeed([], schema)
        with pytest.raises(ValueError) as got:
            TFeed([], schema)
        assert str(got.value) == str(want.value)


def test_unsqueezed_labels_equal(tmp_path):
    files = _write_files(tmp_path, n_files=2, rows_per_file=9, width=3)
    kw = dict(schema="f32:3,i64:1", batch_size=4, num_threads=1,
              squeeze_labels=False)
    got = _batches(TFeed, files, **kw)
    assert got[0][1].shape == (4, 1)
    _assert_batches_equal(got, _batches(JFeed, files, **kw))


class _CTRGen(tdg.MultiSlotDataGenerator):
    def generate_sample(self, line):
        return lambda: iter(())


class _JCTRGen(jdg.MultiSlotDataGenerator):
    def generate_sample(self, line):
        return lambda: iter(())


def test_data_generator_csv_bridge_equal(tmp_path):
    paths = []
    for gen, name in ((_CTRGen(), "port.csv"), (_JCTRGen(), "jax.csv")):
        p = tmp_path / name
        with open(p, "w") as f:
            for i in range(10):
                f.write(gen.to_csv([("click", [i % 2]),
                                    ("ids", [i, i + 1, i + 2]),
                                    ("dense", [i * 0.5, i * 0.25])]))
        paths.append(str(p))
    with open(paths[0]) as a, open(paths[1]) as b:
        assert a.read() == b.read()
    kw = dict(schema="i64:1,i64:3,f32:2", batch_size=5)
    got = _batches(TFeed, [paths[0]], **kw)
    assert sum(len(b[2]) for b in got) == 10
    np.testing.assert_array_equal(_rows([(b[2], b[1]) for b in got]),
                                  _rows([(b[2], b[1]) for b in
                                         _batches(JFeed, [paths[1]], **kw)]))


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken_feed.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_feed, "_SRC", str(bad))
    monkeypatch.setattr(native_feed, "_LIB", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken_feed.cc failed"):
        list(TFeed([], "f32:1"))
