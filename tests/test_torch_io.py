"""The port's ``io`` (datasets, samplers, DataLoader, sequence bucketing)
against the JAX package's, on the same NumPy data and seeds: every
batch, in order, must be identical (exact: both sides run the same
NumPy code over the same seeded draws)."""

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

torch = pytest.importorskip("torch")

import paddle_tpu as jpt  # noqa: E402
import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
import paddle_tpu_torch.io as tio  # noqa: E402


def _data(n=23, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, 3).astype(np.float32)
    y = np.arange(n, dtype=np.int64)
    return x, y


def _host(b):
    if isinstance(b, (tuple, list)):
        return [_host(x) for x in b]
    if isinstance(b, dict):
        return {k: _host(v) for k, v in b.items()}
    if isinstance(b, torch.Tensor):
        return b.numpy()
    return np.asarray(b)


def _passes(loader, n=2):
    return [[_host(b) for b in loader] for _ in range(n)]


def _assert_same(a, b):
    assert type(a) is type(b) or (isinstance(a, list)
                                  and isinstance(b, list)), (a, b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        np.testing.assert_array_equal(a, b)


def _both(make, seed=7, passes=2):
    """``make(io, kw)`` builds a loader from either package's io
    module; both packages seeded alike, two passes each, host batches
    (the JAX package's device copy would narrow int64 to int32)."""
    jpt.seed(seed)
    want = _passes(make(jio, {"to_device": False}), passes)
    tpt.seed(seed)
    got = _passes(make(tio, {"to_device": False}), passes)
    return want, got


@pytest.mark.parametrize("case", [
    "sequential", "shuffle", "drop_last", "shuffle-drop_last",
    "batch_size_none"])
def test_dataloader_batches_match_jax(case):
    x, y = _data()

    def make(io, kw):
        ds = io.TensorDataset([x, y])
        if case == "batch_size_none":
            return io.DataLoader(ds, batch_size=None,
                                 batch_sampler=io.BatchSampler(
                                     ds, batch_size=5), **kw)
        return io.DataLoader(ds, batch_size=5,
                             shuffle="shuffle" in case,
                             drop_last="drop_last" in case, **kw)
    want, got = _both(make)
    _assert_same(got, want)
    if "shuffle" in case:   # the epoch advances the permutation
        assert not np.array_equal(got[0][0][1], got[1][0][1])


def test_shuffle_order_is_drawn_on_the_prefetch_thread():
    """Both packages draw the shuffle on the loader's prefetch thread,
    whose thread-local seed no ``seed()`` call reaches: pass e is
    RandomState(0 + e)'s permutation whatever the seed."""
    x, y = _data()
    for pkg, io in ((jpt, jio), (tpt, tio)):
        for seed in (3, 4):
            pkg.seed(seed)
            loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=23,
                                   shuffle=True, to_device=False)
            for epoch in range(2):
                (_, order), = [_host(b) for b in loader]
                np.testing.assert_array_equal(
                    order, np.random.RandomState(epoch).permutation(23))


def test_random_split_and_datasets_match_jax():
    x, y = _data()

    def parts(io):
        ds = io.TensorDataset([x, y])
        a, b = io.random_split(ds, [15, 8])
        cat = io.ConcatDataset([a, b])
        comp = io.ComposeDataset([io.TensorDataset([x]),
                                  io.TensorDataset([y])])
        return ([_host(a[i]) for i in range(len(a))],
                [_host(b[i]) for i in range(len(b))],
                [_host(cat[i]) for i in range(len(cat))],
                [_host(comp[i]) for i in range(3)])
    for w, g in zip(parts(jio), parts(tio)):
        _assert_same(g, w)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_two_ranks_match_jax(shuffle, drop_last):
    x, y = _data()
    for rank in (0, 1):
        def make(io, kw):
            ds = io.TensorDataset([x, y])
            bs = io.DistributedBatchSampler(ds, batch_size=4,
                                            num_replicas=2, rank=rank,
                                            shuffle=shuffle,
                                            drop_last=drop_last)
            return io.DataLoader(ds, batch_sampler=bs, **kw)
        want, got = _both(make)
        _assert_same(got, want)


@pytest.mark.parametrize("replacement", [True, False])
def test_weighted_random_sampler_matches_jax(replacement):
    x, y = _data()
    w = np.linspace(0.1, 2.0, len(y))

    def make(io, kw):
        ds = io.TensorDataset([x, y])
        s = io.WeightedRandomSampler(w, 17, replacement=replacement)
        return io.DataLoader(ds, sampler=s, batch_size=4, **kw)
    want, got = _both(make, passes=3)
    _assert_same(got, want)


def test_length_bucketing_matches_jax():
    r = np.random.RandomState(3)
    lens = r.randint(1, 40, size=30)
    seqs = [r.randint(0, 50, size=n).astype(np.int64) for n in lens]
    labels = np.arange(30, dtype=np.int64)

    class Seqs:
        def __init__(self, io):
            self.io = io

        def __len__(self):
            return len(seqs)

        def __getitem__(self, i):
            return seqs[i], labels[i]

    def make(io, kw):
        ds = type("DS", (Seqs, io.Dataset), {})(io)
        s = io.LengthBucketBatchSampler(ds, lens, batch_size=4,
                                        shuffle=True)
        return io.DataLoader(ds, batch_sampler=s,
                             collate_fn=io.bucket_collate(
                                 s, return_mask=True), **kw)
    want, got = _both(make)
    _assert_same(got, want)
    for io in (jio, tio):
        assert io.default_boundaries(100) == [16, 32, 64, 100]
        a, m = io.pad_sequence(seqs[:3], pad_to_multiple=8,
                               return_mask=True)
        assert a.shape[1] % 8 == 0 and m.sum() == lens[:3].sum()


@pytest.mark.parametrize("k", [3, 4])
def test_superbatches_with_ragged_tail_match_jax(k):
    """23 samples in batches of 5 (the last of 3) stacked K at a time:
    the short batch flushes its slab early."""
    x, y = _data()

    def make(io, kw):
        loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=5,
                               shuffle=True, **kw)
        return loader.superbatches(k)
    jpt.seed(1)
    want = [_host(s) for s in make(jio, {"to_device": False})]
    tpt.seed(1)
    got = [_host(s) for s in make(tio, {"to_device": False})]
    _assert_same(got, want)
    assert [s[0].shape[0] for s in got][-1] == 1
    _assert_same(_host(tio.stack_batches([(x[:2], y[:2])] * 2)),
                 _host(jio.stack_batches([(x[:2], y[:2])] * 2)))


def test_workers_yield_the_same_batches_as_none():
    x, y = _data(40)
    tpt.seed(5)
    ds = tio.TensorDataset([x, y])
    serial = _passes(tio.DataLoader(ds, batch_size=6, shuffle=True,
                                    to_device=False))
    tpt.seed(5)
    forked = _passes(tio.DataLoader(ds, batch_size=6, shuffle=True,
                                    num_workers=2, to_device=False))
    _assert_same(forked, serial)


class _StuckDataset(tio.Dataset):
    """Index 3 hangs in a fork worker (as a worker would on a lock held
    across the fork)."""

    def __getitem__(self, i):
        if i == 3:
            import time
            time.sleep(60)
        return np.full((2,), i, np.float32)

    def __len__(self):
        return 8


def test_a_hung_fork_worker_fails_under_the_loaders_name(monkeypatch):
    import time
    monkeypatch.setattr(tio, "WORKER_RESULT_TIMEOUT_S", 1.0)
    loader = tio.DataLoader(_StuckDataset(), batch_size=2, num_workers=2,
                            to_device=False)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="DataLoader fork worker"):
        for _ in loader:
            pass
    assert time.monotonic() - t0 < 30


def test_cursor_resumes_mid_pass_like_jax():
    """state_dict after 2 consumed batches of pass 1, loaded into a
    fresh loader: the rest of pass 1 and the next pass are the
    uninterrupted run's, as in the JAX package."""
    x, y = _data()

    def run(io, kw, seed):
        (jpt if io is jio else tpt).seed(seed)
        ds = io.TensorDataset([x, y])
        full = io.DataLoader(ds, batch_size=4, shuffle=True, **kw)
        first = [_host(b) for b in full]
        it = iter(full)
        head = [_host(next(it)), _host(next(it))]
        state = full.state_dict()
        it.close()
        fresh = io.DataLoader(ds, batch_size=4, shuffle=True, **kw)
        fresh.load_state_dict(state)
        tail = [_host(b) for b in fresh]
        nxt = [_host(b) for b in fresh]
        return first, head, state, tail, nxt
    want = run(jio, {"to_device": False}, 9)
    got = run(tio, {"to_device": False}, 9)
    assert got[2] == want[2] == {"pass": 1, "batch": 2}
    for w, g in zip(want[:2] + want[3:], got[:2] + got[3:]):
        _assert_same(g, w)


def test_default_collate_and_device_batches():
    """Collation of nested samples, and ``to_device`` batches as CPU
    tensors with ``device="cpu"``."""
    samples = [{"a": np.ones(2, np.float32) * i, "b": (i, float(i))}
               for i in range(3)]
    _assert_same(_host(tio.default_collate_fn(samples)),
                 _host(jio.default_collate_fn(samples)))
    x, y = _data(8)
    loader = tio.DataLoader(tio.TensorDataset([x, y]), batch_size=4,
                            device="cpu")
    bx, by = next(iter(loader))
    assert isinstance(bx, torch.Tensor) and bx.device.type == "cpu"
    assert by.dtype == torch.int64
    np.testing.assert_array_equal(bx.numpy(), x[:4])


def test_loader_to_device_without_a_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    ds = tio.TensorDataset([np.zeros((4, 2), np.float32)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.DataLoader(ds, batch_size=2)
    assert tio.DataLoader(ds, batch_size=2, to_device=False).device is None
