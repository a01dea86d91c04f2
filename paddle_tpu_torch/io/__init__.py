"""Datasets and the DataLoader (the port's counterpart of
``paddle_tpu/io/__init__.py``).

Samplers, datasets, collation, fork workers and the resume cursor are a
copy of the JAX package's: the same seeds give the same batches in the
same order (``RandomSampler`` draws ``np.random.RandomState(global_seed
+ epoch)`` from :mod:`paddle_tpu_torch.core.rng`, and the loader syncs
the epoch to its pass index).

Device prefetch: a background thread collates NumPy host batches and,
with ``to_device=True``, copies each one to ``device`` ahead of the
consumer. On a CUDA device the copy runs from pinned host memory on a
side stream; the consumer's stream waits on the copy's event before the
batch is handed out, and each tensor is recorded on that stream, so no
batch is read before its copy lands and none is freed while in use.
``to_device=True`` without a ``device`` means the GPU and raises with
no card; ``device="cpu"`` keeps the batches on the CPU as tensors.

Fork workers (``num_workers > 0``) collate NumPy only and never touch
``torch.cuda``, so they may fork after the parent has initialised CUDA.
"""

from __future__ import annotations

import itertools
import math
import queue
import threading
import time
from typing import (Any, Callable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..observability import goodput as _goodput
from ..observability import metrics as _obs
from ..observability import tracing as _tracing
from ..reliability import faults as _faults


def _loader_metrics():
    reg = _obs.default_registry()
    return {
        "wait": reg.histogram(
            "dataloader_next_wait_seconds",
            "time the consumer blocked waiting for the next batch"),
        "batches": reg.counter(
            "dataloader_batches", "batches handed to the train loop"),
    }


def _superbatch_metrics():
    reg = _obs.default_registry()
    return {
        "wait": reg.histogram(
            "train_loop_prefetch_wait_seconds",
            "time the fused train loop blocked waiting for the next "
            "[K, ...] slab (≈0 when the double-buffered prefetch "
            "keeps up)"),
        "batches": reg.counter(
            "train_loop_slabs", "superbatch slabs handed to the fused "
            "train loop"),
    }


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _tree_leaves(t)]
    return [tree]


def _host_array(x) -> np.ndarray:
    """``x`` as a NumPy array on the host: a tensor is read back from its
    device (bf16, which NumPy lacks, through float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [_host_array(t) for t in tensors]
        n = arrays[0].shape[0]
        assert all(a.shape[0] == n for a in arrays)
        self.arrays = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.arrays)

    def __len__(self):
        return self.arrays[0].shape[0]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


def random_split(dataset: Dataset, lengths: Sequence[int]):
    assert sum(lengths) == len(dataset)
    perm = np.random.RandomState(0).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n].tolist()))
        ofs += n
    return out


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self._epoch = 0

    def __iter__(self):
        n = len(self.data_source)
        rs = np.random.RandomState(
            (rng_mod._tls.global_seed + self._epoch) % (2 ** 31))
        self._epoch += 1
        if self.replacement:
            return iter(rs.randint(0, n, self.num_samples).tolist())
        return iter(rs.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _dist_world() -> Tuple[int, int]:
    """(world size, rank) of the default process group, or (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks; rank and world
    size default to the initialised ``torch.distributed`` group's (1
    and 0 without one)."""

    def __init__(self, dataset, batch_size: int, num_replicas=None,
                 rank=None, shuffle: bool = False, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        world, own_rank = _dist_world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else own_rank
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(
            math.ceil(len(dataset) / self.nranks)) if not drop_last else \
            len(dataset) // self.nranks
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rs = np.random.RandomState(self.epoch)
            indices = rs.permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        # a user-driven epoch pin: once called, the DataLoader's
        # pass-index sync backs off and the shuffle order is the
        # caller's responsibility (including on resume)
        self._epoch_set_by_user = True
        self.epoch = epoch


# ---------------------------------------------------------------------------
# Collation + DataLoader
# ---------------------------------------------------------------------------

class WorkerInfo:
    """id / num_workers / seed visible inside a worker process, so that
    an IterableDataset can shard itself."""

    def __init__(self, wid: int, num_workers: int, seed: int):
        self.id = wid
        self.num_workers = num_workers
        self.seed = seed


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """None in the main process."""
    return _worker_info


def default_collate_fn(batch: List[Any]):
    """Stack a list of samples into a NumPy batch."""
    first = batch[0]
    if isinstance(first, (np.ndarray, torch.Tensor)):
        return np.stack([_host_array(b) for b in batch])
    if isinstance(first, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(first, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(first, (list, tuple)):
        return type(first)(default_collate_fn(list(x)) for x in zip(*batch))
    if isinstance(first, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in first}
    return np.asarray(batch)


def _leaf_tensor(x):
    """A numeric batch leaf as a CPU tensor; other leaves unchanged."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.kind not in "biufc":
        return x
    return torch.from_numpy(np.ascontiguousarray(a))


class _PrefetchIterator:
    """Background-thread batch producer with device prefetch. With a
    CUDA ``device`` each batch is copied from pinned memory on a side
    stream and handed out with the consumer's stream waiting on the
    copy's event; with a CPU ``device`` it becomes CPU tensors; with
    None it stays NumPy."""

    _SENTINEL = object()

    def __init__(self, produce: Callable[[], Iterator], buffer_size: int,
                 device: Optional[torch.device], instruments=None,
                 on_item=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._device = device
        self._err: Optional[BaseException] = None
        self._produce = produce
        self._stop = threading.Event()
        self._obs = instruments or _loader_metrics()
        # consumption hook (DataLoader cursor tracking): fires on the
        # CONSUMER thread as each item is handed out — prefetched-but-
        # unconsumed batches never advance the resume cursor
        self._on_item = on_item
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, item, stream):
        """(item on the device, the copy's event or None)."""
        item = _tree_map(_leaf_tensor, item)
        if self._device.type != "cuda":
            return _tree_map(
                lambda x: x.to(self._device)
                if isinstance(x, torch.Tensor) else x, item), None
        with torch.cuda.stream(stream):
            out = _tree_map(
                lambda x: x.pin_memory().to(self._device, non_blocking=True)
                if isinstance(x, torch.Tensor) else x, item)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _run(self):
        stream = None
        try:
            if self._device is not None and self._device.type == "cuda":
                stream = torch.cuda.Stream(self._device)
            for item in self._produce():
                if self._stop.is_set():
                    return
                event = None
                if self._device is not None:
                    item, event = self._to_device(item, stream)
                self._q.put((item, event))
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        got = self._q.get()
        if got is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item, event = got
        if event is not None:
            # the consumer's stream orders its reads after the copy; the
            # caching allocator keeps each tensor until that stream's
            # work on it is done
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for x in _tree_leaves(item):
                if isinstance(x, torch.Tensor):
                    x.record_stream(consumer)
        # wait ≈ how starved the train loop is for input: near zero
        # when prefetch keeps up, ≈ batch production time when not
        t1 = time.perf_counter()
        self._obs["wait"].observe(t1 - t0)
        self._obs["batches"].inc()
        if _goodput.enabled():
            # the SAME wait the histogram observes: input starvation
            # on the time ledger (input_wait badput)
            _goodput.note("input_wait", t1 - t0)
        if _tracing.enabled():
            # post-hoc span over the wait interval
            _tracing.start_span("io.next_wait", t0=t0).end(t1)
        if self._on_item is not None:
            self._on_item(item)
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


# -- multiprocess workers -----------------------------------------------------
#
# fork-based: the dataset is inherited by the worker processes (no
# per-batch pickling of the dataset), batches return through pipes as
# pickled NumPy. Workers collate NumPy only and never touch torch.cuda,
# so they may fork after the parent initialised CUDA.

_mp_dataset = None
_mp_collate = None
# the longest the loader waits for one batch from its fork pool: a worker
# that hangs (a lock held across the fork, say) fails the pass under the
# loader's name instead of hanging the train loop
WORKER_RESULT_TIMEOUT_S = 120.0


def _map_worker_init(dataset, collate_fn, wid, num_workers, seed):
    global _mp_dataset, _mp_collate, _worker_info
    _mp_dataset = dataset
    _mp_collate = collate_fn
    _worker_info = WorkerInfo(wid, num_workers, seed)
    np.random.seed((seed + wid) % (2 ** 31))


def _worker_result(fut):
    """A fork-pool batch, waited on for at most
    ``WORKER_RESULT_TIMEOUT_S``."""
    import concurrent.futures
    try:
        return fut.result(timeout=WORKER_RESULT_TIMEOUT_S)
    except concurrent.futures.TimeoutError:
        raise TimeoutError(
            f"DataLoader fork worker gave no batch in "
            f"{WORKER_RESULT_TIMEOUT_S:.0f} s") from None


def _map_worker_collate(batch_idx):
    return _mp_collate([_mp_dataset[i] for i in batch_idx])


def _iter_worker_loop(dataset, collate_fn, batch_size, drop_last,
                      wid, num_workers, seed, out_q):
    """Worker body for IterableDataset: iterate a private copy with
    worker_info set (the dataset shards itself via get_worker_info),
    collate and ship batches."""
    global _worker_info
    _worker_info = WorkerInfo(wid, num_workers, seed)
    np.random.seed((seed + wid) % (2 ** 31))
    try:
        it = iter(dataset)
        if batch_size is None:
            for item in it:
                out_q.put(("item", item))
        else:
            while True:
                batch = list(itertools.islice(it, batch_size))
                if not batch or (len(batch) < batch_size and drop_last):
                    break
                out_q.put(("item", collate_fn(batch)))
        out_q.put(("done", None))
    except BaseException as e:  # noqa: BLE001 — ship to parent
        import traceback
        out_q.put(("error", traceback.format_exc() + repr(e)))


class DataLoader:
    """Batches of a dataset, produced on a background thread (and by
    fork workers with ``num_workers > 0``) and, with ``to_device``,
    copied to ``device`` ahead of the consumer (the GPU when
    ``device`` is None, which raises with no card)."""

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = 1,
                 shuffle: bool = False, batch_sampler=None, sampler=None,
                 drop_last: bool = False, collate_fn=None,
                 num_workers: int = 0, prefetch_factor: int = 2,
                 return_list: bool = True, to_device: bool = True,
                 device=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        if num_workers == "auto":
            # ref: incubate/autotune.py dataloader tuner
            from ..incubate.autotune import suggested_num_workers
            num_workers = suggested_num_workers()
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.to_device = to_device
        self.device = resolve_device(device) if to_device else None
        self._iterable = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, sampler=sampler, shuffle=shuffle,
                batch_size=batch_size or 1, drop_last=drop_last)
        # resume cursor: which pass (epoch) is running and how many host
        # batches the CONSUMER has taken from it — see state_dict()
        self._pass_index = 0      # passes started (next pass's index)
        self._current_pass = 0
        self._batch_cursor = 0
        self._resume_cursor: Optional[Tuple[int, int]] = None

    def _produce(self, skip: int = 0):
        if self._iterable:
            it = iter(self.dataset)
            if self.batch_size is None:
                yield from itertools.islice(it, skip, None)
                return
            n = 0
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                n += 1
                if n > skip:  # iterables can't seek: consume and drop
                    yield self.collate_fn(batch)
        else:
            # map-style skip happens at the INDEX level — skipped
            # batches cost no __getitem__/collate work on resume
            for batch_idx in itertools.islice(
                    iter(self.batch_sampler), skip, None):
                yield self.collate_fn([self.dataset[i] for i in batch_idx])

    def _produce_multiprocess_map(self, seed, skip: int = 0):
        """Ordered pipelined map over batch indices on a fork pool —
        up to num_workers*prefetch_factor batches in flight."""
        import collections
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context("fork")
        wid_counter = ctx.Value("i", 0)

        def _init(dataset, collate, nw, sd):
            with wid_counter.get_lock():
                wid = wid_counter.value
                wid_counter.value += 1
            _map_worker_init(dataset, collate, wid, nw, sd)

        pool = ProcessPoolExecutor(
            max_workers=self.num_workers, mp_context=ctx,
            initializer=_init,
            initargs=(self.dataset, self.collate_fn, self.num_workers,
                      seed))
        try:
            pending: "collections.deque" = collections.deque()
            depth = self.num_workers * max(self.prefetch_factor, 1)
            it = itertools.islice(iter(self.batch_sampler), skip, None)
            for batch_idx in it:
                pending.append(pool.submit(_map_worker_collate, batch_idx))
                if len(pending) >= depth:
                    yield _worker_result(pending.popleft())
            while pending:
                yield _worker_result(pending.popleft())
        except TimeoutError:
            # a hung worker would block the shutdown's wait as well
            for proc in list(getattr(pool, "_processes", {}).values()):
                proc.kill()
            raise
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def _produce_multiprocess_iter(self, seed, skip: int = 0):
        """IterableDataset workers: each process iterates its own copy
        with worker_info set; the parent round-robins worker queues for
        a deterministic order (which also makes the resume ``skip``
        exact)."""
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        queues = [ctx.Queue(maxsize=max(self.prefetch_factor, 1))
                  for _ in range(self.num_workers)]
        procs = [
            ctx.Process(
                target=_iter_worker_loop,
                args=(self.dataset, self.collate_fn, self.batch_size,
                      self.drop_last, w, self.num_workers, seed, queues[w]),
                daemon=True)
            for w in range(self.num_workers)]
        for p in procs:
            p.start()
        alive = [True] * self.num_workers
        try:
            while any(alive):
                for w in range(self.num_workers):
                    if not alive[w]:
                        continue
                    while True:
                        try:
                            kind, payload = queues[w].get(timeout=5.0)
                            break
                        except queue.Empty:
                            # a worker killed by the OS sends nothing:
                            # fail loudly instead of hanging fit()
                            if not procs[w].is_alive():
                                raise RuntimeError(
                                    f"DataLoader worker {w} died "
                                    f"(exitcode {procs[w].exitcode})")
                    if kind == "error":
                        raise RuntimeError(
                            f"DataLoader worker {w} failed:\n{payload}")
                    if kind == "done":
                        alive[w] = False
                        continue
                    if skip > 0:
                        skip -= 1
                        continue
                    yield payload
        finally:
            for p in procs:
                p.terminate()
            for p in procs:  # reap — terminate alone leaks zombies
                p.join(timeout=5.0)

    def _begin_pass(self) -> Tuple[int, int]:
        """Start one pass over the data: resolve which pass index it is
        (a pending resume cursor wins), how many batches to skip, and
        sync every epoch-seeded sampler to that index — so pass ``e``
        of a resumed run shuffles exactly like pass ``e`` of an
        uninterrupted one."""
        if self._resume_cursor is not None:
            pass_idx, skip = self._resume_cursor
            self._resume_cursor = None
        else:
            pass_idx, skip = self._pass_index, 0
        self._pass_index = pass_idx + 1
        self._current_pass = pass_idx
        self._batch_cursor = skip
        self._sync_shuffle_epoch(pass_idx)
        return pass_idx, skip

    def _sync_shuffle_epoch(self, epoch: int) -> None:
        for obj in (self.batch_sampler,
                    getattr(self.batch_sampler, "sampler", None)):
            if obj is None:
                continue
            if getattr(obj, "_epoch_set_by_user", False):
                # the user drives this sampler's epoch (set_epoch)
                continue
            if hasattr(obj, "set_epoch"):
                obj.set_epoch(epoch)
                # a loader-managed sync must stay distinguishable from
                # a user call: un-latch the flag set_epoch just set
                try:
                    obj._epoch_set_by_user = False
                except AttributeError:
                    pass
            elif hasattr(obj, "_epoch"):
                obj._epoch = epoch

    def _note_consumed(self, n: int) -> None:
        self._batch_cursor += n

    def _select_produce(self, pass_idx: int = None, skip: int = 0):
        """Pick the host-batch producer for one pass (serial generator or
        the fork-pool pipelines), resolving the per-pass worker seed on
        the CALLER thread (where the seed's thread-local state lives —
        the produce generator runs on the prefetch thread)."""
        if pass_idx is None:
            pass_idx, skip = self._begin_pass()
        if self.num_workers > 0:
            # worker seed keyed by the pass index: a resumed run's pass
            # e re-derives the per-worker seeds the interrupted run used
            seed = (int(rng_mod._tls.global_seed) + pass_idx) % (2 ** 31)
            mp_produce = self._produce_multiprocess_iter if self._iterable \
                else self._produce_multiprocess_map
            produce = lambda: mp_produce(seed, skip)  # noqa: E731
        else:
            produce = lambda: self._produce(skip)  # noqa: E731
        if not _faults.enabled():
            return produce

        def produce_with_faults():
            # injection site io.worker: one check per produced host
            # batch — models a worker dying mid-epoch; the fault rides
            # the prefetch queue to the training loop
            for b in produce():
                _faults.check("io.worker")
                yield b

        return produce_with_faults

    def __iter__(self):
        pass_idx, skip = self._begin_pass()
        return _PrefetchIterator(self._select_produce(pass_idx, skip),
                                 self.prefetch_factor, self.device,
                                 on_item=lambda _b: self._note_consumed(1))

    # -- resume cursor ------------------------------------------------------
    def state_dict(self) -> dict:
        """The exact-resume cursor: the pass (epoch) being consumed and
        how many host batches the consumer has taken from it. Batches in
        the prefetch queue (produced, never consumed) are not counted —
        they are produced again on resume."""
        if _faults.enabled():
            _faults.check("loader.state")
        return {"pass": int(self._current_pass),
                "batch": int(self._batch_cursor)}

    def load_state_dict(self, state: dict) -> None:
        """Arm the next pass to resume at ``state``: it runs as pass
        ``state["pass"]`` (same shuffle permutation, same worker seeds)
        and skips the first ``state["batch"]`` batches."""
        if _faults.enabled():
            _faults.check("loader.state")
        pass_idx = int(state["pass"])
        skip = int(state["batch"])
        self._resume_cursor = (pass_idx, skip)
        self._current_pass = pass_idx
        self._batch_cursor = skip
        self._pass_index = pass_idx

    def superbatches(self, steps_per_loop: int):
        """Iterate ``[K, ...]``-stacked slabs of ``steps_per_loop``
        consecutive host batches, with the same background prefetch as
        ``__iter__``. A batch whose leaf shapes differ from the slab
        being built (the ragged tail of an epoch with drop_last=False)
        flushes the slab early, so every slab is rectangular. Wait and
        slab counts land in the ``train_loop_*`` instruments; the resume
        cursor counts the batches inside each consumed slab."""
        k = max(int(steps_per_loop), 1)
        pass_idx, skip = self._begin_pass()
        produce = self._select_produce(pass_idx, skip)

        def gen():
            buf: List[Any] = []
            sig = None
            for b in produce():
                s = tuple(np.shape(x) for x in _tree_leaves(b))
                if buf and s != sig:
                    yield stack_batches(buf)
                    buf = []
                buf.append(b)
                sig = s
                if len(buf) == k:
                    yield stack_batches(buf)
                    buf = []
            if buf:
                yield stack_batches(buf)

        def consumed(slab):
            self._note_consumed(int(_tree_leaves(slab)[0].shape[0]))

        return _PrefetchIterator(gen, max(self.prefetch_factor, 1),
                                 self.device,
                                 instruments=_superbatch_metrics(),
                                 on_item=consumed)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)


def stack_batches(batches: List[Any]):
    """Stack same-structure host batches leaf-wise into one [K, ...]
    superbatch."""
    return _tree_map(lambda *xs: np.stack([_host_array(x) for x in xs]),
                     *batches)


# variable-length sequence tools
from .sequence import (LengthBucketBatchSampler, bucket_collate,  # noqa: E402
                       default_boundaries, pad_sequence)


class ComposeDataset(Dataset):
    """Zip-style composition: sample i concatenates the fields of
    sample i from every child."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one child")
        n = len(self.datasets[0])
        for d in self.datasets[1:]:
            if len(d) != n:
                raise ValueError("ComposeDataset children must have "
                                 "equal lengths")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            s = d[idx]
            out.extend(s if isinstance(s, (tuple, list)) else (s,))
        return tuple(out)


class WeightedRandomSampler(Sampler):
    """Sample indices proportional to weights, with or without
    replacement."""

    def __init__(self, weights, num_samples: int, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = int(num_samples)
        self.replacement = bool(replacement)
        if not replacement and num_samples > len(self.weights):
            raise ValueError("cannot draw more samples than weights "
                             "without replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        # seeded like RandomSampler: seed-reproducible, epoch-advancing,
        # independent of the global np.random state
        epoch = getattr(self, "_epoch", 0)
        self._epoch = epoch + 1
        rs = np.random.RandomState(
            (rng_mod._tls.global_seed + epoch) % (2 ** 31))
        idx = rs.choice(len(p), size=self.num_samples,
                        replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples

from . import checkpoint  # noqa: E402,F401  (io.checkpoint.AutoCheckpoint)
