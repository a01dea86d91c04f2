"""The parameter-server datasets (the port's counterpart of
``paddle_tpu/distributed/dataset.py``): ``QueueDataset`` streams
MultiSlot text files into batches, ``InMemoryDataset`` loads them, then
shuffles with ``random.Random(seed)`` (so both packages give the same
record order from the same seed), and the sparse-table admission
entries (``CountFilterEntry``, ``ProbabilityEntry``,
``ShowClickEntry``). Numpy and the standard library only: a batch is a
list of ``[batch, width]`` arrays, one a slot, zero-padded to the
widest record, which ``Model.fit`` / ``train_batch`` take as they are.
"""

from __future__ import annotations

import random
from typing import (Callable, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

Slot = Tuple[str, List[Union[int, float]]]


def parse_multislot_line(line: str, slot_names: Sequence[str]
                         ) -> List[Slot]:
    """One MultiSlot text line (``<n> v1 .. vn`` a slot, in
    ``slot_names`` order) as ``[(name, values)]``; a value with a ".",
    "e" or "E" is a float, else an int."""
    toks = line.split()
    out: List[Slot] = []
    i = 0
    for name in slot_names:
        if i >= len(toks):
            raise ValueError(f"line ended before slot {name!r}")
        n = int(toks[i])
        vals = toks[i + 1:i + 1 + n]
        if len(vals) != n:
            raise ValueError(
                f"slot {name!r} declares {n} values, found {len(vals)}")
        out.append((name, [float(v) if ("." in v or "e" in v or "E" in v)
                           else int(v) for v in vals]))
        i += 1 + n
    if i != len(toks):
        raise ValueError(f"{len(toks) - i} trailing tokens")
    return out


class _EntryAttr:
    """ref: distributed/entry_attr.py EntryAttr base."""

    def _to_attr(self) -> str:
        raise NotImplementedError


class CountFilterEntry(_EntryAttr):
    """Admit a feature id only after ``count_filter`` occurrences
    ."""

    def __init__(self, count_filter: int):
        if count_filter < 0:
            raise ValueError("count_filter must be >= 0")
        self.count_filter = int(count_filter)

    def _to_attr(self) -> str:
        return f"count_filter_entry:{self.count_filter}"


class ProbabilityEntry(_EntryAttr):
    """Admit new ids with probability p ."""

    def __init__(self, probability: float):
        if not 0.0 <= probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")
        self.probability = float(probability)

    def _to_attr(self) -> str:
        return f"probability_entry:{self.probability}"


class ShowClickEntry(_EntryAttr):
    """Show/click-weighted admission ."""

    def __init__(self, show_name: str, click_name: str):
        self.show_name = show_name
        self.click_name = click_name

    def _to_attr(self) -> str:
        return f"show_click_entry:{self.show_name}:{self.click_name}"


class QueueDataset:
    """Streaming file dataset : parses MultiSlot text lines lazily, yields
    batches; files stream in order with no global materialization."""

    def __init__(self):
        self._files: List[str] = []
        self._slots: Sequence[str] = ()
        self._batch_size = 1
        self._parse: Optional[Callable] = None

    def init(self, batch_size=1, use_var=None, pipe_command=None,
             input_type=0, thread_num=1, fs_name="", fs_ugi="",
             **_kw):
        self._batch_size = batch_size
        if use_var is not None:
            self._slots = [getattr(v, "name", str(v)) for v in use_var]
        return self

    def set_filelist(self, files: Sequence[str]) -> None:
        self._files = list(files)

    def set_use_var(self, use_var) -> None:
        self._slots = [getattr(v, "name", str(v)) for v in use_var]

    def set_batch_size(self, batch_size: int) -> None:
        self._batch_size = batch_size

    def set_parse_fn(self, fn: Callable[[str], Sequence]) -> None:
        """TPU-explicit hook: custom line parser (the pipe_command
        analog, in-process instead of a subprocess pipe)."""
        self._parse = fn

    def _lines(self) -> Iterator[str]:
        for path in self._files:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield line

    def _records(self) -> Iterator[Sequence]:
        for line in self._lines():
            if self._parse is not None:
                yield self._parse(line)
            else:
                yield [vals for _name, vals in
                       parse_multislot_line(line, self._slots)]

    def _iter_records(self) -> Iterator[Sequence]:
        """Record source for iteration — subclasses swap this (e.g. the
        in-memory copy) without re-implementing batching."""
        return self._records()

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        batch: List[Sequence] = []
        for rec in self._iter_records():
            batch.append(rec)
            if len(batch) == self._batch_size:
                yield self._collate(batch)
                batch = []
        if batch:
            yield self._collate(batch)

    @staticmethod
    def _collate(batch: List[Sequence]) -> List[np.ndarray]:
        cols = list(zip(*batch))
        out = []
        for col in cols:
            arrs = [np.asarray(v) for v in col]
            width = max(a.reshape(-1).shape[0] for a in arrs)
            mat = np.zeros((len(arrs), width), arrs[0].dtype)
            for i, a in enumerate(arrs):
                flat = a.reshape(-1)
                mat[i, :len(flat)] = flat
            out.append(mat)
        return out


class InMemoryDataset(QueueDataset):
    """ref: dataset.py InMemoryDataset: load_into_memory →
    local/global_shuffle → train. Memory is host RAM; global shuffle
    across processes is each process shuffling its own file shard with
    a shared seed (the reference shuffles through the PS — no PS
    here; DistributedBatchSampler-style sharding covers placement)."""

    def __init__(self):
        super().__init__()
        self._records_mem: Optional[List[Sequence]] = None

    def load_into_memory(self) -> None:
        self._records_mem = list(self._records())

    def local_shuffle(self, seed: Optional[int] = None) -> None:
        if self._records_mem is None:
            raise RuntimeError("call load_into_memory() first")
        random.Random(seed).shuffle(self._records_mem)

    def global_shuffle(self, fleet=None, thread_num=12,
                       seed: Optional[int] = None) -> None:
        self.local_shuffle(seed if seed is not None else 0)

    def release_memory(self) -> None:
        self._records_mem = None

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._records_mem or [])

    def _iter_records(self):
        if self._records_mem is None:
            return super()._iter_records()
        return iter(self._records_mem)
