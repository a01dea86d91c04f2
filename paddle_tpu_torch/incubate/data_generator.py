"""PS training-data authoring API, the port's counterpart of
``paddle_tpu/incubate/data_generator.py`` (ref: python/paddle/fluid/incubate/
data_generator/__init__.py — ``MultiSlotDataGenerator``: user code
yields (slot_name, values) pairs per sample; the base class serializes
the MultiSlot text protocol ``<n> v1 .. vn`` per slot that the C++
DataFeed parses on the training side).

Context: the CTR path here trains from dense/CSV batches
through the native GIL-free feed (io/native_feed.py) into
SparseEmbedding tables, so this module serves two jobs — byte-level
parity for the reference's authoring protocol (write + parse), and a
``to_csv`` emitter targeting the in-repo native feed."""

from __future__ import annotations

import sys
from typing import Iterable, List, Sequence, Tuple

Slot = Tuple[str, Sequence]


class DataGenerator:
    """ref: data_generator/__init__.py DataGenerator."""

    def __init__(self):
        self._line_limit = None

    # -- user hooks -----------------------------------------------------
    def generate_sample(self, line):
        """Override: return an iterator yielding one sample — a list of
        (slot_name, values) — per call (the reference's contract)."""
        raise NotImplementedError

    def generate_batch(self, samples):
        """Optional batch-level hook (ref: local_iter batching)."""
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    # -- serialization --------------------------------------------------
    def _gen_str(self, sample: List[Slot]) -> str:
        raise NotImplementedError

    def run_from_stdin(self):
        """stdin lines → protocol lines on stdout (the MapReduce shape
        the reference documents)."""
        for line in sys.stdin:
            for sample in self.generate_sample(line)():
                sys.stdout.write(self._gen_str(sample))

    def run_from_files(self, paths: Iterable[str], out_path: str):
        with open(out_path, "w") as out:
            for p in paths:
                with open(p) as f:
                    for line in f:
                        for sample in self.generate_sample(line)():
                            out.write(self._gen_str(sample))


class MultiSlotDataGenerator(DataGenerator):
    """Serializes the MultiSlot text protocol: per sample one line of
    ``<count> v1 .. vcount`` per slot, space-joined
    (ref: MultiSlotDataGenerator._gen_str)."""

    def _gen_str(self, sample: List[Slot]) -> str:
        parts = []
        for _, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts) + "\n"

    def to_csv(self, sample: List[Slot]) -> str:
        """Flatten dense slots into one CSV row for the in-repo native
        feed (io/native_feed.FileDataFeed)."""
        flat = [str(v) for _, values in sample for v in values]
        return ",".join(flat) + "\n"


def parse_multislot_line(line: str, slot_names: Sequence[str]
                         ) -> List[Slot]:
    """Training-side parser for the protocol (the role the reference's
    C++ MultiSlotDataFeed plays, framework/data_feed.cc)."""
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
        numeric = [float(v) if ("." in v or "e" in v or "E" in v)
                   else int(v) for v in vals]
        out.append((name, numeric))
        i += 1 + n
    if i != len(toks):
        raise ValueError(f"{len(toks) - i} trailing tokens")
    return out
