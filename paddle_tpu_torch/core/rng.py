"""Seeded randomness: the initializers' generator and the dropout keys.

``seed(s)`` keeps the signature of ``paddle_tpu.seed`` and seeds two
things.

- One CPU ``torch.Generator`` that the initializers draw from.
  Parameters are always drawn on the CPU and moved to their device
  afterwards, so a seed gives the same weights whatever the device. Its
  numbers differ from ``jax.random``'s: to run both packages on the same
  weights, carry them across with
  :func:`paddle_tpu_torch.interop.load_reference_state`.
- The key streams of ``paddle_tpu/core/rng.py``, ported on JAX's
  threefry (``core/threefry.py``) bit for bit: a thread-local stack of
  :class:`KeyStream` objects whose named sub-streams hand out keys
  (:func:`next_key`). The root key is ``PRNGKey(seed)``; a sub-stream's
  root is ``fold_in(key, crc32(name) & 0x7FFFFFFF)``, split once per
  draw. ``Model.train_batch`` roots each step's stream at
  :func:`split_for_step` through :func:`key_guard`, so dropout masks are
  the JAX package's.

Under data parallelism each rank runs the forward on its rows of the
global batch; :func:`batch_rows` marks that, and dropout then draws the
rank's rows of the global batch's mask (:func:`mask_rows`), as JAX's
partitionable threefry does on a sharded batch. Under tensor
parallelism a rank's attention runs on its slice of the heads;
:func:`head_slice` marks that, and the attention dropout draws the
slice of the global ``[batch, heads, q, k]`` mask (:func:`mask_cols`).
Under sequence parallelism a rank's activations are its slice of the
sequence (dim 1 of ``[batch, seq, hidden]``); :func:`seq_slice` marks
that, and a residual dropout draws that slice of the global mask.
"""

from __future__ import annotations

import contextlib
import threading
import zlib
from typing import Dict, Iterator

import torch

from . import threefry

_lock = threading.Lock()
_generator: torch.Generator | None = None


class KeyStream:
    """A splittable stream of threefry keys (``[2]`` int64 tensors on the
    CPU) with named sub-streams."""

    def __init__(self, key: torch.Tensor):
        self._key = key
        self._streams: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_seed(cls, seed: int) -> "KeyStream":
        return cls(threefry.prng_key(seed))

    def next_key(self, name: str = "global") -> torch.Tensor:
        """Return a fresh key from the named sub-stream."""
        base = self._streams.get(name)
        if base is None:
            base = threefry.fold_in(
                self._key, zlib.crc32(name.encode()) & 0x7FFFFFFF)
        base, out = threefry.split(base)
        self._streams[name] = base
        return out


class _TLS(threading.local):
    def __init__(self):
        self.stack: list[KeyStream] = []
        self.global_seed = 0
        self.batch_rows = None   # (index, count) of a data-parallel rank
        self.mask_cols = None    # (first, total) of a tensor-parallel rank
        self.seq_cols = None     # (first, total) of a sequence-parallel rank


_tls = _TLS()


def seed(s: int) -> None:
    """Set the global seed (analog of ``paddle.seed``)."""
    global _generator
    with _lock:
        _generator = torch.Generator(device="cpu").manual_seed(int(s))
    _tls.global_seed = int(s)
    _tls.stack = [KeyStream.from_seed(int(s))]


def generator() -> torch.Generator:
    """The global CPU generator (seeded with 0 until :func:`seed`)."""
    global _generator
    with _lock:
        if _generator is None:
            _generator = torch.Generator(device="cpu").manual_seed(0)
        return _generator


def get_global_stream() -> KeyStream:
    if not _tls.stack:
        _tls.stack = [KeyStream.from_seed(_tls.global_seed)]
    return _tls.stack[0]


def current_stream() -> KeyStream:
    if not _tls.stack:
        _tls.stack = [KeyStream.from_seed(_tls.global_seed)]
    return _tls.stack[-1]


def next_key(name: str = "global") -> torch.Tensor:
    """A fresh key from the innermost active stream."""
    return current_stream().next_key(name)


@contextlib.contextmanager
def use_stream(stream: KeyStream) -> Iterator[KeyStream]:
    """Route every :func:`next_key` in scope to ``stream``."""
    _tls.stack.append(stream)
    try:
        yield stream
    finally:
        _tls.stack.pop()


def key_guard(key: torch.Tensor):
    """Route every :func:`next_key` in scope to a stream rooted at
    ``key``, so that layer code (dropout) stays key-free."""
    return use_stream(KeyStream(key))


def split_for_step(step: int) -> torch.Tensor:
    """The key of train step ``step``, derived from the global seed."""
    return threefry.fold_in(get_global_stream()._key, step)


@contextlib.contextmanager
def batch_rows(index: int, count: int, groups: int = 1) -> Iterator[None]:
    """In scope, a tensor's leading dim is this rank's share of a global
    batch split evenly over ``count`` data ranks, ``index`` the rank's
    position among them; with ``groups`` (a pipeline's microbatches on a
    pp mesh) the global batch is that many blocks, each split over the
    data ranks, and the rank's rows are its slice of each."""
    prev = _tls.batch_rows
    _tls.batch_rows = (int(index), int(count), int(groups)) \
        if count > 1 else None
    try:
        yield
    finally:
        _tls.batch_rows = prev


def mask_rows(shape):
    """The ``rows`` argument of ``threefry.random_bits`` for a mask of
    ``shape`` whose leading dim is the batch: this rank's rows of the
    global batch under :func:`batch_rows`, else None (the whole
    array)."""
    br = _tls.batch_rows
    if br is None or not shape:
        return None
    index, count, groups = br
    if groups > 1 and shape[0] % groups == 0:
        per = shape[0] // groups
        return (tuple((g * count + index) * per for g in range(groups)),
                count * shape[0])
    return index * shape[0], count * shape[0]


def one_block(saved: tuple) -> tuple:
    """:func:`saved_slices` state for a tensor that is one block of the
    batch (a pipeline's microbatch): its rows are the rank's slice of
    that block."""
    br = saved[0]
    return ((br[0], br[1], 1) if br is not None else None,) + saved[1:]


@contextlib.contextmanager
def head_slice(first: int, total: int) -> Iterator[None]:
    """In scope, dim 1 of a dropout mask is this rank's heads ``first ..``
    of ``total`` (a tensor-parallel rank's attention probabilities)."""
    prev = _tls.mask_cols
    _tls.mask_cols = (int(first), int(total))
    try:
        yield
    finally:
        _tls.mask_cols = prev


@contextlib.contextmanager
def seq_slice(first: int, total: int) -> Iterator[None]:
    """In scope, dim 1 of an activation is this rank's positions ``first
    ..`` of a sequence of ``total`` (a sequence-parallel rank's slice)."""
    prev = _tls.seq_cols
    _tls.seq_cols = (int(first), int(total))
    try:
        yield
    finally:
        _tls.seq_cols = prev


def mask_cols(shape, seq: bool = True):
    """The ``cols`` argument of ``threefry.random_bits`` for a mask of
    ``shape``: this rank's slice of dim 1 under :func:`head_slice`, else
    (unless ``seq`` is False) under :func:`seq_slice`, else None."""
    if len(shape) < 2:
        return None
    if _tls.mask_cols is not None or not seq:
        return _tls.mask_cols
    return _tls.seq_cols


def saved_slices() -> tuple:
    """This thread's :func:`batch_rows`, :func:`head_slice` and
    :func:`seq_slice` state, for :func:`restored_slices` (a recompute on
    another thread, or after the scope closed, draws the same masks)."""
    return _tls.batch_rows, _tls.mask_cols, _tls.seq_cols


@contextlib.contextmanager
def restored_slices(saved: tuple) -> Iterator[None]:
    prev = saved_slices()
    _tls.batch_rows, _tls.mask_cols, _tls.seq_cols = saved
    try:
        yield
    finally:
        _tls.batch_rows, _tls.mask_cols, _tls.seq_cols = prev
