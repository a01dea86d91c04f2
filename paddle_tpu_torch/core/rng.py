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
def key_guard(key: torch.Tensor) -> Iterator[KeyStream]:
    """Route every :func:`next_key` in scope to a stream rooted at
    ``key``, so that layer code (dropout) stays key-free."""
    stream = KeyStream(key)
    _tls.stack.append(stream)
    try:
        yield stream
    finally:
        _tls.stack.pop()


def split_for_step(step: int) -> torch.Tensor:
    """The key of train step ``step``, derived from the global seed."""
    return threefry.fold_in(get_global_stream()._key, step)
