"""Variable-length sequence utilities: padding and length bucketing
(the port's counterpart of ``paddle_tpu/io/sequence.py``).

Every distinct input shape is a new signature for ``Model``'s
recompile guard (``FLAGS.recompile_warn_threshold``), as it is a new
XLA program in the JAX package, so ragged data is

  1. padded by ``pad_sequence`` — ragged sequences to one dense
     [batch, max_len] array + mask,
  2. bucketed by length (``LengthBucketBatchSampler``) so batches land
     on a small fixed set of padded shapes (bounded signature count,
     bounded pad waste).

Boundaries default to powers of two.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import RandomSampler, Sampler, SequenceSampler


def pad_sequence(sequences: Sequence, padding_value: float = 0.0,
                 max_len: Optional[int] = None,
                 pad_to_multiple: Optional[int] = None,
                 return_mask: bool = False, dtype=None):
    """Pad a list of 1-D+ sequences to a dense batch on dim 0.

    Returns ``padded [B, L, ...]`` (+ ``mask [B, L]`` float32 when
    ``return_mask``). ``max_len`` pins L (sequences longer are
    truncated); ``pad_to_multiple`` rounds L up (fewer distinct shapes
    when bucketing is not in play)."""
    seqs = [np.asarray(s) for s in sequences]
    if dtype is None:
        dtype = seqs[0].dtype
    L = max(s.shape[0] for s in seqs) if max_len is None else int(max_len)
    if pad_to_multiple:
        L = -(-L // pad_to_multiple) * pad_to_multiple
    trailing = seqs[0].shape[1:]
    out = np.full((len(seqs), L) + trailing, padding_value, dtype)
    mask = np.zeros((len(seqs), L), np.float32)
    for i, s in enumerate(seqs):
        n = min(s.shape[0], L)
        out[i, :n] = s[:n]
        mask[i, :n] = 1.0
    if return_mask:
        return out, mask
    return out


def default_boundaries(max_len: int, min_len: int = 16) -> List[int]:
    """Power-of-two boundaries up to max_len — log2(max/min)+1 distinct
    padded shapes."""
    bounds = []
    b = min_len
    while b < max_len:
        bounds.append(b)
        b *= 2
    bounds.append(max_len)
    return bounds


class LengthBucketBatchSampler(Sampler):
    """Batch sampler grouping samples of similar length (boundaries
    make the padded shape set finite: one signature per bucket).

    ``lengths``: per-sample lengths (list/array, or a callable applied
    to dataset[i]). Each yielded batch contains indices from ONE bucket;
    pair it with a collate that pads to ``bucket_len_of(batch)`` (e.g.
    ``pad_sequence(batch, max_len=sampler.bucket_len(batch[0]))``)."""

    def __init__(self, dataset, lengths, batch_size: int,
                 boundaries: Optional[Sequence[int]] = None,
                 shuffle: bool = False, drop_last: bool = False):
        super().__init__(dataset)
        if callable(lengths):
            lengths = [lengths(dataset[i]) for i in range(len(dataset))]
        self.lengths = np.asarray(lengths, np.int64)
        if boundaries is None:
            boundaries = default_boundaries(int(self.lengths.max()))
        self.boundaries = sorted(int(b) for b in boundaries)
        if self.lengths.max() > self.boundaries[-1]:
            raise ValueError(
                f"max length {self.lengths.max()} exceeds the last "
                f"boundary {self.boundaries[-1]}")
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._sampler = (RandomSampler(dataset) if shuffle
                         else SequenceSampler(dataset))
        # bucket id of each sample: first boundary >= length
        self.bucket_of = np.searchsorted(self.boundaries, self.lengths)

    def bucket_len(self, idx: int) -> int:
        """Padded length of the bucket that sample ``idx`` falls in."""
        return self.boundaries[self.bucket_of[idx]]

    def __iter__(self):
        buckets: List[List[int]] = [[] for _ in self.boundaries]
        for idx in self._sampler:
            b = self.bucket_of[idx]
            buckets[b].append(idx)
            if len(buckets[b]) == self.batch_size:
                yield buckets[b]
                buckets[b] = []
        if not self.drop_last:
            for b in buckets:
                if b:
                    yield b

    def __len__(self):
        counts = np.bincount(self.bucket_of, minlength=len(self.boundaries))
        if self.drop_last:
            return int((counts // self.batch_size).sum())
        return int((-(-counts // self.batch_size))[counts > 0].sum())


def bucket_collate(sampler: LengthBucketBatchSampler, padding_value=0.0,
                   return_mask: bool = False):
    """Collate_fn factory: pads each (sample, label) batch to its
    bucket's boundary so the batch shape is the bucket shape."""

    def collate(batch):
        # batch: list of (seq, label) or bare seqs
        if isinstance(batch[0], tuple):
            seqs = [b[0] for b in batch]
            rest = [np.asarray([b[i] for b in batch])
                    for i in range(1, len(batch[0]))]
        else:
            seqs, rest = list(batch), []
        L = 0
        for s in seqs:
            n = len(np.asarray(s))
            L = max(L, sampler.boundaries[
                int(np.searchsorted(sampler.boundaries, n))])
        padded = pad_sequence(seqs, padding_value, max_len=L,
                              return_mask=return_mask)
        if return_mask:
            padded, mask = padded
            return (padded, mask, *rest)
        return (padded, *rest) if rest else padded

    return collate
