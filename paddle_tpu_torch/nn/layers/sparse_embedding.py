"""Sparse (large-vocabulary) embedding tables (the port's counterpart of
``paddle_tpu/nn/layers/sparse_embedding.py``): the pooled bag-of-ids
lookup of the CTR models, ``paddle.static.nn.sparse_embedding``'s
surface.

The table is one parameter ``[num_embeddings, embedding_dim]`` with the
logical axes ``("vocab", "embed")``; a lookup is a gather and its
gradient a scatter-add into the rows that were looked up, applied by the
ordinary optimizer step. Padding id 0 (the CTR datasets' pad) embeds to
zero, so an absent feature adds nothing to its pooled slot.
``hash_ids=True`` folds arbitrary ids (Criteo's 2^32 range) into the
table with the JAX package's multiply-shift hash, in 32-bit arithmetic,
so the same ids map to the same rows in both packages; without it an
out-of-range id is clamped to the last row (the JAX gather's ``clip``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import initializer as I
from ..layer import Layer

_MASK32 = 0xFFFFFFFF


def fold_hash_ids(ids: torch.Tensor, num_embeddings: int, padding_idx):
    """Raw feature ids into ``[1, num_embeddings)``, the padding id kept:
    ``h = uint32(id) * 0x9E3779B9``, ``h ^= h >> 16``, ``1 + h % (N -
    1)``. int64 products keep the low 32 bits of the uint32 product (a
    wrap mod 2^64 leaves them)."""
    h = (ids.to(torch.int64) & _MASK32) * 0x9E3779B9 & _MASK32
    h = h ^ (h >> 16)
    folded = (1 + h % (num_embeddings - 1)).to(ids.dtype)
    if padding_idx is not None:
        folded = torch.where(ids == padding_idx,
                             torch.full_like(ids, padding_idx), folded)
    return folded


def pool_bags(ids: torch.Tensor, emb: torch.Tensor, padding_idx,
              combiner: str) -> torch.Tensor:
    """``[b, k, d]`` rows of ``[b, k]`` ids pooled over the bag: padding
    rows contribute zero; ``sum``, ``mean`` or ``sqrtn`` over the
    non-padding count."""
    b, k = ids.shape
    if padding_idx is not None:
        mask = (ids != padding_idx)[..., None]
        emb = emb * mask.to(emb.dtype)
        counts = mask.sum(dim=1).to(emb.dtype)
    else:
        counts = torch.full((b, 1), float(k), dtype=emb.dtype,
                            device=emb.device)
    pooled = emb.sum(dim=1)
    if combiner == "mean":
        pooled = pooled / torch.clamp(counts, min=1.0)
    elif combiner == "sqrtn":
        pooled = pooled / torch.sqrt(torch.clamp(counts, min=1.0))
    return pooled


class SparseEmbedding(Layer):
    """Pooled sparse-slot embedding: ``ids [batch, num_ids]`` (each row a
    bag of feature ids, 0 = padding) to ``[batch, embedding_dim]``,
    pooled by ``combiner`` in {"sum", "mean", "sqrtn"}."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 combiner: str = "sum", padding_idx: Optional[int] = 0,
                 weight_attr=None, hash_ids: bool = False):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.combiner = combiner
        self.padding_idx = padding_idx
        self.hash_ids = hash_ids
        init_w = weight_attr if callable(weight_attr) else \
            I.Uniform(-1e-3, 1e-3)  # CTR-style tiny init
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], initializer=init_w,
            axes=("vocab", "embed"))

    def _fold_ids(self, ids):
        if not self.hash_ids:
            return ids
        return fold_hash_ids(ids, self.num_embeddings, self.padding_idx)

    def forward(self, ids):
        ids = self._fold_ids(torch.as_tensor(ids,
                                             device=self.weight.device))
        b, k = ids.shape
        rows = ids.reshape(-1).clamp(0, self.num_embeddings - 1)
        emb = self.weight[rows].reshape(b, k, self.embedding_dim)
        return pool_bags(ids, emb, self.padding_idx, self.combiner)


class MultiSlotEmbedding(Layer):
    """One shared table, many slots (Criteo's 26 categorical slots):
    ``ids [batch, num_slots]`` (one id a slot) or ``[batch, num_slots,
    ids_per_slot]`` bags to ``[batch, num_slots * embedding_dim]``, the
    slots' pooled embeddings side by side."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 combiner: str = "sum", padding_idx: Optional[int] = 0,
                 hash_ids: bool = False):
        super().__init__()
        self.table = SparseEmbedding(num_embeddings, embedding_dim,
                                     combiner=combiner,
                                     padding_idx=padding_idx,
                                     hash_ids=hash_ids)
        self.embedding_dim = embedding_dim

    def forward(self, ids):
        ids = torch.as_tensor(ids, device=self.table.weight.device)
        if ids.dim() == 2:
            ids = ids[:, :, None]
        b, slots, per = ids.shape
        pooled = self.table(ids.reshape(b * slots, per))
        return pooled.reshape(b, slots * self.embedding_dim)
