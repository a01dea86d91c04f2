"""Wide&Deep and DeepFM CTR models (the port's counterpart of
``paddle_tpu/models/widedeep.py``): the recommendation workload the
reference's parameter server trained (train_from_dataset over
distributed_lookup_table).

Criteo-style input: dense ``[batch, 13]`` float features and sparse
``[batch, 26]`` categorical ids hashed into one shared table, on the
device (``MultiSlotEmbedding``) or in host RAM (``WideDeepHostTable``,
``HostOffloadedEmbedding``). ``synthetic_criteo`` is the JAX package's
generator, so a seed draws the same data in both packages."""

from __future__ import annotations

from typing import Sequence

import torch

from .. import nn
from ..nn.layer import Layer
from ..nn.layers.sparse_embedding import MultiSlotEmbedding


def _deep_tower(in_dim: int, hidden: Sequence[int]) -> "nn.Sequential":
    """[in_dim] -> hidden MLP (ReLU) -> scalar logit, shared by every
    CTR model here."""
    dims = [in_dim, *hidden]
    mlp = []
    for i in range(len(dims) - 1):
        mlp += [nn.Linear(dims[i], dims[i + 1]), nn.ReLU()]
    mlp.append(nn.Linear(dims[-1], 1))
    return nn.Sequential(*mlp)


class WideDeep(Layer):
    """ref model family: wide (linear over sparse) + deep (embeddings +
    MLP), joint logit (Cheng et al. 2016; the canonical PS workload)."""

    def __init__(self, num_dense: int = 13, num_slots: int = 26,
                 vocab_size: int = 1000 * 1000, embedding_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64)):
        super().__init__()
        self.num_dense = num_dense
        # wide: 1-dim embedding = per-feature scalar weight (sparse LR);
        # hash_ids folds raw 2^32-range ids into the table
        self.wide = MultiSlotEmbedding(vocab_size, 1, hash_ids=True)
        self.wide_dense = nn.Linear(num_dense, 1)
        # deep: shared table + MLP over [dense | slot embeddings]
        self.embedding = MultiSlotEmbedding(vocab_size, embedding_dim,
                                            hash_ids=True)
        self.deep = _deep_tower(num_dense + num_slots * embedding_dim,
                                hidden)

    def forward(self, dense, sparse_ids):
        wide_logit = self.wide(sparse_ids).sum(-1, keepdim=True) + \
            self.wide_dense(dense)
        deep_in = torch.cat([dense, self.embedding(sparse_ids)], dim=-1)
        deep_logit = self.deep(deep_in)
        return (wide_logit + deep_logit)[:, 0]  # [batch] logits


class DeepFM(Layer):
    """Factorization-machine + deep tower sharing one embedding table
    (the other canonical CTR model in the reference's PS examples)."""

    def __init__(self, num_dense: int = 13, num_slots: int = 26,
                 vocab_size: int = 1000 * 1000, embedding_dim: int = 16,
                 hidden: Sequence[int] = (128, 64)):
        super().__init__()
        self.first_order = MultiSlotEmbedding(vocab_size, 1,
                                              hash_ids=True)
        self.dense_w = nn.Linear(num_dense, 1)
        self.embedding = MultiSlotEmbedding(vocab_size, embedding_dim,
                                            hash_ids=True)
        self.num_slots = num_slots
        self.embedding_dim = embedding_dim
        self.deep = _deep_tower(num_dense + num_slots * embedding_dim,
                                hidden)

    def forward(self, dense, sparse_ids):
        b = dense.shape[0]
        first = self.first_order(sparse_ids).sum(-1, keepdim=True) + \
            self.dense_w(dense)
        flat = self.embedding(sparse_ids)            # [b, slots*dim]
        v = flat.reshape(b, self.num_slots, self.embedding_dim)
        # FM second order: 0.5 * ((Σv)² - Σv²)
        sum_sq = v.sum(dim=1) ** 2
        sq_sum = (v ** 2).sum(dim=1)
        second = 0.5 * (sum_sq - sq_sum).sum(-1, keepdim=True)
        deep = self.deep(torch.cat([dense, flat], dim=-1))
        return (first + second + deep)[:, 0]


class WideDeepHostTable(Layer):
    """WideDeep with both tables in HOST RAM: the parameter-server
    workload proper (ref: train_from_dataset over
    distributed_lookup_table, memory_sparse_table.h). Table capacity is
    bounded by host memory, not device memory: rows are pulled onto the
    card each batch and row gradients pushed back with a per-row
    accessor rule, so the device footprint is O(batch) whatever the
    vocabulary's size.

    Per-slot layout is preserved (the deep tower sees
    [dense | slot_0 emb | ... | slot_25 emb]) by looking up ids as
    [b*slots, 1] single-id bags — sum pooling over a bag of one is the
    identity, and the host gather vectorizes over the flattened batch
    the same way."""

    def __init__(self, num_dense: int = 13, num_slots: int = 26,
                 vocab_size: int = 100 * 1000 * 1000,
                 embedding_dim: int = 16,
                 hidden: Sequence[int] = (256, 128, 64),
                 optimizer: str = "adagrad", learning_rate: float = 0.05,
                 async_push: bool = False):
        super().__init__()
        from ..nn.layers.host_embedding import HostOffloadedEmbedding
        self.num_dense = num_dense
        self.num_slots = num_slots
        self.embedding_dim = embedding_dim
        kw = dict(hash_ids=True, optimizer=optimizer,
                  learning_rate=learning_rate, async_push=async_push)
        self.wide = HostOffloadedEmbedding(vocab_size, 1, **kw)
        self.wide_dense = nn.Linear(num_dense, 1)
        self.embedding = HostOffloadedEmbedding(vocab_size, embedding_dim,
                                                **kw)
        self.deep = _deep_tower(num_dense + num_slots * embedding_dim,
                                hidden)

    def forward(self, dense, sparse_ids):
        sparse_ids = torch.as_tensor(sparse_ids)
        b, k = sparse_ids.shape
        flat = sparse_ids.reshape(b * k, 1)
        wide_logit = self.wide(flat).reshape(b, k).sum(-1, keepdim=True) \
            + self.wide_dense(dense)
        emb = self.embedding(flat).reshape(b, k * self.embedding_dim)
        deep_logit = self.deep(torch.cat([dense, emb], dim=-1))
        return (wide_logit + deep_logit)[:, 0]


def synthetic_criteo(n: int = 1024, num_dense: int = 13,
                     num_slots: int = 26, vocab_size: int = 10000,
                     seed: int = 0):
    """Synthetic click data with learnable structure: the click
    probability depends on a few 'magic' feature ids and one dense
    column, so models can demonstrably fit it."""
    import numpy as np
    rs = np.random.RandomState(seed)
    dense = rs.randn(n, num_dense).astype(np.float32)
    sparse = rs.randint(1, vocab_size, (n, num_slots)).astype(np.int64)
    magic = (sparse[:, 0] % 5 == 0).astype(np.float32)
    logit = 2.0 * magic + dense[:, 0] - 0.5
    p = 1.0 / (1.0 + np.exp(-logit))
    labels = (rs.rand(n) < p).astype(np.float32)
    return dense, sparse, labels
