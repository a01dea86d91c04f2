"""Tree index for tree-based deep match (TDM) retrieval (the port's
counterpart of ``paddle_tpu/distributed/index_dataset.py``): items are
the leaves of a complete ``branch``-ary tree, training samples each
layer's ancestor as a positive and same-layer nodes as negatives, and a
beam search over the tree replaces a full softmax at serving.

Numpy only, a copy of the JAX package's module: the code scheme (root
code 0; the children of code c are ``c * branch + 1`` to ``c * branch +
branch``; the parent of c is ``(c - 1) // branch``; ancestors get ids
after the largest item id) and the seeded negative sampling
(``np.random.RandomState(seed).choice`` without replacement, layer by
layer) are the JAX package's, so that both give the same samples
element for element.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class TreeNode:
    """Node view (ref: IndexNode — id/code accessors)."""

    __slots__ = ("_id", "_code", "_is_leaf")

    def __init__(self, node_id: int, code: int, is_leaf: bool):
        self._id = int(node_id)
        self._code = int(code)
        self._is_leaf = bool(is_leaf)

    def id(self):
        return self._id

    def code(self):
        return self._code

    def is_leaf(self):
        return self._is_leaf

    def __repr__(self):
        return (f"TreeNode(id={self._id}, code={self._code}, "
                f"leaf={self._is_leaf})")


class Index:
    def __init__(self, name: str):
        self._name = name


class TreeIndex(Index):
    """ref API: TreeIndex(name, path) — here ``path`` is an .npz this
    class's :meth:`save` writes; build fresh trees with
    :meth:`from_items` (catalog order) or :meth:`from_embeddings`
    (balanced recursive spectral split, the offline tree-learner's
    role)."""

    def __init__(self, name: str, path: Optional[str] = None):
        super().__init__(name)
        self._layerwise_sampler = None
        if path is not None:
            data = np.load(path)
            self._init_from(data["codes"], data["ids"],
                            int(data["branch"]))

    # -- construction ------------------------------------------------------
    def _init_from(self, codes, ids, branch: int):
        self._codes = np.asarray(codes, np.int64)      # leaf codes
        self._ids = np.asarray(ids, np.int64)          # leaf item ids
        self._branch = int(branch)
        # level of a code: number of parent steps to reach the root
        def level_of(c):
            lv = 0
            while c > 0:
                c = (c - 1) // branch
                lv += 1
            return lv
        self._height = max(level_of(int(c)) for c in self._codes) + 1
        self._id_by_code: Dict[int, int] = {}
        self._code_by_id: Dict[int, int] = {}
        for c, i in zip(self._codes.tolist(), self._ids.tolist()):
            self._id_by_code[c] = i
            self._code_by_id[i] = c
        # ancestor codes get synthetic ids after the max item id
        # (the reference's tree protos carry explicit ancestor ids;
        # deterministic assignment keeps embedding tables stable)
        next_id = int(self._ids.max()) + 1 if len(self._ids) else 0
        anc = set()
        for c in self._codes.tolist():
            c = (c - 1) // branch
            while c >= 0 and c not in anc:
                anc.add(c)
                if c == 0:
                    break
                c = (c - 1) // branch
        for c in sorted(anc):
            if c not in self._id_by_code:
                self._id_by_code[c] = next_id
                next_id += 1
        self._total = len(self._id_by_code)
        self._max_id = next_id
        self._codes_by_level: Dict[int, np.ndarray] = {}
        by_level: Dict[int, list] = {}
        for c in self._id_by_code:
            by_level.setdefault(level_of(c), []).append(c)
        for lv, cs in by_level.items():
            self._codes_by_level[lv] = np.asarray(sorted(cs), np.int64)

    @classmethod
    def from_items(cls, name: str, item_ids: Sequence[int],
                   branch: int = 2) -> "TreeIndex":
        """Complete tree over the catalog in the given order."""
        n = len(item_ids)
        if n == 0:
            raise ValueError("empty catalog")
        if branch < 2:
            raise ValueError(f"branch must be >= 2, got {branch}")
        height = 1
        while branch ** (height - 1) < n:
            height += 1
        first = (branch ** (height - 1) - 1) // (branch - 1)
        codes = np.arange(first, first + n, dtype=np.int64)
        idx = cls(name)
        idx._init_from(codes, np.asarray(item_ids, np.int64), branch)
        return idx

    @classmethod
    def from_embeddings(cls, name: str, item_ids: Sequence[int],
                        embeddings, branch: int = 2) -> "TreeIndex":
        """Balanced recursive split on the principal direction — the
        offline tree-learning step (similar items share subtrees, which
        is what makes beam search over the tree accurate)."""
        embs = np.asarray(embeddings, np.float64)
        order = np.arange(len(item_ids))

        def split(idxs):
            if len(idxs) <= 1:
                return [idxs]
            x = embs[idxs] - embs[idxs].mean(0)
            # power iteration for the top principal direction
            v = np.ones(x.shape[1]) / np.sqrt(x.shape[1])
            for _ in range(10):
                v = x.T @ (x @ v)
                nv = np.linalg.norm(v)
                if nv < 1e-12:
                    break
                v = v / nv
            proj = x @ v
            srt = idxs[np.argsort(proj, kind="stable")]
            return np.array_split(srt, branch)

        frontier = [order]
        while max(len(f) for f in frontier) > 1:
            nxt = []
            for f in frontier:
                nxt.extend(split(f) if len(f) > 1 else [f])
            frontier = nxt
        leaf_order = [int(f[0]) for f in frontier if len(f)]
        ids = np.asarray(item_ids, np.int64)[leaf_order]
        return cls.from_items(name, ids, branch)

    def save(self, path: str) -> None:
        np.savez(path, codes=self._codes, ids=self._ids,
                 branch=self._branch)

    # -- reference accessors ------------------------------------------------
    def height(self):
        return self._height

    def branch(self):
        return self._branch

    def total_node_nums(self):
        return self._total

    def emb_size(self):
        """Size of the node-embedding table (max node id + 1)."""
        return self._max_id

    def get_all_leafs(self) -> List[TreeNode]:
        return [TreeNode(i, c, True)
                for c, i in zip(self._codes, self._ids)]

    def get_nodes(self, codes) -> List[TreeNode]:
        leaf = set(self._codes.tolist())
        return [TreeNode(self._id_by_code[int(c)], int(c),
                         int(c) in leaf) for c in codes]

    def get_layer_codes(self, level):
        return self._codes_by_level.get(int(level),
                                        np.empty(0, np.int64)).copy()

    def get_travel_codes(self, id, start_level: int = 0):  # noqa: A002
        """Leaf-to-root ancestor codes of item ``id``, stopping at
        ``start_level`` (root=0) — the per-item positive path."""
        c = self._code_by_id[int(id)]
        out = []
        while True:
            lv = self._level_of(c)
            if lv < start_level:
                break
            out.append(c)
            if c == 0:
                break
            c = (c - 1) // self._branch
        return out

    def _level_of(self, c: int) -> int:
        lv = 0
        while c > 0:
            c = (c - 1) // self._branch
            lv += 1
        return lv

    def get_ancestor_codes(self, ids, level):
        out = []
        for i in ids:
            c = self._code_by_id[int(i)]
            while self._level_of(c) > level:
                c = (c - 1) // self._branch
            out.append(c)
        return out

    def get_children_codes(self, ancestor, level):
        cs = [int(ancestor)]
        while cs and self._level_of(cs[0]) < level:
            cs = [c * self._branch + k + 1
                  for c in cs for k in range(self._branch)]
        return [c for c in cs if c in self._id_by_code]

    def get_travel_path(self, child, ancestor):
        res = []
        while child > ancestor:
            res.append(child)
            child = (child - 1) // self._branch
        return res

    def get_pi_relation(self, ids, level):
        codes = self.get_ancestor_codes(ids, level)
        return dict(zip([int(i) for i in ids], codes))

    # -- layerwise sampler (ref: core.IndexSampler "by_layerwise") ----------
    def init_layerwise_sampler(self, layer_sample_counts,
                               start_sample_layer: int = 1,
                               seed: int = 0):
        assert self._layerwise_sampler is None
        self._layerwise_sampler = LayerwiseSampler(
            self, layer_sample_counts, start_sample_layer, seed)

    def layerwise_sample(self, user_input, index_input,
                         with_hierarchy: bool = False):
        if self._layerwise_sampler is None:
            raise ValueError("please init layerwise_sampler first.")
        return self._layerwise_sampler.sample(user_input, index_input,
                                              with_hierarchy)


class LayerwiseSampler:
    """Per-layer positive + uniform same-layer negatives
    (ref: index_sampler.h LayerWiseSampler::sample). ``sample``
    returns the reference's ragged row format; ``sample_arrays``
    returns fixed-shape numpy blocks for a jitted step."""

    def __init__(self, tree: TreeIndex, layer_sample_counts,
                 start_sample_layer: int = 1, seed: int = 0):
        self.tree = tree
        self.start = int(start_sample_layer)
        self.counts = list(layer_sample_counts)
        want = tree.height() - self.start
        if len(self.counts) != want:
            raise ValueError(
                f"layer_sample_counts has {len(self.counts)} entries; "
                f"tree height {tree.height()} with start layer "
                f"{self.start} needs {want}")
        self.rng = np.random.RandomState(seed)

    def sample(self, user_input, index_input, with_hierarchy=False):
        """For each (user_feats, item): one positive row per layer
        ([*user, node_id, 1]) + counts[layer] negative rows
        ([*user, neg_id, 0]). ``with_hierarchy`` swaps the user's own
        history item ids for their same-layer ancestors, like the
        reference."""
        out = []
        tree = self.tree
        for user, item in zip(user_input, index_input):
            user = list(user)
            path = tree.get_travel_codes(int(item), self.start)
            for j, code in enumerate(reversed(path)):  # top-down
                level = self.start + j
                u = user
                if with_hierarchy:
                    u = [tree._id_by_code[c] for c in
                         tree.get_ancestor_codes(user, level)] \
                        if all(int(x) in tree._code_by_id
                               for x in user) else user
                pos_id = tree._id_by_code[code]
                out.append([*u, pos_id, 1])
                layer = tree.get_layer_codes(level)
                layer = layer[layer != code]
                k = min(self.counts[j], len(layer))
                for c in self.rng.choice(layer, size=k, replace=False):
                    out.append([*u, tree._id_by_code[int(c)], 0])
        return out

    def sample_arrays(self, items):
        """Vectorized fixed-shape form: for items [B] returns
        (node_ids [B, L, 1+max_count], labels [B, L, 1+max_count],
        mask) with L = sampled layers — static shapes for jit; slot 0
        is the positive. Layers with fewer candidates than requested
        pad (mask 0)."""
        tree = self.tree
        items = np.asarray(items)
        L = len(self.counts)
        width = 1 + max(self.counts)
        ids = np.zeros((len(items), L, width), np.int64)
        labels = np.zeros((len(items), L, width), np.int64)
        mask = np.zeros((len(items), L, width), np.bool_)
        labels[:, :, 0] = 1
        for b, item in enumerate(items):
            path = list(reversed(
                tree.get_travel_codes(int(item), self.start)))
            for j, code in enumerate(path):
                level = self.start + j
                ids[b, j, 0] = tree._id_by_code[code]
                mask[b, j, 0] = True
                layer = tree.get_layer_codes(level)
                layer = layer[layer != code]
                k = min(self.counts[j], len(layer))
                if k:
                    neg = self.rng.choice(layer, size=k, replace=False)
                    ids[b, j, 1:1 + k] = [tree._id_by_code[int(c)]
                                          for c in neg]
                    mask[b, j, 1:1 + k] = True
        return ids, labels, mask
