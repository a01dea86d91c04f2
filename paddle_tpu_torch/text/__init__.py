"""paddle_tpu_torch.text (the port's counterpart of ``paddle_tpu/text``;
ref: python/paddle/text/ — NLP datasets + ViterbiDecoder,
viterbi_decode.py).

The readers are the JAX package's numpy readers over local standard
formats. The decoder is CRF Viterbi decoding: one batched step a
position forward and one a position back, on the potentials' device
(the JAX package's ``lax.scan`` pair), with ``argmax`` ties at the first
index."""

from __future__ import annotations

import numpy as np
import torch

from ..core import device as _device
from ..nn.layer import Layer


def viterbi_decode(potentials, transitions, lengths=None,
                   include_bos_eos_tag: bool = False):
    """Most-likely tag path per sequence.

    potentials: [batch, seq, ntags] emission scores;
    transitions: [ntags, ntags] (transitions[i, j]: score of i -> j);
    lengths: [batch] valid lengths (default: full).
    include_bos_eos_tag: treat the last transition row (index n-1) as
    the start tag and the second-to-last row (n-2) as the stop tag, the
    reference kernel's convention (start added at t=0, stop added at
    each sequence's final step).
    Returns (scores [batch], paths [batch, seq]).
    ref: python/paddle/text/viterbi_decode.py ViterbiDecoder.
    """
    if not isinstance(potentials, torch.Tensor):
        potentials = torch.as_tensor(np.asarray(potentials),
                                     device=_device.current_device())
    dev = potentials.device
    transitions = torch.as_tensor(transitions, device=dev)
    b, s, n = potentials.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int64, device=dev)
    lengths = torch.as_tensor(lengths, device=dev).to(torch.int64)
    start_row = transitions[n - 1]        # [n]
    stop_row = transitions[n - 2]         # [n]
    tags = torch.arange(n, device=dev)[None, :]

    alpha = potentials[:, 0]
    if include_bos_eos_tag:
        alpha = alpha + start_row[None, :] + torch.where(
            (lengths == 1)[:, None], stop_row[None, :], 0.0)
    backps = []
    for t in range(1, s):
        # score[i, j] = alpha[i] + trans[i, j] + emit[j]
        scores = alpha[:, :, None] + transitions[None, :, :] + \
            potentials[:, t][:, None, :]
        best_prev = torch.argmax(scores, dim=1)              # [b, n]
        best_score = scores.amax(dim=1)
        active = (t < lengths)[:, None]    # frozen past the sequence end
        alpha = torch.where(active, best_score, alpha)
        if include_bos_eos_tag:
            last = (t == lengths - 1)[:, None]
            alpha = alpha + torch.where(last, stop_row[None, :], 0.0)
        backps.append(torch.where(active, best_prev, tags))
    scores = alpha.amax(dim=-1)
    tag = torch.argmax(alpha, dim=-1)                        # [b]
    path = [tag]
    for bp in reversed(backps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return scores, torch.stack(path[::-1], dim=1)


class ViterbiDecoder(Layer):
    """ref: paddle.text.ViterbiDecoder(transitions,
    include_bos_eos_tag)."""

    def __init__(self, transitions, include_bos_eos_tag: bool = False):
        super().__init__()
        self.transitions = torch.as_tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class UCIHousing:
    """ref: text/datasets pattern — placeholder reader for the classic
    regression set; reads the standard housing.data file locally."""

    def __init__(self, root: str, mode: str = "train"):
        import os
        p = os.path.join(root, "housing.data")
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found; place the standard UCI "
                "housing.data file there")
        data = np.loadtxt(p)
        x, y = data[:, :-1].astype(np.float32), data[:, -1:].astype(
            np.float32)
        n = int(0.8 * len(x))
        if mode == "train":
            self.x, self.y = x[:n], y[:n]
        else:
            self.x, self.y = x[n:], y[n:]

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def _build_word_idx(counts, min_freq: int, extra=("<unk>",)):
    """Frequency-cutoff vocab, deterministic order (-count, word); the
    literal special tokens are stripped from the corpus counts first so
    their appended ids stay in range (the reference deletes '<unk>'
    from word_freq the same way, text/datasets/imikolov.py)."""
    for tok in ("<unk>", "<s>", "<e>"):
        counts.pop(tok, None)
    vocab = [w for w, c in sorted(counts.items(),
                                  key=lambda t: (-t[1], t[0]))
             if c >= min_freq]
    word_idx = {w: i for i, w in enumerate(vocab)}
    for tok in extra:
        word_idx[tok] = len(word_idx)
    return word_idx


class Imikolov:
    """PTB-style n-gram language-model dataset (ref: text/datasets/
    imikolov.py — builds a word dict from train, yields n-grams).
    Reads the standard ptb.{train,valid}.txt files locally."""

    def __init__(self, root: str, data_type: str = "NGRAM", window_size:
                 int = 5, mode: str = "train", min_word_freq: int = 50):
        import collections
        import os
        train_p = os.path.join(root, "ptb.train.txt")
        path = os.path.join(
            root, "ptb.train.txt" if mode == "train" else
            "ptb.valid.txt")
        for p in {train_p, path}:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{p} not found; place the ptb text "
                    "files there")
        counts = collections.Counter()
        with open(train_p) as f:
            for line in f:
                counts.update(line.split())
        # sentinels live in the dict like the reference's word dict
        self.word_idx = _build_word_idx(
            counts, min_word_freq, extra=("<s>", "<e>", "<unk>"))
        unk = self.word_idx["<unk>"]
        self.data = []
        with open(path) as f:
            for line in f:
                ids = [self.word_idx.get(w, unk) for w in
                       ["<s>"] + line.split() + ["<e>"]]
                if data_type == "NGRAM":
                    for i in range(len(ids) - window_size + 1):
                        self.data.append(
                            np.asarray(ids[i:i + window_size],
                                       np.int64))
                else:  # SEQ
                    if len(ids) >= 2:
                        self.data.append(np.asarray(ids, np.int64))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i]


class Imdb:
    """IMDB sentiment (ref: text/datasets/imdb.py — aclImdb directory
    tree pos/neg of .txt reviews; builds a word dict, yields
    (ids, label))."""

    def __init__(self, root: str, mode: str = "train", cutoff: int = 150):
        import collections
        import os
        import re
        base = os.path.join(root, "aclImdb")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"{base} not found; place the extracted "
                "aclImdb tree there")
        tok = re.compile(r"[A-Za-z']+").findall

        def read(split, label):
            out = []
            d = os.path.join(base, split, label)
            for fn in sorted(os.listdir(d)):
                with open(os.path.join(d, fn), errors="ignore") as f:
                    out.append([w.lower() for w in tok(f.read())])
            return out

        train_pos = read("train", "pos")
        train_neg = read("train", "neg")
        counts = collections.Counter(
            w for doc in train_pos + train_neg for w in doc)
        self.word_idx = _build_word_idx(counts, cutoff)
        unk = self.word_idx["<unk>"]
        if mode == "train":  # vocab pass already read these files
            pos, neg = train_pos, train_neg
        else:
            pos, neg = read(mode, "pos"), read(mode, "neg")
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in d],
                                np.int64) for d in pos + neg]
        self.labels = np.asarray([0] * len(pos) + [1] * len(neg),
                                 np.int64)

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]


class Movielens:
    """MovieLens-1M ratings (ref: text/datasets/movielens.py — ::
    -separated users.dat/movies.dat/ratings.dat)."""

    def __init__(self, root: str, mode: str = "train",
                 test_ratio: float = 0.1, rand_seed: int = 0):
        import os
        base = root
        sub = os.path.join(root, "ml-1m")
        if os.path.isdir(sub):
            base = sub
        paths = {n: os.path.join(base, f"{n}.dat")
                 for n in ("users", "movies", "ratings")}
        for p in paths.values():
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{p} not found; place the ml-1m .dat "
                    "files there")

        def rows(p):
            with open(p, errors="ignore") as f:
                return [ln.rstrip("\n").split("::") for ln in f if ln.strip()]

        self.users = {int(r[0]): r[1:] for r in rows(paths["users"])}
        self.movies = {int(r[0]): r[1:] for r in rows(paths["movies"])}
        ratings = rows(paths["ratings"])
        rng_ = np.random.RandomState(rand_seed)
        mask = rng_.rand(len(ratings)) < test_ratio
        keep = mask if mode == "test" else ~mask
        self.data = [(int(u), int(m), float(s))
                     for (u, m, s, _), k in zip(ratings, keep) if k]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        u, m, s = self.data[i]
        return (np.int64(u), np.int64(m), np.float32(s))


class Conll05st:
    """CoNLL-2005 SRL dataset reader (ref: text/datasets/conll05.py —
    sentence/predicate/label columns). Reads the standard conll05st
    test file layout from ``root``: a whitespace-columns file
    ``conll05st.txt`` with word, predicate, and IOB label per line,
    blank line between sentences."""

    def __init__(self, root: str, mode: str = "test"):
        import os
        p = os.path.join(root, "conll05st.txt")
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"{p} not found; place the CoNLL-05 column file there")
        sents, cur = [], []
        for line in open(p):
            line = line.strip()
            if not line:
                if cur:
                    sents.append(cur)
                    cur = []
                continue
            cur.append(line.split())
        if cur:
            sents.append(cur)
        self.sentences = sents
        words = sorted({c[0] for s in sents for c in s})
        labels = sorted({c[-1] for s in sents for c in s})
        self.word_dict = {w: i for i, w in enumerate(words)}
        self.label_dict = {l: i for i, l in enumerate(labels)}
        # predicates are the column-1 lemmas; '-' (no predicate) gets
        # its own id so it can't collide with a real lemma's id
        lemmas = sorted({c[1] for s in sents for c in s
                         if len(c) > 2 and c[1] != "-"})
        self.predicate_dict = {w: i for i, w in enumerate(lemmas)}
        self._no_pred = len(self.predicate_dict)

    def __len__(self):
        return len(self.sentences)

    def __getitem__(self, i):
        s = self.sentences[i]
        words = np.asarray([self.word_dict[c[0]] for c in s])
        labels = np.asarray([self.label_dict[c[-1]] for c in s])
        pred = np.asarray([self.predicate_dict[c[1]]
                           if len(c) > 2 and c[1] != "-"
                           else self._no_pred for c in s])
        return words, pred, labels

    def get_dict(self):
        return self.word_dict, self.predicate_dict, self.label_dict


class _WMTBase:
    """Shared WMT parallel-corpus reader: ``root`` holds
    ``{split}.{src}`` / ``{split}.{tgt}`` line-aligned files; vocab is
    built from train with <s>/<e>/<unk> specials (ref:
    text/datasets/wmt14.py / wmt16.py BPE-tokenized readers)."""

    SRC, TGT = "en", "de"

    def __init__(self, root: str, mode: str = "train",
                 src_dict_size: int = 30000, trg_dict_size: int = 30000):
        import os
        sp = os.path.join(root, f"{mode}.{self.SRC}")
        tp = os.path.join(root, f"{mode}.{self.TGT}")
        for p in (sp, tp):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{p} not found; place line-aligned "
                    f"{self.SRC}/{self.TGT} files there")
        self.src_lines = [l.strip().split() for l in open(sp)]
        self.tgt_lines = [l.strip().split() for l in open(tp)]
        # vocab ALWAYS comes from the train split so ids agree across
        # modes (the reference builds one dict from train); fall back
        # to this split only when no train files exist
        from collections import Counter
        vs = os.path.join(root, f"train.{self.SRC}")
        vt = os.path.join(root, f"train.{self.TGT}")
        src_corpus = ([l.strip().split() for l in open(vs)]
                      if os.path.exists(vs) else self.src_lines)
        tgt_corpus = ([l.strip().split() for l in open(vt)]
                      if os.path.exists(vt) else self.tgt_lines)
        self.src_dict = self._vocab(Counter(
            w for l in src_corpus for w in l), src_dict_size)
        self.trg_dict = self._vocab(Counter(
            w for l in tgt_corpus for w in l), trg_dict_size)

    @staticmethod
    def _vocab(counts, size):
        vocab = {"<s>": 0, "<e>": 1, "<unk>": 2}
        for w, _ in counts.most_common(max(size - 3, 0)):
            vocab.setdefault(w, len(vocab))
        return vocab

    def _ids(self, words, vocab):
        unk = vocab["<unk>"]
        return np.asarray([vocab["<s>"]]
                          + [vocab.get(w, unk) for w in words]
                          + [vocab["<e>"]])

    def __len__(self):
        return len(self.src_lines)

    def __getitem__(self, i):
        src = self._ids(self.src_lines[i], self.src_dict)
        tgt = self._ids(self.tgt_lines[i], self.trg_dict)
        return src, tgt[:-1], tgt[1:]


class WMT14(_WMTBase):
    """WMT'14 en -> fr (ref: text/datasets/wmt14.py)."""

    SRC, TGT = "en", "fr"


class WMT16(_WMTBase):
    """WMT'16 en -> de (ref: text/datasets/wmt16.py)."""

    SRC, TGT = "en", "de"
