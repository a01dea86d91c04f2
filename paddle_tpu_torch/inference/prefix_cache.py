"""Hash-based prefix cache over a paged KV pool (host control plane).

The serving observation (vLLM's automatic prefix caching; the paged-KV
formulation PAPERS.md "Ragged Paged Attention" evaluates against): many
requests share a long prompt prefix — a system prompt, few-shot
examples, a conversation so far. Their KV for those tokens is
IDENTICAL, so recomputing it per request is pure waste. This module
keys full KV pages by a rolling hash of their token chunk so a new
request whose prompt prefix matches cached pages maps them into its
block table read-only and prefills only the uncached suffix.

Sharing rules (what keeps this exact):

- Only FULL pages are ever shared, and a shared page is IMMUTABLE: the
  matched prefix is page-aligned, so every write a sequence performs
  (suffix prefill, decode) lands at positions >= the matched length,
  i.e. in its own private pages. A request that diverges mid-page
  simply misses that page's hash and computes a private copy — the
  copy-on-write of this design happens at page granularity, on the
  write side, before any write occurs.
- The matched prefix is capped at the last FULL page <= len(prompt)-1
  tokens, so at least one real prompt token is always computed — the
  engine needs the final prompt position's logits to sample the first
  output token.
- Refcounts count LIVE sequences mapping a page. A page at refcount 0
  stays cached (its KV remains valid in the pool) on an LRU list;
  allocation pressure evicts LRU refcount-zero pages back to the free
  pool. Pages mapped by a live sequence (ref > 0) are never evicted.
- Keys are rolling BLAKE2b digests (parent digest ++ page tokens), so
  a page's key commits to the ENTIRE token history through it, not
  just its own chunk. An evicted parent orphans no one: a descendant's
  digest can only be matched through a walk that re-hashes the same
  history, and the walk stops at the first miss.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

_SEED = b"\x00" * 16


def chain_digest(parent: bytes, chunk: Sequence[int]) -> bytes:
    """One rolling step: digest of ``chunk`` appended to the history
    committed by ``parent`` (``_SEED`` for the root page)."""
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(",".join(map(str, chunk)).encode())
    return h.digest()


def page_digests(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Rolling digests of every FULL page of ``tokens``: digest i
    commits to tokens[0 : (i+1)*page_size]."""
    out: List[bytes] = []
    d = _SEED
    for i in range(len(tokens) // page_size):
        d = chain_digest(d, tokens[i * page_size:(i + 1) * page_size])
        out.append(d)
    return out


class PrefixCache:
    """Digest -> page-id map with live refcounts and an LRU of
    refcount-zero (evictable) pages. Pure host state: the pages
    themselves live in the engine's device pool; this class only
    decides which page ids are shared, reusable, or reclaimable."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self._by_key: Dict[bytes, int] = {}
        self._key_of: Dict[int, bytes] = {}
        self._refs: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # export surface: the token chunk behind each shared digest, so
        # a page is serializable (digest chain re-derivable) without the
        # original prompt in hand
        self._tokens: Dict[bytes, Tuple[int, ...]] = {}
        # pages installed by import_pages (subset of shared pages);
        # drives the memory ledger's "migrated" row
        self._migrated: set = set()
        # cumulative accounting (engine metrics read these)
        self.n_evicted = 0
        self.n_imported = 0

    # -- queries --------------------------------------------------------
    def lookup(self, digests: Sequence[bytes]) -> List[int]:
        """Longest cached prefix run of ``digests`` -> page ids. Pure
        peek: takes no references (call :meth:`acquire` to commit)."""
        pages: List[int] = []
        for d in digests:
            page = self._by_key.get(d)
            if page is None:
                break
            pages.append(page)
        return pages

    def is_shared(self, page: int) -> bool:
        return page in self._key_of

    def is_evictable(self, page: int) -> bool:
        return page in self._lru

    def page_of(self, digest: bytes) -> Optional[int]:
        return self._by_key.get(digest)

    def tokens_of(self, digest: bytes) -> Optional[Tuple[int, ...]]:
        return self._tokens.get(digest)

    @property
    def shared_page_count(self) -> int:
        return len(self._key_of)

    @property
    def evictable_count(self) -> int:
        return len(self._lru)

    @property
    def migrated_page_count(self) -> int:
        return len(self._migrated)

    # -- reference lifecycle --------------------------------------------
    def acquire(self, page: int) -> None:
        """A live sequence maps ``page``; it leaves the evictable set."""
        self._refs[page] = self._refs.get(page, 0) + 1
        self._lru.pop(page, None)

    def release(self, page: int) -> None:
        """A live sequence unmapped ``page``. At refcount zero the page
        stays cached but becomes evictable (tail of the LRU)."""
        r = self._refs[page] - 1
        if r == 0:
            del self._refs[page]
            self._lru[page] = None
        else:
            self._refs[page] = r

    def register(self, digest: bytes, page: int,
                 tokens: Optional[Sequence[int]] = None) -> bool:
        """Promote a private, fully-written page to shared under
        ``digest``, holding one reference for the owning sequence.
        ``tokens`` (the page's token chunk) makes the page exportable.
        Returns False (page stays private) if the digest is already
        cached — e.g. two identical prompts prefilled concurrently."""
        if digest in self._by_key:
            return False
        self._by_key[digest] = page
        self._key_of[page] = digest
        self._refs[page] = self._refs.get(page, 0) + 1
        if tokens is not None:
            self._tokens[digest] = tuple(tokens)
        return True

    def register_imported(self, digest: bytes, page: int,
                          tokens: Sequence[int]) -> None:
        """Install a migrated page as a shared, refcount-ZERO resident:
        no live sequence maps it yet, so it lands straight on the LRU
        tail (evictable under pressure like any cold shared page).
        Caller has already verified the digest chain and written the
        page's KV into the pool."""
        assert digest not in self._by_key, "duplicate import"
        self._by_key[digest] = page
        self._key_of[page] = digest
        self._tokens[digest] = tuple(tokens)
        self._lru[page] = None
        self._migrated.add(page)
        self.n_imported += 1

    # -- reclamation ----------------------------------------------------
    def evict_one(self) -> int:
        """Reclaim the least-recently-freed refcount-zero page for the
        allocator; raises KeyError when nothing is evictable."""
        page, _ = self._lru.popitem(last=False)
        digest = self._key_of.pop(page)
        del self._by_key[digest]
        self._tokens.pop(digest, None)
        self._migrated.discard(page)
        self.n_evicted += 1
        return page

    def flush(self) -> List[int]:
        """Drop every evictable entry (engine close / cache reset) and
        return the reclaimed page ids. Pages still referenced by live
        sequences are untouched."""
        out = []
        while self._lru:
            out.append(self.evict_one())
        return out
