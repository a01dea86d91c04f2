"""Wire format + verification for cross-replica KV-page migration.

A ``kv_pages/v1`` payload carries a run of prefix-cache pages in chain
order: per page the raw K/V block bytes (quantized int8 + per-token-row
scales when the pool is quantized), the page's token chunk, its rolling
blake2b digest, and the parent digest that anchors it. The importer
trusts NONE of it: every page is re-verified on ingest by

- recomputing the rolling digest from (parent, tokens) and comparing —
  a page whose identity doesn't commit to its claimed history is
  rejected;
- checking chain anchoring — a page's parent must be the previous
  accepted page, the chain root, or a digest already resident on the
  importing replica (so a rejected page orphans everything behind it);
- a transport checksum (blake2b over the KV bytes) — flipped bits in
  flight reject the page rather than poisoning the pool;
- exact byte lengths against the importer's own pool geometry.

Rejection is per-page and non-fatal: the importer installs the verified
prefix run and reports the rest, and the router falls back to local
recompute for whatever didn't land. Quantization is deterministic,
so an honestly-exported page is byte-identical to the page the
importer would have computed locally — token identity of migrated vs
recomputed streams follows.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .prefix_cache import _SEED, chain_digest

FORMAT = "kv_pages/v1"


def _checksum(*parts: bytes) -> str:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p)
    return h.hexdigest()


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


def encode_page(digest: bytes, parent: bytes, tokens: Sequence[int],
                k: bytes, v: bytes,
                k_scales: bytes = b"", v_scales: bytes = b"") -> Dict:
    rec = {
        "digest": digest.hex(),
        "parent": parent.hex(),
        "tokens": [int(t) for t in tokens],
        "k": _b64(k),
        "v": _b64(v),
        "checksum": _checksum(k, v, k_scales, v_scales),
    }
    if k_scales or v_scales:
        rec["k_scales"] = _b64(k_scales)
        rec["v_scales"] = _b64(v_scales)
    return rec


def make_payload(pages: List[Dict], *, kv_dtype: str, page_size: int,
                 kv_shape: Sequence[int]) -> Dict:
    return {
        "format": FORMAT,
        "kv_dtype": kv_dtype,
        "page_size": int(page_size),
        "kv_shape": [int(x) for x in kv_shape],
        "pages": pages,
    }


class PageRecord:
    """One verified page, bytes decoded and ready to scatter."""

    __slots__ = ("digest", "tokens", "k", "v", "k_scales", "v_scales")

    def __init__(self, digest: bytes, tokens: Tuple[int, ...],
                 k: bytes, v: bytes, k_scales: bytes, v_scales: bytes):
        self.digest = digest
        self.tokens = tokens
        self.k = k
        self.v = v
        self.k_scales = k_scales
        self.v_scales = v_scales

    @property
    def nbytes(self) -> int:
        return (len(self.k) + len(self.v)
                + len(self.k_scales) + len(self.v_scales))


def verify_payload(payload: Dict, *, kv_dtype: str, page_size: int,
                   kv_shape: Sequence[int], kv_nbytes: int,
                   scale_nbytes: int,
                   resident: Callable[[bytes], bool],
                   ) -> Tuple[List[PageRecord], List[Dict]]:
    """Verify a ``kv_pages/v1`` payload against the importing pool's
    geometry. Returns ``(accepted, rejected)`` where rejected entries
    are ``{"digest": hex, "reason": str}``. Geometry mismatches
    (kv_dtype / page_size / shape) raise ValueError — the two pools
    cannot exchange pages at all, which is a deployment error, not a
    per-page fault.
    """
    if payload.get("format") != FORMAT:
        raise ValueError(f"unknown payload format {payload.get('format')!r}")
    if payload.get("kv_dtype") != kv_dtype:
        raise ValueError(
            f"kv_dtype mismatch: payload {payload.get('kv_dtype')!r} vs "
            f"pool {kv_dtype!r} — prefill and decode pools must share one "
            f"kv_dtype (see docs/RELIABILITY.md)")
    if int(payload.get("page_size", -1)) != int(page_size):
        raise ValueError(
            f"page_size mismatch: payload {payload.get('page_size')} vs "
            f"pool {page_size}")
    if [int(x) for x in payload.get("kv_shape", [])] != \
            [int(x) for x in kv_shape]:
        raise ValueError(
            f"kv_shape mismatch: payload {payload.get('kv_shape')} vs "
            f"pool {list(kv_shape)}")

    accepted: List[PageRecord] = []
    rejected: List[Dict] = []
    prev: Optional[bytes] = None

    def _reject(hex_digest: str, reason: str) -> None:
        rejected.append({"digest": hex_digest, "reason": reason})

    for rec in payload.get("pages", []):
        hx = str(rec.get("digest", ""))
        try:
            digest = bytes.fromhex(hx)
            parent = bytes.fromhex(rec.get("parent", ""))
            tokens = tuple(int(t) for t in rec.get("tokens", ()))
        except (ValueError, TypeError):
            _reject(hx, "malformed")
            prev = None
            continue
        if len(tokens) != page_size:
            _reject(hx, "bad_token_count")
            prev = None
            continue
        # identity: the digest must commit to (parent, tokens)
        if chain_digest(parent, tokens) != digest:
            _reject(hx, "digest_mismatch")
            prev = None
            continue
        # anchoring: parent is the previous accepted page, the chain
        # root, or already resident here — otherwise this page hangs
        # off a rejected/unknown ancestor and could never be matched
        if not (parent == _SEED or parent == prev or resident(parent)):
            _reject(hx, "orphan_parent")
            prev = None
            continue
        try:
            k = _unb64(rec["k"])
            v = _unb64(rec["v"])
            ks = _unb64(rec["k_scales"]) if "k_scales" in rec else b""
            vs = _unb64(rec["v_scales"]) if "v_scales" in rec else b""
        except (KeyError, ValueError, TypeError):
            _reject(hx, "malformed")
            prev = None
            continue
        if _checksum(k, v, ks, vs) != rec.get("checksum"):
            _reject(hx, "checksum_mismatch")
            prev = None
            continue
        if len(k) != kv_nbytes or len(v) != kv_nbytes or \
                len(ks) != scale_nbytes or len(vs) != scale_nbytes:
            _reject(hx, "bad_length")
            prev = None
            continue
        accepted.append(PageRecord(digest, tokens, k, v, ks, vs))
        prev = digest
    return accepted, rejected
