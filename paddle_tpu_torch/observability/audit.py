"""Stream-integrity auditor: every token stream carries a verifiable
digest, and the fleet proves its own determinism in production.

The serving stack's correctness story rests on "token-identical"
claims — nonce-pinned failover and device-retry, cross-replica
KV-page migration, int8 quantization, on-device speculative rounds —
but each one is pinned only in tests. In production a silently
divergent replica (a mismatched draft config, a mixed-kv_dtype
sibling, a bad import that slipped past a checksum) would serve wrong
tokens with zero signal. This module turns the claim into a live
invariant:

CHAIN. Each request carries a rolling blake2b digest chain over
``(nonce, position, token_id)``: ``chain_i = blake2b(chain_{i-1} ||
nonce || i || token_i)``. The engine extends it at the existing drain
boundary (``_deliver_token`` — the token is already on the host, so
the extension costs one hash and ZERO extra device syncs) and returns
the final head as ``stream_digest`` in the result dict. Because the
nonce and position fold into every link, two chains agree iff the two
token streams are identical — and the FIRST differing link is the
first differing token.

VERIFICATION. Wherever the codebase claims identity, the chain is
checked:

- device-retry (engine): a retry re-admitted after a device error
  must re-emit the exact prefix the failed incarnation delivered.
  The engine snapshots the pre-retry tokens+chain and diffs once the
  regenerated stream covers them (``kind="failover"``).
- failover (router): a nonce-pinned cross-replica retry's result is
  integrity-checked (chain recomputed from the returned tokens must
  equal the replica-claimed ``stream_digest``), its engine-knob
  fingerprint is compared against the failed sibling's (a mismatched
  kv_dtype / draft config sibling is a DETECTED divergence, not a
  doc caveat), and any prefix recorded from the failed attempt must
  be extended exactly (``kind="failover"``).
- migration (router): a migrated-pages decode must produce the same
  chain a local recompute would. The prefill fill is a one-token
  generate under the request's own nonce, so its ``stream_digest``
  IS the expected chain at position 0 — the decode stream must
  extend it (``kind="migration"``).
- shadow (router): at ``FLAGS.audit_shadow_rate``, a verified result
  is re-executed OFF-PATH on the same replica under the same nonce
  and the chains diffed link by link (``kind="shadow"``). Sampling
  is a deterministic hash of the nonce, so a replayed seed shadows
  the same requests.

SURFACES. Per-scope chain tables on ``GET /driftz`` (verified /
diverged counts, last divergence with the first divergent position
and both chain heads); ``drift_verified_total`` /
``drift_divergence_total{kind}`` counters, minted at FIRST record so
a never-armed process exports neither and fleet federation reads the
absence as a HOLE (``fleet_drift_*``, the fleet_mfu semantics); any
divergence fires a ONE-SHOT flight dump carrying both streams'
digests, the divergent position, both sides' engine-knob
fingerprints, and (via the recorder's span ring) the request's span
tree.

Disabled cost is ONE module-flag check (``FLAGS.stream_audit``, the
tracing/perf/memory/goodput discipline) — and the chain is pure host
arithmetic, so the flag adds ZERO ops to any compiled program
(HLO-pinned in tests/test_audit.py).
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core import flags as _flags

# one chain link = 16 bytes; hex heads are 32 chars in payloads
DIGEST_SIZE = 16

# divergence taxonomy — every drift_divergence_total{kind} value
KINDS = ("failover", "migration", "shadow")

# -- enable flag (pinned: one module-bool check on the drain path) ---------

_ENABLED = bool(_flags.get_flag("stream_audit"))


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def shadow_rate() -> float:
    """The sampled shadow re-execution rate (FLAGS.audit_shadow_rate,
    read live so a router can be re-rated without a restart)."""
    try:
        return float(_flags.get_flag("audit_shadow_rate"))
    except Exception:  # noqa: BLE001 — a missing flag means no shadows
        return 0.0


# -- chain math ------------------------------------------------------------

def extend(chain: bytes, nonce: int, position: int,
           token_id: int) -> bytes:
    """One link: fold (nonce, position, token_id) into the rolling
    chain. Genesis is ``b""`` — an empty stream's head is the empty
    string (rendered ``""`` in payloads)."""
    h = hashlib.blake2b(chain, digest_size=DIGEST_SIZE)
    h.update(int(nonce).to_bytes(8, "little", signed=True))
    h.update(int(position).to_bytes(8, "little", signed=True))
    h.update(int(token_id).to_bytes(8, "little", signed=True))
    return h.digest()


def chain_of(nonce: int, token_ids: Sequence[int],
             chain: bytes = b"", start: int = 0) -> bytes:
    """Fold a whole stream (or a suffix starting at ``start`` on top
    of an existing ``chain``) into its head."""
    for i, tok in enumerate(token_ids):
        chain = extend(chain, nonce, start + i, int(tok))
    return chain


def heads_of(nonce: int, token_ids: Sequence[int]) -> List[bytes]:
    """The chain head after every position — ``heads_of(n, t)[i] ==
    chain_of(n, t[:i+1])`` (the per-position witnesses a divergence
    report quotes)."""
    out: List[bytes] = []
    chain = b""
    for i, tok in enumerate(token_ids):
        chain = extend(chain, nonce, i, int(tok))
        out.append(chain)
    return out


def verify_prefix(nonce: int, token_ids: Sequence[int],
                  prefix_chain: bytes, prefix_len: int) -> bool:
    """Does this stream extend the exact chain prefix a prior
    incarnation emitted? True iff the first ``prefix_len`` tokens
    fold to ``prefix_chain``."""
    if prefix_len < 0 or prefix_len > len(token_ids):
        return False
    if prefix_len == 0:
        return prefix_chain == b""
    return chain_of(nonce, token_ids[:prefix_len]) == prefix_chain


def first_divergence(tokens_a: Sequence[int],
                     tokens_b: Sequence[int]) -> Optional[int]:
    """First position whose chain links differ between two streams
    under the same nonce, or None when one chain is an exact prefix
    of the other. Because every link folds its position and token,
    the first chain divergence IS the first token mismatch — a
    length difference diverges at the shorter stream's end."""
    n = min(len(tokens_a), len(tokens_b))
    for i in range(n):
        if int(tokens_a[i]) != int(tokens_b[i]):
            return i
    return n if len(tokens_a) != len(tokens_b) else None


def sampled(nonce: int, rate: float) -> bool:
    """Deterministic shadow sampling: a pure hash of the nonce, so a
    replayed fleet (same seed, same nonces) shadows the SAME
    requests — the fault-schedule replayability discipline."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = hashlib.blake2b(b"audit.shadow" +
                        int(nonce).to_bytes(8, "little", signed=True),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") < rate * 2.0 ** 64


# -- the drift table -------------------------------------------------------

class DriftTable:
    """Per-scope verification ledger. A scope is the entity whose
    streams are being audited — the router keys by replica name, a
    replica process by its engine. Thread-safe; reads are snapshots.

    ``record`` is the ONE entry point: it counts the verdict, mints
    the process drift counters on first use (hole-not-zero: a
    never-armed process exports no drift_* series), remembers the
    last divergence per scope (first divergent position + both chain
    heads), and fires a ONE-SHOT ``stream_divergence`` flight dump
    carrying both sides' digests and engine-knob fingerprints."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._scopes: Dict[str, dict] = {}
        self._armed = False

    # metrics + /driftz provider mint lazily, OUTSIDE the lock path
    def _arm(self) -> None:
        if self._armed:
            return
        self._armed = True
        _mint_metrics()
        _register_provider()

    def _scope(self, name: str) -> dict:
        sc = self._scopes.get(name)
        if sc is None:
            sc = {"verified": 0, "diverged": 0,
                  "by_kind": {k: 0 for k in KINDS},
                  "last_divergence": None}
            self._scopes[name] = sc
        return sc

    def record(self, scope: str, kind: str, ok: bool, *,
               position: Optional[int] = None,
               chain_ours: Optional[bytes] = None,
               chain_theirs: Optional[bytes] = None,
               request_id=None, nonce: Optional[int] = None,
               knobs_ours: Optional[dict] = None,
               knobs_theirs: Optional[dict] = None,
               detail: str = "") -> Optional[dict]:
        """Count one verification verdict. Returns the divergence
        record (also stored as the scope's ``last_divergence``) on a
        failed check, None on a verified one."""
        if kind not in KINDS:
            raise ValueError(f"unknown drift kind {kind!r}; "
                             f"expected one of {KINDS}")
        self._arm()
        if ok:
            with self._mu:
                self._scope(scope)["verified"] += 1
            m = _metrics()
            if m is not None:
                m["verified"].inc()
            return None
        div = {
            "ts": round(time.time(), 3),
            "scope": scope,
            "kind": kind,
            "request_id": request_id,
            "nonce": nonce,
            "position": position,
            "chain_ours": (chain_ours.hex()
                           if isinstance(chain_ours, bytes)
                           else chain_ours),
            "chain_theirs": (chain_theirs.hex()
                             if isinstance(chain_theirs, bytes)
                             else chain_theirs),
            "knobs_ours": knobs_ours,
            "knobs_theirs": knobs_theirs,
            "detail": detail,
        }
        with self._mu:
            sc = self._scope(scope)
            sc["diverged"] += 1
            sc["by_kind"][kind] += 1
            sc["last_divergence"] = div
        m = _metrics()
        if m is not None:
            m["diverged"].labels(kind).inc()
        # forensics: ONE dump per process (dedupe) carrying both
        # digests, the position, and both knob fingerprints; the
        # recorder's span ring brings the request's span tree along.
        # Nested under "divergence" so the record's own "kind" (the
        # claim) can't shadow the dump row's kind="extra" tag.
        from . import flight as _flight
        _flight.dump_flight_record("stream_divergence",
                                   extra={"divergence": div},
                                   dedupe=True)
        return div

    def payload(self) -> dict:
        """The /driftz body: per-scope tables + process totals."""
        with self._mu:
            scopes = {
                name: {"verified": sc["verified"],
                       "diverged": sc["diverged"],
                       "by_kind": dict(sc["by_kind"]),
                       "last_divergence": sc["last_divergence"]}
                for name, sc in sorted(self._scopes.items())}
        totals = {
            "verified": sum(s["verified"] for s in scopes.values()),
            "diverged": sum(s["diverged"] for s in scopes.values()),
        }
        return {"enabled": _ENABLED, "shadow_rate": shadow_rate(),
                "kinds": list(KINDS), "totals": totals,
                "scopes": scopes}

    def counts(self) -> dict:
        """Cheap (verified, diverged) totals for /statusz rows."""
        with self._mu:
            return {
                "verified": sum(s["verified"]
                                for s in self._scopes.values()),
                "diverged": sum(s["diverged"]
                                for s in self._scopes.values()),
            }


# -- process singleton + metric minting ------------------------------------

_TABLE = DriftTable()
_M: Optional[dict] = None
_PROVIDER_REGISTERED = False


def instance() -> DriftTable:
    return _TABLE


def record(scope: str, kind: str, ok: bool, **kw) -> Optional[dict]:
    """Module-level convenience over the process drift table."""
    return _TABLE.record(scope, kind, ok, **kw)


def driftz_payload() -> dict:
    return _TABLE.payload()


def _mint_metrics() -> None:
    """Mint drift_* counters at FIRST record (never at import): a
    process that never verified a stream exports no drift series, so
    the fleet scraper reads a missing replica/feature as a HOLE in
    fleet_drift_*, never a zero."""
    global _M
    if _M is not None:
        return
    from .metrics import default_registry
    reg = default_registry()
    _M = {
        "verified": reg.counter(
            "drift_verified_total",
            "Stream-integrity checks that confirmed chain identity "
            "(failover prefix extension, migration chain parity, "
            "shadow re-execution agreement)."),
        "diverged": reg.counter(
            "drift_divergence_total",
            "Stream-integrity checks that found a divergent chain, "
            "by claim kind. ANY nonzero value is a determinism "
            "incident; the paired stream_divergence flight dump "
            "carries the forensics.", label_names=("kind",)),
    }


def _metrics() -> Optional[dict]:
    return _M


def _register_provider() -> None:
    """Self-register the /driftz provider on the process debug-server
    registry (lazy import — server.py must stay importable without
    this module being armed)."""
    global _PROVIDER_REGISTERED
    if _PROVIDER_REGISTERED:
        return
    _PROVIDER_REGISTERED = True
    from . import server as _server
    _server.register_drift_provider("audit", driftz_payload)


def reset() -> None:
    """Test hook: drop the table, counters, and provider registration
    so a fresh test starts hole-not-zero again."""
    global _TABLE, _M, _PROVIDER_REGISTERED
    _TABLE = DriftTable()
    if _M is not None:
        from .metrics import default_registry
        reg = default_registry()
        reg.unregister("drift_verified_total")
        reg.unregister("drift_divergence_total")
        _M = None
    if _PROVIDER_REGISTERED:
        from . import server as _server
        _server.unregister_drift_provider("audit")
        _PROVIDER_REGISTERED = False
