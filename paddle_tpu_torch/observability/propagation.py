"""Cross-process trace propagation: W3C-``traceparent`` inject/extract.

Every process has a span table; a fleet puts a router in front of K
replica processes — and made each request's story split in two: a
``router.request``/``router.dispatch`` tree in the router and an
``llm.request`` tree in the replica, with nothing tying them together.
This module is the missing edge: the router injects its dispatch
span's identity into an HTTP header, the replica extracts it and roots
its request tree UNDER the remote parent, and the whole fleet shares
one ``trace_id`` per request (``tools/trace_merge.py`` then lines the
tables up on one timeline).

The wire format is the W3C Trace Context ``traceparent`` header::

    traceparent: 00-<32 hex trace-id>-<16 hex parent span-id>-<2 hex flags>

Design rules, in order of importance:

- **Extraction never raises and never rejects a request.** A
  malformed, truncated, or future-versioned header degrades to "no
  remote parent" (the replica roots its own trace) — observability
  must not add a 4xx the serving path didn't have.
- **Disabled tracing on either side degrades cleanly.** A disabled
  sender injects nothing (``format_traceparent`` maps the shared noop
  span's empty ids to ``None``); a disabled receiver ignores the
  header (``start_span`` already returns the noop). Neither side can
  mint an orphan parent link.
- **Stdlib-only**, like the rest of the observability layer.

``tracing`` mints ids at exactly the W3C field widths (32-hex trace,
16-hex span), so inject/extract round-trips ids byte-identically;
foreign ids of other widths are zero-padded on inject and accepted
as-is on extract.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .tracing import Span, SpanContext, current_span

# the canonical header name (HTTP headers are case-insensitive; we
# send lowercase, we accept any case)
TRACEPARENT_HEADER = "traceparent"
_VERSION = "00"
_HEX = set("0123456789abcdef")


def _is_hex(s: str) -> bool:
    return bool(s) and set(s) <= _HEX


def format_traceparent(context) -> Optional[str]:
    """Render a Span/SpanContext as a ``traceparent`` value, or
    ``None`` when the context carries no usable identity (noop span
    while tracing is disabled, empty ids) — callers skip the header
    entirely rather than sending a lie."""
    trace_id = str(getattr(context, "trace_id", "") or "").lower()
    span_id = str(getattr(context, "span_id", "") or "").lower()
    if not (_is_hex(trace_id) and _is_hex(span_id)):
        return None
    trace_id = trace_id[-32:].zfill(32)
    span_id = span_id[-16:].zfill(16)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return f"{_VERSION}-{trace_id}-{span_id}-01"


def parse_traceparent(value) -> Optional[SpanContext]:
    """Parse a ``traceparent`` value into a :class:`SpanContext`.
    Anything malformed returns ``None`` — never raises, never 400s."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    # ≥ 4 parts: future versions may append fields; version 'ff' is
    # explicitly invalid per spec
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not _is_hex(version) or version == "ff":
        return None
    if len(trace_id) != 32 or not _is_hex(trace_id):
        return None
    if len(span_id) != 16 or not _is_hex(span_id):
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def inject(carrier: Optional[Dict[str, str]] = None,
           context=None) -> Dict[str, str]:
    """Write the ``traceparent`` header into ``carrier`` (a headers
    dict; created when ``None``). ``context`` defaults to the calling
    thread's current span. Injecting nothing (disabled tracing, no
    span) leaves the carrier untouched."""
    if carrier is None:
        carrier = {}
    if context is None:
        context = current_span()
    header = format_traceparent(context) if context is not None else None
    if header is not None:
        carrier[TRACEPARENT_HEADER] = header
    return carrier


def extract(carrier) -> Optional[SpanContext]:
    """Read a remote parent out of ``carrier`` — a headers mapping
    (case-insensitive lookup) or a bare ``traceparent`` string."""
    if carrier is None:
        return None
    if isinstance(carrier, str):
        return parse_traceparent(carrier)
    value = None
    get = getattr(carrier, "get", None)
    if get is not None:
        value = get(TRACEPARENT_HEADER)
        if value is None:
            value = get(TRACEPARENT_HEADER.title())
        if value is None:       # arbitrary-cased mappings (plain dict)
            for k in carrier:
                if str(k).lower() == TRACEPARENT_HEADER:
                    value = carrier[k]
                    break
    return parse_traceparent(value) if value is not None else None


def context_from(obj: Any) -> Optional[SpanContext]:
    """Coerce the ``trace_context`` argument surfaces accept into a
    SpanContext: a Span/SpanContext passes through (empty noop ids
    become None), a string parses as a traceparent value, a mapping is
    treated as a headers carrier. Unknown types degrade to ``None`` —
    propagation is best-effort by contract."""
    if obj is None:
        return None
    if isinstance(obj, SpanContext):
        return obj if obj.span_id else None
    if isinstance(obj, Span):
        return obj.context
    if isinstance(obj, str):
        return parse_traceparent(obj)
    if hasattr(obj, "get"):
        return extract(obj)
    ctx = getattr(obj, "context", None)   # noop span & span-likes
    if isinstance(ctx, SpanContext):
        return ctx if ctx.span_id else None
    return None
