"""paddle_tpu_torch.observability — metrics, tracing, debug server,
flight recorder, and the memory, perf, goodput and stream-audit
ledgers: the JAX package's control-plane measurement layer, copied
where it imports no JAX and rewritten for one CUDA card where it does
(``memory``'s device half and ``exporters.sample_device_memory`` read
``torch.cuda.memory_stats()``; ``perf`` takes analytic program costs
in place of XLA's cost analysis).

- metrics: Counter / Gauge / Histogram families with labels, one
  process-wide ``MetricRegistry``;
- tracing: request-scoped ``Span`` trees in a bounded process-wide
  table, off by default, near-zero overhead when disabled;
- exporters: Prometheus text exposition, a periodic JSONL file
  reporter, CUDA device-memory gauges;
- goodput, memory, perf, audit: the wall-clock time ledger
  (``/goodputz``), the device-memory attribution ledger (``/memz``),
  the roofline registry (``/perfz``) and the stream-integrity auditor
  (``/driftz``);
- server + flight: a live HTTP debug surface (``/metrics /healthz
  /statusz /tracez /perfz /memz``) and a crash flight recorder.

- slo: ``SLOTracker``, error-budget burn rates over the fleet router's
  request outcomes (``/sloz``).

Not here yet: ``export_chrome_tracing`` and ``POST /profilez`` wait for
the profiler (ROADMAP Queue A7).
"""

from .metrics import (BYTE_BUCKETS, DEFAULT_BUCKETS,  # noqa: F401
                      RATE_BUCKETS, RATIO_BUCKETS, CounterChild,
                      GaugeChild, HistogramChild, MetricFamily,
                      MetricRegistry, default_registry)
from .exporters import (JSONLReporter, prometheus_text,  # noqa: F401
                        sample_device_memory, write_prometheus)
from . import audit  # noqa: F401
from . import goodput  # noqa: F401
from . import memory  # noqa: F401
from . import perf  # noqa: F401
from . import propagation  # noqa: F401
from . import tracing  # noqa: F401
from .tracing import Span, SpanContext, start_span  # noqa: F401
from .tracing import span as trace_span  # noqa: F401
from .propagation import (TRACEPARENT_HEADER,  # noqa: F401
                          format_traceparent, parse_traceparent)
from .server import (DebugServer, get_debug_server,  # noqa: F401
                     register_status_provider, start_debug_server,
                     stop_debug_server, unregister_status_provider)
from .flight import (FlightRecorder, dump_flight_record,  # noqa: F401
                     get_flight_recorder, install_flight_recorder)
from .slo import SLOTracker  # noqa: F401

enable_tracing = tracing.enable
disable_tracing = tracing.disable
tracing_enabled = tracing.enabled

__all__ = [
    "BYTE_BUCKETS", "DEFAULT_BUCKETS", "RATE_BUCKETS", "RATIO_BUCKETS",
    "CounterChild", "GaugeChild", "HistogramChild",
    "MetricFamily", "MetricRegistry", "default_registry",
    "JSONLReporter", "prometheus_text",
    "sample_device_memory", "write_prometheus",
    "goodput", "memory", "perf",
    "tracing", "Span", "SpanContext", "start_span", "trace_span",
    "enable_tracing", "disable_tracing", "tracing_enabled",
    "propagation", "TRACEPARENT_HEADER", "format_traceparent",
    "parse_traceparent", "SLOTracker",
    "DebugServer", "start_debug_server", "get_debug_server",
    "stop_debug_server", "register_status_provider",
    "unregister_status_provider",
    "FlightRecorder", "install_flight_recorder", "get_flight_recorder",
    "dump_flight_record",
]
