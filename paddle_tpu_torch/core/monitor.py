"""Runtime counters (the port's counterpart of
``paddle_tpu/core/monitor.py``; ref: paddle/fluid/platform/monitor.h:80
``StatRegistry`` + STAT_ADD/STAT_GET macros :133 — process-wide named
int/float stats).

A facade over ``paddle_tpu_torch.observability.MetricRegistry``: every
stat is a gauge in the process-wide registry (gauges, not counters —
the reference's STAT_ADD accepts negative deltas and SET overwrites),
so STAT_ADD call sites surface in the Prometheus/JSONL exports beside
the typed histograms. The API (add/set/get/snapshot/reset) and the stat
names are the JAX package's.

Host-side only by design: device numbers (memory, kernel times) come
from ``torch.cuda`` and the observability layer; these counters cover
framework-level events (checkpoints written, restarts, preemptions)."""

from __future__ import annotations

import threading
from typing import Dict, Union

from ..observability.metrics import MetricRegistry, default_registry

Number = Union[int, float]

_STAT_HELP = "STAT_ADD runtime stat (platform/monitor.h analog)"


class StatRegistry:
    _instance = None
    _lock = threading.Lock()

    def __init__(self, registry: MetricRegistry = None):
        self._registry = registry or default_registry()
        self._mu = threading.Lock()
        # stat name → gauge family. Kept explicitly (not re-looked-up
        # by name) so a stat whose name clashes with a typed metric
        # (histogram / labeled family) still resolves to OUR gauge —
        # the reference's StatRegistry never raises.
        self._fams: Dict[str, object] = {}

    @classmethod
    def instance(cls) -> "StatRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def _gauge(self, name: str):
        with self._mu:
            fam = self._fams.get(name)
        if fam is None:
            try:
                fam = self._registry.gauge(name, _STAT_HELP)
            except ValueError:
                # name taken by a histogram/labeled family: park the
                # stat under a suffixed gauge rather than raising
                fam = self._registry.gauge(name + ".stat", _STAT_HELP)
            with self._mu:
                self._fams[name] = fam
        return fam

    def add(self, name: str, value: Number = 1) -> None:
        self._gauge(name).inc(value)

    def set(self, name: str, value: Number) -> None:
        self._gauge(name).set(value)

    def get(self, name: str) -> Number:
        with self._mu:
            fam = self._fams.get(name)
        if fam is None:
            fam = self._registry.get(name)
            if fam is None or fam.kind not in ("counter", "gauge") \
                    or fam.label_names:
                return 0
        return fam.value

    def snapshot(self) -> Dict[str, Number]:
        with self._mu:
            fams = dict(self._fams)
        return {name: fam.value for name, fam in fams.items()}

    def reset(self) -> None:
        with self._mu:
            fams = dict(self._fams)
            self._fams.clear()
        for fam in fams.values():
            self._registry.unregister(fam.name)


def stat_add(name: str, value: Number = 1) -> None:
    """STAT_ADD analog (monitor.h:133)."""
    StatRegistry.instance().add(name, value)


def stat_get(name: str) -> Number:
    return StatRegistry.instance().get(name)
