"""Tracing and metrics: copies of ``repro.obs``' counters, tracer and
metrics registry.

* :class:`Tracer` / :data:`NULL_TRACER` — Chrome trace-event spans from
  the simulator and wall-clock executor timings; off by default via the
  null-object fast path.
* :class:`Counters` — per-core cycle accounting.
* :class:`MetricsRegistry` / :data:`METRICS` — counters, gauges and
  observations with CSV/JSON export.
"""
from .counters import Counters, TrackCounters
from .metrics import METRICS, MetricsRegistry
from .trace import NULL_TRACER, NullTracer, Tracer, validate_chrome_trace

__all__ = [
    "Counters", "TrackCounters",
    "METRICS", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Tracer", "validate_chrome_trace",
]
