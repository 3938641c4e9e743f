"""Tracing and metrics: copies of ``repro.obs``' counters, tracer,
metrics registry and profile report.

* :class:`Tracer` / :data:`NULL_TRACER` — Chrome trace-event spans from
  the simulator and wall-clock executor timings; off by default via the
  null-object fast path.
* :class:`Counters` — per-core cycle accounting.
* :class:`MetricsRegistry` / :data:`METRICS` — counters, gauges and
  observations with CSV/JSON export.
* :func:`profile_report` — the per-core / per-layer utilization table
  of a traced run (``python -m repro_torch.compiler ... --profile``).
"""
from .counters import Counters, TrackCounters
from .metrics import METRICS, MetricsRegistry
from .report import profile_report
from .trace import NULL_TRACER, NullTracer, Tracer, validate_chrome_trace

__all__ = [
    "Counters", "TrackCounters",
    "METRICS", "MetricsRegistry",
    "profile_report",
    "NULL_TRACER", "NullTracer", "Tracer", "validate_chrome_trace",
]
