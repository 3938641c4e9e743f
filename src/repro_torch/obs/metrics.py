"""Shared structured-metrics registry for serving and DSE drivers.

A :class:`MetricsRegistry` holds three primitive kinds:

* **counters** — monotonically increasing integers
  (``serve.program_cache.hit``);
* **gauges** — last-write-wins values (``dse.best_reward``);
* **observations** — value series with derived count/sum/min/max/mean
  (``serve.request.prefill_ms``, ``dse.episode.latency_ms``).

All operations are thread-safe (serving uses the registry from the
cache and request paths concurrently). Export is CSV or JSON, and
``from_json`` round-trips a snapshot — the tested contract that lets
``SearchResult.metrics`` and serve summaries be persisted and diffed.
"""
from __future__ import annotations

import io
import json
import math
import threading


class MetricsRegistry:
    """Named counters / gauges / observation series with CSV+JSON export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._series: dict[str, list[float]] = {}

    # -- write side ---------------------------------------------------------

    def incr(self, name: str, delta: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._series.setdefault(name, []).append(float(value))

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._series.clear()

    # -- read side ----------------------------------------------------------

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def series(self, name: str) -> list[float]:
        with self._lock:
            return list(self._series.get(name, ()))

    def percentile(self, name: str, q: float) -> float:
        """Nearest-rank percentile of an observation series (``q`` in
        [0, 100]); 0.0 for an empty series. Used for the serving
        fleet's p50/p99 latency rows."""
        vals = sorted(self.series(name))
        if not vals:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * len(vals)))
        return vals[min(rank, len(vals)) - 1]

    def snapshot(self) -> dict:
        """Point-in-time JSON-serializable view (sorted keys throughout)."""
        with self._lock:
            out = {
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "observations": {},
            }
            for name in sorted(self._series):
                vals = self._series[name]
                out["observations"][name] = {
                    "count": len(vals),
                    "sum": sum(vals),
                    "min": min(vals),
                    "max": max(vals),
                    "mean": sum(vals) / len(vals),
                    "values": list(vals),
                }
        return out

    # -- export / import ----------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=2) + "\n"

    def to_csv(self) -> str:
        """Flat ``kind,name,field,value`` rows — one schema for all
        three metric kinds so downstream tooling needs a single parser."""
        buf = io.StringIO()
        buf.write("kind,name,field,value\n")
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            buf.write(f"counter,{name},value,{v}\n")
        for name, v in snap["gauges"].items():
            buf.write(f"gauge,{name},value,{v!r}\n")
        for name, stats in snap["observations"].items():
            for field in ("count", "sum", "min", "max", "mean"):
                buf.write(f"observation,{name},{field},{stats[field]!r}\n")
        return buf.getvalue()

    @classmethod
    def from_json(cls, text: str) -> "MetricsRegistry":
        """Rebuild a registry from :meth:`to_json` output (round-trip:
        ``from_json(r.to_json()).snapshot() == r.snapshot()``)."""
        snap = json.loads(text)
        reg = cls()
        for name, v in snap.get("counters", {}).items():
            reg._counters[name] = int(v)
        for name, v in snap.get("gauges", {}).items():
            reg._gauges[name] = float(v)
        for name, stats in snap.get("observations", {}).items():
            reg._series[name] = [float(x) for x in stats.get("values", ())]
        return reg

    def save(self, path: str) -> None:
        text = self.to_csv() if path.endswith(".csv") else self.to_json()
        with open(path, "w") as fh:
            fh.write(text)


#: process-wide registry — serving and DSE code records here by default
#: so one export captures the whole run.
METRICS = MetricsRegistry()
