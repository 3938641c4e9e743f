"""Cycle-accounted per-core counters derived from simulator traces.

The accounting contract (the reason these are more than logging): for
every core track ``(device, core, engine)`` of a traced program,

    busy + sync + stall + idle == makespan

where ``busy`` are compute/DMA cycles, ``sync`` token hand-shake
cycles, ``stall`` cycles blocked on an un-posted token, and ``idle``
the remainder of each layer/stage window the engine did not occupy.
``busy``/``sync``/``stall`` come from the event-driven simulation of
the instruction streams; ``idle`` is accumulated *incrementally* per
placement window (never derived as ``makespan - rest``), so
:meth:`Counters.closure_errors` is a genuine cross-check of the
decomposition against the independently aggregated program makespan —
the trace decomposes the existing ``simulate_program`` number instead
of producing a second opinion.

Everything here is stdlib-only (the ``repro.obs`` subsystem has zero
dependencies); simulator objects are consumed duck-typed.
"""
from __future__ import annotations

import dataclasses

#: engine order of every core track (matches ``compiler.program.ENGINES``)
ENGINES = ("fetch", "execute", "result")
#: core order of the heterogeneous pair (Eq. 12 split: LUT first)
CORES = ("lut", "dsp")


@dataclasses.dataclass
class TrackCounters:
    """Cycle decomposition of one ``(device, core, engine)`` track."""
    busy: int = 0     # compute / DMA cycles
    sync: int = 0     # token send/consume hand-shake cycles
    stall: int = 0    # blocked waiting for an un-posted token
    idle: int = 0     # window remainder (layer drained / other stage)

    @property
    def accounted(self) -> int:
        """Total cycles this track accounts for; closure requires this
        to equal the program makespan exactly."""
        return self.busy + self.sync + self.stall + self.idle

    def pct(self, field: str, makespan: int) -> float:
        return 100.0 * getattr(self, field) / makespan if makespan else 0.0

    def to_dict(self) -> dict:
        return {"busy": self.busy, "sync": self.sync,
                "stall": self.stall, "idle": self.idle}


class Counters:
    """Aggregated observability counters of one traced run.

    * ``tracks`` — :class:`TrackCounters` per ``(device, core, engine)``;
    * ``dma`` — bytes moved per ``(device, core)`` (summed from the
      Fetch/Result instruction ``ddr_range`` fields, i.e. exactly what
      the traced DMA instructions declared);
    * ``wait_by_channel`` — stall cycles per ``(device, channel)``:
      the top stall causes of the profile report;
    * ``queue_peak`` — peak token-queue depth per ``(device, channel)``
      (buffer-slot occupancy for the ``*.wslot``/``*.aslot`` channels);
    * ``layers`` — one placement row per (device, layer): window
      cycles, per-core makespans and the Eq.-12 split balance
      ``min(lut, dsp) / max(lut, dsp)``.
    """

    def __init__(self):
        self.tracks: dict[tuple[int, str, str], TrackCounters] = {}
        self.dma: dict[tuple[int, str], dict[str, int]] = {}
        self.wait_by_channel: dict[tuple[int, str], int] = {}
        self.queue_peak: dict[tuple[int, str], int] = {}
        self.layers: list[dict] = []
        self.makespan: int = 0

    def track(self, device: int, core: str, engine: str) -> TrackCounters:
        key = (device, core, engine)
        tc = self.tracks.get(key)
        if tc is None:
            tc = self.tracks[key] = TrackCounters()
        return tc

    # -- accounting entry points (driven by the Tracer) ---------------------

    def add_layer_window(self, device: int, core: str, window: int,
                         engine_traces: dict | None) -> None:
        """Account one placement window for one core.

        ``engine_traces`` maps engine name -> the per-engine trace of
        the event-driven sim (duck-typed: ``busy``/``sync``/``wait``
        cycle sums and the ``finish`` clock); ``None`` means the core
        is absent in this layer — the whole window is idle for all
        three of its tracks.
        """
        for engine in ENGINES:
            tc = self.track(device, core, engine)
            if engine_traces is None:
                tc.idle += window
                continue
            et = engine_traces[engine]
            tc.busy += et.busy
            tc.sync += et.sync
            tc.stall += et.wait
            tc.idle += window - et.finish

    def pad_idle(self, device: int, cycles: int) -> None:
        """Account cycles a whole device spends outside its own stage
        window (pipeline bundles: the other stages + link edges)."""
        if cycles <= 0:
            return
        for (d, _, _), tc in self.tracks.items():
            if d == device:
                tc.idle += cycles

    def add_dma(self, device: int, core: str, fetched: int,
                written: int) -> None:
        agg = self.dma.setdefault((device, core),
                                  {"bytes_fetched": 0, "bytes_written": 0})
        agg["bytes_fetched"] += fetched
        agg["bytes_written"] += written

    def add_wait(self, device: int, channel: str, cycles: int) -> None:
        key = (device, channel)
        self.wait_by_channel[key] = self.wait_by_channel.get(key, 0) + cycles

    def merge_queue_peak(self, device: int, peaks: dict[str, int]) -> None:
        for ch, depth in peaks.items():
            key = (device, ch)
            if depth > self.queue_peak.get(key, 0):
                self.queue_peak[key] = depth

    # -- the closure contract ----------------------------------------------

    def closure_errors(self) -> list[str]:
        """Tracks whose cycle accounting does not sum to the makespan.

        Empty iff the decomposition closes — the acceptance gate of the
        tracing layer (asserted in ``tests/test_obs.py`` and CI smoke).
        """
        errors = []
        for (d, core, engine), tc in sorted(self.tracks.items()):
            if tc.accounted != self.makespan:
                errors.append(
                    f"dev{d} {core}/{engine}: busy {tc.busy} + sync "
                    f"{tc.sync} + stall {tc.stall} + idle {tc.idle} = "
                    f"{tc.accounted} != makespan {self.makespan}")
        return errors

    def to_dict(self) -> dict:
        """JSON-serializable summary (embedded in the trace file's
        ``otherData`` so a saved trace carries its own accounting)."""
        return {
            "makespan_cycles": self.makespan,
            "tracks": {f"dev{d}.{c}.{e}": tc.to_dict()
                       for (d, c, e), tc in sorted(self.tracks.items())},
            "dma": {f"dev{d}.{c}": dict(v)
                    for (d, c), v in sorted(self.dma.items())},
            "wait_by_channel": {f"dev{d}.{ch}": v for (d, ch), v in
                                sorted(self.wait_by_channel.items())},
            "queue_peak": {f"dev{d}.{ch}": v for (d, ch), v in
                           sorted(self.queue_peak.items())},
            "layers": list(self.layers),
            "closure_errors": self.closure_errors(),
        }
