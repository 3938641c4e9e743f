"""Chrome trace-event tracer for the N3H-Core stack (Perfetto-loadable).

``Tracer`` is the single sink every layer of the stack writes into:

* the event-driven simulator records per-instruction spans in *cycles*
  (:meth:`record_layer` consumes one ``(SimResult, SimTrace)`` pair per
  core placement window);
* executor backends and the serving/DSE drivers record wall-clock
  spans via :meth:`measure`, so simulated and measured timelines land
  in one file side by side.

The export format is the Chrome trace-event JSON object form
(``{"traceEvents": [...], ...}``) using only ``"X"`` complete events
and ``"M"`` metadata events — the subset every trace viewer
(Perfetto, ``chrome://tracing``) accepts. Track mapping:

* ``pid`` = accelerator device index (one process group per FPGA);
  wall-clock measurements live in the reserved ``pid`` 901 and
  inter-device links in 900;
* ``tid`` = ``core_index * 3 + engine_index`` so each device shows six
  rows: lut/fetch, lut/execute, lut/result, dsp/fetch, … — one track
  per engine per core per device;
* ``ts``/``dur`` are raw simulator cycles for simulated tracks
  (open Perfetto with "µs" read as "cycles") and microseconds for
  measured tracks.

Determinism: span records are kept in issue order, the JSON is dumped
with ``sort_keys=True`` and no timestamps or ids beyond the cycle
numbers themselves, so tracing the same program twice produces
byte-identical files (tested, and safe to check in as goldens).

``NULL_TRACER`` is the shared no-op used when tracing is off: every
hook is a ``pass``/fast-path, so the disabled overhead is the cost of
an attribute check.
"""
from __future__ import annotations

import contextlib
import json
import time

from .counters import CORES, ENGINES, Counters

#: reserved track groups (outside any plausible device count)
LINK_PID = 900       # inter-device channel transfers (pipeline edges)
MEASURED_PID = 901   # wall-clock executor / driver spans

_SPAN_CAT = {"busy": "busy", "sync": "sync", "stall": "stall"}


class Tracer:
    """Collects simulator cycle spans + wall-clock spans, aggregates
    :class:`~repro.obs.counters.Counters`, exports Chrome trace JSON."""

    enabled = True

    def __init__(self):
        self._counters = Counters()
        # ordered accounting-op log: the hooks the timed simulation
        # drives ("layer"/"dma"/"pad") only *append* here — all
        # aggregation (counter sums, span-derived stall causes, queue
        # peaks) replays in finalize(), so the timed path pays a few
        # appends per placement window, nothing per instruction.
        # Op order matters: pad_idle applies to the tracks that exist
        # when it fires, so the replay preserves issue order.
        self._ops: list[tuple] = []
        # (device, core, layer_index, layer_name, offset, SimTrace-like)
        # — span lists are lazy replay handles consumed by to_chrome()
        self._layer_records: list[tuple] = []
        self._link_records: list[dict] = []
        self._measured: list[dict] = []
        self._device_names: dict[int, str] = {}
        self._t0 = time.perf_counter()

    @property
    def counters(self) -> Counters:
        """Aggregated counters; first access finalizes pending records."""
        self.finalize()
        return self._counters

    # -- simulator side (cycles) -------------------------------------------

    def begin_device(self, device: int, name: str) -> None:
        self._device_names.setdefault(device, name)

    def record_layer(self, device: int, layer_index: int, layer_name: str,
                     offset: int, window: int, core_results: dict) -> None:
        """Account one placement window (one layer on one device).

        ``core_results`` maps core name -> ``(SimResult, SimTrace)``
        for the cores present in the layer; ``offset`` is the absolute
        start cycle of the window on this device's timeline.
        """
        self._ops.append(("layer", device, layer_index, layer_name,
                          offset, window, core_results))

    def record_dma(self, device: int, core: str, fetched: int,
                   written: int) -> None:
        self._ops.append(("dma", device, core, fetched, written))

    def record_link(self, src_device: int, dst_device: int, offset: int,
                    cycles: int, nbytes: int, label: str) -> None:
        """One inter-device channel transfer (pipeline bundle edge)."""
        self._link_records.append({
            "src": src_device, "dst": dst_device, "offset": offset,
            "cycles": cycles, "nbytes": nbytes, "label": label})

    def pad_idle(self, device: int, cycles: int) -> None:
        self._ops.append(("pad", device, cycles))

    def set_makespan(self, cycles: int) -> None:
        self._counters.makespan = cycles

    def _finalize_layer(self, device, layer_index, layer_name, offset,
                        window, core_results) -> None:
        c = self._counters
        summary = {"device": device, "layer": layer_index,
                   "name": layer_name, "offset": offset, "window": window}
        for core in CORES:
            pair = core_results.get(core)
            if pair is None:
                c.add_layer_window(device, core, window, None)
                summary[f"{core}_cycles"] = 0
                continue
            sim, st = pair
            c.add_layer_window(device, core, window, sim.traces)
            summary[f"{core}_cycles"] = sim.total_cycles
            if st is not None:
                self._layer_records.append(
                    (device, core, layer_index, layer_name, offset, st))
                # span-derived aggregates (forces the lazy replay —
                # exactly the cost the timed sim avoided)
                for (_, kind, _, dur, channel, _) in st.spans:
                    if kind == "stall" and channel:
                        c.add_wait(device, channel, dur)
                c.merge_queue_peak(device, st.queue_peak)
        lut_c, dsp_c = summary["lut_cycles"], summary["dsp_cycles"]
        hi = max(lut_c, dsp_c)
        summary["split_balance"] = round(min(lut_c, dsp_c) / hi, 4) \
            if hi else 1.0
        c.layers.append(summary)

    def finalize(self) -> None:
        """Replay the accounting-op log into :class:`Counters`.

        Idempotent by draining — pending ops are consumed, so records
        arriving after a finalize are picked up by the next call.
        Exports, the profile report and the ``counters`` property all
        route through here."""
        ops, self._ops = self._ops, []
        for op in ops:
            kind = op[0]
            if kind == "layer":
                self._finalize_layer(*op[1:])
            elif kind == "dma":
                self._counters.add_dma(*op[1:])
            else:   # "pad"
                self._counters.pad_idle(*op[1:])

    # -- wall-clock side (executors, serving, DSE) --------------------------

    @contextlib.contextmanager
    def measure(self, track: str, name: str, **args):
        """Wall-clock span on the measured timeline (µs resolution)."""
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self._measured.append({
                "track": track, "name": name,
                "ts_us": (start - self._t0) * 1e6,
                "dur_us": (end - start) * 1e6,
                "args": dict(args)})

    @property
    def measured_spans(self) -> list[dict]:
        return list(self._measured)

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome trace-event object (``json.dump``-ready)."""
        self.finalize()
        events: list[dict] = []
        seen_tracks: set[tuple[int, int]] = set()

        def meta(pid, name):
            events.append({"ph": "M", "pid": pid, "tid": 0,
                           "name": "process_name",
                           "args": {"name": name}})

        for device in sorted(self._device_names):
            meta(device, f"dev{device}:{self._device_names[device]}")

        for (device, core, layer, lname, offset, st) in self._layer_records:
            core_i = CORES.index(core)
            for (engine, kind, start, dur, channel, instr) in st.spans:
                tid = core_i * 3 + ENGINES.index(engine)
                if (device, tid) not in seen_tracks:
                    seen_tracks.add((device, tid))
                    events.append({"ph": "M", "pid": device, "tid": tid,
                                   "name": "thread_name",
                                   "args": {"name": f"{core}/{engine}"}})
                # spans carry raw instr objects (the sim hot loop must
                # not pay enum lookups); resolve names once, here
                if instr is None or isinstance(instr, str):
                    iname = instr
                else:
                    iname = instr.opcode.name
                args = {"kind": kind, "layer": layer, "layer_name": lname,
                        "core": core}
                if channel:
                    args["channel"] = channel
                if iname:
                    args["instr"] = iname
                events.append({
                    "ph": "X", "pid": device, "tid": tid,
                    "cat": _SPAN_CAT[kind],
                    "name": iname or kind,
                    "ts": offset + start, "dur": dur, "args": args})

        if self._link_records:
            meta(LINK_PID, "links")
            for i, rec in enumerate(self._link_records):
                events.append({
                    "ph": "X", "pid": LINK_PID,
                    "tid": rec["src"] * 64 + rec["dst"],
                    "cat": "link", "name": rec["label"],
                    "ts": rec["offset"], "dur": rec["cycles"],
                    "args": {"src_device": rec["src"],
                             "dst_device": rec["dst"],
                             "nbytes": rec["nbytes"]}})

        if self._measured:
            meta(MEASURED_PID, "measured")
            tracks = sorted({m["track"] for m in self._measured})
            tid_of = {t: i for i, t in enumerate(tracks)}
            for t in tracks:
                events.append({"ph": "M", "pid": MEASURED_PID,
                               "tid": tid_of[t], "name": "thread_name",
                               "args": {"name": t}})
            for m in self._measured:
                events.append({
                    "ph": "X", "pid": MEASURED_PID,
                    "tid": tid_of[m["track"]], "cat": "measured",
                    "name": m["name"],
                    "ts": round(m["ts_us"], 3),
                    "dur": round(m["dur_us"], 3),
                    "args": dict(m["args"])})

        return {"traceEvents": events,
                "displayTimeUnit": "ns",
                "otherData": {"generator": "repro.obs",
                              "time_unit": "cycles",
                              "counters": self.counters.to_dict()}}

    def to_json(self) -> str:
        """Deterministic serialization: same program -> same bytes."""
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":")) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())


class NullTracer:
    """No-op tracer: the off-by-default fast path.

    Shares the ``Tracer`` surface so call sites never branch; every
    hook returns immediately. ``enabled`` lets hot loops skip even the
    call (``if tracer.enabled: ...``).
    """

    enabled = False
    counters = None

    def begin_device(self, device, name):
        pass

    def record_layer(self, device, layer_index, layer_name, offset,
                     window, core_results):
        pass

    def record_dma(self, device, core, fetched, written):
        pass

    def record_link(self, src_device, dst_device, offset, cycles,
                    nbytes, label):
        pass

    def pad_idle(self, device, cycles):
        pass

    def set_makespan(self, cycles):
        pass

    def finalize(self):
        pass

    @contextlib.contextmanager
    def measure(self, track, name, **args):
        yield

    measured_spans = ()


#: shared singleton — ``tracer=NULL_TRACER`` default keeps hooks alive
#: but free when tracing is off.
NULL_TRACER = NullTracer()


def validate_chrome_trace(obj: dict) -> list[str]:
    """Structural validation of a Chrome trace-event object.

    Returns a list of problems (empty == valid): used by tests and the
    CI smoke job to gate the uploaded artifact. Checks the object form,
    the per-event required fields for ``"X"``/``"M"`` phases, and that
    durations/timestamps are non-negative numbers.
    """
    problems = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing/invalid 'traceEvents' array"]
    if not events:
        problems.append("empty traceEvents")
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            problems.append(f"{where}: unsupported phase {ph!r}")
            continue
        for field in ("pid", "tid", "name"):
            if field not in ev:
                problems.append(f"{where}: missing {field!r}")
        if ph == "X":
            for field in ("ts", "dur"):
                v = ev.get(field)
                if not isinstance(v, (int, float)):
                    problems.append(f"{where}: {field!r} not numeric")
                elif v < 0:
                    problems.append(f"{where}: {field!r} negative ({v})")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: 'args' not an object")
    return problems
