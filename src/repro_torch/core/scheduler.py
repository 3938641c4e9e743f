"""Event-driven pipeline simulation (Fig. 3).

N3H-Core is *intra-layer asynchronous*: three engines (Fetch, Execute,
Result) per core run their own instruction streams and handshake through
sync tokens (SE = sync-execute, WF = wait-fetch, WE = wait-execute).
This module simulates those streams with an event-driven engine model,
yielding the latency decomposition of Eqs. (6) and (8):
L = sum(L_wait) + sum(L_run) + sum(L_sig) + sum(L_rst).

Instruction generation lives in ``repro.compiler.lower`` — the NN→ISA
compiler is the single source of truth for streams, and this simulator
consumes its output: either raw per-layer streams (the historical
``lut_core_streams`` / ``dsp_core_streams`` entry points, now thin
wrappers over the compiler) or a whole compiled ``Program`` via
:func:`simulate_program`.

The simulator is the ground-truth latency model; `latency_model.py`
derives closed-form approximations from the same pipeline structure and
is validated against this simulator (<2% — the Fig. 5 reproduction).
"""
from __future__ import annotations

import dataclasses
import math
from repro_torch.core import isa

# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FPGADevice:
    """Resource pool + board-level constants of a target device.

    DMA constants are calibration parameters (the paper does not publish
    them); defaults model the Zynq AXI-HP ports at 100 MHz and were
    calibrated so the end-to-end model lands in the ballpark of the
    paper's Table 5 (see EXPERIMENTS.md §Paper-repro).
    """
    name: str
    luts: int
    dsps: int
    bram36: int
    dma_bytes_per_cycle: float = 16.0
    dma_setup_cycles: int = 32
    freq_mhz: float = 100.0

    def cycles_to_ms(self, cycles: float) -> float:
        return cycles / (self.freq_mhz * 1e3)


XC7Z020 = FPGADevice("XC7Z020", luts=53200, dsps=220, bram36=140)
XC7Z045 = FPGADevice("XC7Z045", luts=218600, dsps=900, bram36=545)

DEVICES = {d.name: d for d in (XC7Z020, XC7Z045)}


@dataclasses.dataclass(frozen=True)
class LutCoreConfig:
    """LUT-core knobs of Table 1 (BISMO-style M x N DPU array)."""
    m: int            # DPU rows
    n: int            # DPU columns
    k: int            # bits consumed per DPU per cycle
    d_a: int = 1024   # activation buffer depth
    d_w: int = 1024   # weight buffer depth (latency-insensitive, Eq. 9)
    pipeline_fill: int = 8  # DPU array fill/drain cycles per tile
    # Depthwise mode: channels map to array columns but the K-dim
    # reduction is only kh*kw taps, so the DPU bit-parallelism is mostly
    # idle; effective MAC rate = dense rate * dw_efficiency. The paper
    # observes exactly this ("LUT-Core is not efficient to compute
    # depth-wise layers", §6.2.2).
    dw_efficiency: float = 0.125


@dataclasses.dataclass(frozen=True)
class DspCoreConfig:
    """DSP-core knobs of Table 1. Per §3.3 the register array columns are
    fixed at 16 so the DSP budget pins n_reg_row_a = floor(DSP / 16)."""
    n_reg_row_a: int
    n_reg_col_a: int = 16
    n_reg_col_w: int = 16
    d_a: int = 1024
    d_w: int = 1024
    w_fill_cycles: int = 2    # two columns per buffer per cycle
    a_fill_cycles: int = 1    # one row per buffer per cycle
    # Depthwise: per-tap diagonal weight mode; better than the LUT-core
    # (the paper routes most depthwise layers to the DSP-core).
    dw_efficiency: float = 0.5

    @staticmethod
    def rows_for_device(dev: FPGADevice) -> int:
        return max(1, dev.dsps // 16)


@dataclasses.dataclass(frozen=True)
class GemmDims:
    """GEMM extents in *elements*: out[m, n] = act[m, k] @ wgt[k, n]."""
    m: int
    k: int
    n: int

    def macs(self) -> int:
        return self.m * self.k * self.n


# ---------------------------------------------------------------------------
# Event-driven engine simulator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Op:
    """One scheduled instruction with its timing closure."""
    instr: isa.Instr
    cycles: int                  # busy cycles once runnable (0 for waits)
    channel: str | None = None   # sync channel (send or wait)


@dataclasses.dataclass
class EngineTrace:
    busy: int = 0
    wait: int = 0
    sync: int = 0
    finish: int = 0


@dataclasses.dataclass
class SimResult:
    total_cycles: int
    traces: dict[str, EngineTrace]
    n_instructions: int

    @property
    def l_wait(self) -> int:
        return self.traces["execute"].wait

    @property
    def l_run(self) -> int:
        return self.traces["execute"].busy

    @property
    def l_sig(self) -> int:
        return sum(t.sync for t in self.traces.values())

    @property
    def l_rst(self) -> int:
        return self.traces["result"].busy


class DeadlockError(RuntimeError):
    pass


@dataclasses.dataclass
class SimTrace:
    """Raw per-instruction spans of one :func:`simulate` call (one core
    in one layer window), consumed by ``repro.obs``.

    ``spans`` holds ``(engine, kind, start, dur, channel, instr)``
    tuples — start/dur in cycles relative to the window start, kind is
    ``"busy"``/``"sync"``/``"stall"``, instr the raw instruction object
    (names resolve at export) — in issue order, which is deterministic
    for a fixed program. ``queue_peak`` is the maximum token-queue
    depth observed per channel (buffer-slot occupancy for the
    ``*slot`` channels).
    """
    spans: list = dataclasses.field(default_factory=list)
    queue_peak: dict = dataclasses.field(default_factory=dict)


class LazySimTrace:
    """Deferred span capture for one core's layer window.

    Holds the stream refs and replays the (deterministic) simulation
    with span recording on first access. This is what keeps tracer-on
    ``simulate_program`` within the <15% overhead budget: the timed
    simulation runs the plain hot loop, and the per-instruction span
    cost lands in the export step (``Tracer.to_chrome``), where it
    belongs. Replay equals the live run instruction for instruction
    because :func:`simulate` is deterministic for fixed streams.
    """

    __slots__ = ("_streams", "_tokens", "_st")

    def __init__(self, streams, initial_tokens):
        self._streams = streams
        self._tokens = initial_tokens
        self._st = None

    def _force(self) -> SimTrace:
        if self._st is None:
            st = SimTrace()
            simulate(self._streams, self._tokens, trace=st)
            self._st = st
        return self._st

    @property
    def spans(self) -> list:
        return self._force().spans

    @property
    def queue_peak(self) -> dict:
        return self._force().queue_peak


def simulate(streams: dict[str, list[Op]],
             initial_tokens: dict[str, int] | None = None,
             trace: SimTrace | None = None) -> SimResult:
    """Run the three engine streams to completion.

    Channels are FIFOs of token post-times. A wait op blocks until a
    token with post_time <= infinity exists; the engine resumes at
    max(own_clock, post_time). Initial tokens (e.g. free buffer slots
    for double buffering) are available at t=0.

    ``trace`` (optional) collects per-instruction spans into a
    :class:`SimTrace`; the default ``None`` keeps the hot loop on the
    historical no-bookkeeping path.
    """
    tokens: dict[str, list[int]] = {}
    for ch, cnt in (initial_tokens or {}).items():
        tokens[ch] = [0] * cnt

    spans = trace.spans if trace is not None else None
    peaks = trace.queue_peak if trace is not None else None
    if peaks is not None:
        for ch, q in tokens.items():
            peaks[ch] = len(q)

    idx = {e: 0 for e in streams}
    clock = {e: 0 for e in streams}
    traces = {e: EngineTrace() for e in streams}
    n_instr = sum(len(s) for s in streams.values())

    def runnable(e: str) -> bool:
        i = idx[e]
        if i >= len(streams[e]):
            return False
        op = streams[e][i]
        if op.channel is not None and _is_wait(op):
            return bool(tokens.get(op.channel))
        return True

    progressed = True
    while progressed:
        progressed = False
        for e, stream in streams.items():
            while runnable(e):
                op = stream[idx[e]]
                t = traces[e]
                # span tuples carry the raw instr object; opcode names
                # resolve lazily at trace export (enum .name lookups in
                # the hot loop would dominate the traced-sim cost)
                if op.channel is not None and _is_wait(op):
                    post = tokens[op.channel].pop(0)
                    start = max(clock[e], post)
                    if spans is not None:
                        if start > clock[e]:
                            spans.append((e, "stall", clock[e],
                                          start - clock[e], op.channel,
                                          None))
                        if op.cycles:
                            spans.append((e, "sync", start, op.cycles,
                                          op.channel, op.instr))
                    t.wait += start - clock[e]
                    t.sync += op.cycles
                    clock[e] = start + op.cycles
                elif op.channel is not None:  # send
                    if spans is not None and op.cycles:
                        spans.append((e, "sync", clock[e], op.cycles,
                                      op.channel, op.instr))
                    t.sync += op.cycles
                    clock[e] += op.cycles
                    q = tokens.setdefault(op.channel, [])
                    q.append(clock[e])
                    if peaks is not None and len(q) > peaks.get(op.channel, 0):
                        peaks[op.channel] = len(q)
                else:
                    if spans is not None and op.cycles:
                        spans.append((e, "busy", clock[e], op.cycles,
                                      None, op.instr))
                    t.busy += op.cycles
                    clock[e] += op.cycles
                idx[e] += 1
                progressed = True

    if any(idx[e] < len(streams[e]) for e in streams):
        stuck = {e: (idx[e], len(streams[e])) for e in streams}
        raise DeadlockError(f"engines deadlocked at {stuck}")

    for e in streams:
        traces[e].finish = clock[e]
    total = max(clock.values()) if clock else 0
    return SimResult(total_cycles=total, traces=traces, n_instructions=n_instr)


def _is_wait(op: Op) -> bool:
    return isinstance(op.instr, isa.SyncInstr) and op.instr.is_wait == 1


def _dma_cycles(n_bytes: float, dev: FPGADevice) -> int:
    return int(math.ceil(n_bytes / dev.dma_bytes_per_cycle)) + dev.dma_setup_cycles


# ---------------------------------------------------------------------------
# Stream generation — thin wrappers over the NN→ISA compiler
# ---------------------------------------------------------------------------


def lut_core_streams(g: GemmDims, cfg: LutCoreConfig, dev: FPGADevice,
                     bits_w: int, bits_a: int, depthwise: bool = False
                     ) -> tuple[dict[str, list[Op]], dict[str, int]]:
    """Instruction streams for one layer partition on the LUT-core.

    Delegates to ``repro.compiler.lower.lower_lut_layer`` — the compiler
    owns the Fig.-3 schedule; this wrapper keeps the historical
    (streams, initial_tokens) shape the simulator entry points consume.
    """
    from repro_torch.compiler.lower import lower_lut_layer
    cp = lower_lut_layer(g, cfg, dev, bits_w, bits_a, depthwise)
    return cp.streams, cp.initial_tokens


def dsp_core_streams(g: GemmDims, cfg: DspCoreConfig, dev: FPGADevice,
                     depthwise: bool = False
                     ) -> tuple[dict[str, list[Op]], dict[str, int]]:
    """Instruction streams for one layer partition on the DSP-core.

    Delegates to ``repro.compiler.lower.lower_dsp_layer`` (see
    ``lut_core_streams``).
    """
    from repro_torch.compiler.lower import lower_dsp_layer
    cp = lower_dsp_layer(g, cfg, dev, depthwise)
    return cp.streams, cp.initial_tokens


# ---------------------------------------------------------------------------
# Entry points used by the latency model
# ---------------------------------------------------------------------------


def simulate_lut_core(g: GemmDims, cfg: LutCoreConfig, dev: FPGADevice,
                      bits_w: int, bits_a: int, depthwise: bool = False) -> SimResult:
    if g.n == 0 or g.m == 0 or g.k == 0:
        return SimResult(0, {"fetch": EngineTrace(), "execute": EngineTrace(),
                             "result": EngineTrace()}, 0)
    streams, init = lut_core_streams(g, cfg, dev, bits_w, bits_a, depthwise)
    return simulate(streams, init)


def simulate_dsp_core(g: GemmDims, cfg: DspCoreConfig, dev: FPGADevice,
                      depthwise: bool = False) -> SimResult:
    if g.n == 0 or g.m == 0 or g.k == 0:
        return SimResult(0, {"fetch": EngineTrace(), "execute": EngineTrace(),
                             "result": EngineTrace()}, 0)
    streams, init = dsp_core_streams(g, cfg, dev, depthwise)
    return simulate(streams, init)


# ---------------------------------------------------------------------------
# Compiled-Program simulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerSim:
    """Per-layer simulation of a compiled program layer: both cores run
    concurrently, the layer's makespan is their max (Eq. 10 inner term)."""
    name: str
    lut: SimResult | None
    dsp: SimResult | None
    # per-core SimTrace objects when the sim ran with tracing on
    traces: dict | None = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def cycles(self) -> int:
        return max((r.total_cycles for r in (self.lut, self.dsp)
                    if r is not None), default=0)


@dataclasses.dataclass
class ProgramSim:
    layers: list[LayerSim]

    @property
    def total_cycles(self) -> int:
        """Eq. (10): inter-layer synchronous sum of per-layer makespans."""
        return sum(ls.cycles for ls in self.layers)

    @property
    def n_instructions(self) -> int:
        return sum(r.n_instructions for ls in self.layers
                   for r in (ls.lut, ls.dsp) if r is not None)

    def decomposition(self, core: str) -> dict[str, int]:
        """Aggregate Eq. (6)/(8) terms over layers for one core."""
        agg = {"l_wait": 0, "l_run": 0, "l_sig": 0, "l_rst": 0}
        for ls in self.layers:
            r = getattr(ls, core)
            if r is None:
                continue
            agg["l_wait"] += r.l_wait
            agg["l_run"] += r.l_run
            agg["l_sig"] += r.l_sig
            agg["l_rst"] += r.l_rst
        return agg


@dataclasses.dataclass
class DecodeSim:
    """Decode-mode timing of a step program (``Program.step`` set).

    One generated token costs ``warmup_cycles`` on the first invocation
    (weights stream in from DDR) and ``steady_cycles`` afterwards (the
    ``weights``-resident segments stay on chip; only the new token's
    activations and the persistent kv/state rows move). ``total_cycles``
    is the warm-up invocation so fixed-seq comparisons stay meaningful;
    :meth:`tokens_cycles` scores an ``n``-token generation.
    """
    warmup: ProgramSim
    steady: ProgramSim

    @property
    def warmup_cycles(self) -> int:
        return self.warmup.total_cycles

    @property
    def steady_cycles(self) -> int:
        return self.steady.total_cycles

    @property
    def total_cycles(self) -> int:
        return self.warmup.total_cycles

    def tokens_cycles(self, n_tokens: int) -> int:
        """Cycles to generate ``n_tokens`` (warm-up + steady steps)."""
        return (self.warmup_cycles
                + max(0, n_tokens - 1) * self.steady_cycles)

    # ProgramSim-compatible surface (reports describe the warm-up pass)
    @property
    def layers(self) -> list[LayerSim]:
        return self.warmup.layers

    @property
    def n_instructions(self) -> int:
        return self.warmup.n_instructions

    def decomposition(self, core: str) -> dict[str, int]:
        return self.warmup.decomposition(core)


def simulate_layers(prog, collect_traces: bool = False) -> list[LayerSim]:
    """Event-driven sim of every layer of a single-device program.

    With ``collect_traces`` each :class:`LayerSim` carries per-core
    :class:`LazySimTrace` handles (``repro.obs`` consumes them); the
    timed sim itself stays on the plain fast path — span capture
    replays on first access.
    """
    layers = []
    for lp in prog.layers:
        sims, traces = {}, {}
        for attr in ("lut", "dsp"):
            cp = getattr(lp, attr)
            if cp is None:
                sims[attr] = None
                continue
            # sim_tokens() arms inter-layer barrier waits at t=0: under
            # the Eq.-10 synchronous chain the previous layer has drained.
            tokens = cp.sim_tokens()
            sims[attr] = simulate(cp.streams, tokens)
            if collect_traces:
                traces[attr] = LazySimTrace(cp.streams, tokens)
        layers.append(LayerSim(lp.name, sims["lut"], sims["dsp"],
                               traces=traces or None))
    return layers


def record_program_trace(tracer, device: int, name: str, prog, layers,
                         offset: int = 0,
                         windows: list[int] | None = None) -> int:
    """Feed simulated layers into a ``repro.obs.Tracer``.

    One ``record_layer`` call per placement window; ``windows``
    overrides the per-layer window cycles (bundle *filter* plans share
    the cross-device max per layer, §multi-FPGA), otherwise each
    layer's own makespan is its window. Returns the device-local end
    offset so callers can chain stages.
    """
    tracer.begin_device(device, name)
    for i, (lp, ls) in enumerate(zip(prog.layers, layers)):
        window = ls.cycles if windows is None else windows[i]
        core_results = {}
        for attr in ("lut", "dsp"):
            sim = getattr(ls, attr)
            if sim is None:
                continue
            st = (ls.traces or {}).get(attr)
            core_results[attr] = (sim, st)
            cp = getattr(lp, attr)
            tracer.record_dma(device, attr, cp.bytes_fetched,
                              cp.bytes_written)
        tracer.record_layer(device, lp.index, lp.name, offset, window,
                            core_results)
        offset += window
    return offset


def simulate_program(prog, opt_level: int | None = None,
                     batches: int = 1, tracer=None) -> "ProgramSim":
    """Run a compiled ``repro.compiler.Program`` through the event-driven
    engine model, layer by layer (inter-layer synchronous, §3.1): the
    compiler is the single source of truth for the streams; this is the
    same Fig. 5 ground-truth model the closed forms validate against.

    ``opt_level`` (None = time the program as given) first runs the
    ``repro.compiler.passes`` pipeline at that level, so optimized
    streams are exactly what gets timed — `-O0` vs `-O1` latency deltas
    come from this one entry point.

    A ``repro.compiler.partition.MultiDeviceProgram`` dispatches to the
    cross-device makespan aggregation instead (per-device event-driven
    sims + the plan's link-latency model), returning a ``BundleSim``;
    ``batches`` then sets how many back-to-back inputs the makespan
    covers (pipeline plans overlap them across stages); for a plain
    single-device program ``batches`` is ignored (its makespan for B
    inputs is just ``B * total_cycles``).

    ``tracer`` (a ``repro.obs.Tracer``; default off) records
    per-instruction spans and cycle-accounted counters while
    simulating — the trace *decomposes* the returned makespan, it never
    changes it.
    """
    tracing = tracer is not None and getattr(tracer, "enabled", False)
    if hasattr(prog, "devices"):     # MultiDeviceProgram bundle
        from repro_torch.compiler.partition import optimize_bundle, simulate_bundle
        if opt_level is not None:
            prog = optimize_bundle(prog, opt_level, validate=False)
        return simulate_bundle(prog, batches=batches,
                               tracer=tracer if tracing else None)
    if opt_level is not None:
        from repro_torch.compiler.passes import optimize_program
        prog = optimize_program(prog, opt_level, validate=False)
    if getattr(prog, "step", None) is not None:
        # decode-mode step program: report warm-up vs steady state; the
        # trace lays the two invocations back to back on the timeline
        from repro_torch.compiler.lower import steady_program
        steady = steady_program(prog)
        warm = ProgramSim(simulate_layers(prog, collect_traces=tracing))
        ssim = ProgramSim(simulate_layers(steady, collect_traces=tracing))
        ds = DecodeSim(warmup=warm, steady=ssim)
        if tracing:
            end = record_program_trace(tracer, 0, prog.device.name, prog,
                                       warm.layers)
            end = record_program_trace(tracer, 0, prog.device.name, steady,
                                       ssim.layers, offset=end)
            tracer.set_makespan(end)
        return ds
    ps = ProgramSim(simulate_layers(prog, collect_traces=tracing))
    if tracing:
        record_program_trace(tracer, 0, prog.device.name, prog, ps.layers)
        tracer.set_makespan(ps.total_cycles)
    return ps
