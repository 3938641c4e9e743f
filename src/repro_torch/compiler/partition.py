"""Multi-device program partitioning: one network → N coordinated programs.

N3H-Core's unified ISA and Sync-token hand-shake coordinate two
heterogeneous cores on one FPGA; this module scales the same mechanism
*across* devices. A :class:`PartitionPlan` splits a network over
``n_devices`` accelerators in one of two ways:

  * ``"pipeline"`` — pipeline stages: each device owns a contiguous
    slice of layers (balanced on MACs). Device d hands its boundary
    activations to device d+1 over the chip-to-chip link, synchronized
    by a cross-device Sync pair (``*.xdev`` channels): a send at the
    tail of the producing layer's result stream, a wait at the head of
    the consuming layer's fetch stream.
  * ``"filter"`` — filter-parallel (shard-N): every device owns all
    layers but only a contiguous shard of each layer's output filters
    *in split column order* (the Eq.-12 LUT-partition columns first,
    then the DSP columns — so concatenating device shards reproduces
    the single-device output layout exactly). After every layer each
    device gathers the peer shards it is missing: one ``*.xdev`` wait
    plus one gather DMA (``stage_ctrl=3``, a Fetch over the link into
    the layer's ``L{i}.gather`` segment) per peer, paired with one
    ``*.xdev`` send per peer on the producing side.

The plan kind is derived from the ``parallel/`` logical-axis rules when
not forced: rules that shard filter-like axes (``mlp``/``heads``/
``experts``/``vocab``) over a mesh axis map to ``"filter"``; rules that
shard ``layers`` map to ``"pipeline"``.

:func:`lower_partitioned` compiles the per-device :class:`Program`s
(each through the ordinary ``lower_network`` path, so a 1-device plan
is bit-for-bit the legacy single program) and packages them as a
:class:`MultiDeviceProgram` with an explicit cross-device channel edge
table. :func:`validate_bundle` checks that every edge's token pairing
(sends on the source device, waits on the destination) is intact —
:func:`optimize_bundle` runs the ``passes.py`` pipeline per device and
re-validates, so no pass can silently break a device hand-off.

Timing: :func:`simulate_bundle` aggregates per-device event-driven
simulations into a cross-device makespan under a :class:`LinkModel`
(latency + bandwidth of the device-to-device link; calibration
parameters, like the DMA constants of ``FPGADevice``). Pipeline plans
overlap a stream of ``batches`` inputs (makespan = first-traversal
latency + (batches-1) x steady-state interval); filter plans execute
each layer in data-parallel lockstep (per-layer makespan = max over
devices, gather DMAs included in the streams).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import isa
from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    GemmDims,
    LutCoreConfig,
    Op,
)
from repro_torch.compiler.lower import (
    _clamp16,
    _send,
    _wait,
    lower_network,
    solve_split_dims,
)
from repro_torch.compiler.program import (
    CORE_NAMES,
    CROSS_DEVICE_CHANNELS,
    GemmLayer,
    Program,
)
from repro_torch.parallel.sharding import FILTER_PARALLEL_AXES

PLAN_KINDS = ("pipeline", "filter")

#: gather DMA stage: cross-device link-in (stages 0/1 are weight /
#: activation DDR fetches; see runtime/golden.py's contract checks)
GATHER_STAGE = 3


class PartitionError(RuntimeError):
    """A partition plan is infeasible or a bundle violates it."""


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Device-to-device link timing (calibration parameters).

    ``latency_cycles`` is the fixed hand-off cost per transfer (token
    round-trip + DMA setup across the link); ``bytes_per_cycle`` the
    sustained link bandwidth, deliberately below the on-board DDR's
    ``dma_bytes_per_cycle`` — crossing chips is slower than DRAM.
    """
    latency_cycles: int = 300
    bytes_per_cycle: float = 8.0

    def cycles(self, n_bytes: float) -> int:
        return self.latency_cycles + int(math.ceil(
            n_bytes / self.bytes_per_cycle))


@dataclasses.dataclass(frozen=True)
class ChannelEdge:
    """One cross-device token channel: ``src_device``'s local layer
    ``src_layer`` posts a token consumed by ``dst_device``'s local
    layer ``dst_layer``, moving ``nbytes`` of activations."""
    src_device: int
    src_layer: int
    dst_device: int
    dst_layer: int
    src_channel: str
    dst_channel: str
    nbytes: int


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """How one network maps onto ``n_devices`` accelerators.

    ``stages`` (pipeline) — per device a half-open [lo, hi) range over
    the global layer list. ``shards`` (filter) — per *layer* the
    ``n_devices + 1`` column boundaries of the split-order output
    shard each device owns.
    """
    kind: str
    n_devices: int
    stages: tuple[tuple[int, int], ...] | None = None
    shards: tuple[tuple[int, ...], ...] | None = None
    link: LinkModel = LinkModel()

    def __post_init__(self):
        if self.kind not in PLAN_KINDS:
            raise PartitionError(
                f"plan kind must be one of {PLAN_KINDS}, got {self.kind!r}")
        if self.n_devices < 1:
            raise PartitionError("plan needs at least one device")
        if self.kind == "pipeline" and self.stages is None:
            raise PartitionError("pipeline plan is missing its stages")
        if self.kind == "filter" and self.shards is None:
            raise PartitionError("filter plan is missing its shards")

    def describe(self) -> str:
        if self.kind == "pipeline":
            spans = " ".join(f"[{lo}:{hi})" for lo, hi in self.stages)
            return f"pipeline x{self.n_devices}  stages {spans}"
        return (f"filter x{self.n_devices}  "
                f"{len(self.shards)} layers sharded on output filters")


# ---------------------------------------------------------------------------
# Plan derivation (from the parallel/ logical-axis rules)
# ---------------------------------------------------------------------------

#: logical axes whose sharding means "split output filters" — owned by
#: parallel/sharding.py (the same names DEFAULT_RULES map onto the
#: model axis), aliased here for the plan derivation.
FILTER_AXES = FILTER_PARALLEL_AXES


def kind_from_rules(rules) -> str:
    """Map a ``parallel.sharding.AxisRules`` table to a plan kind.

    Rules that shard the ``layers`` axis ask for pipeline stages; rules
    that shard filter-like axes (``mlp``/``heads``/``experts``/
    ``vocab`` — the model-parallel dims) ask for filter-parallel
    shards. The stock ``DEFAULT_RULES`` shard mlp/heads over "model",
    so they derive ``"filter"``.
    """
    if rules.lookup("layers"):
        return "pipeline"
    if any(rules.lookup(name) for name in FILTER_AXES):
        return "filter"
    return "pipeline"


def _balanced_stages(layers: list[GemmLayer],
                     n_devices: int) -> tuple[tuple[int, int], ...]:
    """Contiguous layer ranges balanced on MACs (prefix-sum targets)."""
    n = len(layers)
    if n_devices > n:
        raise PartitionError(
            f"pipeline plan needs at least one layer per device "
            f"({n} layers < {n_devices} devices)")
    weights = [max(gl.dims.macs(), 1) for gl in layers]
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    total = prefix[-1]
    bounds = [0]
    for d in range(1, n_devices):
        target = total * d / n_devices
        # closest prefix to the target, leaving >=1 layer per stage
        lo = bounds[-1] + 1
        hi = n - (n_devices - d)
        best = min(range(lo, hi + 1),
                   key=lambda i: abs(prefix[i] - target))
        bounds.append(best)
    bounds.append(n)
    return tuple((bounds[d], bounds[d + 1]) for d in range(n_devices))


def _filter_shards(layers: list[GemmLayer],
                   n_devices: int) -> tuple[tuple[int, ...], ...]:
    """Per-layer split-order column boundaries, near-equal widths."""
    shards = []
    for gl in layers:
        n = gl.dims.n
        if n < n_devices:
            raise PartitionError(
                f"layer {gl.name!r} has {n} output filters < "
                f"{n_devices} devices; filter plan infeasible")
        shards.append(tuple(round(n * d / n_devices)
                            for d in range(n_devices + 1)))
    return tuple(shards)


def derive_plan(layers: list[GemmLayer], n_devices: int,
                kind: str | None = None, rules=None,
                link: LinkModel = LinkModel()) -> PartitionPlan:
    """Derive a partition plan for ``layers`` over ``n_devices``.

    ``kind`` falls back to :func:`kind_from_rules` over ``rules`` (the
    ``parallel/`` axis-rule table; ``DEFAULT_RULES`` when None).
    """
    if kind is None:
        if rules is None:
            from repro_torch.parallel.sharding import DEFAULT_RULES as rules
        kind = kind_from_rules(rules)
    if kind == "pipeline":
        return PartitionPlan("pipeline", n_devices,
                             stages=_balanced_stages(layers, n_devices),
                             link=link)
    if kind == "filter":
        return PartitionPlan("filter", n_devices,
                             shards=_filter_shards(layers, n_devices),
                             link=link)
    raise PartitionError(f"unknown plan kind {kind!r}")


# ---------------------------------------------------------------------------
# The multi-device container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiDeviceProgram:
    """One network compiled into a coordinated fleet of per-device
    programs plus the cross-device channel wiring between them."""
    name: str
    plan: PartitionPlan
    devices: list[Program]
    edges: list[ChannelEdge]

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def n_layers(self) -> int:
        """Global layer count of the source network."""
        if self.plan.kind == "pipeline":
            return self.plan.stages[-1][1]
        return len(self.devices[0].layers)

    @property
    def n_instructions(self) -> int:
        return sum(p.n_instructions for p in self.devices)

    def placements(self, global_layer: int) -> list[tuple[int, int]]:
        """[(device, local layer index)] owning ``global_layer``."""
        if self.plan.kind == "pipeline":
            for d, (lo, hi) in enumerate(self.plan.stages):
                if lo <= global_layer < hi:
                    return [(d, global_layer - lo)]
            raise IndexError(f"no stage owns layer {global_layer}")
        if not 0 <= global_layer < self.n_layers:
            raise IndexError(f"no layer {global_layer}")
        return [(d, global_layer) for d in range(self.n_devices)]


# ---------------------------------------------------------------------------
# Lowering: network + plan -> MultiDeviceProgram
# ---------------------------------------------------------------------------


def _per_layer(value, n: int, what: str) -> list:
    out = list(value) if isinstance(value, (list, tuple)) else [value] * n
    if len(out) != n:
        raise ValueError(f"per-layer {what} list must match the layer count")
    return out


def _first_core(lp):
    """The layer's canonical sync core (LUT partition first, as in the
    split column order). Layers with n >= 1 always have one."""
    cp = lp.lut if lp.lut is not None else lp.dsp
    if cp is None:
        raise PartitionError(
            f"layer {lp.index} ({lp.name}) has no active core")
    return cp


def _xdev_send(cp) -> Op:
    c = cp.core
    return _send(c, isa.Engine.RESULT, isa.Engine.FETCH,
                 f"{CORE_NAMES[c]}.xdev")


def _xdev_wait(cp) -> Op:
    c = cp.core
    return _wait(c, isa.Engine.RESULT, isa.Engine.FETCH,
                 f"{CORE_NAMES[c]}.xdev")


def _fetch_insert_at(cp) -> int:
    """Insert point in a fetch stream: after the leading inter-layer
    barrier wait (when present), before everything else."""
    stream = cp.streams["fetch"]
    if (stream and isinstance(stream[0].instr, isa.SyncInstr)
            and stream[0].instr.is_wait
            and stream[0].channel == f"{CORE_NAMES[cp.core]}.bar"):
        return 1
    return 0


def _solved_n_luts(layers, lut_cfg, dsp_cfg, dev, bw, ba,
                   n_luts) -> list[int]:
    """Full-network per-layer neuron splits (given or Eq.-12 solved),
    clamped exactly as ``lower_network`` clamps them."""
    out = []
    for i, gl in enumerate(layers):
        if n_luts is not None:
            out.append(int(min(max(n_luts[i], 0), gl.dims.n)))
        else:
            out.append(solve_split_dims(gl.dims, gl.depthwise, lut_cfg,
                                        dsp_cfg, dev, bw[i], ba[i]))
    return out


def lower_partitioned(name: str, layers: list[GemmLayer],
                      plan: PartitionPlan,
                      lut_cfg: LutCoreConfig, dsp_cfg: DspCoreConfig,
                      dev: FPGADevice,
                      bits_w_lut: int | list[int] = 4,
                      bits_a: int | list[int] = 4,
                      n_luts: list[int] | None = None,
                      opt_level: int = 0,
                      gather_overlap: bool = True) -> MultiDeviceProgram:
    """Compile ``layers`` under ``plan`` into a MultiDeviceProgram.

    Every per-device program goes through the ordinary
    :func:`~repro.compiler.lower.lower_network` path (at ``-O0``; the
    optimization pipeline then runs *per device* via
    :func:`optimize_bundle`, which re-validates the cross-device token
    pairing afterwards). A 1-device plan of either kind reproduces the
    legacy single program bit for bit.

    ``gather_overlap`` (filter plans) places each gather [wait + link
    DMA] pair at the tail of the *producing* layer's fetch stream, so
    the link transfer overlaps that layer's execute/result work instead
    of serializing at the consuming layer's head (the pre-overlap
    behavior, kept under ``gather_overlap=False`` for the makespan
    comparison benchmark).
    """
    nl = len(layers)
    bw = _per_layer(bits_w_lut, nl, "bit")
    ba = _per_layer(bits_a, nl, "bit")
    if plan.kind == "pipeline" and plan.stages[-1][1] != nl:
        raise PartitionError(
            f"plan covers {plan.stages[-1][1]} layers, network has {nl}")
    if plan.kind == "filter" and len(plan.shards) != nl:
        raise PartitionError(
            f"plan shards {len(plan.shards)} layers, network has {nl}")
    splits = _solved_n_luts(layers, lut_cfg, dsp_cfg, dev, bw, ba, n_luts)
    D = plan.n_devices

    def dev_name(d: int) -> str:
        return name if D == 1 else f"{name}@dev{d}"

    if plan.kind == "pipeline":
        progs = [lower_network(dev_name(d), layers[lo:hi], lut_cfg, dsp_cfg,
                               dev, bits_w_lut=bw[lo:hi], bits_a=ba[lo:hi],
                               n_luts=splits[lo:hi])
                 for d, (lo, hi) in enumerate(plan.stages)]
        edges: list[ChannelEdge] = []
        for d in range(D - 1):
            lo, hi = plan.stages[d]
            src_lp = progs[d].layers[-1]
            dst_lp = progs[d + 1].layers[0]
            src_cp, dst_cp = _first_core(src_lp), _first_core(dst_lp)
            g = src_lp.dims
            # boundary activations cross the link at the *consuming*
            # layer's bit-width (they are requantized to it, and the
            # consumer's act fetches/act.in segment are sized with it)
            nbytes = math.ceil(g.m * g.n * dst_lp.bits_a / 8)
            src_cp.streams["result"].append(_xdev_send(src_cp))
            dst_cp.streams["fetch"].insert(_fetch_insert_at(dst_cp),
                                           _xdev_wait(dst_cp))
            edges.append(ChannelEdge(
                src_device=d, src_layer=src_lp.index,
                dst_device=d + 1, dst_layer=dst_lp.index,
                src_channel=f"{CORE_NAMES[src_cp.core]}.xdev",
                dst_channel=f"{CORE_NAMES[dst_cp.core]}.xdev",
                nbytes=nbytes))
        mdp = MultiDeviceProgram(name, plan, progs, edges)
        return optimize_bundle(mdp, opt_level) if opt_level else mdp

    # -- filter-parallel (shard-N over split column order) -----------------
    widths = [[plan.shards[i][d + 1] - plan.shards[i][d]
               for i in range(nl)] for d in range(D)]
    progs = []
    for d in range(D):
        shard_layers = []
        shard_n_luts = []
        for i, gl in enumerate(layers):
            lo, hi = plan.shards[i][d], plan.shards[i][d + 1]
            geom = gl.geometry
            if geom is not None:
                # the device's conv geometry covers only its filter
                # shard; depthwise shards also consume only their own
                # channels' input slices (c_in == c_out)
                geom = dataclasses.replace(
                    geom, c_out=hi - lo,
                    c_in=hi - lo if gl.depthwise else geom.c_in)
            shard_layers.append(GemmLayer(
                gl.name, GemmDims(gl.dims.m, gl.dims.k, hi - lo),
                gl.depthwise, geom, elementwise=gl.elementwise))
            # overlap of [lo, hi) with the LUT columns [0, n_lut)
            shard_n_luts.append(max(0, min(hi, splits[i]) - lo))
        progs.append(lower_network(dev_name(d), shard_layers, lut_cfg,
                                   dsp_cfg, dev, bits_w_lut=bw, bits_a=ba,
                                   n_luts=shard_n_luts))

    edges = []
    if D > 1:
        for d in range(D):
            prog = progs[d]
            for i in range(nl - 1):
                g = layers[i].dims
                # gather segment: the peer shards of layer i's output
                # this device is missing, staged for layer i+1's reads
                # (sized at the consuming layer's activation bits, like
                # the act fetches that read them)
                gather = prog.memory.alloc(
                    f"L{i}.gather",
                    math.ceil(g.m * (g.n - widths[d][i]) * ba[i + 1] / 8))
                src_cp = _first_core(prog.layers[i])
                dst_cp = _first_core(prog.layers[i + 1])
                if gather_overlap:
                    # overlap placement: the gather DMAs ride at the
                    # tail of the *producing* layer's fetch stream, so
                    # the link transfer overlaps that layer's
                    # execute/result work (its xdev wait is armed by the
                    # peer's result-tail send within the same lockstep
                    # layer window)
                    gather_cp, gather_layer = src_cp, i
                    at = len(src_cp.streams["fetch"])
                else:
                    gather_cp, gather_layer = dst_cp, i + 1
                    at = _fetch_insert_at(dst_cp)
                # peer shards stage into the gather segment in device
                # order (self excluded); the DMA's ddr_offset is that
                # staging ordinal, per the tile-index-into-segment
                # convention of the single-device lowerer
                for rank, p in enumerate(q for q in range(D) if q != d):
                    nbytes = math.ceil(g.m * widths[p][i] * ba[i + 1] / 8)
                    # outgoing token for peer p's gather of our shard
                    src_cp.streams["result"].append(_xdev_send(src_cp))
                    # incoming: wait for p's shard, then DMA it over
                    # the link into the gather segment
                    gather_cp.streams["fetch"].insert(
                        at, _xdev_wait(gather_cp))
                    gather_cp.streams["fetch"].insert(at + 1, Op(
                        isa.FetchInstr(gather_cp.core, 0, GATHER_STAGE, 0,
                                       gather.base, rank, _clamp16(nbytes)),
                        cycles=plan.link.cycles(nbytes)))
                    gather_cp.bytes_fetched += nbytes
                    at += 2
                    peer_cp = _first_core(progs[p].layers[i])
                    edges.append(ChannelEdge(
                        src_device=p, src_layer=i,
                        dst_device=d, dst_layer=gather_layer,
                        src_channel=f"{CORE_NAMES[peer_cp.core]}.xdev",
                        dst_channel=f"{CORE_NAMES[gather_cp.core]}.xdev",
                        nbytes=nbytes))
    mdp = MultiDeviceProgram(name, plan, progs, edges)
    return optimize_bundle(mdp, opt_level) if opt_level else mdp


# ---------------------------------------------------------------------------
# Cross-device token-pairing validation + per-device optimization
# ---------------------------------------------------------------------------


def _xdev_counts(prog: Program) -> tuple[dict[int, int], dict[int, int]]:
    """Per-layer (send count, wait count) on cross-device channels."""
    sends: dict[int, int] = {}
    waits: dict[int, int] = {}
    for lp in prog.layers:
        for cp in lp.cores():
            for op in cp.ops():
                if op.channel not in CROSS_DEVICE_CHANNELS:
                    continue
                tgt = waits if op.instr.is_wait else sends
                tgt[lp.index] = tgt.get(lp.index, 0) + 1
    return sends, waits


def validate_bundle(mdp: MultiDeviceProgram) -> None:
    """Check the cross-device token pairing against the edge table.

    Every edge must be backed by exactly one ``*.xdev`` send in the
    source device's producing layer and one ``*.xdev`` wait in the
    destination device's consuming layer — and no stray cross-device
    syncs may exist beyond the edges. Raises :class:`PartitionError`.
    """
    want_send: dict[tuple[int, int], int] = {}
    want_wait: dict[tuple[int, int], int] = {}
    for e in mdp.edges:
        k = (e.src_device, e.src_layer)
        want_send[k] = want_send.get(k, 0) + 1
        k = (e.dst_device, e.dst_layer)
        want_wait[k] = want_wait.get(k, 0) + 1
    for d, prog in enumerate(mdp.devices):
        sends, waits = _xdev_counts(prog)
        for what, have, want in (("send", sends, want_send),
                                 ("wait", waits, want_wait)):
            layers = {li for (dd, li) in want if dd == d} | set(have)
            for li in sorted(layers):
                w = want.get((d, li), 0)
                h = have.get(li, 0)
                if w != h:
                    raise PartitionError(
                        f"device {d} layer {li}: {h} cross-device "
                        f"{what}(s) in streams, edge table expects {w} — "
                        f"token pairing broken")


def optimize_bundle(mdp: MultiDeviceProgram, opt_level: int = 1, *,
                    validate: bool = True) -> MultiDeviceProgram:
    """Run the ``passes.py`` pipeline per device, then re-validate the
    cross-device token pairing (a pass that dropped or duplicated an
    ``*.xdev`` sync would corrupt a remote hand-off silently — the
    per-device deadlock check cannot see it)."""
    from repro_torch.compiler.passes import optimize_program
    if opt_level == 0:
        return mdp
    out = MultiDeviceProgram(
        mdp.name, mdp.plan,
        [optimize_program(p, opt_level, validate=validate)
         for p in mdp.devices],
        list(mdp.edges))
    if validate:
        validate_bundle(out)
    return out


# ---------------------------------------------------------------------------
# Cross-device makespan aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BundleSim:
    """Aggregate timing of a multi-device traversal.

    ``device_sims`` are the per-device event-driven ``ProgramSim``s
    (gather DMAs and their link cycles are already in the streams for
    filter plans). Pipeline plans overlap ``batches`` inputs:
    makespan = first-traversal latency + (batches-1) x steady-state
    interval, where the interval is the slowest stage or link edge.
    Filter plans run layers in data-parallel lockstep: per-layer
    makespan is the max over devices, and batches do not overlap.
    """
    kind: str
    batches: int
    device_sims: list            # list[ProgramSim]
    edge_cycles: list[int]       # per ChannelEdge link cost (pipeline)

    @property
    def stage_cycles(self) -> list[int]:
        return [s.total_cycles for s in self.device_sims]

    @property
    def latency_cycles(self) -> int:
        """One traversal: input enters device 0, result leaves the end."""
        if self.kind == "pipeline":
            return sum(self.stage_cycles) + sum(self.edge_cycles)
        n_layers = len(self.device_sims[0].layers)
        return sum(max(s.layers[i].cycles for s in self.device_sims)
                   for i in range(n_layers))

    @property
    def interval_cycles(self) -> int:
        """Steady-state cycles between consecutive results."""
        if self.kind == "pipeline":
            return max(self.stage_cycles + (self.edge_cycles or [0]))
        return self.latency_cycles

    @property
    def total_cycles(self) -> int:
        """Makespan of ``batches`` back-to-back inputs."""
        return (self.latency_cycles
                + (self.batches - 1) * self.interval_cycles)

    @property
    def n_instructions(self) -> int:
        return sum(s.n_instructions for s in self.device_sims)

    def decomposition(self, core: str) -> dict[str, int]:
        agg = {"l_wait": 0, "l_run": 0, "l_sig": 0, "l_rst": 0}
        for s in self.device_sims:
            d = s.decomposition(core)
            for k in agg:
                agg[k] += d[k]
        return agg


def simulate_bundle(mdp: MultiDeviceProgram, batches: int = 1,
                    tracer=None) -> BundleSim:
    """Per-device event-driven simulation + cross-device aggregation.

    ``tracer`` (a ``repro.obs.Tracer``; default off) records every
    device's spans on its own track group, placed on the bundle's
    global timeline: pipeline stages start after the prior stages and
    link edges they wait on (link transfers get their own track), and
    filter plans share the per-layer cross-device-max window so the
    lockstep idle shows up explicitly. The trace decomposes one
    traversal — its makespan is ``latency_cycles`` (== ``total_cycles``
    at ``batches=1``, the configuration the closure tests pin).
    """
    from repro_torch.core.scheduler import (ProgramSim, record_program_trace,
                                      simulate_layers)
    tracing = tracer is not None and getattr(tracer, "enabled", False)
    sims = [ProgramSim(simulate_layers(p, collect_traces=tracing))
            for p in mdp.devices]
    edge_cycles = [mdp.plan.link.cycles(e.nbytes) for e in mdp.edges] \
        if mdp.plan.kind == "pipeline" else []
    bs = BundleSim(kind=mdp.plan.kind, batches=max(1, int(batches)),
                   device_sims=sims, edge_cycles=edge_cycles)
    if not tracing:
        return bs
    latency = bs.latency_cycles
    if mdp.plan.kind == "pipeline":
        offset = 0
        for d, (prog, ps) in enumerate(zip(mdp.devices, sims)):
            record_program_trace(tracer, d, prog.device.name, prog,
                                 ps.layers, offset=offset)
            # everything outside this device's own stage window —
            # upstream/downstream stages and the link edges — is idle
            # for all six of its tracks
            tracer.pad_idle(d, latency - ps.total_cycles)
            offset += ps.total_cycles
            for e, c in zip(mdp.edges, edge_cycles):
                if e.src_device != d:
                    continue
                tracer.record_link(d, e.dst_device, offset, c, e.nbytes,
                                   f"L{e.src_layer}->L{e.dst_layer}")
                offset += c
    else:  # filter: data-parallel lockstep, shared per-layer windows
        n_layers = len(sims[0].layers)
        windows = [max(s.layers[i].cycles for s in sims)
                   for i in range(n_layers)]
        for d, (prog, ps) in enumerate(zip(mdp.devices, sims)):
            record_program_trace(tracer, d, prog.device.name, prog,
                                 ps.layers, windows=windows)
    tracer.set_makespan(latency)
    return bs


# ---------------------------------------------------------------------------
# Decode-resident bundles (multi-device autoregressive serving)
# ---------------------------------------------------------------------------


def decorate_decode_bundle(mdp: MultiDeviceProgram, step) -> MultiDeviceProgram:
    """Apply :func:`~repro.compiler.lower.decorate_decode` to every
    per-device program in place: weight segments become resident, and
    each device's attention/SSM shard gains its own (shard-sized)
    KV-cache/state segment plus the persistent read/append DMAs. The
    decoration adds no cross-device syncs, so the edge table is
    untouched (re-validated to be sure)."""
    from repro_torch.compiler.lower import decorate_decode
    for p in mdp.devices:
        decorate_decode(p, step)
    validate_bundle(mdp)
    return mdp


def steady_bundle(mdp: MultiDeviceProgram) -> MultiDeviceProgram:
    """The steady-state decode variant of a decorated bundle: each
    device program through :func:`~repro.compiler.lower.steady_program`
    (weight fetches elided, their tokens pre-armed); the cross-device
    hand-offs are untouched, so the edge table carries over verbatim."""
    from repro_torch.compiler.lower import steady_program
    out = MultiDeviceProgram(f"{mdp.name}.steady", mdp.plan,
                             [steady_program(p) for p in mdp.devices],
                             list(mdp.edges))
    validate_bundle(out)
    return out
