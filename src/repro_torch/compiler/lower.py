"""Lowering pass: network layers → unified-ISA instruction streams.

This is the single source of truth for instruction generation. The
per-layer schedules implement Fig. 3 of the paper:

  * LUT-core (bit-serial, BISMO backbone): the serialized activation
    matrix L is resident on chip when it fits; weight column tiles R_j
    stream through a double-buffered weight buffer gated by free-slot
    tokens (WE); result tiles drain as they complete.
  * DSP-core (bit-parallel): activation row tiles double-buffered;
    the weight matrix is cached whole on chip when the weight buffer
    pool allows, else re-fetched per row tile.

``core/scheduler.py``'s ``lut_core_streams`` / ``dsp_core_streams`` are
thin wrappers over :func:`lower_lut_layer` / :func:`lower_dsp_layer`,
so the event-driven simulator, the golden executor and the serialized
program images all consume the exact same streams.

``lower_network`` walks a whole layer list through the neuron split
(Eq. 12) and packages everything as a :class:`Program` with a DDR
memory map and inter-layer barrier tokens (inter-layer synchronous,
intra-layer asynchronous — §3.1). It emits the *canonical* Fig.-3
schedule; ``opt_level >= 1`` then runs the program-level optimization
pipeline of ``passes.py`` (weight-tile prefetch reordering, sync
elision, fused result DMA pairs) over the lowered streams.
"""
from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np

from repro_torch.core import isa
from repro_torch.core.split import split_curves
from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    GemmDims,
    LutCoreConfig,
    Op,
    _dma_cycles,
)
from repro_torch.compiler.program import (
    CHANNEL_FLAGS,
    CoreProgram,
    ElementwiseOp,
    GemmLayer,
    LayerProgram,
    MemoryMap,
    Program,
    StepSpec,
)

#: ``stage_ctrl`` values of the persistent-segment DMAs emitted by the
#: decode decoration (0=weights, 1=acts, 2=result, 3=gather are taken
#: by the fixed-seq lowering and the filter-parallel partitioner).
#: A stage-4 Result appends one row to a ``kv``/``state`` segment at
#: ``base + pos * row_bytes`` (``pos`` is the step-position register
#: supplied per invocation); a stage-5 Fetch reads the persistent
#: window back (timed at the worst-case ``max_seq`` footprint).
KV_APPEND_STAGE = 4
KV_READ_STAGE = 5
PERSISTENT_STAGES = (KV_APPEND_STAGE, KV_READ_STAGE)

#: ``stage_ctrl`` of the fused elementwise result tail (conv chains):
#: a stage-6 Fetch reads the residual-add operand from the producer's
#: output segment; a stage-6 Result applies the tail (add / activation
#: / pool / requant) over the layer's fp32 result and writes the
#: requantized codes back to ``L{i}.out``. The stage is sequential in
#: the result stream — no new sync channel (both cores' flag spaces
#: are full), the tail simply runs after the last result drain and
#: before the inter-layer barrier send.
EW_STAGE = 6
#: Elementwise throughput model: lanes applied per cycle per op pass.
EW_LANES = 16

#: Channels whose tokens are posted by the fetch engine strictly after
#: weight fetches — the sends that go away with the fetches when a
#: steady-state decode program elides resident-weight loads.
_WEIGHT_FETCH_SENDS = frozenset({"lut.wtile", "dsp.wall", "dsp.wtile"})
#: Fetch-engine waits that exist only to gate weight-tile fetches.
_WEIGHT_FETCH_WAITS = frozenset({"lut.wslot"})


@dataclasses.dataclass(frozen=True)
class LayerAddrs:
    """DDR bases the layer's DMA instructions address (all 32-bit)."""
    wgt_base: int = 0
    act_base: int = 0
    out_base: int = 0


def _send(core: isa.CoreSel, src: isa.Engine, dst: isa.Engine,
          ch: str) -> Op:
    flag = CHANNEL_FLAGS[ch]
    return Op(
        isa.SyncInstr(core=core, src_engine=src, dst_engine=dst, cur_state=0,
                      next_state=min(3, flag), token_flag=flag, is_wait=0),
        cycles=1, channel=ch)


def _wait(core: isa.CoreSel, src: isa.Engine, dst: isa.Engine,
          ch: str) -> Op:
    flag = CHANNEL_FLAGS[ch]
    return Op(
        isa.SyncInstr(core=core, src_engine=src, dst_engine=dst, cur_state=1,
                      next_state=min(3, flag), token_flag=flag, is_wait=1),
        cycles=1, channel=ch)


def _clamp16(v: float) -> int:
    return min(65535, int(v))


# ---------------------------------------------------------------------------
# LUT-core layer lowering (bit-serial schedule of Fig. 3)
# ---------------------------------------------------------------------------


def lower_lut_layer(g: GemmDims, cfg: LutCoreConfig, dev: FPGADevice,
                    bits_w: int, bits_a: int, depthwise: bool = False,
                    addrs: LayerAddrs = LayerAddrs(),
                    act_bytes: float | None = None) -> CoreProgram:
    """Lower one layer partition onto the LUT-core.

    Cycle model: a (m x n) output tile accumulates over ceil(K_g/K)
    K-bit beats per binary plane pair; there are bits_w*bits_a plane
    pairs; plus a fixed array fill/drain per tile. Result tiles are
    written back to DDR requantized to the next layer's activation
    bit-width (§3.1), approximated with ``bits_a``.

    ``act_bytes`` overrides the activation-fetch footprint: conv layers
    pass the raw spatial NHWC source size (the fused kernels generate
    im2col patches on chip, so DMA never moves the kh*kw-duplicated
    column matrix).
    """
    C = isa.CoreSel.LUT
    nt_m = math.ceil(g.m / cfg.m)
    nt_n = math.ceil(g.n / cfg.n)
    if depthwise:
        # channels across columns, K = kh*kw taps, derated MAC rate
        nt_k = 1
        tile_exec = math.ceil(g.k * bits_w * bits_a /
                              (cfg.k * cfg.dw_efficiency)) + cfg.pipeline_fill
        bytes_l = g.m * g.n * bits_a / 8.0      # NHWC, no channel reuse
        bytes_r_tile = g.k * cfg.n * bits_w / 8.0
    else:
        nt_k = math.ceil(g.k / cfg.k)
        tile_exec = nt_k * bits_w * bits_a + cfg.pipeline_fill
        bytes_l = g.m * g.k * bits_a / 8.0      # serialized activation planes
        bytes_r_tile = cfg.n * g.k * bits_w / 8.0   # one weight column-tile
    if act_bytes is not None:
        bytes_l = float(act_bytes)              # spatial source, no im2col dup
    bytes_out_tile = cfg.m * cfg.n * bits_a / 8.0   # requantized write-back

    # Activation residency: the activation buffer pool holds M x D_a x K
    # bits. When the (serialized) L matrix exceeds it, L is re-streamed
    # for every weight column tile (§3.1).
    a_capacity_bits = cfg.m * cfg.d_a * cfg.k
    a_resident = bytes_l * 8 <= a_capacity_bits

    fetch: list[Op] = []
    execu: list[Op] = []
    result: list[Op] = []
    fetched = written = 0.0

    def fetch_wtile(j: int) -> Op:
        nonlocal fetched
        fetched += bytes_r_tile
        return Op(isa.FetchInstr(C, 0, 0, j % 2, addrs.wgt_base, j,
                                 _clamp16(bytes_r_tile)),
                  cycles=_dma_cycles(bytes_r_tile, dev))

    def fetch_act(half: int) -> Op:
        nonlocal fetched
        fetched += bytes_l
        return Op(isa.FetchInstr(C, 0, 1, half, addrs.act_base, 0,
                                 _clamp16(bytes_l)),
                  cycles=_dma_cycles(bytes_l, dev))

    # R0 first, then L (paper: "R0 is fetched ... then L0 is fetched").
    fetch.append(fetch_wtile(0))
    fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "lut.wtile"))
    fetch.append(fetch_act(0))
    fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "lut.act"))
    for j in range(1, nt_n):
        # Wait for a free slot in the double-buffered weight buffer (WE).
        fetch.append(_wait(C, isa.Engine.EXECUTE, isa.Engine.FETCH, "lut.wslot"))
        fetch.append(fetch_wtile(j))
        fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "lut.wtile"))
        if not a_resident:
            # re-stream the activation matrix for this column tile
            fetch.append(fetch_act(j % 2))
            fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE,
                               "lut.act"))

    execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "lut.act"))
    for j in range(nt_n):
        execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "lut.wtile"))
        if not a_resident and j > 0:
            execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE,
                               "lut.act"))
        for i in range(nt_m):
            execu.append(Op(isa.ExecuteInstr(
                C, buf_addr_a=(i * nt_k) & 0xFFFF, buf_addr_w=(j * nt_k) & 0xFFFF,
                tile_m=min(4095, cfg.m), tile_k=min(65535, g.k),
                tile_n=min(4095, cfg.n), bits_w=bits_w, bits_a=bits_a,
                accumulate=0), cycles=tile_exec))
            execu.append(_send(C, isa.Engine.EXECUTE, isa.Engine.RESULT, "lut.res"))
        # Free this weight-buffer slot for the fetch engine (SE).
        execu.append(_send(C, isa.Engine.EXECUTE, isa.Engine.FETCH, "lut.wslot"))

    for j in range(nt_n):
        for i in range(nt_m):
            result.append(_wait(C, isa.Engine.EXECUTE, isa.Engine.RESULT, "lut.res"))
            written += bytes_out_tile
            result.append(Op(isa.ResultInstr(C, 0, 2, 0, addrs.out_base,
                                             (j * nt_m + i) & 0xFFFFFF,
                                             _clamp16(bytes_out_tile)),
                             cycles=_dma_cycles(bytes_out_tile, dev)))

    # One weight-buffer slot is free at t=0 (the other is filled by the
    # un-gated first fetch) => effective double buffering.
    return CoreProgram(
        core=C,
        streams={"fetch": fetch, "execute": execu, "result": result},
        initial_tokens={"lut.wslot": 1},
        bytes_fetched=fetched, bytes_written=written)


# ---------------------------------------------------------------------------
# DSP-core layer lowering (bit-parallel schedule)
# ---------------------------------------------------------------------------


def lower_dsp_layer(g: GemmDims, cfg: DspCoreConfig, dev: FPGADevice,
                    depthwise: bool = False,
                    addrs: LayerAddrs = LayerAddrs(),
                    act_bytes: float | None = None) -> CoreProgram:
    """Lower one layer partition onto the DSP-core.

    The register arrays compute an [R x 16] x [16 x 16] product per
    K-step: 2 cycles to fill the weight registers (two columns per
    buffer per cycle), then 16 systolic MAC cycles. Activation row-tiles
    are double buffered; weight column-tiles are cached on chip when the
    weight buffer capacity allows, else re-fetched per row-tile.

    ``act_bytes`` overrides the total activation-fetch footprint (spread
    evenly over the row tiles) — conv layers pass the raw spatial NHWC
    source size since the fused kernels im2col on chip.
    """
    C = isa.CoreSel.DSP
    R = cfg.n_reg_row_a
    kstep = cfg.w_fill_cycles + cfg.n_reg_col_w + cfg.a_fill_cycles
    nt_m = math.ceil(g.m / R)
    nt_n = math.ceil(g.n / cfg.n_reg_col_w)
    bits_a_stored = 4  # activations are zero-padded to 4 bits in buffers
    if depthwise:
        # per-tap diagonal weight mode: 16 channels per pass, derated
        tile_exec = math.ceil(g.k * kstep /
                              (cfg.n_reg_col_a * cfg.dw_efficiency))
        bytes_a_tile = R * cfg.n_reg_col_w * bits_a_stored / 8.0
        bytes_w_tile = g.k * cfg.n_reg_col_w * 4 / 8.0
    else:
        nt_k = math.ceil(g.k / cfg.n_reg_col_a)
        tile_exec = nt_k * kstep
        bytes_a_tile = R * g.k * bits_a_stored / 8.0
        bytes_w_tile = g.k * cfg.n_reg_col_w * 4 / 8.0  # int4 weights
    if act_bytes is not None:
        bytes_a_tile = float(act_bytes) / nt_m  # spatial source, no im2col dup
    bytes_out_tile = R * cfg.n_reg_col_w * bits_a_stored / 8.0

    # Weight resident if every column tile fits the weight buffer pool.
    w_capacity_bits = (cfg.n_reg_col_w // 2) * cfg.d_w * (cfg.n_reg_col_a * 4)
    w_resident = nt_n * bytes_w_tile * 8 <= w_capacity_bits

    fetch: list[Op] = []
    execu: list[Op] = []
    result: list[Op] = []
    fetched = written = 0.0

    if w_resident:
        fetched += nt_n * bytes_w_tile
        fetch.append(Op(isa.FetchInstr(C, 0, 0, 0, addrs.wgt_base, 0,
                                       _clamp16(nt_n * bytes_w_tile)),
                        cycles=_dma_cycles(nt_n * bytes_w_tile, dev)))
        fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "dsp.wall"))

    for i in range(nt_m):
        if i >= 2:
            fetch.append(_wait(C, isa.Engine.EXECUTE, isa.Engine.FETCH, "dsp.aslot"))
        fetched += bytes_a_tile
        fetch.append(Op(isa.FetchInstr(C, 0, 1, i % 2, addrs.act_base, i,
                                       _clamp16(bytes_a_tile)),
                        cycles=_dma_cycles(bytes_a_tile, dev)))
        fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "dsp.atile"))
        if not w_resident:
            for j in range(nt_n):
                fetched += bytes_w_tile
                fetch.append(Op(isa.FetchInstr(C, 0, 0, j % 2, addrs.wgt_base, j,
                                               _clamp16(bytes_w_tile)),
                                cycles=_dma_cycles(bytes_w_tile, dev)))
                fetch.append(_send(C, isa.Engine.FETCH, isa.Engine.EXECUTE,
                                   "dsp.wtile"))

    if w_resident:
        execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "dsp.wall"))
    for i in range(nt_m):
        execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE, "dsp.atile"))
        for j in range(nt_n):
            if not w_resident:
                execu.append(_wait(C, isa.Engine.FETCH, isa.Engine.EXECUTE,
                                   "dsp.wtile"))
            execu.append(Op(isa.ExecuteInstr(
                C, buf_addr_a=i & 0xFFFF, buf_addr_w=j & 0xFFFF,
                tile_m=min(4095, R), tile_k=min(65535, g.k),
                tile_n=cfg.n_reg_col_w, bits_w=4, bits_a=4,
                accumulate=0), cycles=tile_exec))
            execu.append(_send(C, isa.Engine.EXECUTE, isa.Engine.RESULT, "dsp.res"))
        execu.append(_send(C, isa.Engine.EXECUTE, isa.Engine.FETCH, "dsp.aslot"))

    for i in range(nt_m):
        for j in range(nt_n):
            result.append(_wait(C, isa.Engine.EXECUTE, isa.Engine.RESULT, "dsp.res"))
            written += bytes_out_tile
            result.append(Op(isa.ResultInstr(C, 0, 2, 0, addrs.out_base,
                                             (i * nt_n + j) & 0xFFFFFF,
                                             _clamp16(bytes_out_tile)),
                             cycles=_dma_cycles(bytes_out_tile, dev)))

    return CoreProgram(
        core=C,
        streams={"fetch": fetch, "execute": execu, "result": result},
        initial_tokens={"dsp.aslot": 1},
        bytes_fetched=fetched, bytes_written=written)


# ---------------------------------------------------------------------------
# Neuron split on raw GEMM dims (Eq. 12 over the closed-form curves)
# ---------------------------------------------------------------------------


def solve_split_dims(g: GemmDims, depthwise: bool, lut_cfg: LutCoreConfig,
                     dsp_cfg: DspCoreConfig, dev: FPGADevice,
                     bits_w_lut: int, bits_a: int) -> int:
    """Exact Eq.-(12) argmin over n_lut in {0..n}; the curves come from
    ``core/split.py`` so the DSE and the compiler share one solver."""
    _, _, makespan = split_curves(g, depthwise, lut_cfg, dsp_cfg, dev,
                                  bits_w_lut, bits_a)
    return int(np.argmin(makespan))


# ---------------------------------------------------------------------------
# Whole-network lowering
# ---------------------------------------------------------------------------


def _barrier(core: isa.CoreSel, ch: str) -> tuple[Op, Op]:
    send = _send(core, isa.Engine.RESULT, isa.Engine.FETCH, ch)
    wait = _wait(core, isa.Engine.RESULT, isa.Engine.FETCH, ch)
    return send, wait


def _requant_bits(layers: list[GemmLayer], ba: list[int], i: int) -> int:
    """Write-back code width of conv layer ``i``: the activation
    bit-width of its first consumer — a later layer whose activation
    read (``geometry.src_offset``) or residual add reaches ``i``.
    Returns 0 for the final layer (no consumer: raw fp32 logits)."""
    for j in range(i + 1, len(layers)):
        gj = layers[j].geometry
        if j - (gj.src_offset if gj is not None else 1) == i:
            return ba[j]
        for op in layers[j].elementwise:
            if op.kind == "add" and j - op.src_offset == i:
                return ba[j]
    return 0


def lower_network(name: str, layers: list[GemmLayer],
                  lut_cfg: LutCoreConfig, dsp_cfg: DspCoreConfig,
                  dev: FPGADevice,
                  bits_w_lut: int | list[int] = 4,
                  bits_a: int | list[int] = 4,
                  n_luts: list[int] | None = None,
                  opt_level: int = 0,
                  plan=None,
                  step: StepSpec | None = None) -> Program:
    """Compile a whole network into a :class:`Program`.

    ``step`` (a :class:`~repro.compiler.program.StepSpec`) switches to
    *decode mode*: ``layers`` must be the m=batch single-step GEMM
    list, and the lowered program is decorated with the invocation
    contract — weight segments become ``weights``-resident, attention
    k/v projections gain persistent ``kv`` cache segments (stage-4
    append at the step position, stage-5 read-back before the output
    projection) and SSM blocks a persistent ``state`` segment — before
    the optimization pipeline runs (see :func:`decorate_decode`;
    :func:`steady_program` derives the warm-cache variant whose weight
    fetches are elided).

    ``plan`` (a ``partition.PartitionPlan``) switches to the
    multi-device path: the network is partitioned per the plan and a
    ``MultiDeviceProgram`` bundle of per-device programs with
    cross-device Sync channels is returned instead (a 1-device plan
    reproduces the single program bit for bit).

    Per layer: pick the neuron split (given ``n_luts`` or solved via
    Eq. 12), partition the GEMM along output filters, lower each
    partition on its core, and allocate DDR segments for weights and
    the activation chain. Plain GEMM layers read their producer's
    output segment directly (layer i reads layer i-1's output). Conv
    layers (a :class:`~repro.compiler.program.ConvGeometry` on the
    ``GemmLayer``) read the *spatial* NHWC segment of the producer
    named by ``geometry.src_offset`` (falling back to ``act.in`` when
    it precedes the program): the fused kernels generate im2col
    patches on chip, so no ``L{i}.col`` staging copy exists in the DDR
    map and the act-fetch DMA accounting covers only the raw spatial
    footprint. Layers are chained inter-layer synchronously: each
    core's fetch stream for layer i>0 opens with a barrier wait
    matched by a barrier send at the tail of its layer i-1 result
    stream.

    ``opt_level=0`` returns the canonical schedule; ``opt_level=1``
    additionally runs the ``passes.py`` optimization pipeline (the
    per-pass accounting lands on ``Program.opt_stats``).
    """
    if plan is not None:
        # deferred import: partition.py builds on this lowerer
        from repro_torch.compiler.partition import lower_partitioned
        return lower_partitioned(name, layers, plan, lut_cfg, dsp_cfg,
                                 dev, bits_w_lut=bits_w_lut, bits_a=bits_a,
                                 n_luts=n_luts, opt_level=opt_level)
    nl = len(layers)
    bw = list(bits_w_lut) if isinstance(bits_w_lut, (list, tuple)) \
        else [bits_w_lut] * nl
    ba = list(bits_a) if isinstance(bits_a, (list, tuple)) else [bits_a] * nl
    if len(bw) != nl or len(ba) != nl:
        raise ValueError("per-layer bit lists must match the layer count")
    for i, (w, a) in enumerate(zip(bw, ba)):
        # paper range is 2-8 (and the ISA bit-width fields are 4 bits)
        if not (2 <= w <= 8 and 2 <= a <= 8):
            raise ValueError(
                f"layer {i}: bit-widths must be in 2..8, got "
                f"bits_w_lut={w} bits_a={a}")

    mem = MemoryMap()
    if nl and layers[0].geometry is not None:
        # conv programs ingest the spatial NHWC tensor, not its im2col
        geo0 = layers[0].geometry
        in_bytes = math.ceil(geo0.in_hw * geo0.in_hw * geo0.c_in
                             * ba[0] / 8)
    else:
        in_bytes = math.ceil(layers[0].dims.m * layers[0].dims.k
                             * ba[0] / 8) if nl else 0
    in_seg = mem.alloc("act.in", in_bytes)

    progs: list[LayerProgram] = []
    out_segs: list = []
    for i, layer in enumerate(layers):
        g = layer.dims
        geom = layer.geometry
        if n_luts is not None:
            n_lut = int(min(max(n_luts[i], 0), g.n))
        else:
            n_lut = solve_split_dims(g, layer.depthwise, lut_cfg, dsp_cfg,
                                     dev, bw[i], ba[i])
        g_lut = GemmDims(g.m, g.k, n_lut)
        g_dsp = GemmDims(g.m, g.k, g.n - n_lut)

        wgt_lut = mem.alloc(f"L{i}.wgt.lut",
                            math.ceil(g.k * g_lut.n * bw[i] / 8))
        wgt_dsp = mem.alloc(f"L{i}.wgt.dsp", math.ceil(g.k * g_dsp.n * 4 / 8))
        if geom is not None:
            # fused conv path: act fetches read the producer's spatial
            # NHWC segment directly; im2col happens inside the kernel,
            # so neither DDR nor DMA ever sees the column matrix.
            src = i - geom.src_offset
            act_seg = out_segs[src] if src >= 0 else in_seg
            act_bytes = math.ceil(geom.in_hw * geom.in_hw * geom.c_in
                                  * ba[i] / 8)
        else:
            src = i - 1
            act_seg = out_segs[src] if src >= 0 else in_seg
            act_bytes = None
        out_seg = mem.alloc(f"L{i}.out", math.ceil(g.m * g.n * ba[i] / 8))

        lut_cp = dsp_cp = None
        if g_lut.n > 0:
            lut_cp = lower_lut_layer(
                g_lut, lut_cfg, dev, bw[i], ba[i], layer.depthwise,
                LayerAddrs(wgt_lut.base, act_seg.base, out_seg.base),
                act_bytes=act_bytes)
        if g_dsp.n > 0:
            dsp_cp = lower_dsp_layer(
                g_dsp, dsp_cfg, dev, layer.depthwise,
                LayerAddrs(wgt_dsp.base, act_seg.base, out_seg.base),
                act_bytes=act_bytes)

        # Fused elementwise result tail (conv chains only): the spec's
        # add/activation ops plus the write-back requant at the first
        # consumer's activation bit-width. Emitted as stage-6 DMAs on
        # the layer's first active core — sequential in its streams, so
        # the event-driven simulator times them with no extra channel.
        ew = tuple(layer.elementwise)
        if geom is not None:
            qb = _requant_bits(layers, ba, i)
            if qb:
                ew = ew + (ElementwiseOp("requant", bits=qb),)
        if ew and geom is not None:
            cp = lut_cp if lut_cp is not None else dsp_cp
            qbits = ew[-1].bits if ew[-1].kind == "requant" else 32
            phw = geom.pooled_hw()
            ew_out_bytes = math.ceil(phw * phw * geom.c_out * qbits / 8)
            for op in ew:
                if op.kind != "add":
                    continue
                src_res = i - op.src_offset
                res_seg = out_segs[src_res] if src_res >= 0 else in_seg
                res_bytes = math.ceil(g.m * g.n * ba[i] / 8)
                cp.streams["fetch"].append(
                    Op(isa.FetchInstr(cp.core, 0, EW_STAGE, 0,
                                      res_seg.base, 0, _clamp16(res_bytes)),
                       cycles=_dma_cycles(res_bytes, dev)))
                cp.bytes_fetched += res_bytes
            ew_cycles = (len(ew) * math.ceil(g.m * g.n / EW_LANES)
                         + _dma_cycles(ew_out_bytes, dev))
            cp.streams["result"].append(
                Op(isa.ResultInstr(cp.core, 0, EW_STAGE, 0, out_seg.base,
                                   len(ew) & 0xFFFFFF,
                                   _clamp16(ew_out_bytes)),
                   cycles=ew_cycles))
            cp.bytes_written += ew_out_bytes

        progs.append(LayerProgram(
            index=i, name=layer.name, dims=g, n_lut=n_lut,
            bits_w_lut=bw[i], bits_a=ba[i], depthwise=layer.depthwise,
            lut=lut_cp, dsp=dsp_cp, geometry=geom, elementwise=ew))
        out_segs.append(out_seg)

    # Inter-layer barriers (per core, when active on both sides).
    for prev, cur in zip(progs, progs[1:]):
        for attr, ch in (("lut", "lut.bar"), ("dsp", "dsp.bar")):
            p_cp, c_cp = getattr(prev, attr), getattr(cur, attr)
            if p_cp is None or c_cp is None:
                continue
            send, wait = _barrier(p_cp.core, ch)
            p_cp.streams["result"].append(send)
            c_cp.streams["fetch"].insert(0, wait)

    prog = Program(name=name, device=dev, lut_cfg=lut_cfg, dsp_cfg=dsp_cfg,
                   layers=progs, memory=mem)
    if step is not None:
        decorate_decode(prog, step)
    if opt_level:
        # deferred import: passes.py consumes Program, not the lowerer
        from repro_torch.compiler.passes import optimize_program
        prog = optimize_program(prog, opt_level, copy_program=False)
    return prog


# ---------------------------------------------------------------------------
# Decode mode: residency decoration + steady-state weight-fetch elision
# ---------------------------------------------------------------------------


def _first_core(lp: LayerProgram) -> CoreProgram:
    return lp.lut if lp.lut is not None else lp.dsp


def _persistent_insert_at(cp: CoreProgram) -> int:
    """Index after the leading barrier/cross-device waits of a fetch
    stream — persistent reads slot in once the layer is released."""
    at = 0
    stream = cp.streams["fetch"]
    while at < len(stream) and isinstance(stream[at].instr, isa.SyncInstr):
        at += 1
    return at


def _persistent_append_at(cp: CoreProgram) -> int:
    """Index before the trailing barrier sends of a result stream —
    persistent appends land before the next layer is released."""
    stream = cp.streams["result"]
    at = len(stream)
    while at > 0 and isinstance(stream[at - 1].instr, isa.SyncInstr):
        at -= 1
    return at


def decorate_decode(prog: Program, step: StepSpec) -> Program:
    """Stamp the invocation contract onto a lowered m=batch program.

    Driven purely by layer names (so it applies unchanged to the
    per-device shards of a partitioned bundle, which keep them):

      * every ``L{i}.wgt.*`` segment becomes ``weights``-resident;
      * ``*.attn.k`` / ``*.attn.v`` layers allocate a persistent ``kv``
        segment (``max_seq`` rows of the requantized projection output)
        and append one row per invocation via a stage-4 Result at the
        step position;
      * ``*.attn.o`` layers read both caches of their block back
        through stage-5 Fetches (timed at the worst-case full window);
      * ``*.ssm.out`` layers allocate a per-block fp32 ``state``
        segment, read it at the fetch head and write it back in place
        at the result tail.
    """
    mem, dev = prog.memory, prog.device
    for seg in list(mem.segments):
        if ".wgt." in seg.name:
            mem.set_residency(seg.name, "weights")
    for lp in prog.layers:
        cp = _first_core(lp)
        if lp.name.endswith((".attn.k", ".attn.v")):
            row = math.ceil(step.batch * lp.dims.n * lp.bits_a / 8)
            seg = mem.alloc(f"{lp.name}.cache", step.max_seq * row,
                            residency="kv")
            cp.streams["result"].insert(
                _persistent_append_at(cp),
                Op(isa.ResultInstr(cp.core, 0, KV_APPEND_STAGE, 0,
                                   seg.base, 0, _clamp16(row)),
                   cycles=_dma_cycles(row, dev)))
            cp.bytes_written += row
        elif lp.name.endswith(".attn.o"):
            blk = lp.name.rsplit(".", 2)[0]
            at = _persistent_insert_at(cp)
            for which in ("k", "v"):
                cache = f"{blk}.attn.{which}.cache"
                if cache not in mem:
                    continue
                seg = mem[cache]
                cp.streams["fetch"].insert(
                    at, Op(isa.FetchInstr(cp.core, 0, KV_READ_STAGE, 0,
                                          seg.base, 0, _clamp16(seg.size)),
                           cycles=_dma_cycles(seg.size, dev)))
                cp.bytes_fetched += seg.size
                at += 1
        elif lp.name.endswith(".ssm.out"):
            # fp32 recurrent state, one row per batch lane, in-place
            nbytes = step.batch * lp.dims.k * 4
            seg = mem.alloc(f"{lp.name.rsplit('.', 1)[0]}.state", nbytes,
                            residency="state")
            cp.streams["fetch"].insert(
                _persistent_insert_at(cp),
                Op(isa.FetchInstr(cp.core, 0, KV_READ_STAGE, 0,
                                  seg.base, 0, _clamp16(nbytes)),
                   cycles=_dma_cycles(nbytes, dev)))
            cp.streams["result"].insert(
                _persistent_append_at(cp),
                Op(isa.ResultInstr(cp.core, 0, KV_APPEND_STAGE, 0,
                                   seg.base, 0, _clamp16(nbytes)),
                   cycles=_dma_cycles(nbytes, dev)))
            cp.bytes_fetched += nbytes
            cp.bytes_written += nbytes
    prog.step = step
    return prog


def steady_program(prog: Program) -> Program:
    """Derive the steady-state variant of a decode program: stage-0
    fetches into ``weights``-resident segments are elided along with
    their slot waits and ready sends, whose tokens are armed as initial
    tokens instead (the tiles are already on chip from the warm-up
    invocation). Persistent kv/state traffic and all activation
    movement survive — steady state moves only the new token.
    """
    if prog.step is None:
        raise ValueError("steady_program needs a decode program "
                         "(Program.step is None)")
    out = copy.deepcopy(prog)
    out.name = f"{prog.name}.steady"
    resident = {s.base for s in out.memory.segments
                if s.residency == "weights"}
    for lp in out.layers:
        for cp in lp.cores():
            kept: list[Op] = []
            for op in cp.streams["fetch"]:
                ins = op.instr
                if (isinstance(ins, isa.FetchInstr)
                        and ins.stage_ctrl == 0
                        and ins.ddr_base in resident):
                    cp.bytes_fetched -= max(
                        0.0, (op.cycles - prog.device.dma_setup_cycles)
                        * prog.device.dma_bytes_per_cycle)
                    continue
                if isinstance(ins, isa.SyncInstr):
                    if ins.is_wait and op.channel in _WEIGHT_FETCH_WAITS:
                        continue
                    if not ins.is_wait and op.channel in _WEIGHT_FETCH_SENDS:
                        cp.initial_tokens[op.channel] = \
                            cp.initial_tokens.get(op.channel, 0) + 1
                        continue
                kept.append(op)
            cp.streams["fetch"] = kept
    return out
