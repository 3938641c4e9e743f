"""Program IR of the NN→ISA compiler.

A :class:`Program` is the compiler's output artifact and the single
currency everything downstream consumes:

  * ``core/scheduler.py`` simulates its per-engine instruction streams
    (the Fig. 3/Fig. 5 latency decomposition);
  * ``compiler/runtime/`` executes it functionally against the
    reference GEMM numerics (golden model) or the batched Pallas path;
  * ``compiler/asm.py`` serializes it to text assembly and to a packed
    binary image, bit-exactly.

Structure: one :class:`LayerProgram` per network layer, each holding the
two per-core instruction streams (LUT bit-serial partition + DSP
bit-parallel partition) produced by the neuron split, plus the DDR
:class:`MemoryMap` that positions weights/activations/outputs.

Every instruction is a real 128-bit ``core/isa.py`` word; each carries a
timing closure (busy cycles once runnable — the scheduler's DMA/compute
cycle model evaluated at lowering time) and, for Sync instructions, the
token channel it posts to / consumes from. Channels are recoverable
from the encoded word alone via the per-core ``token_flag`` tables
below, so disassembly loses nothing.
"""
from __future__ import annotations

import dataclasses
import hashlib

from repro_torch.core import isa
from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    GemmDims,
    LutCoreConfig,
    Op,
)

# ---------------------------------------------------------------------------
# Sync channel <-> token_flag tables (3-bit flag per core)
# ---------------------------------------------------------------------------

# LUT-core channels: weight column tile ready (SE), activation matrix
# ready, free weight-buffer slot (WE), result tile ready, layer barrier,
# cross-device hand-off (multi-device plans, compiler/partition.py).
LUT_CHANNEL_FLAGS = {"lut.wtile": 1, "lut.act": 2, "lut.wslot": 3,
                     "lut.res": 4, "lut.bar": 5, "lut.xdev": 6}
# DSP-core channels: whole-weight-resident ready, activation row tile,
# weight column tile, free activation slot, result tile, layer barrier,
# cross-device hand-off.
DSP_CHANNEL_FLAGS = {"dsp.wall": 1, "dsp.atile": 2, "dsp.wtile": 3,
                     "dsp.aslot": 4, "dsp.res": 5, "dsp.bar": 6,
                     "dsp.xdev": 7}

CHANNEL_FLAGS = {**LUT_CHANNEL_FLAGS, **DSP_CHANNEL_FLAGS}

#: Channels whose tokens cross a device boundary (the matching send or
#: wait lives in *another* device's program). Local simulation arms
#: their waits at t=0; the optimization passes must never elide or
#: reorder them (compiler/passes.py), and ``partition.validate_bundle``
#: checks the cross-device pairing instead.
CROSS_DEVICE_CHANNELS = frozenset({"lut.xdev", "dsp.xdev"})
FLAG_CHANNELS = {
    isa.CoreSel.LUT: {f: ch for ch, f in LUT_CHANNEL_FLAGS.items()},
    isa.CoreSel.DSP: {f: ch for ch, f in DSP_CHANNEL_FLAGS.items()},
}

ENGINES = ("fetch", "execute", "result")
CORE_NAMES = {isa.CoreSel.LUT: "lut", isa.CoreSel.DSP: "dsp"}


def channel_of(instr: isa.SyncInstr) -> str:
    """Recover the token channel name from an encoded Sync instruction."""
    try:
        return FLAG_CHANNELS[instr.core][instr.token_flag]
    except KeyError:
        raise ValueError(
            f"unknown sync token flag {instr.token_flag} for core "
            f"{instr.core!r}") from None


# ---------------------------------------------------------------------------
# DDR memory map
# ---------------------------------------------------------------------------


#: Segment residency classes — the invocation contract for decode-mode
#: programs. ``io`` segments are per-step scratch (reloaded/rewritten on
#: every invocation); ``weights`` segments survive *across* invocations
#: (the first step loads them, steady-state steps reuse the resident
#: tiles); ``kv``/``state`` segments are persistent and updated in place
#: (attention KV rows appended at the step position, SSM recurrent state
#: read-modify-written each step).
RESIDENCY_CLASSES = ("io", "weights", "kv", "state")


@dataclasses.dataclass(frozen=True)
class Segment:
    """One named DDR region. ``size`` in bytes; tile-granular DMA
    instructions address it as (ddr_base=base, ddr_offset=tile index).
    ``residency`` is the invocation-contract class (RESIDENCY_CLASSES)."""
    name: str
    base: int
    size: int
    residency: str = "io"

    def __post_init__(self):
        if self.residency not in RESIDENCY_CLASSES:
            raise ValueError(f"unknown residency class {self.residency!r}")

    @property
    def end(self) -> int:
        return self.base + self.size


class MemoryMap:
    """Bump allocator over the 32-bit DDR space, 64-byte aligned."""

    ALIGN = 64

    def __init__(self):
        self.segments: list[Segment] = []
        self._by_name: dict[str, Segment] = {}
        self._cursor = 0

    def alloc(self, name: str, size: int,
              residency: str = "io") -> Segment:
        if name in self._by_name:
            raise ValueError(f"duplicate segment {name!r}")
        size = max(int(size), 0)
        base = self._cursor
        seg = Segment(name, base, size, residency)
        aligned = (size + self.ALIGN - 1) // self.ALIGN * self.ALIGN
        self._cursor = base + aligned
        if self._cursor >= (1 << 32):
            raise ValueError(f"DDR map overflows 32-bit space at {name!r}")
        self.segments.append(seg)
        self._by_name[name] = seg
        return seg

    def set_residency(self, name: str, residency: str) -> Segment:
        """Reclassify an existing segment (segments are frozen, so the
        record is replaced in place — base/size identity unchanged)."""
        old = self._by_name[name]
        seg = dataclasses.replace(old, residency=residency)
        self.segments[self.segments.index(old)] = seg
        self._by_name[name] = seg
        return seg

    def __getitem__(self, name: str) -> Segment:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    @property
    def footprint(self) -> int:
        return self._cursor

    def __eq__(self, other) -> bool:
        return (isinstance(other, MemoryMap)
                and self.segments == other.segments)

    def __repr__(self) -> str:
        return f"MemoryMap({len(self.segments)} segments, {self.footprint}B)"


# ---------------------------------------------------------------------------
# Conv-layer spatial geometry (im2col lowering, §3.2.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """Spatial geometry a conv layer's im2col lowering carries into the
    program.

    The GEMM view (``GemmDims``) is what the cores execute; the geometry
    is what the activation staging needs to *build* that view from an
    NHWC spatial tensor: ``m == out_hw**2``, ``k == c_in * kernel**2``
    for dense convs and ``k == kernel**2`` per channel for depthwise.

    ``src_offset`` names the layer whose output this layer consumes as
    its input — this layer's index minus ``src_offset`` (1 for the
    plain sequential chain, 3 for the ResNet downsample shortcuts that
    read the block input). A source falling before the program start
    reads the program input segment (``act.in``). ``pool`` is spatial
    glue applied to *this* layer's output before the consumer reads it:
    ``"max"`` (3x3 stride-2 SAME max pool, the ResNet stem) or
    ``"gap"`` (global average pool before the classifier).
    """
    kernel: int
    stride: int
    pad: int
    in_hw: int
    out_hw: int
    c_in: int
    c_out: int
    src_offset: int = 1
    pool: str = ""

    def __post_init__(self):
        if self.pool not in ("", "max", "gap"):
            raise ValueError(f"unknown pool kind {self.pool!r}")
        if self.src_offset < 1:
            raise ValueError("src_offset must be >= 1")

    @property
    def in_shape(self) -> tuple[int, int, int]:
        """Spatial NHWC input extents (batch 1): [in_hw, in_hw, c_in]."""
        return (self.in_hw, self.in_hw, self.c_in)

    def pooled_hw(self) -> int:
        """Output feature-map size after this layer's ``pool`` glue."""
        from repro_torch.core.workloads import pooled_hw
        return pooled_hw(self.out_hw, self.pool)


# ---------------------------------------------------------------------------
# Fused elementwise result tail (§residual/activation glue, in-program)
# ---------------------------------------------------------------------------


#: Elementwise op kinds, in canonical tail order: an optional residual
#: ``add`` first, then one activation (``relu``/``relu6``/``hswish``),
#: then (after the layer's ``pool`` glue) the write-back ``requant``.
ELEMENTWISE_KINDS = ("add", "relu", "relu6", "hswish", "requant")


@dataclasses.dataclass(frozen=True)
class ElementwiseOp:
    """One operation of a layer's fused elementwise result tail.

    The tail runs on the layer's fp32 result tiles before write-back:
    ``add`` accumulates the stored output of the producer ``src_offset``
    layers back (dequantized at that producer's write-back scale —
    ResNet shortcuts, MobileNet inverted residuals), the activation
    kinds apply pointwise, and ``requant`` re-quantizes to ``bits``-bit
    codes with a per-tensor max-abs scale — the codes the layer's DDR
    output segment actually holds. The layer's ``geometry.pool`` glue
    applies between the activation and the requant, matching the fp32
    network (pool over activations, then quantize).
    """
    kind: str
    src_offset: int = 0   # add: producer distance (layer pos - src pos)
    bits: int = 0         # requant: target code width

    def __post_init__(self):
        if self.kind not in ELEMENTWISE_KINDS:
            raise ValueError(f"unknown elementwise kind {self.kind!r}")
        if self.kind == "add" and self.src_offset < 1:
            raise ValueError("elementwise add needs src_offset >= 1")
        if self.kind == "requant" and not (1 <= self.bits <= 8):
            raise ValueError(f"requant bits out of range: {self.bits}")


# ---------------------------------------------------------------------------
# Per-core, per-layer stream bundles
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CoreProgram:
    """One core's three engine streams for one layer partition."""
    core: isa.CoreSel
    streams: dict[str, list[Op]]
    initial_tokens: dict[str, int]
    # lowering-time stats (bytes are exact, pre-clamp model quantities)
    bytes_fetched: float = 0.0
    bytes_written: float = 0.0

    @property
    def n_instructions(self) -> int:
        return sum(len(s) for s in self.streams.values())

    def ops(self):
        for e in ENGINES:
            yield from self.streams.get(e, [])

    def sim_tokens(self) -> dict[str, int]:
        """Initial tokens for simulating this layer *in isolation*.

        The program artifact keeps inter-layer barrier waits un-armed —
        on hardware (or a concurrent multi-layer consumer) the matching
        send at the tail of the previous layer's result stream posts
        them. Layer-at-a-time simulation/execution models the Eq.-10
        synchronous chain, where the previous layer has fully drained,
        so any barrier-channel deficit is pre-armed at t=0 here. The
        same applies to cross-device channels (``*.xdev``): their
        matching sends live in another device's program.
        """
        tokens = dict(self.initial_tokens)
        cn = CORE_NAMES[self.core]
        for ch in (f"{cn}.bar", f"{cn}.xdev"):
            # Arm every in-layer barrier/cross-device *wait*; the
            # layer's own sends target another layer (or device) and
            # must not offset the count.
            waits = sum(1 for op in self.ops()
                        if op.channel == ch
                        and isinstance(op.instr, isa.SyncInstr)
                        and op.instr.is_wait)
            deficit = waits - tokens.get(ch, 0)
            if deficit > 0:
                tokens[ch] = tokens.get(ch, 0) + deficit
        return tokens


@dataclasses.dataclass
class LayerProgram:
    """One network layer lowered under its neuron split."""
    index: int
    name: str
    dims: GemmDims               # full (un-split) layer GEMM
    n_lut: int                   # filters on the LUT (bit-serial) core
    bits_w_lut: int
    bits_a: int
    depthwise: bool
    lut: CoreProgram | None      # None when n_lut == 0
    dsp: CoreProgram | None      # None when n_lut == dims.n
    # Spatial geometry for conv layers (None for plain GEMM/FC layers):
    # drives the executor's im2col staging and the NHWC chain.
    geometry: ConvGeometry | None = None
    # Fused elementwise result tail (ElementwiseOp tuple, canonical
    # order add -> activation -> requant); empty for LM/FC layers whose
    # inter-layer glue stays in the session frontends.
    elementwise: tuple = ()

    @property
    def n_dsp(self) -> int:
        return self.dims.n - self.n_lut

    def cores(self) -> list[CoreProgram]:
        return [c for c in (self.lut, self.dsp) if c is not None]

    @property
    def n_instructions(self) -> int:
        return sum(c.n_instructions for c in self.cores())


# ---------------------------------------------------------------------------
# Decode-step invocation header
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """Invocation header of a decode-mode program.

    A program carrying a StepSpec is a *step* program: one invocation
    advances generation by one token position. The runtime contract is
    a step-position register ``pos`` supplied per invocation — every
    persistent-segment access (``kv`` append/read) is addressed as
    ``segment.base + pos * row_bytes`` — plus the residency classes on
    the memory map: after the warm-up invocation, ``weights`` segments
    are resident and their fetches are elided (:func:`lower.steady_program`).

    ``family`` is the registry module kind (``lm``/``ssm``/``hybrid``)
    and the attention geometry fields drive the session glue between
    compiled GEMMs (zeros for pure-SSM programs).
    """
    family: str
    batch: int
    max_seq: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0

    def to_meta(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_meta(meta: dict) -> "StepSpec":
        return StepSpec(**meta)


# ---------------------------------------------------------------------------
# Whole-network Program
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ProgramStats:
    n_instructions: int
    by_opcode: dict[str, int]
    bytes_fetched: float
    bytes_written: float
    ddr_footprint: int

    @property
    def bytes_moved(self) -> float:
        return self.bytes_fetched + self.bytes_written

    @property
    def image_bytes(self) -> int:
        return self.n_instructions * isa.WORD_BITS // 8


@dataclasses.dataclass
class Program:
    """A whole network compiled to unified-ISA instruction streams."""
    name: str
    device: FPGADevice
    lut_cfg: LutCoreConfig
    dsp_cfg: DspCoreConfig
    layers: list[LayerProgram]
    memory: MemoryMap
    # Per-pass accounting attached by passes.PassPipeline (not part of
    # the program identity: excluded from __eq__ and serialization).
    opt_stats: list = dataclasses.field(default_factory=list, repr=False)
    # Decode invocation header (None for plain fixed-seq programs).
    step: StepSpec | None = None

    def stats(self) -> ProgramStats:
        by_op = {op.name: 0 for op in isa.Opcode}
        fetched = written = 0.0
        n = 0
        for lp in self.layers:
            for cp in lp.cores():
                fetched += cp.bytes_fetched
                written += cp.bytes_written
                for op in cp.ops():
                    by_op[op.instr.opcode.name] += 1
                    n += 1
        return ProgramStats(n, by_op, fetched, written, self.memory.footprint)

    @property
    def n_instructions(self) -> int:
        return sum(lp.n_instructions for lp in self.layers)

    def words(self) -> list[int]:
        """Flat 128-bit instruction image (layer-major, lut before dsp,
        fetch/execute/result engine order)."""
        return [op.instr.encode()
                for lp in self.layers
                for cp in lp.cores()
                for op in cp.ops()]

    def fingerprint(self) -> str:
        """Stable content hash of the instruction image + identity.

        Keyed on the encoded words (which capture every operand,
        bit-width and sync flag) plus name/device/seq extents, so two
        programs share a fingerprint iff they execute identically —
        the ``PallasExecutor`` per-program JIT cache keys on this.
        """
        h = hashlib.sha256(self.name.encode())
        h.update(self.device.name.encode())
        if self.step is not None:
            h.update(repr(self.step).encode())
        for lp in self.layers:
            if lp.elementwise:
                # tail semantics (op kinds, add sources, requant bits)
                # live in layer metadata, not the instruction words
                h.update(repr(lp.elementwise).encode())
        for w in self.words():
            h.update(w.to_bytes(16, "little"))
        return h.hexdigest()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Program):
            return NotImplemented
        return (self.name == other.name
                and self.device == other.device
                and self.lut_cfg == other.lut_cfg
                and self.dsp_cfg == other.dsp_cfg
                and self.layers == other.layers
                and self.memory == other.memory
                and self.step == other.step)


# ---------------------------------------------------------------------------
# Generic layer description consumed by the lowering pass
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmLayer:
    """A layer already reduced to GEMM extents (im2col view for convs,
    direct for linears). This is what ``networks.py`` produces for both
    the CNN workload zoo and the LM registry archs. Conv layers carry
    their :class:`ConvGeometry` so the executors can stage im2col
    activations and chain spatial tensors."""
    name: str
    dims: GemmDims
    depthwise: bool = False
    geometry: ConvGeometry | None = None
    # Residual-add / activation ops of the layer's fused result tail
    # (the write-back requant is appended by ``lower_network``, which
    # knows the consumer's activation bit-width).
    elementwise: tuple = ()

    @staticmethod
    def from_conv(spec) -> "GemmLayer":
        """Lower a ``core/workloads.py`` ConvSpec to its GEMM view,
        keeping the spatial geometry (the downsample shortcuts read the
        block input, three layers back in the zoo's layer order) and the
        spec's residual/activation glue as elementwise tail ops."""
        geom = ConvGeometry(
            kernel=spec.kernel, stride=spec.stride, pad=spec.kernel // 2,
            in_hw=spec.in_hw, out_hw=spec.out_hw,
            c_in=spec.c_out if spec.depthwise else spec.c_in,
            c_out=spec.c_out,
            src_offset=3 if spec.shortcut else 1,
            pool=getattr(spec, "pool", ""))
        ew = []
        if getattr(spec, "res_src", 0):
            ew.append(ElementwiseOp("add", src_offset=spec.res_src))
        if getattr(spec, "act", ""):
            ew.append(ElementwiseOp(spec.act))
        return GemmLayer(spec.name, spec.gemm(), spec.depthwise, geom,
                         elementwise=tuple(ew))
