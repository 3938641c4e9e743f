"""The unified 128-bit Instruction Set Architecture of N3H-Core (§3.1).

Both the DSP- and LUT-core execute the same four instruction kinds:

  * ``Fetch``   — DMA a region from DDR into an on-chip buffer.
  * ``Execute`` — run a GEMM tile on the core's compute array.
  * ``Result``  — DMA a finished output tile from the result buffer to DDR.
  * ``Sync``    — post/await a synchronization token between engines
                  (intra-layer asynchronous, inter-layer synchronous).

Per the paper, every instruction is 128 bits. Fetch/Result carry
{on-chip base (16b), stage control (3b), on-chip r/w range (1b)} and
{DDR base (32b), DDR offset (24b), DDR r/w range (16b)}. Execute carries
the on-chip operand addresses plus the GEMM-core tile parameters of
Table 1. Sync carries the current state (1b), next state (2b) of each
engine and a 3-bit token flag.

This module gives a bit-exact encode/decode used by the scheduler and
covered by round-trip property tests.
"""
from __future__ import annotations

import dataclasses
import enum


WORD_BITS = 128


class Opcode(enum.IntEnum):
    FETCH = 0
    EXECUTE = 1
    RESULT = 2
    SYNC = 3


class Engine(enum.IntEnum):
    FETCH = 0
    EXECUTE = 1
    RESULT = 2


class CoreSel(enum.IntEnum):
    LUT = 0
    DSP = 1


# ---------------------------------------------------------------------------
# Bit-packing helpers
# ---------------------------------------------------------------------------

class _Packer:
    """LSB-first field packer for a fixed-width word."""

    def __init__(self):
        self.value = 0
        self.pos = 0

    def put(self, v: int, width: int, name: str = "") -> "_Packer":
        if v < 0 or v >= (1 << width):
            raise ValueError(f"field {name!r}={v} does not fit in {width} bits")
        self.value |= (v & ((1 << width) - 1)) << self.pos
        self.pos += width
        if self.pos > WORD_BITS:
            raise ValueError("instruction overflows 128 bits")
        return self


class _Unpacker:
    def __init__(self, word: int):
        self.word = word
        self.pos = 0

    def get(self, width: int) -> int:
        v = (self.word >> self.pos) & ((1 << width) - 1)
        self.pos += width
        return v


# ---------------------------------------------------------------------------
# Instruction dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FetchInstr:
    """DMA DDR -> on-chip buffer."""
    core: CoreSel
    onchip_base: int      # 16b — target buffer word address
    stage_ctrl: int       # 3b  — which pipeline stage the data feeds
    onchip_range: int     # 1b  — buffer half-select (double buffering)
    ddr_base: int         # 32b
    ddr_offset: int       # 24b
    ddr_range: int        # 16b — transfer length (beats)

    opcode = Opcode.FETCH

    def encode(self) -> int:
        p = _Packer()
        p.put(int(Opcode.FETCH), 2, "opcode")
        p.put(int(self.core), 1, "core")
        p.put(self.onchip_base, 16, "onchip_base")
        p.put(self.stage_ctrl, 3, "stage_ctrl")
        p.put(self.onchip_range, 1, "onchip_range")
        p.put(self.ddr_base, 32, "ddr_base")
        p.put(self.ddr_offset, 24, "ddr_offset")
        p.put(self.ddr_range, 16, "ddr_range")
        return p.value


@dataclasses.dataclass(frozen=True)
class ResultInstr:
    """DMA result buffer -> DDR."""
    core: CoreSel
    onchip_base: int
    stage_ctrl: int
    onchip_range: int
    ddr_base: int
    ddr_offset: int
    ddr_range: int

    opcode = Opcode.RESULT

    def encode(self) -> int:
        p = _Packer()
        p.put(int(Opcode.RESULT), 2, "opcode")
        p.put(int(self.core), 1, "core")
        p.put(self.onchip_base, 16, "onchip_base")
        p.put(self.stage_ctrl, 3, "stage_ctrl")
        p.put(self.onchip_range, 1, "onchip_range")
        p.put(self.ddr_base, 32, "ddr_base")
        p.put(self.ddr_offset, 24, "ddr_offset")
        p.put(self.ddr_range, 16, "ddr_range")
        return p.value


@dataclasses.dataclass(frozen=True)
class ExecuteInstr:
    """Run one GEMM tile. Tile params mirror Table 1 knobs."""
    core: CoreSel
    buf_addr_a: int   # 16b — activation buffer read base
    buf_addr_w: int   # 16b — weight buffer read base
    tile_m: int       # 12b
    tile_k: int       # 16b
    tile_n: int       # 12b
    bits_w: int       # 4b  — weight bit-width (LUT-core serial passes)
    bits_a: int       # 4b  — activation bit-width
    accumulate: int   # 1b  — accumulate onto existing partial sum

    opcode = Opcode.EXECUTE

    def encode(self) -> int:
        p = _Packer()
        p.put(int(Opcode.EXECUTE), 2, "opcode")
        p.put(int(self.core), 1, "core")
        p.put(self.buf_addr_a, 16, "buf_addr_a")
        p.put(self.buf_addr_w, 16, "buf_addr_w")
        p.put(self.tile_m, 12, "tile_m")
        p.put(self.tile_k, 16, "tile_k")
        p.put(self.tile_n, 12, "tile_n")
        p.put(self.bits_w, 4, "bits_w")
        p.put(self.bits_a, 4, "bits_a")
        p.put(self.accumulate, 1, "accumulate")
        return p.value


@dataclasses.dataclass(frozen=True)
class SyncInstr:
    """Token-based engine handshake (SE / WF / WE of Fig. 3)."""
    core: CoreSel
    src_engine: Engine
    dst_engine: Engine
    cur_state: int     # 1b
    next_state: int    # 2b
    token_flag: int    # 3b
    is_wait: int       # 1b — 1: consume token (wait), 0: produce token (send)

    opcode = Opcode.SYNC

    def encode(self) -> int:
        p = _Packer()
        p.put(int(Opcode.SYNC), 2, "opcode")
        p.put(int(self.core), 1, "core")
        p.put(int(self.src_engine), 2, "src_engine")
        p.put(int(self.dst_engine), 2, "dst_engine")
        p.put(self.cur_state, 1, "cur_state")
        p.put(self.next_state, 2, "next_state")
        p.put(self.token_flag, 3, "token_flag")
        p.put(self.is_wait, 1, "is_wait")
        return p.value


Instr = FetchInstr | ResultInstr | ExecuteInstr | SyncInstr


def decode(word: int) -> Instr:
    """Decode a 128-bit word back into its instruction dataclass."""
    if word < 0 or word >= (1 << WORD_BITS):
        raise ValueError("not a 128-bit word")
    u = _Unpacker(word)
    op = Opcode(u.get(2))
    core = CoreSel(u.get(1))
    if op in (Opcode.FETCH, Opcode.RESULT):
        cls = FetchInstr if op == Opcode.FETCH else ResultInstr
        return cls(
            core=core,
            onchip_base=u.get(16),
            stage_ctrl=u.get(3),
            onchip_range=u.get(1),
            ddr_base=u.get(32),
            ddr_offset=u.get(24),
            ddr_range=u.get(16),
        )
    if op == Opcode.EXECUTE:
        return ExecuteInstr(
            core=core,
            buf_addr_a=u.get(16),
            buf_addr_w=u.get(16),
            tile_m=u.get(12),
            tile_k=u.get(16),
            tile_n=u.get(12),
            bits_w=u.get(4),
            bits_a=u.get(4),
            accumulate=u.get(1),
        )
    return SyncInstr(
        core=core,
        src_engine=Engine(u.get(2)),
        dst_engine=Engine(u.get(2)),
        cur_state=u.get(1),
        next_state=u.get(2),
        token_flag=u.get(3),
        is_wait=u.get(1),
    )
