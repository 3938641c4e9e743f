"""Golden-model interpreter backend (the reference executor), on torch
tensors.

The counterpart of ``repro.compiler.runtime.golden``. It executes a
compiled program *instruction by instruction*: the streams drive real
data movement and tile GEMMs against the port's exact oracles of
``kernels/ref.py`` — bitplane (bit-serial) arithmetic for LUT-core
partitions, packed-int4 for DSP-core partitions, and their grouped
forms for depthwise layers — so the result is bit-exact against every
``CudaExecutor`` path on the same codes and scales, on any device.

The interpreter enforces the ISA contract along the way:

  * Fetch instructions must address the layer's DDR segments from the
    program's memory map (weights at ``L{i}.wgt.{core}``, activations
    at the producer's output segment — for conv layers the producer's
    *spatial* NHWC segment named by ``geometry.src_offset``, since the
    fused kernels im2col on chip and no staging copy exists);
  * every Execute must only consume weight tiles a prior Fetch brought
    on chip, and the tile count must cover the partition exactly;
  * Result instructions place output tiles by their DDR offset and must
    tile the output without overlap — a fused Result burst
    (``passes.DmaFusionPass``) drains ``max(1, onchip_base)``
    consecutive tiles;
  * the sync-token protocol is validated by running the event-driven
    scheduler over the same streams (``check_timing``, on by default).

This is the slow path: a Python loop per tile, each tile a few small
torch ops (on the card, each op a launch). ``CudaExecutor`` executes
programs at speed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import isa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.compiler.lower import EW_STAGE, KV_APPEND_STAGE, \
    KV_READ_STAGE
from repro_torch.compiler.program import CORE_NAMES, CoreProgram, \
    LayerProgram
from repro_torch.compiler.runtime.base import ExecutionError, ExecutorBackend


class GoldenExecutor(ExecutorBackend):
    """Contract-checking functional interpreter over a compiled program."""

    name = "golden"

    # -- core interpretation ----------------------------------------------

    def _segments(self, lp: LayerProgram, core_name: str):
        mem = self.program.memory
        wgt = mem[f"L{lp.index}.wgt.{core_name}"]
        if lp.geometry is not None:
            # conv layers fetch their producer's *spatial* NHWC segment
            # (im2col happens inside the fused kernel — no staged copy)
            src = lp.index - lp.geometry.src_offset
        else:
            src = lp.index - 1
        act = mem["act.in"] if src < 0 else mem[f"L{src}.out"]
        out = mem[f"L{lp.index}.out"]
        return wgt, act, out

    def _persistent_segment(self, lp: LayerProgram, base: int):
        """The kv/state-residency segment at ``base``, or None."""
        for seg in self.program.memory.segments:
            if seg.base == base and seg.residency in ("kv", "state"):
                return seg
        return None

    def _run_core(self, lp: LayerProgram, cp: CoreProgram, x_q,
                  w_codes, w_scales) -> torch.Tensor:
        core_name = CORE_NAMES[cp.core]
        g_n = w_codes.shape[1]
        if core_name == "lut":
            tm, tn = self.program.lut_cfg.m, self.program.lut_cfg.n
            bits = lp.bits_w_lut
        else:
            tm, tn = self.program.dsp_cfg.n_reg_row_a, \
                self.program.dsp_cfg.n_reg_col_w
            bits = 4
        m = lp.dims.m
        nt_m = math.ceil(m / tm)
        nt_n = math.ceil(g_n / tn)
        wgt_seg, act_seg, out_seg = self._segments(lp, core_name)

        # 1. Fetch stream: record what lands on chip, check addressing.
        fetched_wtiles: set[int] = set()
        n_wgt_fetches = 0
        act_loaded = False
        for op in cp.streams["fetch"]:
            i = op.instr
            if not isinstance(i, isa.FetchInstr):
                continue
            if i.stage_ctrl == 0:                    # weight tile / wall
                if i.ddr_base != wgt_seg.base:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: weight fetch addresses "
                        f"{i.ddr_base:#x}, expected segment "
                        f"{wgt_seg.name}@{wgt_seg.base:#x}")
                n_wgt_fetches += 1
                # a fused burst (passes.DmaFusionPass) lands
                # max(1, onchip_base) consecutive tiles
                fetched_wtiles.update(range(
                    i.ddr_offset, i.ddr_offset + max(1, i.onchip_base)))
            elif i.stage_ctrl == 1:                  # activations
                if i.ddr_base != act_seg.base:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: activation fetch addresses "
                        f"{i.ddr_base:#x}, expected segment "
                        f"{act_seg.name}@{act_seg.base:#x}")
                act_loaded = True
            elif i.stage_ctrl == 3:                  # cross-device gather
                # filter-parallel plans stage peer activation shards in a
                # gather segment; the data itself arrives via the link,
                # so only the addressing contract is checked here.
                mem = self.program.memory
                names = (f"L{lp.index}.gather", f"L{lp.index - 1}.gather")
                if not any(g in mem and i.ddr_base == mem[g].base
                           for g in names):
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: gather fetch addresses "
                        f"{i.ddr_base:#x}, expected one of {names}")
            elif i.stage_ctrl == EW_STAGE:           # residual-add operand
                # the fused elementwise tail reads the add producer's
                # stored output codes; the chain hands the executor the
                # dequantized operand, so only the addressing contract
                # (some earlier layer's output segment, or the program
                # input) is checked here.
                mem = self.program.memory
                names = tuple(f"L{j}.out" for j in range(lp.index)) \
                    + ("act.in",)
                if not any(s in mem and i.ddr_base == mem[s].base
                           for s in names):
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: elementwise residual "
                        f"fetch addresses {i.ddr_base:#x}, which is not "
                        f"an earlier layer's output segment")
            elif i.stage_ctrl == KV_READ_STAGE:      # persistent KV/state
                # decode programs read the layer's live cache/state
                # segment; the session runtime carries the contents, so
                # only the addressing contract is checked here.
                seg = self._persistent_segment(lp, i.ddr_base)
                if seg is None:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: persistent read "
                        f"addresses {i.ddr_base:#x}, which is not a "
                        f"kv/state segment")
            else:
                raise ExecutionError(
                    f"L{lp.index} {core_name}: fetch stage_ctrl="
                    f"{i.stage_ctrl} is not a defined buffer stage")
        if not act_loaded:
            raise ExecutionError(
                f"L{lp.index} {core_name}: no activation fetch in stream")
        # DSP whole-weight residency: a single stage-0 fetch at offset 0
        # DMAs the entire weight matrix, covering every column tile.
        if core_name == "dsp" and n_wgt_fetches == 1 and 0 in fetched_wtiles:
            fetched_wtiles.update(range(nt_n))
        # Steady-state decode residency: a weights-resident segment with
        # no fetch in the stream means the tiles stayed on chip from the
        # warm-up invocation (compiler/lower.py steady_program).
        if n_wgt_fetches == 0 and wgt_seg.residency == "weights":
            fetched_wtiles.update(range(nt_n))

        # 2. Execute stream: tile GEMMs through the exact oracles.
        tiles: dict[int, torch.Tensor] = {}
        t = 0
        for op in cp.streams["execute"]:
            i = op.instr
            if not isinstance(i, isa.ExecuteInstr):
                continue
            if core_name == "lut":
                j, ti = divmod(t, nt_m)              # column-major schedule
            else:
                ti, j = divmod(t, nt_n)              # row-major schedule
            if j not in fetched_wtiles:
                raise ExecutionError(
                    f"L{lp.index} {core_name}: execute consumes weight tile "
                    f"{j} before any fetch brought it on chip")
            r0, r1 = ti * tm, min((ti + 1) * tm, m)
            c0, c1 = j * tn, min((j + 1) * tn, g_n)
            if lp.depthwise:
                # grouped GEMM: channels c0:c1 each contract their own
                # im2col slice of the staged [m, k, n_part] stack
                x_t = x_q[r0:r1, :, c0:c1]
                if core_name == "lut":
                    tile = kref.bitserial_grouped_gemm_ref(
                        x_t, w_codes[:, c0:c1], w_scales[c0:c1], bits)
                else:
                    tile = kref.int4_grouped_gemm_ref(
                        x_t, w_codes[:, c0:c1], w_scales[c0:c1])
            elif core_name == "lut":
                tile = kref.bitserial_gemm_ref(
                    x_q[r0:r1], w_codes[:, c0:c1], w_scales[c0:c1], bits)
            else:
                tile = kops.int4_matmul(
                    x_q[r0:r1], w_codes[:, c0:c1], w_scales[c0:c1],
                    mode="ref")
            tiles[(j * nt_m + ti) if core_name == "lut"
                  else (ti * nt_n + j)] = tile
            t += 1
        if t != nt_m * nt_n:
            raise ExecutionError(
                f"L{lp.index} {core_name}: {t} execute instructions do not "
                f"tile the [{m},{g_n}] partition ({nt_m}x{nt_n} expected)")

        # 3. Result stream: drain tiles to the output DDR segment. A
        # fused burst drains max(1, onchip_base) consecutive tiles.
        out = torch.zeros((m, g_n), dtype=torch.float32, device=self.device)
        placed: set[int] = set()
        for op in cp.streams["result"]:
            i = op.instr
            if not isinstance(i, isa.ResultInstr):
                continue
            if i.stage_ctrl == KV_APPEND_STAGE:      # persistent KV/state
                # decode programs append this step's K/V rows (or write
                # back the recurrent state) to a live cache segment; the
                # session runtime owns the contents — check addressing
                # only, and do not count it toward the output tiling.
                seg = self._persistent_segment(lp, i.ddr_base)
                if seg is None:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: persistent write "
                        f"addresses {i.ddr_base:#x}, which is not a "
                        f"kv/state segment")
                continue
            if i.stage_ctrl == EW_STAGE:             # fused elementwise tail
                # the stage-6 write-back re-quantizes the layer's final
                # (post add/act/pool) output into L{i}.out; the chain
                # computes the data (runtime/base.py elementwise_tail)
                # — check addressing only, outside the output tiling.
                if i.ddr_base != out_seg.base:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: elementwise write-back "
                        f"addresses {i.ddr_base:#x}, expected segment "
                        f"{out_seg.name}@{out_seg.base:#x}")
                continue
            if i.ddr_base != out_seg.base:
                raise ExecutionError(
                    f"L{lp.index} {core_name}: result writes {i.ddr_base:#x},"
                    f" expected segment {out_seg.name}@{out_seg.base:#x}")
            burst = max(1, i.onchip_base)
            for off in range(i.ddr_offset, i.ddr_offset + burst):
                if off in placed:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: result tile {off} written "
                        f"twice")
                if off not in tiles:
                    raise ExecutionError(
                        f"L{lp.index} {core_name}: result drains tile {off} "
                        f"which was never executed")
                placed.add(off)
                if core_name == "lut":
                    j, ti = divmod(off, nt_m)
                else:
                    ti, j = divmod(off, nt_n)
                r0, r1 = ti * tm, min((ti + 1) * tm, m)
                c0, c1 = j * tn, min((j + 1) * tn, g_n)
                out[r0:r1, c0:c1] = tiles[off]
        if len(placed) != nt_m * nt_n:
            raise ExecutionError(
                f"L{lp.index} {core_name}: result stream drained "
                f"{len(placed)}/{nt_m * nt_n} tiles")
        return out
