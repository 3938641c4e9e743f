#!/usr/bin/env python3
"""Where a kernel launch spends its device time, on one NVIDIA card.

    python3 kernel_parts.py [--out PATH]
                            [--only {split,flash,bwd,f32,depthwise,plans}]
                            [--parent-flash PATH] [--parent-bwd PATH]
                            [--parent-f32 PATH] [--parent-depthwise PATH]
                            [--parent-split PATH] [--fit-from JSON]

Builds variants of the kernel sources into ``build/kernel_parts/``, each
with parts of the main loop taken out, and times them: the split-GEMM
kernels at resnet18's distinct layer shapes, llama3.2-1b's decode
layers, the co-design loop's HeteroLinear shapes and resnet18's ``filter``
x 3 shards (:data:`SHAPES`), the fused kernel under
``fused_hetero_gemm.fused_plan``'s launch and the single-path ones under
``split_plan``'s tile and K split, the flash kernel at
the serving prefill, S=2048, decode, decode4, the three D=256 shapes and
the wide pairs' prefill, ragged and offset shapes (:data:`FLASH_SHAPES`)
and, with the log-sum-exp, their training shapes
(:data:`FLASH_TRAIN_SHAPES`), each under ``flash_attention.flash_plan``,
and the flash backward's two entry points (:data:`BWD_SHAPES`). Each
variant's ptxas report (registers, spills, and any warning, a wgmma
serialised among them) is printed as it is built.

``src/repro_torch/kernels/csrc/fused_split_gemm.cu``, its
``fused_hetero_gemm`` on both sides of the split (:data:`VARIANTS`):

    full          the kernel as it is
    no_mma        the wgmma and mma.sync instructions commented out
                  (their accumulators left as they are), so the
                  fragments are still built from the words
    copies_only   only the producer's copies and the ring's barriers (no
                  fragments, no products)
    empty         no copies either: launch, the ring's barriers, the
                  split-K reduction
    plane_passes  one tensor pass per LUT bit plane (the folded fragment
                  issued ``bits`` times), the tensor-core cost of the
                  earlier design's plane loop without its plane bytes:
                  the fold's gain is ``plane_passes`` less ``full``

``--only plans`` times the fused kernels (the conv form where the layer
is a conv) under every launch plan ``fused_hetero_gemm.fused_candidates``
allows at :data:`PLAN_SHAPES` and prints, per shape, the chooser's plan
and time beside the five fastest; ``--fit-from JSON``, with no card,
fits ``fused_hetero_gemm.PLAN_COST`` to the rows such a run wrote with
``--out JSON`` (least squares, then a random search on the sum over
shapes of the chosen plan's time over the fastest plan's) and prints the
coefficients and that sum.

With ``--parent-split PATH`` (an earlier ``fused_split_gemm.cu``, e.g.
``git show dd26106:src/repro_torch/kernels/csrc/fused_split_gemm.cu``, the
``mma.sync`` kernel on int8 planes and packed bytes with
``split_plan``'s tiles) it times that source's ``fused_hetero_gemm`` on
``planes`` / ``packed`` beside this one's at every shape, in turns
(parent, this, this, parent).

``src/repro_torch/kernels/csrc/split_gemm.cu``, its ``bitserial_gemm`` on
the LUT side and ``int4_gemm`` on the DSP side, each under the plan of
its one-sided shape (:data:`SPLIT_VARIANTS`):

    full         the kernel as it is
    no_mma       each mma replaced by one integer add of its operands, so
                 the fragments are still built
    no_unpack    the weight words passed to the mma as they are: no
                 spreading of bits or nibbles to bytes
    copies_only  only the cp.async copies (no fragments, no mma)
    empty        no copies either

``src/repro_torch/kernels/csrc/flash_attention.cu``, its
``flash_attention`` (:data:`FLASH_VARIANTS`; the first four edit the
mma.sync kernel and the wide pairs' wgmma instance alike):

    full         the kernel as it is
    no_mma       each mma replaced by one add of its operands (a LOP3
                 and an FADD on the FP32 pipe, as split_gemm's no_mma),
                 so the ldmatrix fragments, the softmax and the P
                 packing stay; the wgmma instructions commented out
                 (their accumulators left as they are)
    copies_only  only the copies of Q, K and V (cp.async; TMA, each
                 stage released as it lands) and the epilogue (no
                 fragments, no mma, no softmax)
    empty        no copies either: launch, the KV loop's barriers and the
                 epilogue
    mma_sync     the wide pairs' prefill form on the mma.sync kernel, as
                 the parent launched it (chip_smoke.PARENT_FLASH_EDITS)
    head_major   the wgmma instance's blocks a KV head's query heads at
                 a time (a head's query tiles, the heaviest first), not
                 heaviest first over a group of heads (as many as a wave
                 of blocks covers, whose K and V fit in 24 MiB)
    no_store     the wgmma instance without its output's TMA store
    q_smem       the wgmma instance's q . k with Q from shared memory at
                 (192, 128) too (QA off)
    wgmma_short  (192, 128) over at most 64 queries on the wgmma instance,
                 which the launch leaves to the mma.sync kernel

and, at a shape ``flash_plan`` gives the decode form, ``prefill_form``:
the full kernel launched in the prefill form instead (one 64-row block
per query head), which computes the same output, to weigh the decode
form against it.

``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, each entry point
alone and the two back to back (``pair``, as a train step runs them) at
seamless's encoder shape, llama's S=2048, qwen2-vl's D=128, the D=128
GQA shape whose tiles cross the diagonal and the wide pairs' training
shapes, MLA's (192, 128) and gemma's (256, 256) (:data:`BWD_SHAPES`), as
variants (:data:`BWD_VARIANTS`; each edits the wide instance too):

    full          the kernel as it is
    no_mma        the tensor-core products taken out (the wgmma
                  instructions commented out, their accumulators left
                  as they are), so the tile loop, the softmax and the
                  masks stay
    copies_only   only the streamed tiles' copies and the epilogue (the
                  consumers release each stage as it lands)
    empty         no copies either: launch, the pipeline's barriers and
                  the epilogue
    no_pdl        dkdv launched as an ordinary launch, not as a
                  programmatic dependent of dq (timed as the pair)
    no_stagger    the wide dkdv's WG-K issues dp as soon as its tile
                  lands, beside WG-V's s, instead of once s is done (at
                  the wide shapes only)

With ``--parent-bwd PATH`` (an earlier ``flash_attention_bwd.cu`` with
the same entry points, e.g. ``git show
a4c59dd:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, the
wide pairs on ``mma.sync``) it prints, for each kernel both sources
have, whether the two compile to the same SASS (``cuobjdump``), and
times that source's pair
beside this one's at the same shapes, in turns (``turns/parent_1``,
``this_1``, ``this_2``, ``parent_2``), so that a change to the source is
weighed on one card in one call. ``--parent-flash PATH`` does the same
for an earlier ``flash_attention.cu`` (e.g. ``git show
c0c2c54:src/repro_torch/kernels/csrc/flash_attention.cu``, the wide
pairs' prefill form on ``mma.sync``), against the full source and
against the ``mma_sync`` variant, whose kernels should all be the
parent's.

``src/repro_torch/kernels/csrc/flash_attention_f32.cu`` (``--only f32``):
its forward at every ``chip_smoke.F32_SHAPES`` row beside SDPA in fp32,
and its backward, dq, dkdv and the two back to back at the rows with a
backward, beside SDPA's fp32 backward, as variants (:data:`F32_VARIANTS`;
the ``fwd_`` ones timed on the forward, the others on the backward):

    full             the kernels as they are
    copies_only      the backward with only the streamed tiles' copies,
                     the delta, dkdv's cluster reduction and the stores (no
                     products)
    no_reduce        dkdv's ranks store their own partials: no reads of
                     another rank's shared memory (wrong sums at S > 1)
    no_split         dkdv launched with S = 1 (one block a key tile)
    generic          every backward pair on the (0, 0) instance, the head
                     sizes read at run time
    no_overlap       each streamed tile of the backward waited for before
                     the tile before it is computed, so no copy overlaps a
                     product
    fwd_copies_only  the forward with only its K / V ring's copies, Q's and
                     the epilogue (no products, no softmax)
    fwd_generic      every forward pair on the (0, 0) instance
    fwd_no_overlap   each K / V tile of the forward waited for before it is
                     computed

With ``--parent-f32 PATH`` (an earlier ``flash_attention_f32.cu`` with
the same entry points, e.g. ``git show
3178a1d:src/repro_torch/kernels/csrc/flash_attention_f32.cu``, the
forward before its redesign) it prints whether ``dq_kernel`` and
``dkdv_kernel`` compile to the parent's SASS, and times the parent's
forward, dq, dkdv and pair beside this one's, the forward and the pairs
in turns (parent, this, this, parent).

``src/repro_torch/kernels/csrc/depthwise_gemm.cu`` (``--only
depthwise``), ``depthwise_conv_gemm`` at full-width mobilenet_v2's 17
depthwise layers (the fused path's launches, on random codes at each
layer's split and bits) and at each layer's two shards of its
``filter`` x 2 bundle (two launches), summed per image, as variants
(:data:`DW_VARIANTS`), each with its launch plan
(``depthwise_gemm.depthwise_plan``):

    full         the kernel as it is
    empty        nothing loaded, computed or stored: the launch floor
    loads_only   the multiply-adds taken out (an XOR of the operands in
                 place of each __dp4a)
    scalar       one channel a thread everywhere (V = 1)
    no_decode    the block's weights all 0, no plane read
    no_x         no input read (every tap 0)
    no_store     the products kept, the stores taken out
    no_reuse     the input's loads past L1 (``__ldcg``): each pixel's
                 taps come from L2, not from the lines its neighbours'
                 threads brought in (the design's only reuse of input)

With ``--parent-depthwise PATH`` (an earlier ``depthwise_gemm.cu`` with
the same entry points, e.g. ``git show
3178a1d:src/repro_torch/kernels/csrc/depthwise_gemm.cu``, the kernel
before its redesign) it times that source beside this one at each layer
and over the shards, in turns (parent, this, this, parent).

Device time per launch is ``chip_smoke.device_times``': CUDA events
around 20 launches, enqueued in full behind a spin kernel. A part's cost
is the difference between two variants; the variants compute wrong
numbers, only their times mean anything. Exits non-zero without CUDA or
when a source no longer has the statements a variant takes out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT_DIR = ROOT / "build" / "kernel_parts"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from chip_smoke import PARENT_FLASH_EDITS  # noqa: E402

#: split_gemm.cu's mma warps skip their fragments and mma
_NO_MMA = ("    if (!mma_warp) continue;\n", "    continue;\n")
_FUSED_NO_MMA = [('"wgmma.mma_async', '"// wgmma.mma_async', 3),
                 ('"mma.sync.aligned', '"// mma.sync.aligned')]
_FUSED_NO_COMPUTE = (
    "  const bool active = blk.j0 + cb < n_region && blk.m0 + tb < p.M;\n",
    "  const bool active = false;\n")
_FUSED_NO_COPIES = (
    "      blk.load_stage(smem + s * L.stage, s_begin + i, ptid);\n", "")
_FUSED_PLANE_PASSES = (
    "      products(cur, xs);\n",
    "      for (int b = 0; b < (blk.lut ? p.bits : 1); ++b) products(cur, xs);"
    "\n")
#: fused_split_gemm.cu: variant -> (statement, replacement[, n]) edits
VARIANTS = {
    "full": [],
    "no_mma": _FUSED_NO_MMA,
    "copies_only": [_FUSED_NO_COMPUTE],
    "empty": [_FUSED_NO_COMPUTE, _FUSED_NO_COPIES],
    "plane_passes": [_FUSED_PLANE_PASSES],
}
_SPLIT_NO_MMA = (
    "for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[kk][i], bf[kk][j][0], "
    "bf[kk][j][1]);",
    "for (int j = 0; j < NI; ++j) acc[i][j][0] += (int)(a[kk][i][0] ^ "
    "bf[kk][j][0] ^ bf[kk][j][1]);")
_SPLIT_NO_UNPACK = [
    ("  b0 = (((w >> (4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * sc;\n"
     "  b1 = (((w >> (16 + 4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * "
     "sc;\n", "  b0 = w;\n  b1 = w ^ sc;\n"),
    ("  b0 = spread_int4(row[q >> 1] >> sh);\n"
     "  b1 = spread_int4(row[2 + (q >> 1)] >> sh);\n",
     "  b0 = row[q >> 1] >> sh;\n  b1 = row[2 + (q >> 1)];\n")]
_SPLIT_NO_COPIES = [
    ("    if (p.a_vec == 16)\n      load_a_vec<16>(as, k0);",
     "    if (true) {}"),
    ("    load_words(Bs + buf * bstage, step);\n", "")]
#: split_gemm.cu: variant -> (statement, replacement) edits
SPLIT_VARIANTS = {
    "full": [],
    "no_mma": [_SPLIT_NO_MMA],
    "no_unpack": _SPLIT_NO_UNPACK,
    "copies_only": [_NO_MMA],
    "empty": [_NO_MMA, *_SPLIT_NO_COPIES],
}
_FLASH_NO_MMA = (
    """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
""",
    """  c[0] += __uint_as_float(a[0] ^ b0 ^ b1);
""")
_FLASH_NO_COMPUTE = ("      if (skip) continue;\n", "      continue;\n")
_FLASH_NO_COPIES = [
    ("      issue_q();\n", ""),
    ("    load_tile<DQK, BKV>(ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0, "
     "tid);\n"
     "    load_tile<DV, BKV>(ks + KTILE, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0, "
     "tid);\n", "")]
#: the same edits of the wide pairs' wgmma instance: (statement,
#: replacement[, occurrences])
_WIDE_NO_MMA = ('"wgmma.mma_async', '"// wgmma.mma_async', 3)
_WIDE_NO_COMPUTE = ("      if (t < mine) {\n", "      if (false) {\n")
_WIDE_NO_COPIES = [
    ('"cp.async.bulk.tensor.4d.shared::cluster',
     '"// cp.async.bulk.tensor.4d.shared::cluster'),
    ('"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;',
     '"mbarrier.arrive.shared::cta.b64 _, [%0];')]
#: the wgmma instance's group of heads, and (192, 128)'s launch of it
_GROUP = ("  const int group = min(B * Hq, max(1, min(by_l2, by_wave)) * "
          "a.rep);\n")
_SHORT = ("      if (a.Sq > BQ) return launch_wide<DQK, DV>(a, grid, "
          "stream);\n")
#: flash_attention.cu: variant -> (statement, replacement[, n]) edits
FLASH_VARIANTS = {
    "full": [],
    "no_mma": [_FLASH_NO_MMA, _WIDE_NO_MMA],
    "copies_only": [_FLASH_NO_COMPUTE, _WIDE_NO_COMPUTE],
    "empty": [_FLASH_NO_COMPUTE, *_FLASH_NO_COPIES, _WIDE_NO_COMPUTE,
              *_WIDE_NO_COPIES],
    "mma_sync": PARENT_FLASH_EDITS,
    "head_major": [(_GROUP, "  const int group = a.rep;\n")],
    "no_store": [('"cp.async.bulk.tensor.4d.global',
                  '"// cp.async.bulk.tensor.4d.global')],
    "q_smem": [("  static constexpr bool QA = DV / 2 + DQK / 4 <= 128;\n",
                "  static constexpr bool QA = false;\n")],
    "wgmma_short": [(_SHORT, _SHORT.replace("a.Sq > BQ", "true"))],
}
#: the flash variants that differ from "full" only where the wgmma
#: instance runs (q_smem only at (192, 128)), or, wgmma_short, where
#: (192, 128)'s prefill form does not take it; timed only there
FLASH_WIDE_VARIANTS = ("mma_sync", "head_major", "no_store", "q_smem",
                       "wgmma_short")
#: (statement, replacement, occurrences): the wgmma helpers, one per shape
#: and operand form
_BWD_NO_MMA = ('"wgmma.mma_async', '"// wgmma.mma_async', 4)
_BWD_NO_COMPUTE = [("dkdv_tile<D>(", "if (false) dkdv_tile<D>("),
                   ("dq_tile<D>(", "if (false) dq_tile<D>("),
                   ("dq_wide_tile<D, DV>(", "if (false) dq_wide_tile<D, DV>("),
                   ("dv_tile<D, DV>(", "if (false) dv_tile<D, DV>("),
                   ("dk_tile<D, DV>(", "if (false) dk_tile<D, DV>(")]
_BWD_NO_COPIES = [
    ('"cp.async.bulk.tensor', '"// cp.async.bulk.tensor'),
    ('"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;',
     '"mbarrier.arrive.shared::cta.b64 _, [%0];')]
#: flash_attention_bwd.cu (dq and dkdv on wgmma and TMA): variant ->
#: edits
BWD_VARIANTS = {
    "full": [],
    "no_mma": [_BWD_NO_MMA],
    "copies_only": _BWD_NO_COMPUTE,
    "empty": [*_BWD_NO_COMPUTE, *_BWD_NO_COPIES],
    "no_pdl": [("m, a, true);", "m, a, false);", 4)],
    "no_stagger": [("  bar_arrive(BAR_S_DONE, 2 * WG);\n", ""),
                   ("  bar_sync(BAR_S_DONE, 2 * WG);\n", "")],
}
#: variants that differ from "full" only at the wide pairs, timed there
WIDE_VARIANTS = ("no_stagger",)
#: chip_smoke.BWD_SHAPES rows timed here: seamless's encoder (the
#: training path's), llama's GQA at S 2048, qwen2-vl's D=128, the D=128
#: GQA shape whose tiles cross the diagonal, and the wide pairs' training
#: shapes (deepseek-v2's MLA, gemma-7b's D 256)
BWD_SHAPES = ("seamless_enc", "llama_s2048", "qwen2vl_d128", "gqa_d128",
              "mla_train", "d256_train")
#: chip_smoke.FLASH_SHAPES rows timed here: the serving prefill, S=2048,
#: the two decode-form shapes, the three at D=256, deepseek-v2's MLA
#: prefill (keys 192 wide, values 128) and ragged shape, and both wide
#: pairs' 300 queries offset into 1000 keys
FLASH_SHAPES = ("prefill", "s2048", "decode", "decode4", "d256_prefill",
                "d256_ragged", "d256_decode4", "mla_prefill", "mla_ragged",
                "d256_offset", "mla_offset")
#: chip_smoke.BWD_SHAPES rows whose forward (with the log-sum-exp, as a
#: training step launches it) is timed too: the wide pairs' training
#: shapes
FLASH_TRAIN_SHAPES = ("mla_train", "d256_train")
_FWD_TILE = "    cp_commit();\n    const int k0 = it * BK;\n"
_FWD_PAIR = "    using P = decltype(p);\n    return kv_bf16"
_F32_NO_COMPUTE = [("dq_tile<D_, DV_>(", "if (false) dq_tile<D_, DV_>("),
                   ("dkdv_tile<D_, DV_>(", "if (false) dkdv_tile<D_, DV_>(")]
_F32_SYNC = "    cp_commit();\n    {tile}<D_, DV_>("
#: flash_attention_f32.cu's backward: variant -> (statement, replacement)
#: edits
F32_VARIANTS = {
    "full": [],
    "copies_only": _F32_NO_COMPUTE,
    "no_reduce": [("    float4 sum = part4_of(e, 0);\n",
                   "    float4 sum = part4[e];\n"),
                  ("    for (int src = 1; src < S; ++src) {\n",
                   "    for (int src = S; src < S; ++src) {\n")],
    "no_split": [("  a.split = dkdv_split(a);\n", "  a.split = 1;\n")],
    "generic": [("int with_pair(int D, int DV, F f) {\n",
                 "int with_pair(int D, int DV, F f) {\n"
                 "  if (true) return f(Pair<0, 0>{});\n")],
    "no_overlap": [(_F32_SYNC.format(tile=t), _F32_SYNC.format(tile=t).replace(
        "    cp_commit();\n", "    cp_commit();\n    cp_wait<0>();\n"
        "    __syncthreads();\n")) for t in ("dq_tile", "dkdv_tile")],
    "fwd_copies_only": [(_FWD_TILE, _FWD_TILE.replace(
        "    const int k0", "    continue;\n    const int k0"))],
    "fwd_generic": [(_FWD_PAIR, _FWD_PAIR.replace("decltype(p)",
                                                  "Pair<0, 0>"))],
    "fwd_no_overlap": [(_FWD_TILE, _FWD_TILE.replace(
        "    const int k0", "    cp_wait<0>();\n    __syncthreads();\n"
        "    const int k0"))],
}
#: the F32_VARIANTS that differ from "full" only in the forward, timed
#: there; the others differ only in the backward
F32_FWD_VARIANTS = ("fwd_copies_only", "fwd_generic", "fwd_no_overlap")
_DW_START = ("  const int KH = KT ? KT : (SPATIAL ? p.ks : p.K), "
             "KW = SPATIAL ? KH : 1;\n")
_DW_OUT = "  float* o = p.out + (size_t)m * p.N + c;\n"
#: depthwise_gemm.cu: variant -> (statement, replacement) edits
DW_VARIANTS = {
    "full": [],
    "empty": [(_DW_START, "  return;\n" + _DW_START)],
    "loads_only": [("  return __dp4a((int)x, (int)w, acc);\n",
                    "  return acc ^ (int)(x ^ w);\n")],
    "scalar": [("  pl.v = (fast || SPATIAL) && fits(VEC) && VEC <= p.M ? VEC "
                ": 1;\n", "  pl.v = 1;\n")],
    "no_decode": [("*reinterpret_cast<uint32_t*>(wb + k * CB + 4 * q) = "
                   "tap4(p, k, c0 + 4 * q);",
                   "*reinterpret_cast<uint32_t*>(wb + k * CB + 4 * q) = 0u;"),
                  ("wb[k * CB + q] = c0 + q < p.N ? (uint8_t)tap1(",
                   "wb[k * CB + q] = false ? (uint8_t)tap1(")],
    "no_x": [("        const bool ok = active && (KT || (kh < KH",
              "        const bool ok = false && (KT || (kh < KH"),
             ("      const bool ok = active && (KT || kh < KH);",
              "      const bool ok = false && (KT || kh < KH);")],
    "no_store": [(_DW_OUT, "  if (acc[0] != 0x7654321) return;\n"
                  + _DW_OUT)],
    "no_reuse": [("__ldg(reinterpret_cast<const unsigned*>(p)) : 0u",
                  "__ldcg(reinterpret_cast<const unsigned*>(p)) : 0u"),
                 ("(uint32_t)(uint8_t)__ldg(p) : 0u",
                  "(uint32_t)(uint8_t)__ldcg(p) : 0u")],
}

#: the split-GEMM shapes (M, K, n_lut, n_dsp), bits 4: resnet18's
#: distinct layers; llama3.2-1b's decode layers at batch 8 (q / o, k / v,
#: gate / up, down, the padded vocabulary's head), half their columns on
#: each side; the co-design loop's HeteroLinear shapes (chip_smoke.HETERO:
#: the quickstart's, the llama MLP at ratio 0.5 and at its solved ratio,
#: 1,632 serial columns); resnet18's ``filter`` x 3 shards whose widths are
#: not multiples of 4 (conv1's all-LUT 21 columns and mixed 5 / 16, conv17's
#: 80 / 91, fc's 333)
SHAPES = {
    "conv1": (12544, 147, 48, 16), "conv2": (3136, 576, 48, 16),
    "conv7": (784, 1152, 96, 32), "conv8_ds": (784, 64, 64, 64),
    "conv12": (196, 2304, 192, 64), "conv17": (49, 4608, 432, 80),
    "conv18_ds": (49, 256, 416, 96), "fc": (1, 512, 680, 320),
    "dec_q": (8, 2048, 1024, 1024), "dec_kv": (8, 2048, 256, 256),
    "dec_up": (8, 2048, 4096, 4096), "dec_down": (8, 8192, 1024, 1024),
    "dec_head": (8, 2048, 64128, 64128),
    "hetero_quickstart": (16, 256, 77, 115),
    "hetero_mlp": (4096, 2048, 4096, 4096),
    "hetero_mlp_solved": (4096, 2048, 1632, 6560),
    "x3_conv1": (12544, 147, 21, 0), "x3_conv1_mixed": (12544, 147, 5, 16),
    "x3_conv17": (49, 4608, 80, 91), "x3_fc": (1, 512, 333, 0),
}


def ptxas_lines(report: str) -> list[str]:
    """nvcc's ``-Xptxas -v`` report cut to each kernel's name, its
    registers and spills, and any warning (a wgmma serialised)."""
    lines = []
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(\w+?_kernel\w*?)E",
                      ln)
        if m:
            lines.append(m.group(1))
        elif any(w in ln for w in ("Used", "spill", "arning", "Loss")):
            lines.append(ln.split(":", 1)[-1].strip())
    return lines


def build_variants(source: str, variants: dict) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant of ``csrc/<source>.cu``, all started
    together; each library's entry points bound as ``build.SOURCES``
    says. An edit is (statement, replacement), the statement found
    exactly once, or (statement, replacement, n), found exactly n
    times."""
    from repro_torch.kernels import build
    path = CSRC / f"{source}.cu"
    text = path.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new, *n in edits:
            if src.count(old) != (n[0] if n else 1):
                raise SystemExit(f"error: variant {name}: {old!r} is not "
                                 f"in {path.name} {n[0] if n else 1} "
                                 f"time(s)")
            src = src.replace(old, new)
        stem = OUT_DIR / f"{source}-{name}"
        stem.with_suffix(".cu").write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (stem.with_suffix(".so"),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"error: nvcc failed on {source} variant "
                             f"{name}:\n{err}")
        print(f"build: {source} {name}: ptxas: "
              f"{'; '.join(ptxas_lines(out + err))}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry, argtypes in build.SOURCES[source].items():
            fn = getattr(libs[name], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the times as "
                    "JSON here")
    ap.add_argument("--only", choices=("split", "flash", "bwd", "f32",
                                       "depthwise", "plans"),
                    default=None, help="time one kernel family only "
                    "(plans: the fused kernel under every launch plan, run "
                    "only when asked for)")
    ap.add_argument("--fit-from", default=None, metavar="JSON",
                    help="fit fused_plan's cost coefficients to the rows an "
                         "--only plans run wrote with --out (no card "
                         "needed)")
    ap.add_argument("--parent-bwd", default=None, metavar="PATH",
                    help="also time the flash_attention_bwd.cu at PATH (an "
                         "earlier version with the same entry points) beside "
                         "this one's, in turns")
    ap.add_argument("--parent-flash", default=None, metavar="PATH",
                    help="the same for the flash_attention.cu at PATH")
    ap.add_argument("--parent-f32", default=None, metavar="PATH",
                    help="the same for the flash_attention_f32.cu at PATH")
    ap.add_argument("--parent-depthwise", default=None, metavar="PATH",
                    help="the same for the depthwise_gemm.cu at PATH")
    ap.add_argument("--parent-split", default=None, metavar="PATH",
                    help="the same for the fused_split_gemm.cu at PATH (the "
                         "earlier entry point on planes and packed bytes)")
    args = ap.parse_args(argv)
    if args.fit_from:
        sys.path.insert(0, str(ROOT / "src"))
        fit_plan_cost(json.loads(Path(args.fit_from).read_text()))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import device_times, nvidia_smi

    print(f"card: {nvidia_smi()}")
    rows = []
    for family, fn in (("split", time_split), ("flash", time_flash),
                       ("bwd", time_bwd), ("f32", time_f32),
                       ("depthwise", time_depthwise)):
        if args.only in (None, family):
            rows += fn(torch, device_times, {
                "bwd": args.parent_bwd, "flash": args.parent_flash,
                "f32": args.parent_f32, "split": args.parent_split,
                "depthwise": args.parent_depthwise}[family])
    if args.only == "plans":
        rows += time_plans(torch, device_times)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


def time_flash(torch, device_times, parent: str | None = None
               ) -> list[dict]:
    """The flash variants at :data:`FLASH_SHAPES` and, with the
    log-sum-exp, :data:`FLASH_TRAIN_SHAPES`, each under its plan, and
    the full kernel in the prefill form where the plan is the decode
    form; the wide variants (:data:`FLASH_WIDE_VARIANTS`) only where they
    differ from "full". With ``parent``, that source beside this one's,
    in turns (parent, this, this, parent)."""
    from chip_smoke import BWD_SHAPES, FLASH_SHAPES as SMOKE_SHAPES
    from repro_torch.kernels.flash_attention import WIDE_THREADS, \
        flash_plan, kernel_args
    libs = build_variants("flash_attention", FLASH_VARIANTS)
    old = build_parent("flash_attention", parent) if parent else None
    if old is not None:
        for vname in ("full", "mma_sync"):
            print(f"sass: this source's {vname} variant against the parent:")
            same_sass(OUT_DIR / f"flash_attention-{vname}.so",
                      OUT_DIR / "flash_attention-parent.so")
    gen = torch.Generator(device="cuda").manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    shapes = [s for s in SMOKE_SHAPES if s.name in FLASH_SHAPES] + \
        [s for s in BWD_SHAPES if s.name in FLASH_TRAIN_SHAPES]
    for shape in shapes:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        dv = shape.v_dim
        q, k, v = (torch.randn((b, s, h, e), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for s, h, e in ((sq, hq, d), (skv, hkv, d),
                                   (skv, hkv, dv)))
        out = torch.empty((b, sq, hq, dv), device="cuda",
                          dtype=torch.bfloat16)
        lse = torch.empty((b, hq, sq), device="cuda") \
            if name in FLASH_TRAIN_SHAPES else None
        plan = flash_plan(b, sq, skv, hq, hkv, d, dv)
        cargs = {form: kernel_args(q, k, v, out, d ** -0.5, causal, off,
                                   plan._replace(form=form), lse)
                 for form in {plan.form, "prefill"}}

        def run(lib, form=plan.form):
            rc = lib.flash_attention(*cargs[form], stream)
            if rc:
                raise RuntimeError(f"launch failed with error {rc}")
        wgmma = plan.threads == WIDE_THREADS  # the wgmma instance runs
        mla = plan.form == "prefill" and (d, dv) == (192, 128)
        differs = {**{v: wgmma for v in FLASH_WIDE_VARIANTS},
                   "q_smem": wgmma and mla, "wgmma_short": mla and not wgmma}
        fns = {vname: (lambda lib=lib: run(lib), 20)
               for vname, lib in libs.items() if differs.get(vname, True)}
        if plan.form == "decode":
            fns["prefill_form"] = (lambda: run(libs["full"], "prefill"), 20)
        if old is not None:
            for key, lib in (("turns/parent_1", old),
                             ("turns/this_1", libs["full"]),
                             ("turns/this_2", libs["full"]),
                             ("turns/parent_2", old)):
                fns[key] = (lambda lib=lib: run(lib), 20)
        us = {vname: 1e3 * t
              for vname, t in device_times(torch, fns).items()}
        rows.append({"kernel": "flash_attention", "shape": name, "b": b,
                     "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d,
                     "dv": dv, "form": plan.form, "grid": list(plan.grid),
                     "threads": plan.threads, "lse": lse is not None,
                     "us": us})
        print(f"flash_attention {name}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} DV={dv} {plan.form} grid {plan.grid} x "
              f"{plan.threads}{' with lse' if lse is not None else ''}: "
              + "; ".join(
                  f"{vname} {t:.2f} us" for vname, t in us.items()))
        del q, k, v, out, lse
    return rows


def build_parent(source: str, path: str) -> ctypes.CDLL:
    """``path``, an earlier ``csrc/<source>.cu`` with this one's entry
    points, built as the variants are."""
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / f"{source}-parent.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), path], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"error: nvcc failed on {path}:\n{proc.stderr}")
    print(f"build: {source} parent: ptxas: "
          f"{'; '.join(ptxas_lines(proc.stdout + proc.stderr))}")
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in build.SOURCES[source].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def sass_of(lib: Path) -> dict[str, str]:
    """Each kernel's SASS in ``lib`` (``cuobjdump -sass``, beside nvcc), by
    its name less the source's anonymous namespace, with the instruction
    addresses' comments taken out, up to the line of dots that ends it."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}", "", name.strip())
        out[name] = re.sub(r"/\*[0-9a-f]{4,}\*/", "",
                           body.split("..........")[0])
    return out


def same_sass(this: Path, parent: Path) -> None:
    """Print, for each kernel of the parent's library that this one also
    has, whether the two compiled to the same SASS."""
    mine, theirs = sass_of(this), sass_of(parent)
    for name in sorted(set(mine) & set(theirs)):
        same = mine[name] == theirs[name]
        print(f"sass {name[:48]}: "
              + ("the parent's" if same else "differs from the parent's"))
        if not same:
            pairs = [(a, b) for a, b in zip(theirs[name].splitlines(),
                                            mine[name].splitlines())
                     if a != b]
            print("\n".join(f"  parent: {a.strip()}\n  this:   {b.strip()}"
                            for a, b in pairs[:4]))


def time_bwd(torch, device_times, parent: str | None = None) -> list[dict]:
    """The backward's variants at :data:`BWD_SHAPES`, each entry point
    timed alone and the two as a pair; with ``parent``, that source's
    pair beside this one's, in turns (parent, this, this, parent)."""
    from chip_smoke import BWD_SHAPES as SMOKE_SHAPES
    from repro_torch.kernels import flash_attention_bwd as fab
    libs = build_variants("flash_attention_bwd", BWD_VARIANTS)
    old = build_parent("flash_attention_bwd", parent) if parent else None
    if old is not None:
        same_sass(OUT_DIR / "flash_attention_bwd-full.so",
                  OUT_DIR / "flash_attention_bwd-parent.so")
    gen = torch.Generator(device="cuda").manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for shape in SMOKE_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        if name not in BWD_SHAPES:
            continue
        dv = shape.v_dim
        q, k, v, out, dout = (
            torch.randn(sh, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                       (b, sq, hq, dv), (b, sq, hq, dv)))
        # the row statistics of a softmax over ~Skv keys of unit scores
        lse = torch.full((b, hq, sq), math.log(skv), device="cuda")
        delta = torch.empty((b, hq, sq), device="cuda")
        grads = [torch.empty_like(t) for t in (q, k, v)]
        args = fab.entry_args(q, k, v, out, dout, lse, delta, *grads,
                              d ** -0.5, causal, off)

        def run(lib, entry):
            rc = getattr(lib, entry)(*args[entry], stream)
            if rc:
                raise RuntimeError(f"{entry} failed with error {rc}")

        def pair(lib):
            for entry in fab.ENTRY_POINTS:
                run(lib, entry)
        fns = {}
        wide = d > 128
        for vname, lib in libs.items():
            if vname in WIDE_VARIANTS and not wide:
                continue  # the same kernels as "full" at (64, 64), (128, 128)
            if vname != "no_pdl":
                for entry in fab.ENTRY_POINTS:
                    short = entry.replace("flash_attention_bwd_", "")
                    fns[f"{vname}/{short}"] = (
                        lambda lib=lib, entry=entry: run(lib, entry), 20)
            if vname in ("full", "no_pdl", *WIDE_VARIANTS):
                fns[f"{vname}/pair"] = (lambda lib=lib: pair(lib), 20)
        if old is not None:
            def old_pair():
                for entry in fab.ENTRY_POINTS:
                    rc = getattr(old, entry)(*args[entry], stream)
                    if rc:
                        raise RuntimeError(f"parent {entry} failed with "
                                           f"error {rc}")
            for key, fn in (
                    ("turns/parent_1", old_pair),
                    ("turns/this_1", lambda: pair(libs["full"])),
                    ("turns/this_2", lambda: pair(libs["full"])),
                    ("turns/parent_2", old_pair)):
                fns[key] = (fn, 20)
        # dkdv alone reads the delta dq writes
        run(libs["full"], "flash_attention_bwd_dq")
        us = {key: 1e3 * t for key, t in device_times(torch, fns).items()}
        rows.append({"kernel": "flash_attention_bwd", "shape": name, "b": b,
                     "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d,
                     "dv": dv, "causal": causal, "kv_offset": off, "us": us})
        print(f"flash_attention_bwd {name}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} DV={dv} causal={causal}: " + "; ".join(
                  f"{key} {t:.2f} us" for key, t in us.items()))
        del q, k, v, out, dout, lse, delta, grads
    return rows


def time_f32(torch, device_times, parent: str | None = None) -> list[dict]:
    """The fp32 kernel's variants: the forward at every
    ``chip_smoke.F32_SHAPES`` row beside SDPA in fp32, and at the rows
    with a backward dq, dkdv and the pair beside SDPA's fp32 backward;
    with ``parent``, that source's forward, dq, dkdv and pair, the
    forward and the pairs in turns."""
    from chip_smoke import F32_SHAPES, sdpa_bwd_fn, sdpa_fn
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import f32_kernel_args
    libs = build_variants("flash_attention_f32", F32_VARIANTS)
    old = build_parent("flash_attention_f32", parent) if parent else None
    if old is not None:
        print("sass: the backward's kernels against the parent's (the "
              "forward's instances are new):")
        same_sass(OUT_DIR / "flash_attention_f32-full.so",
                  OUT_DIR / "flash_attention_f32-parent.so")
    gen = torch.Generator(device="cuda").manual_seed(14)
    stream = torch.cuda.current_stream().cuda_stream
    names = fab.F32_ENTRY_POINTS
    bwd_libs = {n: lib for n, lib in libs.items()
                if n not in F32_FWD_VARIANTS}
    fwd_libs = {n: lib for n, lib in libs.items()
                if n == "full" or n in F32_FWD_VARIANTS}
    rows = []
    for shape in F32_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        dv = shape.v_dim
        kv_dt = torch.bfloat16 if shape.kv_bf16 else torch.float32
        q, k, v, out, dout = (
            torch.randn(sh, generator=gen, device="cuda").to(dt)
            for sh, dt in (((b, sq, hq, d), torch.float32),
                           ((b, skv, hkv, d), kv_dt),
                           ((b, skv, hkv, dv), kv_dt),
                           ((b, sq, hq, dv), kv_dt),
                           ((b, sq, hq, dv), torch.float32)))
        fargs = f32_kernel_args(q, k, v, out, d ** -0.5, causal, off)

        def fwd(lib, who="this"):
            rc = lib.flash_attention_f32(*fargs, stream)
            if rc:
                raise RuntimeError(f"{who} flash_attention_f32 failed with "
                                   f"error {rc}")
        fns = {f"{vname}/fwd": (lambda lib=lib: fwd(lib), 20)
               for vname, lib in fwd_libs.items()}
        if old is not None:
            for key, lib, who in (("fwd_turns/parent_1", old, "parent"),
                                  ("fwd_turns/this_1", libs["full"], "this"),
                                  ("fwd_turns/this_2", libs["full"], "this"),
                                  ("fwd_turns/parent_2", old, "parent")):
                fns[key] = (lambda lib=lib, who=who: fwd(lib, who), 20)
        fns["sdpa"] = (sdpa_fn(torch, q, k.float(), v.float(), causal, off),
                       20)
        if shape.backward:
            lse = torch.full((b, hq, sq), math.log(skv), device="cuda")
            delta = torch.empty((b, hq, sq), device="cuda")
            grads = [torch.empty_like(t) for t in (q, k, v)]
            args = fab.entry_args(q, k, v, out, dout, lse, delta, *grads,
                                  d ** -0.5, causal, off)

            def run(lib, entry, who="this"):
                rc = getattr(lib, entry)(*args[entry], stream)
                if rc:
                    raise RuntimeError(f"{who} {entry} failed with error "
                                       f"{rc}")

            def pair(lib, who="this"):
                for entry in names:
                    run(lib, entry, who)
            for vname, lib in bwd_libs.items():
                for entry in names:
                    short = entry.replace("flash_attention_f32_bwd_", "")
                    fns[f"{vname}/{short}"] = (
                        lambda lib=lib, entry=entry: run(lib, entry), 20)
                fns[f"{vname}/pair"] = (lambda lib=lib: pair(lib), 20)
            if old is not None:
                for entry in names:
                    short = entry.replace("flash_attention_f32_bwd_", "")
                    fns[f"parent/{short}"] = (
                        lambda entry=entry: run(old, entry, "parent"), 20)
                for key, fn in (
                        ("turns/parent_1", lambda: pair(old, "parent")),
                        ("turns/this_1", lambda: pair(libs["full"])),
                        ("turns/this_2", lambda: pair(libs["full"])),
                        ("turns/parent_2", lambda: pair(old, "parent"))):
                    fns[key] = (fn, 20)
            lib_bwd = sdpa_bwd_fn(torch, q, k, v, dout, causal, off)
            if lib_bwd is not None:
                fns["sdpa_bwd"] = (lib_bwd, 20)
            # dkdv alone reads the delta dq writes
            run(libs["full"], names[0])
        us = {key: 1e3 * t for key, t in device_times(torch, fns).items()}
        fplan = fab.f32_fwd_plan(b, sq, skv, hq, hkv, d, dv, causal, off,
                                 shape.kv_bf16)
        row = {"kernel": "flash_attention_f32", "shape": name, "b": b,
               "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d, "dv": dv,
               "causal": causal, "kv_offset": off,
               "kv_bf16": shape.kv_bf16, "fwd_blocks": fplan.blocks,
               "fwd_instance": fplan.instance, "us": us}
        if shape.backward:
            row["split"] = fab.f32_bwd_plan(b, sq, skv, hq, hkv, d, dv,
                                            causal, off).split
        rows.append(row)
        print(f"flash_attention_f32 {name}: B={b} Sq={sq} Skv={skv} "
              f"Hq={hq} Hkv={hkv} D={d} DV={dv} causal={causal} "
              f"kv_offset={off} K/V {str(kv_dt).split('.')[-1]}, forward "
              f"{fplan.blocks} blocks, instance {fplan.instance}, "
              f"{fplan.key_slices} key slices, {fplan.smem} B shared"
              + (f", backward S={row['split']}" if shape.backward else "")
              + ": " + "; ".join(f"{key} {t:.2f} us"
                                 for key, t in us.items()))
        del q, k, v, out, dout
    return rows


def time_depthwise(torch, device_times, parent: str | None = None
                   ) -> list[dict]:
    """``depthwise_conv_gemm``'s variants at full-width mobilenet_v2's
    depthwise layers and at their ``filter`` x 2 shards, each layer's
    plan printed; with ``parent``, that source beside this one in
    turns. Per-image sums last."""
    import collections

    from repro_torch.compiler import compile_network
    from repro_torch.kernels import ops
    from repro_torch.kernels.depthwise_gemm import depthwise_plan
    libs = build_variants("depthwise_gemm", DW_VARIANTS)
    old = build_parent("depthwise_gemm", parent) if parent else None
    prog = compile_network("mobilenet_v2")
    shards = [dev.layers for dev in compile_network(
        "mobilenet_v2", devices=2, partition="filter").devices]
    gen = torch.Generator().manual_seed(31)
    stream = torch.cuda.current_stream().cuda_stream

    def case(lp):
        """One launch's arguments at ``lp``'s shape and split, random
        codes and input, and its plan."""
        g, n = lp.geometry, lp.dims.n
        bits, n_lut = lp.bits_w_lut, lp.n_lut
        k = g.kernel * g.kernel
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        sw = ops.prepare_split(
            k, torch.randint(lo, hi, (k, n_lut), generator=gen),
            torch.rand(n_lut, generator=gen) + 0.5, bits,
            torch.randint(-8, 8, (k, n - n_lut), generator=gen),
            torch.rand(n - n_lut, generator=gen) + 0.5,
            torch.device("cuda"))
        x = torch.randint(-128, 128, (g.in_hw, g.in_hw, n), generator=gen,
                          dtype=torch.int8).cuda()
        out = torch.empty((g.out_hw ** 2, n), device="cuda")
        args = (x.data_ptr(), g.in_hw, g.in_hw, n, g.kernel, g.stride, g.pad,
                g.out_hw, sw.planes.data_ptr(), bits, n_lut,
                sw.packed.data_ptr(), n - n_lut, sw.scale.data_ptr(),
                out.data_ptr())
        plan = depthwise_plan(g.out_hw ** 2, k, n, True, g.kernel, g.stride,
                              g.out_hw, x.data_ptr(), out.data_ptr())
        return (args, (sw, x, out)), plan

    def run(lib, calls, who="this"):
        for args, _ in calls:
            rc = lib.depthwise_conv_gemm(*args, stream)
            if rc:
                raise RuntimeError(f"{who} depthwise_conv_gemm failed with "
                                   f"error {rc}")
    rows, total = [], collections.Counter()
    for lp in prog.layers:
        if not lp.depthwise:
            continue
        one, plan = case(lp)
        two = [case(sh[lp.index])[0] for sh in shards]
        fns = {}
        for form, calls in (("layer", [one]), ("shards", two)):
            for vname, lib in libs.items():
                fns[f"{form}/{vname}"] = (
                    lambda lib=lib, calls=calls: run(lib, calls), 20)
            if old is not None:
                for key, lib, who in (("parent_1", old, "parent"),
                                      ("this_1", libs["full"], "this"),
                                      ("this_2", libs["full"], "this"),
                                      ("parent_2", old, "parent")):
                    fns[f"{form}/turns/{key}"] = (
                        lambda lib=lib, calls=calls, who=who:
                        run(lib, calls, who), 20)
        us = {key: 1e3 * t for key, t in device_times(torch, fns).items()}
        total.update(us)
        g = lp.geometry
        rows.append({"kernel": "depthwise_conv_gemm", "layer": lp.name,
                     "in_hw": g.in_hw, "c": lp.dims.n, "stride": g.stride,
                     "n_lut": lp.n_lut, "plan": plan._asdict(), "us": us})
        print(f"depthwise {lp.name}: {g.in_hw}x{g.in_hw}x{lp.dims.n} stride "
              f"{g.stride} n_lut {lp.n_lut}, plan V={plan.v} "
              f"block {plan.block} grid {plan.grid}: " + "; ".join(
                  f"{key} {t:.2f} us"
                                           for key, t in us.items()))
    rows.append({"kernel": "depthwise_conv_gemm", "layer": "per_image",
                 "us": dict(total)})
    print("depthwise per image (17 layers): " + "; ".join(
        f"{key} {t:.2f} us" for key, t in total.items()))
    return rows


def time_split(torch, device_times, parent: str | None = None
               ) -> list[dict]:
    """The split-GEMM variants at :data:`SHAPES`: the fused kernel's
    under ``fused_plan``, the single-path kernels' under ``split_plan`` on
    their one-sided shapes. With ``parent``, that ``fused_split_gemm.cu``
    (the earlier entry point on ``planes`` / ``packed`` and
    ``split_plan``'s tiles) beside this one's, in turns (parent, this,
    this, parent)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hetero_gemm import fused_plan, \
        split_plan, weight_bytes
    fused_libs = build_variants("fused_split_gemm", VARIANTS)
    split_libs = build_variants("split_gemm", SPLIT_VARIANTS)
    old = build_parent("fused_split_gemm", parent) if parent else None
    if old is not None:  # the earlier signature: planes, packed, (bm, bn, S)
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        old.fused_hetero_gemm.argtypes = [p_, i_, i_, p_, i_, i_, p_, i_, p_,
                                          p_, i_, i_, i_, p_]
    gen = torch.Generator().manual_seed(0)
    rows = []
    for layer, (m, k, n_lut, n_dsp) in SHAPES.items():
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        sw = ops.prepare_split(
            k, torch.randint(-8, 8, (k, n_lut), generator=gen),
            torch.ones(n_lut), 4,
            torch.randint(-8, 8, (k, n_dsp), generator=gen),
            torch.ones(n_dsp), torch.device("cuda"))
        out = torch.empty((m, n_lut + n_dsp), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        # (kernel, its plan, the call of one variant's library)
        calls = {"fused_hetero_gemm": (
            fused_plan(m, k, n_lut, n_dsp, 4),
            lambda lib, pl: lib.fused_hetero_gemm(
                x.data_ptr(), m, k, sw.lut_words.data_ptr(), 4, n_lut,
                sw.dsp_words.data_ptr(), n_dsp, sw.scale.data_ptr(),
                out.data_ptr(), pl.t, pl.wc, pl.split, pl.stages, stream))}
        if n_lut:
            calls["bitserial_gemm"] = (
                split_plan(m, k, n_lut, 0),
                lambda lib, pl: lib.bitserial_gemm(
                    x.data_ptr(), m, k, sw.lut_words.data_ptr(), 4, n_lut,
                    sw.s_lut.data_ptr(), out.data_ptr(), pl.bm, pl.bn,
                    pl.split, stream))
        if n_dsp:
            calls["int4_gemm"] = (
                split_plan(m, k, 0, n_dsp),
                lambda lib, pl: lib.int4_gemm(
                    x.data_ptr(), m, k, sw.dsp_words.data_ptr(), n_dsp,
                    sw.s_dsp.data_ptr(), out.data_ptr(), pl.bm, pl.bn,
                    pl.split, stream))
        for kernel, (plan, call) in calls.items():
            libs = fused_libs if kernel == "fused_hetero_gemm" else \
                split_libs

            def run(lib, call=call, plan=plan, who="this"):
                rc = call(lib, plan)
                if rc:
                    raise RuntimeError(f"{who} launch failed with error "
                                       f"{rc}")
            fns = {name: (lambda lib=lib: run(lib), 20)
                   for name, lib in libs.items()}
            if kernel == "fused_hetero_gemm" and old is not None:
                pp = split_plan(m, k, n_lut, n_dsp)

                def run_parent(pp=pp):
                    rc = old.fused_hetero_gemm(
                        x.data_ptr(), m, k, sw.planes.data_ptr(), 4, n_lut,
                        sw.packed.data_ptr(), n_dsp, sw.scale.data_ptr(),
                        out.data_ptr(), pp.bm, pp.bn, pp.split, stream)
                    if rc:
                        raise RuntimeError(f"parent launch failed with "
                                           f"error {rc}")
                for key, fn in (("turns/parent_1", run_parent),
                                ("turns/this_1", fns["full"][0]),
                                ("turns/this_2", fns["full"][0]),
                                ("turns/parent_2", run_parent)):
                    fns[key] = (fn, 20)
            us = {name: 1e3 * t for name, t in device_times(torch,
                                                            fns).items()}
            row = {"kernel": kernel, "layer": layer, "m": m, "k": k,
                   "n_lut": n_lut, "n_dsp": n_dsp, "plan": list(plan),
                   "us": us}
            if kernel == "fused_hetero_gemm":
                row["weight_bytes"] = weight_bytes(k, 4, n_lut, n_dsp)
                desc = (f"t={plan.t} wc={plan.wc} S={plan.split} "
                        f"stages={plan.stages} smem={plan.smem} "
                        f"blocks={plan.blocks}, "
                        f"{row['weight_bytes']} weight bytes")
            else:
                desc = (f"BM={plan.bm} BN={plan.bn} S={plan.split} "
                        f"blocks={plan.blocks}")
            rows.append(row)
            print(f"{kernel} {layer}: M={m} K={k} {n_lut}/{n_dsp} {desc}: "
                  + "; ".join(f"{name} {t:.2f} us"
                              for name, t in us.items()))
        del x, sw, out
    return rows


#: the shapes ``--only plans`` times, bits 4: (name, conv (H=W, C,
#: kernel, stride, pad) or None, M, K, n_lut, n_dsp): resnet18's distinct
#: layers in the conv form, three of its ``filter`` x 3 shards, the decode
#: layers of :data:`SHAPES`, the llama MLP and the quickstart layer
PLAN_SHAPES = [
    ("conv1", (224, 3, 7, 2, 3), 48, 16), ("conv2", (56, 64, 3, 1, 1), 48, 16),
    ("conv6", (56, 64, 3, 2, 1), 96, 32),
    ("conv7", (28, 128, 3, 1, 1), 96, 32),
    ("conv8_ds", (56, 64, 1, 2, 0), 64, 64),
    ("conv11", (28, 128, 3, 2, 1), 224, 32),
    ("conv12", (14, 256, 3, 1, 1), 192, 64),
    ("conv13_ds", (28, 128, 1, 2, 0), 192, 64),
    ("conv16", (14, 256, 3, 2, 1), 432, 80),
    ("conv17", (7, 512, 3, 1, 1), 432, 80),
    ("conv18_ds", (14, 256, 1, 2, 0), 416, 96),
    ("fc", (1, 512, 1, 1, 0), 680, 320),
    ("x3_conv1", (224, 3, 7, 2, 3), 21, 0),
    ("x3_conv1_mixed", (224, 3, 7, 2, 3), 5, 16),
    ("x3_conv17", (7, 512, 3, 1, 1), 80, 91),
    *[(name, None, *SHAPES[name][2:]) for name in (
        "dec_q", "dec_kv", "dec_up", "dec_down", "dec_head")],
    ("hetero_mlp", None, 4096, 4096), ("hetero_quickstart", None, 77, 115),
]


def plan_shape(name, conv, n_lut, n_dsp) -> tuple[int, int]:
    """(M, K) of a :data:`PLAN_SHAPES` row."""
    if conv is None:
        return tuple(SHAPES[name][:2])
    hw, c, ks, st, pad = conv
    return ((hw + 2 * pad - ks) // st + 1) ** 2, ks * ks * c


def time_plans(torch, device_times) -> list[dict]:
    """The fused kernel at :data:`PLAN_SHAPES` under every candidate
    plan (each with ``fused_stages``' ring), the chooser's marked."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.fused_hetero_gemm import fused_candidates, \
        fused_plan, fused_stages
    build.build_all(("fused_split_gemm",))
    gen = torch.Generator().manual_seed(0)
    rows = []
    for name, conv, n_lut, n_dsp in PLAN_SHAPES:
        m, k = plan_shape(name, conv, n_lut, n_dsp)
        if conv is None:
            x = torch.randint(-8, 8, (m, k), generator=gen,
                              dtype=torch.int8).cuda()
            entry, lead = "fused_hetero_gemm", (m, k)
        else:
            hw, c, ks, st, pad = conv
            x = torch.randint(-8, 8, (hw, hw, c), generator=gen,
                              dtype=torch.int8).cuda()
            entry = "fused_conv_gemm"
            lead = (hw, hw, c, ks, st, pad, math.isqrt(m))
        sw = ops.prepare_split(
            k, torch.randint(-8, 8, (k, n_lut), generator=gen),
            torch.ones(n_lut), 4,
            torch.randint(-8, 8, (k, n_dsp), generator=gen),
            torch.ones(n_dsp), torch.device("cuda"))
        out = torch.empty((m, n_lut + n_dsp), device="cuda")
        fns = {}
        for t, wc, split in fused_candidates(m, k):
            plan = (t, wc, split,
                    fused_stages(t, wc, split, k, 4, n_lut, n_dsp))
            fns[plan] = (lambda plan=plan: build.launch(
                entry, x, x.data_ptr(), *lead, sw.lut_words.data_ptr(), 4,
                n_lut, sw.dsp_words.data_ptr(), n_dsp, sw.scale.data_ptr(),
                out.data_ptr(), *plan), 10)
        us = {plan: 1e3 * t for plan, t in device_times(torch, fns).items()}
        chosen = tuple(fused_plan(m, k, n_lut, n_dsp, 4)[:4])
        best = sorted(us.items(), key=lambda kv: kv[1])
        rows.append({"kernel": entry, "layer": name, "m": m, "k": k,
                     "n_lut": n_lut, "n_dsp": n_dsp, "chosen": list(chosen),
                     "plans": [[*plan, t] for plan, t in us.items()]})
        print(f"plans {name} M={m} K={k} {n_lut}/{n_dsp}: chosen "
              f"(t, wc, S, stages) {chosen} {us[chosen]:.2f} us; fastest "
              + "; ".join(f"{plan} {t:.2f}" for plan, t in best[:5]))
        del x, sw, out
    return rows


def fit_plan_cost(rows: list[dict], iters: int = 8000) -> dict:
    """``fused_hetero_gemm.PLAN_COST`` fitted to :func:`time_plans`' rows:
    for each weight of a wave when two blocks share an SM in (1, 1.2, 1.5,
    2), least squares on the times (each shape's rows weighted by one over
    its fastest time); then, from the best of those and the current
    coefficients, a random search that keeps a change unless it raises
    the sum over shapes of the chosen plan's time over the fastest plan's.
    Prints and returns the fit."""
    import numpy as np
    from repro_torch.kernels.fused_hetero_gemm import PLAN_COST, _fused_cost
    keys = [k for k in PLAN_COST if k != "two_per_sm"]
    cases = [(r, tuple(p[:3]), p[4]) for r in rows for p in r["plans"]]
    fastest = {r["layer"]: min(p[4] for p in r["plans"]) for r in rows}

    def features(two):  # each coefficient's term, by a unit coefficient
        unit = {k: 0.0 for k in keys}
        cols = []
        for k in keys:
            c = {**unit, k: 1.0, "two_per_sm": two}
            cols.append([_fused_cost(r["m"], r["k"], r["n_lut"], r["n_dsp"],
                                     4, *plan, c) for r, plan, _ in cases])
        return np.array(cols).T

    times = np.array([t for _, _, t in cases])
    layers = [r["layer"] for r, _, _ in cases]
    index = {name: [i for i, n in enumerate(layers) if n == name]
             for name in fastest}

    def regret(x, coef):
        pred = x @ coef
        return sum(times[min(ix, key=lambda i: pred[i])] / fastest[name]
                   for name, ix in index.items())

    now = np.array([PLAN_COST[k] for k in keys])
    x_now = features(PLAN_COST["two_per_sm"])
    best = (regret(x_now, now), PLAN_COST["two_per_sm"], x_now, now)
    start = best[0]
    for two in (1.0, 1.2, 1.5, 2.0):
        x = features(two)
        w = np.array([1 / fastest[n] for n in layers])
        coef = np.maximum(np.linalg.lstsq(x * w[:, None], times * w,
                                          rcond=None)[0], 0)
        if regret(x, coef) < best[0]:
            best = (regret(x, coef), two, x, coef)
    cur, two, x, coef = best
    rng = np.random.default_rng(0)
    for _ in range(iters):
        cand = np.maximum(coef * np.exp(rng.normal(0, 0.3, coef.shape)), 0)
        r = regret(x, cand)
        if r < cur or (r == cur and rng.random() < 0.3):
            coef, cur = cand, r
    fit = {**{k: round(float(v), 4) for k, v in zip(keys, coef)},
           "two_per_sm": two}
    print(f"fit: PLAN_COST = {fit}; sum of chosen over fastest "
          f"{cur:.2f} at {len(fastest)} shapes (the current coefficients "
          f"{start:.2f})")
    return fit


if __name__ == "__main__":
    sys.exit(main())
