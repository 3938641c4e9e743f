"""Fused split-aware whole-layer kernels: both sides of the Eq.-12
split in one launch.

``fused_hetero_gemm`` — [M, K] int8 activations against the LUT columns'
bit-packed K-major plane words and the DSP columns' K-major int4 words
(``ops.SplitWeights.lut_words`` / ``.dsp_words``), one int32
accumulation and one fp32 per-column dequant; the output lands as one
[M, n_lut + n_dsp] tensor in split column order.

``fused_conv_gemm`` — the im2col-free conv variant: the kernel reads the
*unpadded* NHWC block and gathers the patches itself, so no column
matrix and no padded copy exist. Its CUDA form needs no VMEM budget and
no fallback: every resnet18 layer, ``conv1`` and ``fc`` included, takes
it.

Both wrappers launch the CUDA kernels of ``csrc/fused_split_gemm.cu``
(wgmma with the weights as the register operand, the planes folded into
the int8 codes in registers, a producer warpgroup's ``cp.async`` ring,
split-K over a thread-block cluster) on CUDA tensors and compute the
plain PyTorch version (``*_plain``) on CPU tensors; nothing else chooses
between the two. :func:`fused_plan` picks each launch's token tile, its
warpgroups' arrangement, K split and ring depth from the shape alone.
:func:`split_plan` picks the tile and K split of the single-path kernels
(``csrc/split_gemm.cu``) on their one-sided shape. Weights arrive
already prepared (``ops.prepare_split``), so the executor prepares them
once at bind time.
"""
from __future__ import annotations

import typing

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch


#: K bytes per pipeline step of the single-path kernels (``BK`` in
#: ``csrc/split_gemm.cu``)
BK = 64
#: the single-path kernels' compiled (BM, BN) output tiles, in order of
#: preference for M > 16
TILES = ((64, 64), (64, 32), (16, 64), (16, 32))
#: the cluster sizes along K (portable: at most 8)
SPLITS = (1, 2, 4, 8)
#: the block counts a launch aims for: one to two blocks per SM of an H100
MIN_BLOCKS, MAX_BLOCKS = 132, 264

class SplitPlan(typing.NamedTuple):
    """One launch's tile (BM x BN), cluster size along K and grid size."""
    bm: int
    bn: int
    split: int
    blocks: int


def _blocks(m: int, n_lut: int, n_dsp: int, bm: int, bn: int) -> int:
    """Blocks of one K slice: row tiles x (LUT + DSP column tiles)."""
    return -(-m // bm) * (-(-n_lut // bn) + -(-n_dsp // bn))


def split_plan(m: int, k: int, n_lut: int, n_dsp: int) -> SplitPlan:
    """The tile (BM, BN) and the K split S of one launch, and its block
    count. For each tile, S is the smallest power of two that brings the
    grid to :data:`MIN_BLOCKS`, at most 8 and at most the K steps. The
    first tile whose grid lands in [MIN_BLOCKS, MAX_BLOCKS] wins (the
    16-row tiles come first when M <= 16); where none does (a large M
    with few columns, or too few K steps to split), the tile whose grid
    comes closest to the range."""
    steps = -(-k // BK)
    order = TILES if m > 16 else TILES[2:] + TILES[:2]
    plans = []
    for bm, bn in order:
        base = _blocks(m, n_lut, n_dsp, bm, bn)
        split = 1
        while base * split < MIN_BLOCKS and 2 * split <= min(SPLITS[-1],
                                                               steps):
            split *= 2
        plans.append(SplitPlan(bm, bn, split, base * split))
    for plan in plans:
        if MIN_BLOCKS <= plan.blocks <= MAX_BLOCKS:
            return plan
    return min(plans, key=lambda p: max(MIN_BLOCKS / p.blocks,
                                        p.blocks / MAX_BLOCKS))


def k_slices(k: int, split: int, bk: int = BK) -> list[tuple[int, int]]:
    """The [begin, end) K range of each block of a cluster of ``split``:
    block r takes steps [r * steps // S, (r + 1) * steps // S) of ``bk``
    bytes (:data:`BK` for the single-path kernels, :data:`FUSED_BK` for
    the fused ones), as the kernels do."""
    steps = -(-k // bk)
    return [(r * steps // split * bk, min(k, (r + 1) * steps // split * bk))
            for r in range(split)]


# ---------------------------------------------------------------------------
# The fused kernels' launch plan
# ---------------------------------------------------------------------------

#: K bytes per step of the fused kernels (``BK`` in
#: ``csrc/fused_split_gemm.cu``): one 128-byte swizzled row a token
FUSED_BK = 128
#: the compiled token tiles: wgmma's N (widths the PTX ISA allows for
#: ``.m64nNk32.s8``), or mma.sync's n8 blocks below :data:`WGMMA_MIN_T`
TOKEN_TILES = (8, 16, 32, 64, 128, 256)
#: output columns of a consumer warpgroup (wgmma's M); a block has two
WG_COLS, CONSUMERS = 64, 2
#: the narrowest token tile on wgmma (``Wgmma<T>`` in the source);
#: narrower ones run mma.sync
WGMMA_MIN_T = 64
#: the ring's most stages (``MAX_STAGES``); a block's shared memory when
#: one block holds an SM, and when two share it (token tiles up to
#: :data:`TWO_PER_SM`, the kernel's launch bounds)
MAX_STAGES = 8
SMEM_ONE, SMEM_TWO = 232448, 115712
TWO_PER_SM = 16
#: an H100's SMs
SMS = 132


class FusedPlan(typing.NamedTuple):
    """One fused launch: the token tile ``t`` (wgmma's N); ``wc``, the
    consumer warpgroups along the columns (2: a block is 128 columns x t
    tokens; 1: 64 columns x 2t tokens); the cluster size along K; the
    ring's stages; the dynamic shared memory and the grid's blocks."""
    t: int
    wc: int
    split: int
    stages: int
    smem: int
    blocks: int


def fused_layout(t: int, wc: int, bits: int, n_lut: int, n_dsp: int,
                 stages: int) -> tuple[int, int]:
    """(bytes of one ring stage, dynamic shared memory of the launch), as
    ``layout_of`` in the source computes them: a stage is the token tile
    (128 bytes a token) and the step's weight words (LUT 16 bytes a plane
    and column, DSP 80 a column), rounded up to 1024; the ring or the
    int32 partial tile, whichever is larger, then 16 bytes of barriers a
    stage, 8 bytes of row table a token and 1024 for alignment."""
    tt, cc = t * (CONSUMERS // wc), WG_COLS * wc
    words = max(bits * cc * 16 if n_lut else 0, cc * 80 if n_dsp else 0)
    stage = -(-(tt * FUSED_BK + words) // 1024) * 1024
    body = max(stages * stage, tt * (cc + 4) * 4)
    return stage, 1024 + body + 16 * stages + 8 * tt


def fused_blocks(m: int, n_lut: int, n_dsp: int, t: int, wc: int) -> int:
    """Blocks of one K slice: token tiles x (LUT + DSP column tiles)."""
    cc = WG_COLS * wc
    return -(-m // (t * (CONSUMERS // wc))) * (-(-n_lut // cc) +
                                               -(-n_dsp // cc))


#: :func:`_fused_cost`'s coefficients, µs: a block's fixed cost; a step's
#: fixed cost, per KB of its token tile, per KB of its weight words, per
#: million multiply-adds on wgmma and on mma.sync, per 32 tokens of a byte
#: gather; a K split's fixed cost and per KB of its partial tile; and the
#: weight of a wave when two blocks share an SM. Fitted
#: (``kernel_parts.py --fit-from``) to the times ``kernel_parts.py --only
#: plans`` takes of every plan at 22 shapes on an NVIDIA H100 80GB HBM3
#: at 700 W: the chosen plan's time over the fastest's sums to 22.40 over
#: the 22 shapes (22 at best). A ranking, not a prediction of time.
PLAN_COST = dict(block=0.002, step=2.4311, token_kb=0.7662, word_kb=0.2375,
                 mmac=0.0056, mmac_sync=4.1389, gather=8643.2035,
                 split=10.0789, part_kb=0.198, two_per_sm=1.5)


def _fused_cost(m: int, k: int, n_lut: int, n_dsp: int, bits: int, t: int,
                wc: int, split: int, c: dict = PLAN_COST) -> float:
    """A launch's modelled time, to rank plans: waves of blocks (two an
    SM at t <= :data:`TWO_PER_SM`, a wave weighted ``two_per_sm``), each
    a fixed cost, its K steps and, split, its partial tile's reduction.
    A step costs its token tile's and weight words' KB, its
    multiply-adds (on wgmma, or mma.sync below :data:`WGMMA_MIN_T`
    tokens) and, where K is not a multiple of 4 (conv1's C = 3, the
    byte gather), its tokens."""
    steps = -(-k // FUSED_BK)
    tt, cc = t * (CONSUMERS // wc), WG_COLS * wc
    per_sm = 2 if t <= TWO_PER_SM else 1
    blocks = split * fused_blocks(m, n_lut, n_dsp, t, wc)
    waves = -(-blocks // (SMS * per_sm)) * (c["two_per_sm"] if per_sm == 2
                                            else 1)
    words = bits * cc * 16 if n_lut >= n_dsp else cc * 64
    mmac = c["mmac" if t >= WGMMA_MIN_T else "mmac_sync"]
    step = (c["step"] + c["token_kb"] * min(tt, m) * FUSED_BK / 1024
            + c["word_kb"] * words / 1024 + mmac * tt * cc * FUSED_BK / 1e6
            + (c["gather"] * tt / 32 if k % 4 else 0))
    reduce = c["split"] + c["part_kb"] * tt * cc * 4 / 1024 if split > 1 \
        else 0
    return waves * (c["block"] + -(-steps // split) * step + reduce)


def fused_candidates(m: int, k: int) -> list[tuple[int, int, int]]:
    """The (t, wc, split) a launch at M tokens and K may take: a token
    tile no wider than twice M (t = 8 always), two token tiles a block
    (wc = 1) only where M is wider than one, and a K split no larger
    than the K steps."""
    steps = -(-k // FUSED_BK)
    return [(t, wc, split) for t in TOKEN_TILES for wc in (2, 1)
            for split in SPLITS
            if (t == TOKEN_TILES[0] or t < 2 * m) and (wc == 2 or t < m)
            and split <= steps]


def fused_stages(t: int, wc: int, split: int, k: int, bits: int, n_lut: int,
                 n_dsp: int) -> int:
    """The ring's depth: the steps a block walks, at least 2 (a consumer
    holds one stage while it waits for the next) and at most
    :data:`MAX_STAGES`, as many as fit the shared memory one block an SM
    (two at t <= :data:`TWO_PER_SM`) leaves."""
    cap = SMEM_TWO if t <= TWO_PER_SM else SMEM_ONE
    stages = min(MAX_STAGES, max(-(-(-(-k // FUSED_BK)) // split), 2))
    while stages > 2 and fused_layout(t, wc, bits, n_lut, n_dsp,
                                      stages)[1] > cap:
        stages -= 1
    return stages


def fused_plan(m: int, k: int, n_lut: int, n_dsp: int,
               bits: int = 4) -> FusedPlan:
    """The fused kernels' launch at an (M, K, n_lut, n_dsp) shape and
    the LUT side's bit width: of :func:`fused_candidates`, the one of
    least :func:`_fused_cost` (the first on a tie), its ring as deep as
    :func:`fused_stages` allows."""
    t, wc, split = min(fused_candidates(m, k), key=lambda c: _fused_cost(
        m, k, n_lut, n_dsp, bits, *c))
    stages = fused_stages(t, wc, split, k, bits, n_lut, n_dsp)
    return FusedPlan(t, wc, split, stages,
                     fused_layout(t, wc, bits, n_lut, n_dsp, stages)[1],
                     split * fused_blocks(m, n_lut, n_dsp, t, wc))


def weight_bytes(k: int, bits: int, n_lut: int, n_dsp: int) -> int:
    """Bytes of the weight words the fused kernels read: ``bits`` planes
    of ``ref.kmajor_row_words(k, 32)`` words a LUT column, and
    ``ref.kmajor_row_words(k, 8)`` a DSP column."""
    return 4 * (bits * n_lut * ref.kmajor_row_words(k, ref.LUT_PER_WORD)
                + n_dsp * ref.kmajor_row_words(k, ref.DSP_PER_WORD))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_split(kernel, x, planes, packed, w_scale, bits, n_lut, n_dsp, k):
    """The depthwise kernel's operands: bit planes [bits, K, n_lut] and
    packed int4 pairs [K, ceil(n_dsp / 2)]."""
    dev = x.device
    check_operand(kernel, "planes", planes, torch.int8, (bits, k, n_lut), dev)
    check_operand(kernel, "packed", packed, torch.int8,
                  (k, (n_dsp + 1) // 2), dev)
    _check_sides(kernel, x, w_scale, bits, n_lut, n_dsp)


def _check_sides(kernel, x, w_scale, bits, n_lut, n_dsp):
    check_operand(kernel, "w_scale", w_scale, torch.float32,
                  (n_lut + n_dsp,), x.device)
    if n_lut + n_dsp == 0:
        raise ValueError(f"{kernel}: both split sides are empty")
    if n_lut and not 1 <= bits <= 8:
        raise ValueError(f"{kernel}: bits must be in 1..8, got {bits}")


def _check_words(kernel, x, lut_words, dsp_words, w_scale, bits, n_lut,
                 n_dsp, k):
    """The fused kernels' operands: the K-major words of both sides,
    16-byte aligned (the kernel's copies are 16-byte)."""
    dev = x.device
    check_operand(kernel, "lut_words", lut_words, torch.int32,
                  (bits, n_lut, ref.kmajor_row_words(k, ref.LUT_PER_WORD)),
                  dev)
    check_operand(kernel, "dsp_words", dsp_words, torch.int32,
                  (n_dsp, ref.kmajor_row_words(k, ref.DSP_PER_WORD)), dev)
    _check_sides(kernel, x, w_scale, bits, n_lut, n_dsp)
    for what, t in (("lut_words", lut_words), ("dsp_words", dsp_words)):
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {what} must be 16-byte aligned")


def fused_hetero_gemm_plain(x: torch.Tensor, lut_words: torch.Tensor,
                            dsp_words: torch.Tensor, w_scale: torch.Tensor,
                            bits: int, n_lut: int, n_dsp: int
                            ) -> torch.Tensor:
    """Plain version of :func:`fused_hetero_gemm` on the same prepared
    operands: the words unpacked (``ref.unpack_bits_kmajor`` /
    ``ref.unpack_int4_kmajor``), the two sides' exact int32 products side
    by side, then the per-column dequant."""
    k = x.shape[1]
    accs = []
    if n_lut:
        accs.append(ref.bitplane_dot(x, ref.unpack_bits_kmajor(lut_words,
                                                               k)))
    if n_dsp:
        accs.append(ref.exact_dot(x, ref.unpack_int4_kmajor(dsp_words, k)))
    return torch.cat(accs, dim=1).to(torch.float32) * w_scale[None, :]


def fused_hetero_gemm(x: torch.Tensor, lut_words: torch.Tensor,
                      dsp_words: torch.Tensor, w_scale: torch.Tensor,
                      bits: int, n_lut: int, n_dsp: int) -> torch.Tensor:
    """Single-launch split GEMM.

    x: [M, K] int8; lut_words: [bits, n_lut, ref.kmajor_row_words(K, 32)]
    int32 (``ref.pack_bits_kmajor`` of the ``bitplane_decompose``
    planes); dsp_words: [n_dsp, ref.kmajor_row_words(K, 8)] int32
    (``ref.pack_int4_kmajor`` of the codes); w_scale: [n_lut + n_dsp]
    fp32. Returns fp32 [M, n_lut + n_dsp] in split column order.
    """
    m, k = x.shape
    check_operand("fused_hetero_gemm", "x", x, torch.int8, (m, k), x.device)
    _check_words("fused_hetero_gemm", x, lut_words, dsp_words, w_scale, bits,
                 n_lut, n_dsp, k)
    if not x.is_cuda:
        return fused_hetero_gemm_plain(x, lut_words, dsp_words, w_scale,
                                       bits, n_lut, n_dsp)
    out = torch.empty((m, n_lut + n_dsp), dtype=torch.float32,
                      device=x.device)
    plan = fused_plan(m, k, n_lut, n_dsp, bits)
    launch("fused_hetero_gemm", x, x.data_ptr(), m, k, lut_words.data_ptr(),
           bits, n_lut, dsp_words.data_ptr(), n_dsp, w_scale.data_ptr(),
           out.data_ptr(), plan.t, plan.wc, plan.split, plan.stages)
    return out


def fused_conv_gemm_plain(x_sp, lut_words, dsp_words, w_scale, bits, n_lut,
                          n_dsp, kernel, stride, pad, out_hw):
    """Plain version of :func:`fused_conv_gemm`: im2col staging, then
    the dense plain split GEMM."""
    col = ref.conv_patches_ref(x_sp, kernel, stride, pad, out_hw)
    col = col.reshape(out_hw * out_hw, -1)
    return fused_hetero_gemm_plain(col, lut_words, dsp_words, w_scale, bits,
                                   n_lut, n_dsp)


def fused_conv_gemm(x_sp: torch.Tensor, lut_words: torch.Tensor,
                    dsp_words: torch.Tensor, w_scale: torch.Tensor, bits: int,
                    n_lut: int, n_dsp: int, kernel: int, stride: int,
                    pad: int, out_hw: int) -> torch.Tensor:
    """Single-launch im2col-free conv GEMM.

    x_sp: [H, W, C] int8 spatial activations, *unpadded* (the kernel
    supplies the zero padding); weights as :func:`fused_hetero_gemm`
    with K = ``kernel**2 * C`` rows in (kh, kw, c) order. Returns fp32
    [out_hw**2, n_lut + n_dsp] in split column order.
    """
    h, w, c = x_sp.shape
    k = kernel * kernel * c
    check_operand("fused_conv_gemm", "x_sp", x_sp, torch.int8, (h, w, c),
                  x_sp.device)
    _check_words("fused_conv_gemm", x_sp, lut_words, dsp_words, w_scale,
                 bits, n_lut, n_dsp, k)
    if (h + 2 * pad - kernel) // stride + 1 != out_hw or h != w:
        raise ValueError(f"fused_conv_gemm: [{h},{w}] input with kernel "
                         f"{kernel}, stride {stride}, pad {pad} does not "
                         f"give {out_hw}x{out_hw}")
    if not x_sp.is_cuda:
        return fused_conv_gemm_plain(x_sp, lut_words, dsp_words, w_scale,
                                     bits, n_lut, n_dsp, kernel, stride, pad,
                                     out_hw)
    out = torch.empty((out_hw * out_hw, n_lut + n_dsp), dtype=torch.float32,
                      device=x_sp.device)
    plan = fused_plan(out_hw * out_hw, k, n_lut, n_dsp, bits)
    launch("fused_conv_gemm", x_sp, x_sp.data_ptr(), h, w, c, kernel, stride,
           pad, out_hw, lut_words.data_ptr(), bits, n_lut,
           dsp_words.data_ptr(), n_dsp, w_scale.data_ptr(), out.data_ptr(),
           plan.t, plan.wc, plan.split, plan.stages)
    return out
