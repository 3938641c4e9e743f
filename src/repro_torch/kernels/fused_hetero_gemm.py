"""Fused split-aware whole-layer kernels: both sides of the Eq.-12
split in one launch.

``fused_hetero_gemm`` — [M, K] int8 activations against the LUT columns'
bit planes and the DSP columns' packed int4 bytes, one int32
accumulation and one fp32 per-column dequant; the output lands as one
[M, n_lut + n_dsp] tensor in split column order.

``fused_conv_gemm`` — the im2col-free conv variant: the kernel reads the
*unpadded* NHWC block and gathers the patches itself, so no column
matrix and no padded copy exist. Its CUDA form needs no VMEM budget and
no fallback: every resnet18 layer, ``conv1`` and ``fc`` included, takes
it.

Both wrappers launch the CUDA kernels of ``csrc/fused_split_gemm.cu``
(int8 tensor cores, a ``cp.async`` pipeline, split-K over a thread-block
cluster) on CUDA tensors and compute the plain PyTorch version
(``*_plain``) on CPU tensors; nothing else chooses between the two.
:func:`split_plan` picks each launch's tile and K split from the shape
alone; the single-path kernels (``csrc/split_gemm.cu``) take it on their
one-sided shape. Weights arrive already prepared (``ops.prepare_split``), so the
executor prepares them once at bind time.
"""
from __future__ import annotations

import typing

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch


#: K bytes per pipeline step of the CUDA kernel (``BK`` in the source)
BK = 64
#: the compiled (BM, BN) output tiles, in order of preference for M > 16
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


def k_slices(k: int, split: int) -> list[tuple[int, int]]:
    """The [begin, end) K range of each block of a cluster of ``split``:
    block r takes steps [r * steps // S, (r + 1) * steps // S) of
    :data:`BK`, as the kernel does."""
    steps = -(-k // BK)
    return [(r * steps // split * BK, min(k, (r + 1) * steps // split * BK))
            for r in range(split)]


def _check_split(kernel, x, planes, packed, w_scale, bits, n_lut, n_dsp, k):
    dev = x.device
    check_operand(kernel, "planes", planes, torch.int8, (bits, k, n_lut), dev)
    check_operand(kernel, "packed", packed, torch.int8,
                  (k, (n_dsp + 1) // 2), dev)
    check_operand(kernel, "w_scale", w_scale, torch.float32,
                  (n_lut + n_dsp,), dev)
    if n_lut + n_dsp == 0:
        raise ValueError(f"{kernel}: both split sides are empty")
    if n_lut and not 1 <= bits <= 8:
        raise ValueError(f"{kernel}: bits must be in 1..8, got {bits}")


def fused_hetero_gemm_plain(x: torch.Tensor, planes: torch.Tensor,
                            packed: torch.Tensor, w_scale: torch.Tensor,
                            bits: int, n_lut: int, n_dsp: int
                            ) -> torch.Tensor:
    """Plain version of :func:`fused_hetero_gemm` on the same prepared
    operands: the two sides' exact int32 products side by side, then the
    per-column dequant."""
    accs = []
    if n_lut:
        accs.append(ref.bitplane_dot(x, planes))
    if n_dsp:
        accs.append(ref.exact_dot(x, ref.unpack_int4(packed)[:, :n_dsp]))
    return torch.cat(accs, dim=1).to(torch.float32) * w_scale[None, :]


def fused_hetero_gemm(x: torch.Tensor, planes: torch.Tensor,
                      packed: torch.Tensor, w_scale: torch.Tensor, bits: int,
                      n_lut: int, n_dsp: int) -> torch.Tensor:
    """Single-launch split GEMM.

    x: [M, K] int8; planes: [bits, K, n_lut] int8 {0, 1}; packed:
    [K, ceil(n_dsp/2)] int8 ``ref.pack_int4`` bytes; w_scale:
    [n_lut + n_dsp] fp32. Returns fp32 [M, n_lut + n_dsp] in split
    column order.
    """
    m, k = x.shape
    check_operand("fused_hetero_gemm", "x", x, torch.int8, (m, k), x.device)
    _check_split("fused_hetero_gemm", x, planes, packed, w_scale, bits,
                 n_lut, n_dsp, k)
    if not x.is_cuda:
        return fused_hetero_gemm_plain(x, planes, packed, w_scale, bits,
                                       n_lut, n_dsp)
    out = torch.empty((m, n_lut + n_dsp), dtype=torch.float32,
                      device=x.device)
    plan = split_plan(m, k, n_lut, n_dsp)
    launch("fused_hetero_gemm", x, x.data_ptr(), m, k, planes.data_ptr(),
           bits, n_lut, packed.data_ptr(), n_dsp, w_scale.data_ptr(),
           out.data_ptr(), plan.bm, plan.bn, plan.split)
    return out


def fused_conv_gemm_plain(x_sp, planes, packed, w_scale, bits, n_lut, n_dsp,
                          kernel, stride, pad, out_hw):
    """Plain version of :func:`fused_conv_gemm`: im2col staging, then
    the dense plain split GEMM."""
    col = ref.conv_patches_ref(x_sp, kernel, stride, pad, out_hw)
    col = col.reshape(out_hw * out_hw, -1)
    return fused_hetero_gemm_plain(col, planes, packed, w_scale, bits, n_lut,
                                   n_dsp)


def fused_conv_gemm(x_sp: torch.Tensor, planes: torch.Tensor,
                    packed: torch.Tensor, w_scale: torch.Tensor, bits: int,
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
    _check_split("fused_conv_gemm", x_sp, planes, packed, w_scale, bits,
                 n_lut, n_dsp, k)
    if (h + 2 * pad - kernel) // stride + 1 != out_hw or h != w:
        raise ValueError(f"fused_conv_gemm: [{h},{w}] input with kernel "
                         f"{kernel}, stride {stride}, pad {pad} does not "
                         f"give {out_hw}x{out_hw}")
    if not x_sp.is_cuda:
        return fused_conv_gemm_plain(x_sp, planes, packed, w_scale, bits,
                                     n_lut, n_dsp, kernel, stride, pad,
                                     out_hw)
    out = torch.empty((out_hw * out_hw, n_lut + n_dsp), dtype=torch.float32,
                      device=x_sp.device)
    plan = split_plan(out_hw * out_hw, k, n_lut, n_dsp)
    launch("fused_conv_gemm", x_sp, x_sp.data_ptr(), h, w, c, kernel, stride,
           pad, out_hw, planes.data_ptr(), bits, n_lut, packed.data_ptr(),
           n_dsp, w_scale.data_ptr(), out.data_ptr(), plan.bm, plan.bn,
           plan.split)
    return out
