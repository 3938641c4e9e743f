"""Depthwise (grouped) split contraction: both sides of the Eq.-12
split of a depthwise layer in one launch.

Each output channel c contracts only its own K = kh*kw taps:
out[m, c] = (sum_k x[m, k, c] * w[k, c]) * scale[c], fp32 [M, N] in
split order. The first ``n_lut`` channels take the LUT core's bit-plane
sum (Eq. 1), the rest the DSP core's int4 codes; either side may be
empty. The reference runs this as an exact int32 einsum on every
backend (``repro.kernels.ops.fused_grouped_matmul``; no Pallas kernel);
here it is one CUDA kernel (``csrc/depthwise_gemm.cu``) with two ways
of addressing its input:

  * :func:`depthwise_conv_gemm` reads the *unpadded* NHWC block and
    gathers each pixel's taps itself, zero outside the image, so no
    im2col stack is staged on the main path;
  * :func:`grouped_gemm` reads a staged [M, K, N] stack (the staged
    path and the per-partition path).

Both launch the kernel on CUDA tensors and compute their plain PyTorch
version (``*_plain``, the ``ref`` oracles on the same prepared
operands) on CPU tensors; nothing else chooses between the two. The
weights are ``ops.SplitWeights``' planes and packed bytes, the layout
the fused dense kernels read. :func:`depthwise_plan` mirrors the launch
the C entry points choose (channels a thread, the block and the
grid), and :func:`folded_taps` the kernel's fold of a
LUT channel's planes into its signed taps; the tests hold both on the
CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch
from repro_torch.kernels.fused_hetero_gemm import _check_split

#: the most taps a channel's registers hold in the kernel (``MAX_K``)
MAX_TAPS = 32
#: the launch plan's constants, the source's (``csrc/depthwise_gemm.cu``)
DW_MAX_KSIZE = 5            # spatial kernel size, at most
DW_VEC = 4                  # channels a thread, where they fit
DW_MAX_THREADS = 128        # threads a block, at most
DW_SLOTS = 132              # blocks the grid aims at: one an SM
DW_TILE_PIX = 32            # pixels a block, preferred


class DepthwisePlan(NamedTuple):
    """One launch of ``csrc/depthwise_gemm.cu``: ``v`` channels a thread
    (one output pixel each), a block of (tv channel vectors, tw pixels of
    an output row, th rows; staged: the pixels one row), the grid over
    them, the block's dynamic shared memory in bytes, and the kernel
    instance (spatial, compiled taps (0: read at run time), v)."""
    v: int
    block: tuple[int, int, int]
    grid: tuple[int, int, int]
    smem: int
    instance: tuple[bool, int, int]


def depthwise_plan(m: int, k: int, n: int, spatial: bool, ksize: int = 0,
                   stride: int = 1, out_hw: int = 0, x_ptr: int = 0,
                   out_ptr: int = 0) -> DepthwisePlan:
    """What the C entry points launch for ``m`` outputs of ``k`` taps
    over ``n`` channels (the source's header says why): the spatial form
    (``depthwise_conv_gemm``: ``ksize`` x ``ksize`` at ``stride``,
    ``out_hw`` x ``out_hw`` outputs) or the staged one (``grouped_gemm``);
    ``x_ptr`` and ``out_ptr`` the input's and the output's addresses
    (their alignment bounds the vector width)."""
    fast = ksize == 3 if spatial else k == 9

    fits = n % DW_VEC == 0 and x_ptr % DW_VEC == 0 and out_ptr % 16 == 0
    v = DW_VEC if (fast or spatial) and fits and DW_VEC <= m else 1
    nv = n // v
    cols, rows = (out_hw, out_hw) if spatial else (m, 1)
    pix = cols * rows
    bt = DW_MAX_THREADS
    while True:
        cap = bt // min(pix, DW_TILE_PIX)
        tv = max([d for d in range(2, min(cap, nv) + 1) if nv % d == 0],
                 default=1)
        tp = min(bt // tv, pix)
        tw = min(tp, cols)
        th = min(tp // tw, rows)
        grid = (-(-nv // tv), -(-cols // tw), -(-rows // th))
        if grid[0] * grid[1] * grid[2] >= DW_SLOTS or bt == 32:
            break
        bt //= 2
    kh, kw = (ksize, ksize) if spatial else (k, 1)
    taps = (3 if spatial else 9) if fast else 0
    return DepthwisePlan(v, (tv, tw, th), grid,
                         -(-kh * kw * tv * v // 16) * 16, (spatial, taps, v))


def folded_taps(planes: torch.Tensor, packed: torch.Tensor, bits: int,
                n_lut: int, n_dsp: int) -> torch.Tensor:
    """The kernel's weights, int32 [K, N] in split order: a LUT channel's
    planes folded into its signed taps, sum_b s_b * plane_b (s_b = 2^b,
    the MSB plane -2^(bits-1)), then each DSP channel's sign-extended
    int4 code. The kernel's one sum of K products over these is the
    plain version's plane-by-plane sum, bit for bit: every term is an
    integer and |sum| < 2^31."""
    k = planes.shape[1]
    cols = []
    if n_lut:
        pl = (planes.to(torch.int32) & 1)
        s = torch.tensor([-(1 << b) if b == bits - 1 else 1 << b
                          for b in range(bits)], dtype=torch.int32)
        cols.append((pl * s[:, None, None]).sum(0, dtype=torch.int32))
    if n_dsp:
        cols.append(ref.unpack_int4(packed)[:, :n_dsp].to(torch.int32))
    return torch.cat(cols, dim=1) if cols else torch.zeros((k, 0),
                                                           dtype=torch.int32)


def _check_weights(kernel, x, k, planes, packed, w_scale, bits, n_lut,
                   n_dsp):
    """The dense kernels' weight checks, and the taps the kernel holds."""
    _check_split(kernel, x, planes, packed, w_scale, bits, n_lut, n_dsp, k)
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"{kernel}: {k} taps; the kernel takes 1..{MAX_TAPS}")


def grouped_gemm_plain(x_col: torch.Tensor, planes: torch.Tensor,
                       packed: torch.Tensor, w_scale: torch.Tensor,
                       bits: int, n_lut: int, n_dsp: int) -> torch.Tensor:
    """Plain version of :func:`grouped_gemm` on the same prepared
    operands: each side's exact int32 per-channel sums side by side
    (the LUT side plane by plane), then the per-channel dequant."""
    accs = []
    if n_lut:
        accs.append(ref.bitplane_grouped_dot(x_col[:, :, :n_lut], planes))
    if n_dsp:
        accs.append(ref.grouped_dot(x_col[:, :, n_lut:],
                                    ref.unpack_int4(packed)[:, :n_dsp]))
    return torch.cat(accs, dim=1).to(torch.float32) * w_scale[None, :]


def grouped_gemm(x_col: torch.Tensor, planes: torch.Tensor,
                 packed: torch.Tensor, w_scale: torch.Tensor, bits: int,
                 n_lut: int, n_dsp: int) -> torch.Tensor:
    """Single-launch grouped split contraction.

    x_col: [M, K, N] int8 per-channel im2col slices, N = n_lut + n_dsp
    in split order; planes: [bits, K, n_lut] int8 {0, 1}; packed:
    [K, ceil(n_dsp/2)] int8 ``ref.pack_int4`` bytes; w_scale: [N] fp32.
    Returns fp32 [M, N].
    """
    m, k, n = x_col.shape
    check_operand("grouped_gemm", "x_col", x_col, torch.int8,
                  (m, k, n_lut + n_dsp), x_col.device)
    _check_weights("grouped_gemm", x_col, k, planes, packed, w_scale, bits,
                   n_lut, n_dsp)
    if not x_col.is_cuda:
        return grouped_gemm_plain(x_col, planes, packed, w_scale, bits,
                                  n_lut, n_dsp)
    out = torch.empty((m, n), dtype=torch.float32, device=x_col.device)
    launch("grouped_gemm", x_col, x_col.data_ptr(), m, k, planes.data_ptr(),
           bits, n_lut, packed.data_ptr(), n_dsp, w_scale.data_ptr(),
           out.data_ptr())
    return out


def depthwise_conv_gemm_plain(x_sp, planes, packed, w_scale, bits, n_lut,
                              n_dsp, kernel, stride, pad, out_hw):
    """Plain version of :func:`depthwise_conv_gemm`: the im2col stack,
    then :func:`grouped_gemm_plain`."""
    col = ref.conv_patches_ref(x_sp, kernel, stride, pad, out_hw)
    return grouped_gemm_plain(col, planes, packed, w_scale, bits, n_lut,
                              n_dsp)


def depthwise_conv_gemm(x_sp: torch.Tensor, planes: torch.Tensor,
                        packed: torch.Tensor, w_scale: torch.Tensor,
                        bits: int, n_lut: int, n_dsp: int, kernel: int,
                        stride: int, pad: int, out_hw: int) -> torch.Tensor:
    """Single-launch im2col-free depthwise conv.

    x_sp: [H, W, C] int8 spatial activations, *unpadded* (the kernel
    supplies the zero padding), C = n_lut + n_dsp; weights as
    :func:`grouped_gemm` with K = ``kernel**2`` taps in (kh, kw) order.
    Returns fp32 [out_hw**2, C].
    """
    h, w, c = x_sp.shape
    check_operand("depthwise_conv_gemm", "x_sp", x_sp, torch.int8,
                  (h, w, n_lut + n_dsp), x_sp.device)
    _check_weights("depthwise_conv_gemm", x_sp, kernel * kernel, planes,
                   packed, w_scale, bits, n_lut, n_dsp)
    if (h + 2 * pad - kernel) // stride + 1 != out_hw or h != w:
        raise ValueError(f"depthwise_conv_gemm: [{h},{w}] input with kernel "
                         f"{kernel}, stride {stride}, pad {pad} does not "
                         f"give {out_hw}x{out_hw}")
    if not x_sp.is_cuda:
        return depthwise_conv_gemm_plain(x_sp, planes, packed, w_scale, bits,
                                         n_lut, n_dsp, kernel, stride, pad,
                                         out_hw)
    out = torch.empty((out_hw * out_hw, c), dtype=torch.float32,
                      device=x_sp.device)
    launch("depthwise_conv_gemm", x_sp, x_sp.data_ptr(), h, w, c, kernel,
           stride, pad, out_hw, planes.data_ptr(), bits, n_lut,
           packed.data_ptr(), n_dsp, w_scale.data_ptr(), out.data_ptr())
    return out
