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

Both wrappers launch the CUDA kernels of ``csrc/split_gemm.cu`` on CUDA
tensors and compute the plain PyTorch version (``*_plain``) on CPU
tensors; nothing else chooses between the two. Weights arrive already
prepared (``ops.prepare_split``), so the executor prepares them once at
bind time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_gemm import bitserial_gemm_plain
from repro_torch.kernels.build import check_operand, launch
from repro_torch.kernels.int4_gemm import int4_gemm_plain


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
    operands: the two single-path plain versions side by side (the
    dequant is per output element, so fusing cannot change a bit)."""
    outs = []
    if n_lut:
        outs.append(bitserial_gemm_plain(x, planes, w_scale[:n_lut], bits))
    if n_dsp:
        outs.append(int4_gemm_plain(x, packed, w_scale[n_lut:], n_dsp))
    return torch.cat(outs, dim=1)


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
    launch("fused_hetero_gemm", x, x.data_ptr(), m, k, planes.data_ptr(),
           bits, n_lut, packed.data_ptr(), n_dsp, w_scale.data_ptr(),
           out.data_ptr())
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
    launch("fused_conv_gemm", x_sp, x_sp.data_ptr(), h, w, c, kernel, stride,
           pad, out_hw, planes.data_ptr(), bits, n_lut, packed.data_ptr(),
           n_dsp, w_scale.data_ptr(), out.data_ptr())
    return out
