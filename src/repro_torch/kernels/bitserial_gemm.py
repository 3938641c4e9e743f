"""Bitplane GEMM — the LUT-core side of the split on its own.

The paper's LUT core executes a ``w``-bit GEMM as a weighted sum of
binary GEMMs (Eq. 1), so its latency scales with the weight bit width.
The CUDA kernel (``csrc/split_gemm.cu``, entry ``bitserial_gemm``) keeps
that structure: one int8 tensor-core pass per bit plane into one int32
accumulator, the plane's bits spread to bytes in registers from the
bit-packed, K-major words of ``ref.pack_bits_kmajor``. It launches on
CUDA tensors; on CPU tensors the wrapper computes
:func:`bitserial_gemm_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch
from repro_torch.kernels.fused_hetero_gemm import split_plan


def bitserial_gemm_plain(x: torch.Tensor, lut_words: torch.Tensor,
                         w_scale: torch.Tensor, bits: int,
                         n: int) -> torch.Tensor:
    """Plain version of :func:`bitserial_gemm` on the same operands: the
    words unpacked to planes, then ``ref.bitserial_gemm_ref``'s sum."""
    planes = ref.unpack_bits_kmajor(lut_words, x.shape[1])
    return ref.bitplane_dot(x, planes).to(torch.float32) * w_scale[None, :]


def bitserial_gemm(x: torch.Tensor, lut_words: torch.Tensor,
                   w_scale: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """out[M, n] (fp32) = (x int8 @ reconstruct(planes)) * w_scale.

    x: [M, K] int8; lut_words: [bits, n, ref.kmajor_row_words(K, 32)]
    int32 (``ref.pack_bits_kmajor`` of the ``bitplane_decompose``
    planes); w_scale: [n] fp32.
    """
    m, k = x.shape
    dev = x.device
    check_operand("bitserial_gemm", "x", x, torch.int8, (m, k), dev)
    check_operand("bitserial_gemm", "lut_words", lut_words, torch.int32,
                  (bits, n, ref.kmajor_row_words(k, ref.LUT_PER_WORD)), dev)
    check_operand("bitserial_gemm", "w_scale", w_scale, torch.float32, (n,),
                  dev)
    if not 1 <= bits <= 8:
        raise ValueError(f"bitserial_gemm: bits must be in 1..8, got {bits}")
    if not x.is_cuda:
        return bitserial_gemm_plain(x, lut_words, w_scale, bits, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan = split_plan(m, k, n, 0)
    launch("bitserial_gemm", x, x.data_ptr(), m, k, lut_words.data_ptr(),
           bits, n, w_scale.data_ptr(), out.data_ptr(), plan.bm, plan.bn,
           plan.split)
    return out
