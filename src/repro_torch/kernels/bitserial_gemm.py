"""Bitplane GEMM — the LUT-core side of the split on its own.

The paper's LUT core executes a ``w``-bit GEMM as a weighted sum of
binary GEMMs (Eq. 1), so its latency scales with the weight bit width.
The CUDA kernel (``csrc/split_gemm.cu``, entry ``bitserial_gemm``) keeps
that structure: one ``__dp4a`` pass per bit plane, shifted partial sums
in an int32 accumulator. It launches on CUDA tensors; on CPU tensors the
wrapper computes :func:`bitserial_gemm_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch


def bitserial_gemm_plain(x: torch.Tensor, planes: torch.Tensor,
                         w_scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of :func:`bitserial_gemm` on the same operands."""
    acc = torch.zeros((x.shape[0], planes.shape[2]), dtype=torch.int32,
                      device=x.device)
    for b, s in enumerate(ref.plane_scales(bits)):
        acc = acc + s * ref.exact_dot(x, planes[b])
    return acc.to(torch.float32) * w_scale[None, :]


def bitserial_gemm(x: torch.Tensor, planes: torch.Tensor,
                   w_scale: torch.Tensor, bits: int) -> torch.Tensor:
    """out[M, N] (fp32) = (x int8 @ reconstruct(planes)) * w_scale.

    x: [M, K] int8; planes: [bits, K, N] int8 in {0, 1}
    (``ref.bitplane_decompose`` layout); w_scale: [N] fp32.
    """
    m, k = x.shape
    n = planes.shape[2]
    dev = x.device
    check_operand("bitserial_gemm", "x", x, torch.int8, (m, k), dev)
    check_operand("bitserial_gemm", "planes", planes, torch.int8,
                  (bits, k, n), dev)
    check_operand("bitserial_gemm", "w_scale", w_scale, torch.float32, (n,),
                  dev)
    if not 1 <= bits <= 8:
        raise ValueError(f"bitserial_gemm: bits must be in 1..8, got {bits}")
    if not x.is_cuda:
        return bitserial_gemm_plain(x, planes, w_scale, bits)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch("bitserial_gemm", x, x.data_ptr(), m, k, planes.data_ptr(), bits,
           n, w_scale.data_ptr(), out.data_ptr())
    return out
