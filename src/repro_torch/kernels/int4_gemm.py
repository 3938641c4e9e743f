"""Packed-int4 GEMM — the DSP-core side of the split on its own.

The paper's DSP core packs two int4 weights per multiplier; its latency
does not depend on the LUT side's bit width. The CUDA kernel
(``csrc/split_gemm.cu``, entry ``int4_gemm``) reads two codes per byte,
sign-extends the nibbles in registers and contracts with ``__dp4a``.
It launches on CUDA tensors; on CPU tensors the wrapper computes
:func:`int4_gemm_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch


def int4_gemm_plain(x: torch.Tensor, packed: torch.Tensor,
                    w_scale: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`int4_gemm` on the same operands."""
    acc = ref.exact_dot(x, ref.unpack_int4(packed)[:, :n])
    return acc.to(torch.float32) * w_scale[None, :]


def int4_gemm(x: torch.Tensor, packed: torch.Tensor, w_scale: torch.Tensor,
              n: int) -> torch.Tensor:
    """out[M, n] (fp32) = (x int8 @ unpack_int4(packed)[:, :n]) * w_scale.

    x: [M, K] int8; packed: [K, ceil(n/2)] int8 (``ref.pack_int4``
    layout, an odd ``n`` padded by one code); w_scale: [n] fp32.
    """
    m, k = x.shape
    dev = x.device
    check_operand("int4_gemm", "x", x, torch.int8, (m, k), dev)
    check_operand("int4_gemm", "packed", packed, torch.int8,
                  (k, (n + 1) // 2), dev)
    check_operand("int4_gemm", "w_scale", w_scale, torch.float32, (n,), dev)
    if not x.is_cuda:
        return int4_gemm_plain(x, packed, w_scale, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    launch("int4_gemm", x, x.data_ptr(), m, k, packed.data_ptr(), n,
           w_scale.data_ptr(), out.data_ptr())
    return out
