"""Packed-int4 GEMM — the DSP-core side of the split on its own.

The paper's DSP core packs two int4 weights per multiplier; its latency
does not depend on the LUT side's bit width. The CUDA kernel
(``csrc/split_gemm.cu``, entry ``int4_gemm``) reads eight codes per
int32 word of ``ref.pack_int4_kmajor``'s K-major layout, spreads and
sign-extends them to bytes in registers and contracts them on the int8
tensor cores. It launches on CUDA tensors; on CPU tensors the wrapper
computes :func:`int4_gemm_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_operand, launch
from repro_torch.kernels.fused_hetero_gemm import split_plan


def int4_gemm_plain(x: torch.Tensor, dsp_words: torch.Tensor,
                    w_scale: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`int4_gemm` on the same operands."""
    acc = ref.exact_dot(x, ref.unpack_int4_kmajor(dsp_words, x.shape[1]))
    return acc.to(torch.float32) * w_scale[None, :]


def int4_gemm(x: torch.Tensor, dsp_words: torch.Tensor, w_scale: torch.Tensor,
              n: int) -> torch.Tensor:
    """out[M, n] (fp32) = (x int8 @ w) * w_scale, w the int4 codes.

    x: [M, K] int8; dsp_words: [n, ref.kmajor_row_words(K, 8)] int32
    (``ref.pack_int4_kmajor`` of the [K, n] codes); w_scale: [n] fp32.
    """
    m, k = x.shape
    dev = x.device
    check_operand("int4_gemm", "x", x, torch.int8, (m, k), dev)
    check_operand("int4_gemm", "dsp_words", dsp_words, torch.int32,
                  (n, ref.kmajor_row_words(k, ref.DSP_PER_WORD)), dev)
    check_operand("int4_gemm", "w_scale", w_scale, torch.float32, (n,), dev)
    if not x.is_cuda:
        return int4_gemm_plain(x, dsp_words, w_scale, n)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan = split_plan(m, k, 0, n)
    launch("int4_gemm", x, x.data_ptr(), m, k, dsp_words.data_ptr(), n,
           w_scale.data_ptr(), out.data_ptr(), plan.bm, plan.bn, plan.split)
    return out
