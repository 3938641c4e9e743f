"""Hand-written CUDA kernels for Hopper (``csrc/``), each with its
plain PyTorch version beside it.

  fused_hetero_gemm — both sides of the Eq.-12 split in ONE launch
                      (dense + im2col-free conv variants)
  bitserial_gemm    — bitplane GEMM (the LUT-core side; cost ∝ bits)
  int4_gemm         — packed-int4 GEMM (the DSP-core side)
  flash_attention   — online-softmax attention (the LM's prefill, every
                      attention of a train step), with its gradient
  flash_attention_bwd — the attention's backward (dq with delta, then dk/dv)
  build             — nvcc build, ctypes loader, launch counters
  ref               — plain versions of the reference's oracles
  ops               — public wrappers (weight preparation, dispatch)

On CUDA tensors a wrapper launches its kernel or raises; on CPU tensors
it computes the plain version. Nothing is built at import time.
"""
from repro_torch.kernels.ops import (
    SplitWeights,
    attention,
    bitserial_matmul,
    dsp_matmul,
    fused_conv_matmul,
    fused_matmul,
    hetero_matmul,
    int4_matmul,
    lut_matmul,
    prepare_split,
    split_conv_matmul,
    split_matmul,
)
from repro_torch.kernels.ref import (
    bitplane_decompose,
    bitplane_reconstruct,
    conv_patches_ref,
    flash_attention_ref,
    pack_int4,
    plane_scales,
    unpack_int4,
)

__all__ = [
    "SplitWeights", "attention", "bitserial_matmul", "dsp_matmul",
    "fused_conv_matmul", "fused_matmul", "hetero_matmul", "int4_matmul",
    "lut_matmul", "prepare_split", "split_conv_matmul", "split_matmul",
    "bitplane_decompose", "bitplane_reconstruct", "conv_patches_ref",
    "flash_attention_ref", "pack_int4", "plane_scales", "unpack_int4",
]
