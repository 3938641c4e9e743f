"""Public wrappers around the split-GEMM kernels, the depthwise kernel
and flash attention.

Two layers of entry points:

  * on *prepared* split weights (:class:`SplitWeights`, made once by
    :func:`prepare_split`): :func:`split_matmul`,
    :func:`split_conv_matmul`, :func:`lut_matmul`, :func:`dsp_matmul`,
    and for depthwise layers :func:`split_grouped_matmul`,
    :func:`split_depthwise_matmul`, :func:`lut_grouped_matmul`,
    :func:`dsp_grouped_matmul` — what the executor calls on every layer;
  * on weight *codes*, the counterparts of ``repro.kernels.ops``:
    :func:`bitserial_matmul`, :func:`int4_matmul`, :func:`fused_matmul`,
    :func:`fused_conv_matmul`, :func:`hetero_matmul`,
    :func:`bitserial_grouped_matmul`, :func:`int4_grouped_matmul`,
    :func:`fused_grouped_matmul`, :func:`fused_depthwise_matmul` — these
    prepare the weights on every call, as the reference's wrappers do.

``mode`` is ``"auto"`` (the kernel wrapper: the CUDA kernel on CUDA
tensors, its plain version on CPU tensors) or ``"ref"`` (plain PyTorch
on any device: the plain versions on prepared weights, the ported
oracles of ``ref.py`` on codes). Unlike the reference there is no
padding to block multiples and no splicing: the kernels mask ragged
extents and write the DSP columns at offset ``n_lut`` themselves.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_gemm import bitserial_gemm, \
    bitserial_gemm_plain
from repro_torch.kernels.depthwise_gemm import depthwise_conv_gemm, \
    depthwise_conv_gemm_plain, grouped_gemm, grouped_gemm_plain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_hetero_gemm import fused_conv_gemm, \
    fused_conv_gemm_plain, fused_hetero_gemm, fused_hetero_gemm_plain
from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain

MODES = ("auto", "ref")


def _plain(mode: str) -> bool:
    """Whether ``mode`` asks for plain PyTorch rather than the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return mode == "ref"


def _pick(kernel, plain, mode: str):
    return plain if _plain(mode) else kernel


@dataclasses.dataclass(frozen=True)
class SplitWeights:
    """One layer's split weights in the kernels' layouts, on one device.

    What the depthwise kernel reads:
      planes: [bits, K, n_lut] int8 bit planes of the LUT columns;
      packed: [K, ceil(n_dsp/2)] int8 int4 pairs of the DSP columns.
    What the fused and the single-path split-GEMM kernels read, K-major
    (``ref.pack_*_kmajor``), each row zero-padded to a multiple of 16
    bytes so that it starts 16-byte aligned at any column count (a zero
    bit or code adds 0 to every plane):
      lut_words: [bits, n_lut, ceil(K/128)*4] int32, bit k % 32 of word
        k // 32 of row (b, n) is plane b's bit of weight (k, n);
      dsp_words: [n_dsp, ceil(K/32)*4] int32, nibble k % 8 of word k // 8
        of row n is the two's-complement code (k, n), lowest first.
    scale: [n_lut + n_dsp] fp32 per-column scales in split order.
    """
    planes: torch.Tensor
    packed: torch.Tensor
    lut_words: torch.Tensor
    dsp_words: torch.Tensor
    scale: torch.Tensor
    bits: int
    n_lut: int
    n_dsp: int

    @property
    def s_lut(self) -> torch.Tensor:
        return self.scale[:self.n_lut]

    @property
    def s_dsp(self) -> torch.Tensor:
        return self.scale[self.n_lut:]


def prepare_split(k: int, w_lut: torch.Tensor | None,
                  s_lut: torch.Tensor | None, bits: int,
                  w_dsp: torch.Tensor | None, s_dsp: torch.Tensor | None,
                  device: torch.device) -> SplitWeights:
    """Bit planes, packed bytes, their K-major words and split-order
    scales from [K, n] weight codes (an absent side is None or has 0
    columns), made once, on ``device``."""
    n_lut = 0 if w_lut is None else w_lut.shape[1]
    n_dsp = 0 if w_dsp is None else w_dsp.shape[1]
    if n_lut + n_dsp == 0:
        raise ValueError("both split sides are empty")
    w_lut = torch.zeros((k, 0), dtype=torch.int32, device=device) \
        if w_lut is None else w_lut.to(device, torch.int32)
    w_dsp = torch.zeros((k, 0), dtype=torch.int32, device=device) \
        if w_dsp is None else w_dsp.to(device, torch.int32)
    planes = ref.bitplane_decompose(w_lut, bits)
    packed = ref.pack_int4(F.pad(w_dsp, (0, n_dsp % 2)))
    scales = [s.to(device, torch.float32).reshape(-1)
              for s, n in ((s_lut, n_lut), (s_dsp, n_dsp)) if n]
    return SplitWeights(planes.contiguous(), packed.contiguous(),
                        ref.pack_bits_kmajor(planes).contiguous(),
                        ref.pack_int4_kmajor(w_dsp).contiguous(),
                        torch.cat(scales).contiguous(), bits, n_lut, n_dsp)


# ---------------------------------------------------------------------------
# On prepared weights
# ---------------------------------------------------------------------------


def lut_matmul(x_q: torch.Tensor, sw: SplitWeights, *,
               mode: str = "auto") -> torch.Tensor:
    """The LUT partition alone: [M, K] int8 -> fp32 [M, n_lut]."""
    fn = _pick(bitserial_gemm, bitserial_gemm_plain, mode)
    return fn(x_q, sw.lut_words, sw.s_lut, sw.bits, sw.n_lut)


def dsp_matmul(x_q: torch.Tensor, sw: SplitWeights, *,
               mode: str = "auto") -> torch.Tensor:
    """The DSP partition alone: [M, K] int8 -> fp32 [M, n_dsp]."""
    fn = _pick(int4_gemm, int4_gemm_plain, mode)
    return fn(x_q, sw.dsp_words, sw.s_dsp, sw.n_dsp)


def split_matmul(x_q: torch.Tensor, sw: SplitWeights, *,
                 mode: str = "auto") -> torch.Tensor:
    """Both sides of the split in one launch: [M, K] int8 -> fp32
    [M, n_lut + n_dsp] in split column order. A one-sided split takes
    the matching single-path kernel, as the reference does."""
    if sw.n_lut == 0:
        return dsp_matmul(x_q, sw, mode=mode)
    if sw.n_dsp == 0:
        return lut_matmul(x_q, sw, mode=mode)
    fn = _pick(fused_hetero_gemm, fused_hetero_gemm_plain, mode)
    return fn(x_q, sw.lut_words, sw.dsp_words, sw.scale, sw.bits, sw.n_lut,
              sw.n_dsp)


def split_conv_matmul(x_sp: torch.Tensor, kernel: int, stride: int, pad: int,
                      out_hw: int, sw: SplitWeights, *,
                      mode: str = "auto") -> torch.Tensor:
    """Im2col-free conv GEMM from the unpadded [H, W, C] int8 block in
    one launch, one-sided splits included: fp32 [out_hw**2, n]."""
    fn = _pick(fused_conv_gemm, fused_conv_gemm_plain, mode)
    return fn(x_sp, sw.lut_words, sw.dsp_words, sw.scale, sw.bits, sw.n_lut,
              sw.n_dsp, kernel, stride, pad, out_hw)


def split_grouped_matmul(x_col: torch.Tensor, sw: SplitWeights, *,
                         mode: str = "auto") -> torch.Tensor:
    """Depthwise layer, both sides in one launch: staged [M, K, N] int8
    per-channel slices -> fp32 [M, N] in split order."""
    fn = _pick(grouped_gemm, grouped_gemm_plain, mode)
    return fn(x_col, sw.planes, sw.packed, sw.scale, sw.bits, sw.n_lut,
              sw.n_dsp)


def split_depthwise_matmul(x_sp: torch.Tensor, kernel: int, stride: int,
                           pad: int, out_hw: int, sw: SplitWeights, *,
                           mode: str = "auto") -> torch.Tensor:
    """Im2col-free depthwise conv from the unpadded [H, W, C] int8 block
    in one launch, one-sided splits included: fp32 [out_hw**2, C]."""
    fn = _pick(depthwise_conv_gemm, depthwise_conv_gemm_plain, mode)
    return fn(x_sp, sw.planes, sw.packed, sw.scale, sw.bits, sw.n_lut,
              sw.n_dsp, kernel, stride, pad, out_hw)


def lut_grouped_matmul(x_col: torch.Tensor, sw: SplitWeights, *,
                       mode: str = "auto") -> torch.Tensor:
    """The LUT partition of a depthwise layer alone: its channels'
    [M, K, n_lut] slices (copied contiguous if a view) -> fp32
    [M, n_lut]."""
    fn = _pick(grouped_gemm, grouped_gemm_plain, mode)
    return fn(x_col.contiguous(), sw.planes, sw.packed[:, :0], sw.s_lut,
              sw.bits, sw.n_lut, 0)


def dsp_grouped_matmul(x_col: torch.Tensor, sw: SplitWeights, *,
                       mode: str = "auto") -> torch.Tensor:
    """The DSP partition of a depthwise layer alone: its channels'
    [M, K, n_dsp] slices (copied contiguous if a view) -> fp32
    [M, n_dsp]."""
    fn = _pick(grouped_gemm, grouped_gemm_plain, mode)
    return fn(x_col.contiguous(), sw.planes[:, :, :0], sw.packed, sw.s_dsp,
              sw.bits, 0, sw.n_dsp)


# ---------------------------------------------------------------------------
# On weight codes (the reference's public surface)
# ---------------------------------------------------------------------------


def bitserial_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                     w_scale: torch.Tensor, bits: int, *,
                     mode: str = "auto") -> torch.Tensor:
    """Bitplane-path GEMM: x_q [M, K] int8; w_q [K, N] codes within
    ``bits`` bits; w_scale [N] fp32."""
    if _plain(mode):
        return ref.bitserial_gemm_ref(x_q, w_q, w_scale, bits)
    sw = prepare_split(w_q.shape[0], w_q, w_scale, bits, None, None,
                       x_q.device)
    return lut_matmul(x_q, sw)


def int4_matmul(x_q: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                *, mode: str = "auto") -> torch.Tensor:
    """Packed-int4-path GEMM: x_q [M, K] int8; w_q [K, N] codes in
    [-8, 7]; w_scale [N] fp32."""
    if _plain(mode):
        n = w_q.shape[1]
        packed = ref.pack_int4(F.pad(w_q.to(torch.int32), (0, n % 2)))
        return ref.int4_gemm_ref(x_q, packed,
                                 F.pad(w_scale, (0, n % 2)))[:, :n]
    sw = prepare_split(w_q.shape[0], None, None, 0, w_q, w_scale, x_q.device)
    return dsp_matmul(x_q, sw)


def _norm_side(w_q, w_scale):
    """An absent split side may arrive as None or as a 0-column array."""
    if w_q is None or w_q.shape[-1] == 0:
        return None, None
    return w_q, w_scale


def fused_matmul(x_q: torch.Tensor, w_lut: torch.Tensor | None,
                 s_lut: torch.Tensor | None, bits: int,
                 w_dsp: torch.Tensor | None, s_dsp: torch.Tensor | None, *,
                 mode: str = "auto") -> torch.Tensor:
    """Fused split GEMM — both sides of the Eq.-12 split in ONE launch.
    Returns fp32 [M, n_lut + n_dsp] in split column order."""
    w_lut, s_lut = _norm_side(w_lut, s_lut)
    w_dsp, s_dsp = _norm_side(w_dsp, s_dsp)
    if w_lut is None and w_dsp is None:
        raise ValueError("fused_matmul: both split sides are empty")
    if _plain(mode):
        return ref.fused_hetero_gemm_ref(x_q, w_lut, s_lut, bits, w_dsp,
                                         s_dsp)
    sw = prepare_split(x_q.shape[1], w_lut, s_lut, bits, w_dsp, s_dsp,
                       x_q.device)
    return split_matmul(x_q, sw)


def fused_conv_matmul(x_sp: torch.Tensor, kernel: int, stride: int, pad: int,
                      out_hw: int, w_lut: torch.Tensor | None,
                      s_lut: torch.Tensor | None, bits: int,
                      w_dsp: torch.Tensor | None, s_dsp: torch.Tensor | None,
                      *, mode: str = "auto") -> torch.Tensor:
    """Fused im2col-free conv GEMM from the *unpadded* [H, W, C] int8
    block; weights as :func:`fused_matmul` with K = ``kernel**2 * C``
    rows in (kh, kw, c) order."""
    w_lut, s_lut = _norm_side(w_lut, s_lut)
    w_dsp, s_dsp = _norm_side(w_dsp, s_dsp)
    if w_lut is None and w_dsp is None:
        raise ValueError("fused_conv_matmul: both split sides are empty")
    k = kernel * kernel * x_sp.shape[2]
    if _plain(mode):
        x_col = ref.conv_patches_ref(x_sp, kernel, stride, pad, out_hw)
        return ref.fused_hetero_gemm_ref(x_col.reshape(out_hw * out_hw, k),
                                         w_lut, s_lut, bits, w_dsp, s_dsp)
    sw = prepare_split(k, w_lut, s_lut, bits, w_dsp, s_dsp, x_sp.device)
    return split_conv_matmul(x_sp, kernel, stride, pad, out_hw, sw)


def hetero_matmul(x_q: torch.Tensor, w_q_serial: torch.Tensor,
                  s_serial: torch.Tensor, bits_serial: int,
                  w_q_parallel: torch.Tensor, s_parallel: torch.Tensor, *,
                  mode: str = "auto") -> torch.Tensor:
    """The paper's split GEMM: serial-path columns then int4 columns,
    one launch per side."""
    outs = []
    if w_q_serial.shape[1]:
        outs.append(bitserial_matmul(x_q, w_q_serial, s_serial, bits_serial,
                                     mode=mode))
    if w_q_parallel.shape[1]:
        outs.append(int4_matmul(x_q, w_q_parallel, s_parallel, mode=mode))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def bitserial_grouped_matmul(x_col: torch.Tensor, w_q: torch.Tensor,
                             w_scale: torch.Tensor, bits: int, *,
                             mode: str = "auto") -> torch.Tensor:
    """Depthwise (grouped) bitplane GEMM: each output channel contracts
    only its own [M, K] slice of ``x_col`` [M, K, N]; w_q [K, N] codes
    within ``bits`` bits; w_scale [N] fp32."""
    if _plain(mode):
        return ref.bitserial_grouped_gemm_ref(x_col, w_q, w_scale, bits)
    sw = prepare_split(w_q.shape[0], w_q, w_scale, bits, None, None,
                       x_col.device)
    return lut_grouped_matmul(x_col, sw)


def int4_grouped_matmul(x_col: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor, *,
                        mode: str = "auto") -> torch.Tensor:
    """Depthwise (grouped) int4 GEMM over per-channel slices: w_q
    [K, N] codes in [-8, 7]."""
    if _plain(mode):
        return ref.int4_grouped_gemm_ref(x_col, w_q, w_scale)
    sw = prepare_split(w_q.shape[0], None, None, 0, w_q, w_scale,
                       x_col.device)
    return dsp_grouped_matmul(x_col, sw)


def fused_grouped_matmul(x_col: torch.Tensor, w_lut: torch.Tensor | None,
                         s_lut: torch.Tensor | None, bits: int,
                         w_dsp: torch.Tensor | None,
                         s_dsp: torch.Tensor | None, *,
                         mode: str = "auto") -> torch.Tensor:
    """Fused depthwise split GEMM over per-channel im2col slices:
    x_col [M, K, N] over *all* N channels in split order; the first
    n_lut channels contract bit-serially, the rest as int4, in ONE
    launch."""
    w_lut, s_lut = _norm_side(w_lut, s_lut)
    w_dsp, s_dsp = _norm_side(w_dsp, s_dsp)
    if w_lut is None and w_dsp is None:
        raise ValueError("fused_grouped_matmul: both split sides are empty")
    if _plain(mode):
        return ref.fused_hetero_grouped_gemm_ref(x_col, w_lut, s_lut, bits,
                                                 w_dsp, s_dsp)
    sw = prepare_split(x_col.shape[1], w_lut, s_lut, bits, w_dsp, s_dsp,
                       x_col.device)
    return split_grouped_matmul(x_col, sw)


def fused_depthwise_matmul(x_sp: torch.Tensor, kernel: int, stride: int,
                           pad: int, out_hw: int,
                           w_lut: torch.Tensor | None,
                           s_lut: torch.Tensor | None, bits: int,
                           w_dsp: torch.Tensor | None,
                           s_dsp: torch.Tensor | None, *,
                           mode: str = "auto") -> torch.Tensor:
    """Fused depthwise conv from the *unpadded* [H, W, C] int8 block;
    weights as :func:`fused_grouped_matmul` with K = ``kernel**2`` taps
    in (kh, kw) order."""
    w_lut, s_lut = _norm_side(w_lut, s_lut)
    w_dsp, s_dsp = _norm_side(w_dsp, s_dsp)
    if w_lut is None and w_dsp is None:
        raise ValueError("fused_depthwise_matmul: both split sides are "
                         "empty")
    if _plain(mode):
        x_col = ref.conv_patches_ref(x_sp, kernel, stride, pad, out_hw)
        return ref.fused_hetero_grouped_gemm_ref(x_col, w_lut, s_lut, bits,
                                                 w_dsp, s_dsp)
    sw = prepare_split(kernel * kernel, w_lut, s_lut, bits, w_dsp, s_dsp,
                       x_sp.device)
    return split_depthwise_matmul(x_sp, kernel, stride, pad, out_hw, sw)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kv_offset: int = 0,
              mode: str = "auto") -> torch.Tensor:
    """Flash attention with grouped-query heads.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D] with Hq % Hkv == 0.
    ``"auto"`` is the flash kernel (its plain version on CPU tensors),
    which maps query head h to KV head h // (Hq // Hkv) and reads the
    [B, H, S, D] tensors through strides; ``"ref"`` is the plain softmax
    oracle on the KV heads repeated, as the reference computes it.
    """
    if _plain(mode):
        rep = q.shape[1] // k.shape[1]
        return ref.flash_attention_ref(q, k.repeat_interleave(rep, dim=1),
                                       v.repeat_interleave(rep, dim=1),
                                       causal=causal, kv_offset=kv_offset)
    return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           kv_offset=kv_offset).transpose(1, 2)
