"""Plain PyTorch versions of the split-GEMM kernels, of the grouped
(depthwise) contraction, and the plain softmax attention oracle.

The counterparts of ``repro.kernels.ref``'s oracles, bit for bit. They
run on any device: the CPU tests call them, and on the card they are
what each CUDA kernel is held against.

Integer products contract in float64 and are cast back to int32. That
is exact here: activations are int8 (|x| <= 128), a weight is a bit
plane in {0, 1} or an int4 code (|w| <= 8) or at most an 8-bit code
(|w| <= 128), and K <= 4608, so every partial sum is an integer below
2^27, far inside float64's 2^53. CUDA has no int32 matmul, and DGEMM is
exact on these inputs, so the same code is right on the CPU and on the
card. The grouped (depthwise) oracles contract only K = kh*kw taps per
channel: an elementwise int32 product and an int32 sum over the taps,
exact on any device. The fp32 dequant is then one elementwise multiply,
the same op the kernels and the reference apply.

Also hosts the representation helpers shared by the plain versions and
the kernels' weight preparation:

  * ``bitplane_decompose`` — paper Eq. (1): a ``bits``-bit signed
    integer tensor becomes ``bits`` binary planes with per-plane signed
    weights (two's complement: MSB plane weight is -2^(bits-1)).
  * ``pack_int4`` / ``unpack_int4`` — two int4 codes per int8 byte
    along the last axis, even index in the low nibble (the reference's
    layout, which the fused kernels read).
  * ``pack_bits_kmajor`` / ``pack_int4_kmajor`` and their inverses — the
    port's private K-major words that the single-path kernels read: 32
    plane bits or 8 int4 codes of one column per int32 word, rows padded
    to 16 bytes (:func:`kmajor_row_words`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Representation helpers
# ---------------------------------------------------------------------------


def plane_scales(bits: int) -> list[int]:
    """Signed per-plane weights of a two's-complement decomposition."""
    return [2 ** b for b in range(bits - 1)] + [-(2 ** (bits - 1))]


def bitplane_decompose(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed integer codes -> ``[bits, ...]`` binary planes (int8 0/1).

    Reconstruction: ``q == sum_b plane_scales(bits)[b] * planes[b]``.
    """
    u = q.to(torch.int32) & ((1 << bits) - 1)  # two's complement bits
    shifts = torch.arange(bits, dtype=torch.int32, device=q.device)
    shifts = shifts.reshape((bits,) + (1,) * q.ndim)
    return ((u.unsqueeze(0) >> shifts) & 1).to(torch.int8)


def bitplane_reconstruct(planes: torch.Tensor) -> torch.Tensor:
    bits = planes.shape[0]
    s = torch.tensor(plane_scales(bits), dtype=torch.int32,
                     device=planes.device)
    s = s.reshape((bits,) + (1,) * (planes.ndim - 1))
    return torch.sum(planes.to(torch.int32) * s, dim=0, dtype=torch.int32)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 codes pairwise along the last axis: [..., N] ->
    [..., N//2] int8 with even index in the low nibble."""
    if q.shape[-1] % 2 != 0:
        raise ValueError("last axis must be even to pack int4 pairs")
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = q[..., 1::2].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4`` (sign-extended in int32)."""
    b = p.to(torch.int32)
    lo = (b << 28) >> 28                    # arithmetic shift sign-extends
    hi = b >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2).to(torch.int8)


#: values per int32 word of the K-major layouts: plane bits, int4 codes
LUT_PER_WORD, DSP_PER_WORD = 32, 8


def kmajor_row_words(k: int, per_word: int) -> int:
    """Words of one K-major weight row: ``k`` values, ``per_word`` to a
    word, zero-padded to a multiple of 4 words (16 bytes), so that every
    row starts 16-byte aligned for the kernels' ``cp.async`` copies."""
    return -(-k // (4 * per_word)) * 4


def _to_words(vals: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """[..., k] unsigned ``width``-bit values -> [..., row words] int32,
    value i of a word at bits [width*i, width*(i+1)), padding zero."""
    per_word = 32 // width
    kw = kmajor_row_words(k, per_word)
    v = F.pad(vals.to(torch.int64), (0, kw * per_word - k))
    v = v.reshape(*vals.shape[:-1], kw, per_word)
    shifts = width * torch.arange(per_word, dtype=torch.int64,
                                  device=vals.device)
    w = torch.sum(v << shifts, dim=-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)  # two's complement


def _from_words(words: torch.Tensor, width: int, k: int) -> torch.Tensor:
    """Inverse of :func:`_to_words`: [..., row words] -> [..., k] int64."""
    per_word = 32 // width
    shifts = width * torch.arange(per_word, dtype=torch.int64,
                                  device=words.device)
    v = (words.to(torch.int64).unsqueeze(-1) >> shifts) & ((1 << width) - 1)
    return v.reshape(*words.shape[:-1], words.shape[-1] * per_word)[..., :k]


def pack_bits_kmajor(planes: torch.Tensor) -> torch.Tensor:
    """[bits, K, N] 0/1 planes -> [bits, N, kmajor_row_words(K, 32)]
    int32: bit k % 32 of word k // 32 of row (b, n) is planes[b, k, n];
    the row's padding bits are zero."""
    return _to_words(planes.transpose(1, 2), 1, planes.shape[1])


def unpack_bits_kmajor(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_kmajor`: [bits, K, N] int8 in {0, 1}."""
    return _from_words(words, 1, k).transpose(1, 2).to(torch.int8)


def pack_int4_kmajor(q: torch.Tensor) -> torch.Tensor:
    """[K, N] int4 codes in [-8, 7] -> [N, kmajor_row_words(K, 8)] int32:
    nibble k % 8 of word k // 8 of row n is code (k, n) in two's
    complement, lowest nibble first; the row's padding codes are zero."""
    return _to_words(q.t().to(torch.int64) & 0xF, 4, q.shape[0])


def unpack_int4_kmajor(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4_kmajor`: [K, N] int8 codes."""
    return ((_from_words(words, 4, k) ^ 8) - 8).t().to(torch.int8)


def exact_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 [M, K] and small-integer [K, N]
    through float64 (see the module docstring), as int32."""
    return (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int32)


def bitplane_dot(x: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Exact int32 sum_b s_b * (x @ planes[b]) of int8 [M, K] and
    [bits, K, N] 0/1 planes (paper Eq. 1)."""
    acc = torch.zeros((x.shape[0], planes.shape[2]), dtype=torch.int32,
                      device=x.device)
    for b, s in enumerate(plane_scales(planes.shape[0])):
        acc = acc + s * exact_dot(x, planes[b])
    return acc


def grouped_dot(x_col: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int32 per-channel contraction of int8 [M, K, N] and
    small-integer [K, N]: out[m, c] = sum_k x_col[m, k, c] * w[k, c].

    An elementwise int32 product and a sum over the K taps, which is
    exact on every device (|x| <= 128, |w| <= 128 and K = kh*kw taps
    keep every sum far below 2^31); no matmul, so no float path."""
    prod = x_col.to(torch.int32) * w.to(torch.int32).unsqueeze(0)
    return torch.sum(prod, dim=1, dtype=torch.int32)


def bitplane_grouped_dot(x_col: torch.Tensor,
                         planes: torch.Tensor) -> torch.Tensor:
    """Exact int32 sum_b s_b * grouped_dot(x_col, planes[b]) of int8
    [M, K, N] and [bits, K, N] 0/1 planes (Eq. 1, per channel)."""
    acc = torch.zeros((x_col.shape[0], planes.shape[2]), dtype=torch.int32,
                      device=x_col.device)
    for b, s in enumerate(plane_scales(planes.shape[0])):
        acc = acc + s * grouped_dot(x_col, planes[b])
    return acc


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def bitserial_gemm_ref(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Bitplane GEMM.

    x: [M, K] int8 activations; w_q: [K, N] signed integer codes within
    ``bits`` bits; w_scale: [N] fp32 per-column scales. Returns fp32
    [M, N] = (x @ w_q) * w_scale through the bitplane decomposition.
    """
    acc = bitplane_dot(x, bitplane_decompose(w_q, bits))
    return acc.to(torch.float32) * w_scale[None, :]


def int4_gemm_ref(x: torch.Tensor, w_packed: torch.Tensor,
                  w_scale: torch.Tensor) -> torch.Tensor:
    """Packed-int4 GEMM.

    x: [M, K] int8; w_packed: [K, N//2] int8 (pack_int4 layout);
    w_scale: [N] fp32. Returns fp32 [M, N].
    """
    acc = exact_dot(x, unpack_int4(w_packed))
    return acc.to(torch.float32) * w_scale[None, :]


def bitserial_grouped_gemm_ref(x_col: torch.Tensor, w_q: torch.Tensor,
                               w_scale: torch.Tensor,
                               bits: int) -> torch.Tensor:
    """Grouped (depthwise) bitplane GEMM.

    x_col: [M, K, N] int8, one im2col slice per output channel (K is the
    kh*kw tap count; channel c sees only its own slice); w_q: [K, N]
    codes within ``bits`` bits; w_scale: [N] fp32. Returns fp32 [M, N]
    with out[m, c] = (sum_k x_col[m, k, c] * w_q[k, c]) * w_scale[c],
    through the bitplane decomposition.
    """
    acc = bitplane_grouped_dot(x_col, bitplane_decompose(w_q, bits))
    return acc.to(torch.float32) * w_scale[None, :]


def int4_grouped_gemm_ref(x_col: torch.Tensor, w_q: torch.Tensor,
                          w_scale: torch.Tensor) -> torch.Tensor:
    """Grouped (depthwise) int4 GEMM: x_col [M, K, N] int8; w_q [K, N]
    codes in [-8, 7]; w_scale [N] fp32. Returns fp32 [M, N]."""
    return grouped_dot(x_col, w_q).to(torch.float32) * w_scale[None, :]


def conv_patches_ref(x_sp: torch.Tensor, kernel: int, stride: int, pad: int,
                     out_hw: int) -> torch.Tensor:
    """Im2col patch generation from a spatial [H, W, C] tensor:
    returns [out_hw*out_hw, kernel*kernel, C] (output positions
    row-major, taps in (kh, kw) order). Zero padding — code 0 is real
    0.0 under the symmetric quantizer. The (kh, kw, c) column order
    matches the HWIO weight flattening ``w.reshape(k, n)``.
    """
    x = F.pad(x_sp, (0, 0, pad, pad, pad, pad))
    span = stride * (out_hw - 1) + 1
    taps = [x[dh:dh + span:stride, dw:dw + span:stride, :]
            for dh in range(kernel) for dw in range(kernel)]
    pat = torch.stack(taps, dim=2)             # [oh, oh, kk*kk, C]
    return pat.reshape(out_hw * out_hw, kernel * kernel, x_sp.shape[2])


def fused_hetero_gemm_ref(x: torch.Tensor, w_lut: torch.Tensor | None,
                          s_lut: torch.Tensor | None, bits: int,
                          w_dsp: torch.Tensor | None,
                          s_dsp: torch.Tensor | None) -> torch.Tensor:
    """Fused split GEMM: one int32 accumulation over both sides of the
    Eq.-12 split, one per-column dequant.

    x: [M, K] int8; w_lut: [K, n_lut] codes within ``bits`` bits (or
    None); w_dsp: [K, n_dsp] codes in [-8, 7] (or None); s_*: per-column
    fp32 scales. Returns fp32 [M, n_lut + n_dsp] in split column order.
    """
    accs, scales = [], []
    if w_lut is not None and w_lut.shape[1]:
        accs.append(bitplane_dot(x, bitplane_decompose(w_lut, bits)))
        scales.append(s_lut)
    if w_dsp is not None and w_dsp.shape[1]:
        accs.append(exact_dot(x, w_dsp))
        scales.append(s_dsp)
    acc = torch.cat(accs, dim=1)
    sc = torch.cat(scales)
    return acc.to(torch.float32) * sc[None, :]


def fused_hetero_grouped_gemm_ref(x_col: torch.Tensor,
                                  w_lut: torch.Tensor | None,
                                  s_lut: torch.Tensor | None, bits: int,
                                  w_dsp: torch.Tensor | None,
                                  s_dsp: torch.Tensor | None
                                  ) -> torch.Tensor:
    """Fused grouped (depthwise) split GEMM.

    x_col: [M, K, N] int8 per-channel im2col slices over *all* N
    channels in split order: the first n_lut channels contract
    bit-serially, the rest through the int4 path. Bit-identical to the
    two grouped oracles run per partition and concatenated.
    """
    outs = []
    n_lut = 0 if w_lut is None else w_lut.shape[1]
    if n_lut:
        outs.append(bitserial_grouped_gemm_ref(x_col[:, :, :n_lut], w_lut,
                                               s_lut, bits))
    if w_dsp is not None and w_dsp.shape[1]:
        outs.append(int4_grouped_gemm_ref(x_col[:, :, n_lut:], w_dsp,
                                          s_dsp))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def hetero_gemm_ref(x: torch.Tensor, w_q_serial: torch.Tensor,
                    s_serial: torch.Tensor, bits_serial: int,
                    w_packed_parallel: torch.Tensor,
                    s_parallel: torch.Tensor) -> torch.Tensor:
    """The paper's heterogeneous split GEMM: first columns via the
    bitplane path, remaining via the packed-int4 path, concatenated."""
    lo = bitserial_gemm_ref(x, w_q_serial, s_serial, bits_serial)
    hi = int4_gemm_ref(x, w_packed_parallel, s_parallel)
    return torch.cat([lo, hi], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: float | None = None,
                        kv_offset: int = 0) -> torch.Tensor:
    """Plain softmax attention oracle, in fp32.

    q: [B, H, Sq, D]; k, v: [B, H, Skv, D]. ``kv_offset`` positions the
    query block inside the KV sequence (decode: Sq=1, offset=Skv-1).
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
