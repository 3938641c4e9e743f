"""Uniform symmetric quantizer — paper Eq. (2), on torch tensors.

    x_hat = f_q(x, s) = clip(round(x / s), alpha_hat, beta_hat)

with ``alpha_hat = -2^(N_bits-1)`` and ``beta_hat = 2^(N_bits-1) - 1``.

The counterpart of ``repro.quant.uniform``'s inference half, bit for
bit: ``torch.round`` rounds half to even like ``jnp.round``, scales
multiply by the float32-rounded reciprocal of ``beta_hat`` (never
divide by it), and ``x / s`` divides by a tensor, which is IEEE
division on every device. ``quant_snr_db`` is the counterpart of
``repro.quant.uniform.quant_snr_db``; only the tests call it. The
straight-through fake quantizers belong to training and are not ported
yet.
"""
from __future__ import annotations

import numpy as np
import torch


def qrange(bits: int) -> tuple[int, int]:
    """Integer range (alpha_hat, beta_hat) of a signed ``bits``-bit code."""
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def quantize(x: torch.Tensor, s: torch.Tensor, bits: int) -> torch.Tensor:
    """Eq. (2): real tensor -> integer codes (round-to-nearest-even)."""
    lo, hi = qrange(bits)
    return torch.clamp(torch.round(x / s), lo, hi).to(torch.int32)


def dequantize(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _inv_hi(bits: int) -> float:
    """Float32-rounded reciprocal of beta_hat, as a Python float that
    float32 represents exactly. The reference multiplies by
    ``float32(1 / hi)``; handing torch the already-rounded value keeps
    the product identical whether the scalar is applied in float32 or
    in double."""
    _, hi = qrange(bits)
    return float(np.float32(1.0 / hi))


def fit_scale(x: torch.Tensor, bits: int, eps: float = 1e-8) -> torch.Tensor:
    """Symmetric max-abs scale: s = max|x| / beta_hat (per tensor), a
    0-dim float32 tensor on ``x``'s device."""
    return torch.clamp(x.abs().max(), min=eps) * _inv_hi(bits)


def fit_scale_per_channel(x: torch.Tensor, bits: int, axis: int = 0,
                          eps: float = 1e-8) -> torch.Tensor:
    """Per-channel (filter-wise) scales along ``axis``; keepdims for broadcast."""
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    m = torch.amax(x.abs(), dim=reduce_axes, keepdim=True)
    return torch.clamp(m, min=eps) * _inv_hi(bits)


def quant_snr_db(x: torch.Tensor, x_hat: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (accuracy proxy when no
    labelled dataset is available offline)."""
    sig = torch.sum(torch.square(x))
    err = torch.sum(torch.square(x - x_hat))
    return 10.0 * torch.log10((sig + eps) / (err + eps))
