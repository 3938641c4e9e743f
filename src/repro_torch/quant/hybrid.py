"""Filter-wise hybrid quantization — paper Section 4 and Fig. 6, the
per-layer configuration.

A layer's weight tensor ``W`` (viewed as c_out filters) is split between
the two heterogeneous cores:

  * DSP-core filters: fixed ``B_DSP`` = 4-bit uniform quantization.
  * LUT-core filters: flexible ``B_wL`` in 2..8 bits (per layer, chosen
    by the DSE framework).

Which filters go where is decided by the KL divergence between each
filter's fp32 weight distribution and its quantized counterpart: filters
with the *largest* divergence (i.e. most damaged by quantization) are
allocated to the core with the higher bit-width.

Activations are quantized layer-wise with a shared ``B_a`` (2..4 bits;
8-bit for first/last layers) since both cores consume the same
activation stream.

The counterpart of ``repro.quant.hybrid`` on torch tensors. The
allocation is a discrete choice over float32 divergences, so it is
computed as the reference computes it: the histograms hold exact
counts (a ``scatter_add_`` of ones in place of the reference's summed
one-hot, which gives the same integers without a [c_out, K, n_bins]
tensor), and ``torch.argsort(..., stable=True)`` orders ties as
``jnp.argsort`` does.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.quant.uniform import (
    dequantize,
    fake_quant_per_channel,
    fit_scale_per_channel,
    quantize,
)

DSP_WEIGHT_BITS = 4  # the paper's DSP-core is designed for int4 weights


@dataclasses.dataclass(frozen=True)
class LayerQuantConfig:
    """Per-layer knobs searched by the DSE framework (Table 2)."""
    w_bits_lut: int = 4      # B^{w-L} in 2..8
    a_bits: int = 4          # B^{a}   in 2..4 (8 for first/last layers)
    ratio: float = 0.5       # Eq. (11): Filter_LUT / Filter_all
    w_bits_dsp: int = DSP_WEIGHT_BITS
    alloc_metric: str = "kl"  # "kl" (paper) | "mse" (beyond-paper)

    def __post_init__(self):
        if not (0.0 <= self.ratio <= 1.0):
            raise ValueError(f"ratio must be in [0,1], got {self.ratio}")
        if not (1 <= self.w_bits_lut <= 8):
            raise ValueError(f"w_bits_lut out of range: {self.w_bits_lut}")
        if not (1 <= self.a_bits <= 8):
            raise ValueError(f"a_bits out of range: {self.a_bits}")

    def n_lut_filters(self, c_out: int) -> int:
        return int(round(self.ratio * c_out))


@dataclasses.dataclass
class HybridQuantizedWeight:
    """Integer codes + scales + core assignment for one layer.

    ``perm`` maps sorted position -> original filter index; the first
    ``n_lut`` entries are the LUT-core filters (highest KL divergence
    when w_bits_lut > 4, lowest otherwise).
    """
    q_lut: torch.Tensor        # [n_lut, ...] integer codes (int32)
    q_dsp: torch.Tensor        # [n_dsp, ...] integer codes (int32)
    s_lut: torch.Tensor        # [n_lut, 1...] per-filter scales
    s_dsp: torch.Tensor        # [n_dsp, 1...]
    perm: torch.Tensor         # [c_out] original filter index per sorted slot
    cfg: LayerQuantConfig

    @property
    def n_lut(self) -> int:
        return self.q_lut.shape[0]

    def dequantize(self) -> torch.Tensor:
        """Reconstruct the fake-quantized weight in original filter order."""
        w_lut = dequantize(self.q_lut, self.s_lut)
        w_dsp = dequantize(self.q_dsp, self.s_dsp)
        w_sorted = torch.cat([w_lut, w_dsp], dim=0)
        inv = torch.argsort(self.perm, stable=True)
        return w_sorted[inv]


def _filter_kl_divergence(w: torch.Tensor, bits: int,
                          n_bins: int = 64) -> torch.Tensor:
    """Per-filter KL(P_fp32 || P_quant) over weight-value histograms.

    ``w``: [c_out, K] flattened filters. Histograms share per-filter bin
    edges spanning [-max|w|, max|w|]; the quantized histogram is built
    from the dequantized codes (calibration as in the paper, which uses
    one batch of images — weights need no data).
    """
    s = fit_scale_per_channel(w, bits, axis=0)
    deq = dequantize(quantize(w, s, bits), s)

    lo = -torch.amax(torch.abs(w), dim=1, keepdim=True) - 1e-6
    hi = -lo

    def hist(x):
        # normalized positions in [0,1], hard-binned, then smoothed with a
        # small triangular kernel — the raw histogram KL is dominated by
        # per-bin sampling noise at realistic filter sizes otherwise.
        t = (x - lo) / (hi - lo)
        idx = torch.clamp((t * n_bins).to(torch.int32), 0, n_bins - 1)
        h = torch.zeros((x.shape[0], n_bins), dtype=torch.float32,
                        device=x.device)
        h.scatter_add_(1, idx.long(), torch.ones_like(x, dtype=torch.float32))
        h = (h
             + 0.5 * F.pad(h[:, 1:], (0, 1))
             + 0.5 * F.pad(h[:, :-1], (1, 0)))
        return h / torch.clamp(torch.sum(h, dim=1, keepdim=True), min=1.0)

    p = hist(w)
    q = hist(deq)
    eps = 1e-8
    return torch.sum(p * (torch.log(p + eps) - torch.log(q + eps)), dim=1)


def _filter_rel_mse(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-filter relative quantization MSE — a *beyond-paper* allocation
    metric. On mixed filter ensembles the histogram KL of the paper
    correlates only weakly with actual quantization damage (outlier-
    laden filters get LOW KL but HIGH damage); relative MSE ranks by the
    damage itself. Selected with ``LayerQuantConfig.alloc_metric``."""
    s = fit_scale_per_channel(w, bits, axis=0)
    deq = dequantize(quantize(w, s, bits), s)
    num = torch.sum(torch.square(deq - w), dim=1)
    den = torch.clamp(torch.sum(torch.square(w), dim=1), min=1e-12)
    return num / den


def kl_filter_allocation(w: torch.Tensor,
                         cfg: LayerQuantConfig) -> torch.Tensor:
    """Return a permutation of filter indices: first n_lut slots -> LUT core.

    Paper rule: filters with greater KL divergence go to the core with
    the *higher* bit-width. When ``w_bits_lut >= w_bits_dsp`` the LUT
    core is the high-precision one so it takes the top-KL filters;
    otherwise the DSP core (fixed int4) takes them.
    ``cfg.alloc_metric`` picks the sensitivity metric: "kl" (paper) or
    "mse" (beyond-paper; tracks damage more faithfully).
    """
    c_out = w.shape[0]
    flat = w.reshape(c_out, -1)
    # Divergence at the *lower* of the two bit-widths: that is the one
    # that damages sensitive filters, so rank by it.
    probe_bits = min(cfg.w_bits_lut, cfg.w_bits_dsp)
    if cfg.alloc_metric == "mse":
        kl = _filter_rel_mse(flat, probe_bits)
    else:
        kl = _filter_kl_divergence(flat, probe_bits)
    order_desc = torch.argsort(-kl, stable=True)  # highest divergence first
    n_lut = cfg.n_lut_filters(c_out)
    if cfg.w_bits_lut >= cfg.w_bits_dsp:
        # LUT core is high precision: it takes the most sensitive filters.
        lut_idx = order_desc[:n_lut]
        dsp_idx = order_desc[n_lut:]
    else:
        dsp_idx = order_desc[: c_out - n_lut]
        lut_idx = order_desc[c_out - n_lut:]
    return torch.cat([lut_idx, dsp_idx], dim=0)


def hybrid_quantize_weight(w: torch.Tensor, cfg: LayerQuantConfig,
                           perm: torch.Tensor | None = None
                           ) -> HybridQuantizedWeight:
    """Quantize filters into the two-core hybrid representation.

    ``w``: [c_out, ...]. Returns integer codes for both partitions with
    per-filter scales.
    """
    c_out = w.shape[0]
    if perm is None:
        perm = kl_filter_allocation(w, cfg)
    n_lut = cfg.n_lut_filters(c_out)
    w_sorted = w[perm]
    w_lut, w_dsp = w_sorted[:n_lut], w_sorted[n_lut:]

    s_lut = fit_scale_per_channel(w_lut, cfg.w_bits_lut, axis=0)
    s_dsp = fit_scale_per_channel(w_dsp, cfg.w_bits_dsp, axis=0)
    return HybridQuantizedWeight(
        q_lut=quantize(w_lut, s_lut, cfg.w_bits_lut),
        q_dsp=quantize(w_dsp, s_dsp, cfg.w_bits_dsp),
        s_lut=s_lut,
        s_dsp=s_dsp,
        perm=perm,
        cfg=cfg,
    )


def hybrid_fake_quant_weight(w: torch.Tensor, cfg: LayerQuantConfig,
                             perm: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Differentiable (STE) hybrid fake-quantization, for QAT.

    Keeps original filter order; each filter is fake-quantized at the
    bit-width of the core it is allocated to.
    """
    c_out = w.shape[0]
    if perm is None:
        perm = kl_filter_allocation(w.detach(), cfg)
    n_lut = cfg.n_lut_filters(c_out)
    is_lut_slot = torch.arange(c_out, device=w.device) < n_lut
    inv = torch.argsort(perm, stable=True)
    is_lut = is_lut_slot[inv]  # [c_out] in original order

    fq_lut = fake_quant_per_channel(w, cfg.w_bits_lut, axis=0)
    fq_dsp = fake_quant_per_channel(w, cfg.w_bits_dsp, axis=0)
    mask_shape = (c_out,) + (1,) * (w.ndim - 1)
    m = is_lut.reshape(mask_shape)
    return torch.where(m, fq_lut, fq_dsp)


def model_size_bits(layer_shapes: list[tuple[int, int]],
                    cfgs: list[LayerQuantConfig]) -> int:
    """Total weight footprint in bits under a hybrid scheme.

    ``layer_shapes``: (c_out, fan_in) per layer.
    """
    total = 0
    for (c_out, fan_in), cfg in zip(layer_shapes, cfgs):
        n_lut = cfg.n_lut_filters(c_out)
        total += n_lut * fan_in * cfg.w_bits_lut
        total += (c_out - n_lut) * fan_in * cfg.w_bits_dsp
    return total
