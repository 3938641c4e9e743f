"""Filter-wise hybrid quantization — paper Section 4 and Fig. 6, the
per-layer configuration.

A layer's weight tensor ``W`` (viewed as c_out filters) is split between
the two heterogeneous cores:

  * DSP-core filters: fixed ``B_DSP`` = 4-bit uniform quantization.
  * LUT-core filters: flexible ``B_wL`` in 2..8 bits (per layer, chosen
    by the DSE framework).

Activations are quantized layer-wise with a shared ``B_a`` (2..4 bits;
8-bit for first/last layers) since both cores consume the same
activation stream.

The counterpart of ``repro.quant.hybrid``'s :class:`LayerQuantConfig`,
which the LM's ``--quantize`` projections read; the KL filter
allocation and the quantized-weight containers come with the
deployable HeteroLinear (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import dataclasses

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
