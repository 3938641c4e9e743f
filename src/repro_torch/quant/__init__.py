"""Quantization substrate: the uniform symmetric quantizer (Eq. 2)."""
from repro_torch.quant.uniform import (
    dequantize,
    fit_scale,
    fit_scale_per_channel,
    qrange,
    quant_snr_db,
    quantize,
)

__all__ = ["dequantize", "fit_scale", "fit_scale_per_channel", "qrange",
           "quant_snr_db", "quantize"]
