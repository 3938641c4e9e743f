"""Quantization substrate: the uniform symmetric quantizer (Eq. 2) and
the per-layer hybrid quantization config."""
from repro_torch.quant.hybrid import DSP_WEIGHT_BITS, LayerQuantConfig
from repro_torch.quant.uniform import (
    dequantize,
    fit_scale,
    fit_scale_per_channel,
    qrange,
    quant_snr_db,
    quantize,
)

__all__ = ["DSP_WEIGHT_BITS", "LayerQuantConfig", "dequantize", "fit_scale",
           "fit_scale_per_channel", "qrange", "quant_snr_db", "quantize"]
