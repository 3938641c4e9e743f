"""Quantization substrate: the uniform symmetric quantizer (Eq. 2),
the filter-wise hybrid mixed-precision scheme (Fig. 6), the
KL-divergence filter->core allocation, and quantization-aware-training
(STE) utilities."""
from repro_torch.quant.hybrid import (
    DSP_WEIGHT_BITS,
    HybridQuantizedWeight,
    LayerQuantConfig,
    hybrid_fake_quant_weight,
    hybrid_quantize_weight,
    kl_filter_allocation,
    model_size_bits,
)
from repro_torch.quant.uniform import (
    dequantize,
    fake_quant,
    fake_quant_per_channel,
    fit_scale,
    fit_scale_per_channel,
    qrange,
    quant_snr_db,
    quantize,
)

__all__ = ["DSP_WEIGHT_BITS", "HybridQuantizedWeight", "LayerQuantConfig",
           "dequantize", "fake_quant", "fake_quant_per_channel", "fit_scale",
           "fit_scale_per_channel", "hybrid_fake_quant_weight",
           "hybrid_quantize_weight", "kl_filter_allocation",
           "model_size_bits", "qrange", "quant_snr_db", "quantize"]
