"""Dataset-scale validation of compiled programs against their models:
``accuracy`` (``python -m repro_torch.eval.accuracy``)."""
from repro_torch.eval.accuracy import (
    AGREEMENT_FLOOR,
    AccuracyReport,
    bind_folded_weights,
    build_reference,
    compile_quantized_cnn,
    evaluate_agreement,
    fold_to_matrix,
    make_accuracy_fn,
    quantize_folded_matrix,
)

__all__ = [
    "AGREEMENT_FLOOR",
    "AccuracyReport",
    "bind_folded_weights",
    "build_reference",
    "compile_quantized_cnn",
    "evaluate_agreement",
    "fold_to_matrix",
    "make_accuracy_fn",
    "quantize_folded_matrix",
]
