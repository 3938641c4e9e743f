"""Seeded synthetic data: ``SyntheticTokens`` for the LM serving path,
``SyntheticImages`` for the CNN accuracy harness."""
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens

__all__ = ["SyntheticImages", "SyntheticTokens"]
