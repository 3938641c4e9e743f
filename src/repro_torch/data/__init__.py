"""Seeded synthetic data: ``SyntheticTokens`` for the LM serving path,
``SyntheticImages`` for the CNN accuracy harness."""
