"""Seeded synthetic data: ``SyntheticTokens`` for the LM serving path."""
