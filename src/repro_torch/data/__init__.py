"""Seeded synthetic data: ``SyntheticTokens`` for the LM serving and
training paths, ``SyntheticImages`` for the CNN accuracy harness,
``make_host_batch`` for the smoke tests, ``make_batch_specs`` for the
dry-run."""
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens, \
    make_batch_specs, make_host_batch

__all__ = ["SyntheticImages", "SyntheticTokens", "make_batch_specs",
           "make_host_batch"]
