"""Dataset-scale validation of compiled programs against their models:
``accuracy`` (``python -m repro_torch.eval.accuracy``)."""
