"""Models: ``cnn`` is ResNet-18 / MobileNet-V2 (the configs the
compiler scales and the fp32 networks the accuracy harness trains);
``layers`` and ``lm`` are the dense decoder-only LM the serving path
runs."""
