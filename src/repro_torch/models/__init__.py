"""Models: ``cnn`` is ResNet-18 / MobileNet-V2 (the configs the
compiler scales and the fp32 networks the accuracy harness trains);
``layers`` and ``lm`` are the dense decoder-only LM the serving path
runs; ``ssm`` and ``hybrid`` hold the Mamba2 and Jamba configs (and
``layers.MoEConfig``) that the compiler and the decode sessions read."""
