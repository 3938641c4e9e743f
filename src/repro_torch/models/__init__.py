"""Models: ``cnn`` holds the ResNet-18 / MobileNet-V2 configs the
compiler scales (the fp32 networks come with a later slice); ``layers``
and ``lm`` are the dense decoder-only LM the serving path runs."""
