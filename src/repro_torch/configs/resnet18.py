"""ResNet-18 @224 (ImageNet) — the paper's primary evaluation workload.

Not part of the LM arch pool; used by the paper-reproduction benchmarks
(Tables 3-5, Figs. 5-12) and by the end-to-end QAT training example.
"""
from repro_torch.models.cnn import CNNConfig, reduced_config

CONFIG = CNNConfig(arch="resnet18", n_classes=1000, in_hw=224)
SMOKE = reduced_config("resnet18")
