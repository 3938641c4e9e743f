"""MobileNet-V2 @224 (ImageNet) — the paper's second evaluation workload."""
from repro_torch.models.cnn import CNNConfig, reduced_config

CONFIG = CNNConfig(arch="mobilenet_v2", n_classes=1000, in_hw=224)
SMOKE = reduced_config("mobilenet_v2")
