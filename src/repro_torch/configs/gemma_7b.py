"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="gemma-7b",
    family="dense",
    module="lm",
    model=LMConfig(
        name="gemma-7b",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, act="gelu", remat="full",
        tie_embeddings=True,
    ),
    smoke=LMConfig(
        name="gemma-7b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=192, vocab=512, vocab_pad_multiple=16, act="gelu",
        param_dtype=torch.float32,
    ),
    notes="GeGLU MLP, MHA (kv=16); full attention -> long_500k skipped",
))
