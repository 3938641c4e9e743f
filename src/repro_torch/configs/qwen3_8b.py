"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="qwen3-8b",
    family="dense",
    module="lm",
    model=LMConfig(
        name="qwen3-8b",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12288, vocab=151936, rope_theta=1000000.0, qk_norm=True,
        remat="full",
    ),
    smoke=LMConfig(
        name="qwen3-8b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, vocab_pad_multiple=16, qk_norm=True,
        param_dtype=torch.float32,
    ),
    notes="qk_norm after head split; full attention -> long_500k skipped",
))
