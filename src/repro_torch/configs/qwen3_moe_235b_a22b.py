"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
d_ff=1536 (per expert) vocab=151936, MoE 128e top-8.
[hf:Qwen/Qwen3-30B-A3B (scaled); hf]"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.layers import MoEConfig
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    module="lm",
    model=LMConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936, rope_theta=1000000.0, qk_norm=True,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, group_size=512),
        remat="full",
    ),
    smoke=LMConfig(
        name="qwen3-moe-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=512, vocab_pad_multiple=16, qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, group_size=64),
        param_dtype=torch.float32,
    ),
    notes="all layers MoE (128e top-8); full attention -> long_500k skipped",
))
