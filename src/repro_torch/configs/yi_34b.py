"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, llama-arch GQA. [arXiv:2403.04652; hf]

56 heads do not divide a 16-way model axis, so its rules run the
attention sequence-parallel (a sharding-rule override, as in the
reference; the port's models make no activation constraints yet, so
it binds nothing until tensor parallelism lands). Its bf16 parameters
are 68.8 GB, so one 80 GB card serves it at published widths with its
depth cut.
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="yi-34b",
    family="dense",
    module="lm",
    model=LMConfig(
        name="yi-34b",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab=64000, rope_theta=5000000.0, remat="full",
    ),
    rule_overrides={"act_heads": (), "act_seq_attn": ("model",)},
    smoke=LMConfig(
        name="yi-34b-smoke",
        n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
        d_ff=160, vocab=512, vocab_pad_multiple=16,
        param_dtype=torch.float32,
    ),
    notes="56 heads !% 16 -> sequence-parallel attention; long_500k skipped",
))
