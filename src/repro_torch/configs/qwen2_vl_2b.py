"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, M-RoPE. [arXiv:2409.12191; hf]

The vision frontend is a stub, as in the reference: precomputed patch
embeddings (``extra_embed``) are added to the token embeddings; the
launcher serves text, whose positions drive all three M-RoPE
components. M-RoPE splits the 64 frequency bands (head_dim 128) into
(t, h, w) = (16, 24, 24) sections. 12 heads do not divide the
reference's 16-way model axis, so its rules run the attention
sequence-parallel (a sharding-rule override, as in the reference; it
binds nothing in the port until tensor parallelism lands).
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    module="lm",
    model=LMConfig(
        name="qwen2-vl-2b",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
        d_ff=8960, vocab=151936, rope_theta=1000000.0,
        mrope_sections=(16, 24, 24), remat="full",
        tie_embeddings=True,
    ),
    rule_overrides={"act_heads": (), "act_seq_attn": ("model",)},
    frontend="vision",
    smoke=LMConfig(
        name="qwen2-vl-smoke",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab=512, vocab_pad_multiple=16,
        mrope_sections=(4, 2, 2),
        param_dtype=torch.float32,
    ),
    notes="M-RoPE; 12 heads !% 16 -> seq-parallel attention; "
          "vision frontend stubbed; long_500k skipped",
))
