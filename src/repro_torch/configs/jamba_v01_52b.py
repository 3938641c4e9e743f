"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2, Mamba+attn 1:7 interleave.
[arXiv:2403.19887; hf]

SSM head layout: d_inner = 2*d_model = 8192, head_dim 64 -> 128 SSD
heads, d_state 64 (Jamba v0.1 uses Mamba-1 with N=16; the SSD
formulation keeps a larger state, as in the reference).
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.hybrid import HybridConfig
from repro_torch.models.layers import MoEConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = register(ArchConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    skip_shapes=(),                      # sub-quadratic: runs long_500k
    module="hybrid",
    model=HybridConfig(
        name="jamba-v0.1-52b",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        ssm=SSMConfig(d_model=4096, d_inner=8192, head_dim=64, d_state=64,
                      n_groups=1, conv_kernel=4, chunk=256),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, group_size=512),
        remat="full",
    ),
    smoke=HybridConfig(
        name="jamba-smoke",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, vocab_pad_multiple=16,
        ssm=SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=16,
                      n_groups=1, chunk=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96, group_size=64),
        param_dtype=torch.float32,
    ),
    notes="1:7 attn:mamba, MoE every 2nd layer; runs long_500k",
))
