"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD. [arXiv:2405.21060; unverified]

Attention-free. The paper's technique applies to the in/out
projections (GEMM-level); the SSD scan itself is not a GEMM and is not
split. The compiler and the decode sessions read this config, and
``models/ssm.py`` serves it.
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.ssm import SSMConfig, SSMLMConfig

CONFIG = register(ArchConfig(
    arch_id="mamba2-780m",
    family="ssm",
    skip_shapes=(),                      # sub-quadratic: runs long_500k
    module="ssm",
    model=SSMLMConfig(
        name="mamba2-780m",
        n_layers=48, d_model=1536, vocab=50280,
        ssm=SSMConfig(d_model=1536, d_inner=3072, head_dim=64, d_state=128,
                      n_groups=1, conv_kernel=4, chunk=256),
        tie_embeddings=True, remat="full",
    ),
    smoke=SSMLMConfig(
        name="mamba2-780m-smoke",
        n_layers=2, d_model=64, vocab=512, vocab_pad_multiple=16,
        ssm=SSMConfig(d_model=64, d_inner=128, head_dim=16, d_state=32,
                      n_groups=1, chunk=32),
        param_dtype=torch.float32,
    ),
    notes="attention-free SSD; runs all four shapes incl. long_500k",
))
