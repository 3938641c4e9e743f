"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B; unverified]"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.lm import LMConfig

CONFIG = register(ArchConfig(
    arch_id="llama3.2-1b",
    family="dense",
    module="lm",
    model=LMConfig(
        name="llama3.2-1b",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab=128256, rope_theta=500000.0, remat="full",
        tie_embeddings=True,
    ),
    smoke=LMConfig(
        name="llama3.2-1b-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, vocab_pad_multiple=16, rope_theta=500000.0,
        param_dtype=torch.float32,
    ),
    notes="small llama3; full attention -> long_500k skipped",
))
