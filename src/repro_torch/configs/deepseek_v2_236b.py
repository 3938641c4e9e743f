"""deepseek-v2-236b [moe] — 60L d_model=5120 128H, MLA kv_lora=512,
d_ff=1536 (per expert), 2 shared + 160 routed top-6, vocab=102400.
[arXiv:2405.04434; hf]

MLA decode uses the absorbed compressed-cache form (cache is
[B, S, kv_lora + rope] per layer — the MLA memory win). First layer is
dense (d_ff 12288), remaining 59 are MoE, as in the released model.
Prefill attention is the flash kernel at key size 192 (128 + 64 rotary
columns) over value size 128. Its bf16 parameters are 471.6 GB, so one
80 GB card serves it at published widths with its depth cut (the
launcher's ``--layers``, which keeps the dense layer).
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.layers import MoEConfig
from repro_torch.models.lm import LMConfig, MLAConfig

CONFIG = register(ArchConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    module="lm",
    model=LMConfig(
        name="deepseek-v2-236b",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=1536, vocab=102400,
        mla=MLAConfig(kv_lora=512, q_lora=1536, qk_nope_dim=128,
                      qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff=1536, n_shared=2,
                      group_size=512),
        n_dense_prefix=1, d_ff_dense=12288,
        remat="full",
    ),
    smoke=LMConfig(
        name="deepseek-v2-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=512, vocab_pad_multiple=16,
        mla=MLAConfig(kv_lora=32, q_lora=48, qk_nope_dim=16, qk_rope_dim=8,
                      v_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=96, n_shared=1,
                      group_size=64),
        n_dense_prefix=1, d_ff_dense=128,
        param_dtype=torch.float32,
    ),
    notes="MLA + 2 shared + 160 routed top-6; long_500k skipped",
))
