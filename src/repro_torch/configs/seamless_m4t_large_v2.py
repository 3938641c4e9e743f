"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206, encoder-decoder. [arXiv:2308.11596; hf]

24 encoder + 24 decoder layers. The speech frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings
[B, S_src, d_model]. vocab 256206 is padded to 256256 (the reference
pads for even 16-way sharding of the embedding and logit matrices;
logits are sliced back).
"""
import torch

from repro_torch.configs.registry import ArchConfig, register
from repro_torch.models.encdec import EncDecConfig

CONFIG = register(ArchConfig(
    arch_id="seamless-m4t-large-v2",
    family="audio",
    module="encdec",
    model=EncDecConfig(
        name="seamless-m4t-large-v2",
        n_enc_layers=24, n_dec_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=8192, vocab=256206,
        remat="full",
    ),
    frontend="audio",
    smoke=EncDecConfig(
        name="seamless-smoke",
        n_enc_layers=2, n_dec_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        head_dim=12, d_ff=96, vocab=512, vocab_pad_multiple=16,
        param_dtype=torch.float32,
    ),
    notes="enc-dec; audio frontend stubbed; decode = decoder step with "
          "cross-attention to encoder memory; long_500k skipped",
))
