"""Jamba-style hybrid LM configs, in the port.

The config half of ``repro.models.hybrid``: Mamba and attention
sub-layers in periods of ``PERIOD`` layers, MoE FFNs on every second
layer. The compiler walks a ``HybridConfig`` into projection GEMMs
(``compiler/networks.py``) and the decode sessions run them with their
own glue (``compiler/runtime/session.py``); the hybrid forward is a
later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import lm as lm_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MoEConfig

PERIOD = 8


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    name: str
    n_layers: int                      # must be a multiple of PERIOD
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    ssm: ssm_mod.SSMConfig
    moe: MoEConfig
    vocab_pad_multiple: int = 256
    rope_theta: float = 10000.0
    act: str = "silu"
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    remat: str = "none"
    scan_unroll: bool = False
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def n_periods(self) -> int:
        if self.n_layers % PERIOD:
            raise ValueError(f"n_layers {self.n_layers} % {PERIOD} != 0")
        return self.n_layers // PERIOD

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    def as_lm(self) -> lm_mod.LMConfig:
        """Attention sub-layer view (reuses lm.py attention)."""
        return lm_mod.LMConfig(
            name=self.name, n_layers=1, d_model=self.d_model,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, d_ff=self.d_ff, vocab=self.vocab,
            rope_theta=self.rope_theta, act=self.act,
            param_dtype=self.param_dtype, norm_eps=self.norm_eps,
            q_chunk=self.q_chunk, kv_chunk=self.kv_chunk)
