"""Mamba2 configs, in the port.

The config half of ``repro.models.ssm``: ``SSMConfig`` (one SSD mixer)
and ``SSMLMConfig`` (the decoder-only Mamba2 LM, mamba2-780m). The
compiler walks them into projection GEMMs (``compiler/networks.py``)
and the decode sessions run their in/out projections with the
session's own recurrence glue (``compiler/runtime/session.py``). The
SSD forward itself (chunked scan, causal conv, gated norm) is a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int                 # = expand * d_model (2x)
    head_dim: int = 64           # P
    d_state: int = 128           # N
    n_groups: int = 1            # G (B/C shared across heads per group)
    conv_kernel: int = 4
    chunk: int = 256             # Lc
    dt_min: float = 1e-3
    dt_max: float = 1e-1

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


@dataclasses.dataclass(frozen=True)
class SSMLMConfig:
    """Decoder-only Mamba2 LM (mamba2-780m)."""
    name: str
    n_layers: int
    d_model: int
    vocab: int
    ssm: SSMConfig
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    remat: str = "none"
    scan_unroll: bool = False

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m
