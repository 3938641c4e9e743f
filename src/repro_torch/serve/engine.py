"""Inference engine: prefill / decode step factories + generation loop.

The counterpart of ``repro.serve.engine`` for the LM family (the other
families raise ``NotImplementedError``). The factories give the
launcher one signature whatever the model:

    prefill_fn(params, batch, cache)       -> (logits, cache)
    decode_fn(params, token, cache, pos)   -> (logits, cache)

PyTorch runs eagerly, so there is no ``jit``; the cache is written in
place and returned. ``attn_mode="ref"`` runs prefill attention on the
flash kernel's plain version (the comparison run on the card).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.registry import ArchConfig


def _check_family(arch: ArchConfig) -> None:
    if arch.module != "lm":
        raise NotImplementedError(
            f"{arch.arch_id}: the {arch.module!r} family is served by a "
            f"later slice of the port; this one serves module 'lm'")


def make_cache(arch: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> Any:
    _check_family(arch)
    return arch.model_module().init_cache(arch.model, batch, max_seq, dtype,
                                          device)


def make_prefill_fn(arch: ArchConfig, attn_mode: str = "auto") -> Callable:
    _check_family(arch)
    mod, cfg = arch.model_module(), arch.model

    def prefill_fn(params, batch, cache):
        return mod.prefill(params, batch["tokens"], cache, cfg,
                           attn_mode=attn_mode)
    return prefill_fn


def make_decode_fn(arch: ArchConfig) -> Callable:
    _check_family(arch)
    mod, cfg = arch.model_module(), arch.model

    def decode_fn(params, token, cache, pos):
        return mod.decode_step(params, token, cache, pos, cfg)
    return decode_fn


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[B, vocab] logits -> [B, 1] int32 argmax tokens."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def greedy_generate(arch: ArchConfig, params: Any, prompts: torch.Tensor,
                    n_new: int, attn_mode: str = "auto") -> torch.Tensor:
    """Greedy batched generation (the end-to-end serving path): one
    prefill scores the prompt and fills an fp32 KV cache (the
    reference's default), then ``n_new - 1`` decode steps.

    prompts: [B, S0] int on the parameters' device. Returns
    [B, S0 + n_new].
    """
    b, s0 = prompts.shape
    cache = make_cache(arch, b, s0 + n_new, torch.float32, prompts.device)
    prefill_fn = make_prefill_fn(arch, attn_mode)
    decode_fn = make_decode_fn(arch)
    logits, cache = prefill_fn(params, {"tokens": prompts}, cache)
    tok = greedy_token(logits[:, -1])
    new = [tok]
    pos = s0
    for _ in range(n_new - 1):
        logits, cache = decode_fn(params, tok, cache, pos)
        tok = greedy_token(logits)
        new.append(tok)
        pos += 1
    return torch.cat([prompts.to(torch.int32)] + new, dim=1)
