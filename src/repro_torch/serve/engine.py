"""Inference engine: prefill / decode step factories + generation loop.

The counterpart of ``repro.serve.engine`` for the LM (dense, MoE, MLA
and VLM), SSM, hybrid and encoder-decoder families. The factories give
the launcher one signature whatever the model:

    prefill_fn(params, batch, cache)       -> (logits, cache)
    decode_fn(params, token, cache, pos)   -> (logits, cache)

Family notes, as in the reference:
  * lm   — real prefill (scores the prompt AND fills the KV cache).
  * ssm  — decode carries the recurrent state; "prefill" scores the
           prompt with the chunked forward and returns the cache as it
           was (``greedy_generate`` builds the state token by token).
  * hybrid — like ssm for the Mamba sublayers, plus a KV cache for the
           attention sublayer: "prefill" is ``forward`` and returns the
           cache as it was.
  * encdec — prefill encodes ``batch["frames"]``, builds the static
           cross cache from the memory, and scores the prompt with
           ``forward`` (which encodes a second time, as the reference
           does); decode is one decoder token.

PyTorch runs eagerly, so there is no ``jit``; the cache is written in
place and returned. ``attn_mode="ref"`` runs prefill attention (and the
encoder-decoder's decode cross-attention) on the flash kernel's plain
version (the comparison run on the card).

The compiled (quantized) serving path drives a registry arch's
decode-step program through a decode-resident ``ExecutorSession``
(``make_compiled_session``, ``greedy_generate_compiled``): weights
bound once, warm-up program on the first token, steady program after,
every GEMM a split-GEMM kernel launch on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.registry import ArchConfig


@dataclasses.dataclass
class ServeState:
    cache: Any
    pos: int


#: the model modules the port serves
SERVED = ("lm", "ssm", "hybrid", "encdec")


def _check_family(arch: ArchConfig) -> None:
    if arch.module not in SERVED:
        raise NotImplementedError(
            f"{arch.arch_id}: the {arch.module!r} module has no serving "
            f"path; the port serves modules {SERVED}")


def make_cache(arch: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> Any:
    _check_family(arch)
    mod = arch.model_module()
    if arch.module == "ssm":       # the recurrent state takes no max_seq
        return mod.init_cache(arch.model, batch, dtype=dtype, device=device)
    if arch.module == "encdec":
        return mod.init_cache(arch.model, batch, max_tgt=max_seq,
                              src=max_seq, dtype=dtype, device=device)
    # lm, and hybrid: its attention sublayers' KV caches take max_seq
    return mod.init_cache(arch.model, batch, max_seq, dtype, device)


def make_prefill_fn(arch: ArchConfig, attn_mode: str = "auto") -> Callable:
    _check_family(arch)
    mod, cfg = arch.model_module(), arch.model

    if arch.module == "lm":
        def prefill_fn(params, batch, cache):
            return mod.prefill(params, batch["tokens"], cache, cfg,
                               extra_embed=batch.get("extra_embed"),
                               attn_mode=attn_mode)
        return prefill_fn

    if arch.module == "encdec":
        def prefill_fn(params, batch, cache):
            memory = mod.encode(params, batch["frames"], cfg, attn_mode)
            cache = mod.build_cross_cache(params, memory, cfg, cache)
            logits, _ = mod.forward(params, batch["frames"], batch["tokens"],
                                    cfg, attn_mode)
            return logits, cache
        return prefill_fn

    # ssm / hybrid: forward scores the prompt; the recurrent state (and
    # the hybrid's KV cache) accrues during generation (see
    # greedy_generate)
    def prefill_fn(params, batch, cache):
        logits, _ = mod.forward(params, batch["tokens"], cfg)
        return logits, cache
    return prefill_fn


def make_decode_fn(arch: ArchConfig, attn_mode: str = "auto") -> Callable:
    """The decode step; ``attn_mode`` reaches the one decode path that
    launches the flash kernel, the encoder-decoder's cross-attention."""
    _check_family(arch)
    mod, cfg = arch.model_module(), arch.model
    kw = {"attn_mode": attn_mode} if arch.module == "encdec" else {}

    def decode_fn(params, token, cache, pos):
        return mod.decode_step(params, token, cache, pos, cfg, **kw)
    return decode_fn


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[B, vocab] logits -> [B, 1] int32 argmax tokens."""
    return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)


def greedy_generate(arch: ArchConfig, params: Any, prompts: torch.Tensor,
                    n_new: int, attn_mode: str = "auto") -> torch.Tensor:
    """Greedy batched generation (the end-to-end serving path) with an
    fp32 cache (the reference's default). For the LM, one prefill scores
    the prompt and fills the KV cache; the recurrent families (ssm,
    hybrid) build their state token by token through ``decode_fn``,
    since their prefill scores the prompt but does not advance the
    state. Then ``n_new - 1`` decode steps.

    prompts: [B, S0] int on the parameters' device. Returns
    [B, S0 + n_new]. The encoder-decoder raises ``NotImplementedError``,
    as in the reference (it needs frames to encode).
    """
    if arch.module == "encdec":
        raise NotImplementedError(
            f"{arch.arch_id}: greedy_generate takes no frames to encode; "
            f"serve an encoder-decoder through make_prefill_fn and "
            f"make_decode_fn, as the launcher does")
    b, s0 = prompts.shape
    cache = make_cache(arch, b, s0 + n_new, torch.float32, prompts.device)
    decode_fn = make_decode_fn(arch)
    if arch.module == "lm":
        prefill_fn = make_prefill_fn(arch, attn_mode)
        logits, cache = prefill_fn(params, {"tokens": prompts}, cache)
        tok = greedy_token(logits[:, -1])
    else:                          # recurrent: ssm, hybrid
        for t in range(s0):
            logits, cache = decode_fn(params, prompts[:, t:t + 1], cache, t)
        tok = greedy_token(logits)
    new = [tok]
    pos = s0
    for _ in range(n_new - 1):
        logits, cache = decode_fn(params, tok, cache, pos)
        tok = greedy_token(logits)
        new.append(tok)
        pos += 1
    return torch.cat([prompts.to(torch.int32)] + new, dim=1)


# ---------------------------------------------------------------------------
# Compiled (quantized) serving path: decode-resident executor sessions
# ---------------------------------------------------------------------------


def make_compiled_session(arch_id: str, *, backend: str = "cuda",
                          batch: int = 1, max_seq: int = 64,
                          bits_w: int = 4, bits_a: int = 4,
                          opt_level: int = 1, device: str = "XC7Z020",
                          seed: int | None = None, tracer=None,
                          torch_device="cuda"):
    """Build a decode-resident :class:`~repro_torch.compiler.runtime.
    session.ExecutorSession` for a registry arch: compile the decode
    step program (weights resident, KV/state persistent), bind synthetic
    quantized weights once, and report the simulator's warm-up vs
    steady-state step cycles into ``obs.METRICS``
    (``serve.decode.warmup_cycles`` / ``serve.decode.steady_cycles``).

    ``device`` is the modelled FPGA the program is compiled for;
    ``torch_device`` is where the session runs (the card unless the
    caller asks for the CPU).
    """
    from repro_torch.obs import METRICS
    from repro_torch.core.scheduler import simulate_program
    from repro_torch.compiler import compile_decode_network
    from repro_torch.compiler.runtime import ExecutorSession
    prog = compile_decode_network(arch_id, batch=batch, max_seq=max_seq,
                                  bits_w=bits_w, bits_a=bits_a,
                                  opt_level=opt_level, device=device)
    ds = simulate_program(prog)
    METRICS.gauge("serve.decode.warmup_cycles", ds.warmup_cycles)
    METRICS.gauge("serve.decode.steady_cycles", ds.steady_cycles)
    session = ExecutorSession(prog, backend=backend, tracer=tracer,
                              device=torch_device)
    session.bind_synthetic_all(seed=seed)
    return session


def make_compiled_decode_fn(session) -> Callable:
    """Adapt an ``ExecutorSession`` to the uniform decode signature.
    ``params`` and ``cache`` pass through untouched — the session owns
    the resident weights and the live cache buffers."""
    def decode_fn(params, token, cache, pos):
        logits = session.step(
            torch.as_tensor(token).to(torch.int32).reshape(-1), int(pos))
        return logits, cache
    return decode_fn


def greedy_generate_compiled(session, prompts, n_new: int) -> torch.Tensor:
    """Greedy generation through a compiled decode session: the prompt
    is consumed step by step (warm-up program on the first token,
    steady-state program after), then ``n_new`` greedy tokens follow —
    every step against the session's resident weights and live caches.

    prompts: [B, S0] int (numpy or a tensor). Returns [B, S0 + n_new]
    int32 on the prompts' device (the CPU for numpy prompts).
    """
    prompts = torch.as_tensor(prompts).to(torch.int32)
    b, s0 = prompts.shape
    if b != session.spec.batch:
        raise ValueError(f"session is compiled for batch="
                         f"{session.spec.batch}, prompts have {b}")
    if s0 + n_new > session.spec.max_seq:
        raise ValueError(f"{s0} prompt + {n_new} new tokens exceed the "
                         f"session's max_seq={session.spec.max_seq}")
    session.reset()
    logits = None
    for t in range(s0):
        logits = session.step(prompts[:, t], t)
    new = []
    for i in range(n_new):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        new.append(tok[:, None].to(prompts.device))
        if i + 1 < n_new:
            logits = session.step(tok, s0 + i)
    return torch.cat([prompts] + new, dim=1)
