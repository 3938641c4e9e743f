"""Seamless-M4T-v2 backbone, an encoder-decoder transformer, in PyTorch.

The counterpart of ``repro.models.encdec``. As there, the speech
frontend is a stub: the encoder takes precomputed frame embeddings
[B, S_src, d_model] (what the real model's conformer feature extractor
would emit); the text decoder is a causal transformer with
cross-attention to the encoder memory.

Encoder: bidirectional self-attention + MLP. Decoder: causal
self-attention + cross-attention + MLP. Layers are stacked as in the
reference (a leading "layers" axis on every leaf) and walked by a
Python loop where the reference scans. Every ``blockwise_attention``
call is one flash-attention launch on the card: the encoder's
bidirectional self-attention, the decoder's causal one, and the
cross-attention (non-causal, Sq != Skv) both over the memory and, in a
decode step, over the static cross cache (Sq = 1, the kernel's decode
form). The decoder's self-attention in a decode step is the plain
``decode_attention`` over its cache, as in the reference.

Decode caches per decoder layer: self K/V (grows, written in place)
and cross K/V (computed once from the encoder memory by
``build_cross_cache``, static afterwards). As in the reference, the
engine's prefill leaves the self cache empty, so decode starts from it.

Entry points:
  param_specs / init / params_from_jax  — parameters
  encode / forward                      — memory, teacher-forced logits
  init_cache / build_cross_cache / decode_step — decoding
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding as S


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """The reference's ``EncDecConfig`` fields, dtypes as torch dtypes.
    ``remat="full"`` recomputes each encoder and decoder layer in the
    backward pass of a forward under grad mode, as the reference's
    ``jax.checkpoint`` does; serving runs the layers plainly.
    ``scan_unroll`` means nothing here."""
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_pad_multiple: int = 256
    rope_theta: float = 10000.0
    act: str = "relu"                    # seamless uses ReLU FFNs
    param_dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6
    remat: str = "none"
    scan_unroll: bool = False
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _attn_specs(cfg: EncDecConfig) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, hq * hd), ("embed", "heads"), dt),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wo": ParamSpec((hq * hd, d), ("heads", "embed"), dt),
    }


def _enc_layer_specs(cfg: EncDecConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "ln_attn": L.rmsnorm_spec(cfg.d_model, dt),
        "attn": _attn_specs(cfg),
        "ln_mlp": L.rmsnorm_spec(cfg.d_model, dt),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, dt),
    }


def _dec_layer_specs(cfg: EncDecConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "ln_self": L.rmsnorm_spec(cfg.d_model, dt),
        "self_attn": _attn_specs(cfg),
        "ln_cross": L.rmsnorm_spec(cfg.d_model, dt),
        "cross_attn": _attn_specs(cfg),
        "ln_mlp": L.rmsnorm_spec(cfg.d_model, dt),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, dt),
    }


def param_specs(cfg: EncDecConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), dt, "embed"),
        "enc_layers": L.stack_specs(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "ln_enc": L.rmsnorm_spec(cfg.d_model, dt),
        "dec_layers": L.stack_specs(_dec_layer_specs(cfg), cfg.n_dec_layers),
        "ln_dec": L.rmsnorm_spec(cfg.d_model, dt),
        "unembed": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab"), dt),
    }


def init(cfg: EncDecConfig, gen: torch.Generator) -> dict:
    """Random weights by the reference's laws, made on ``gen``'s
    device."""
    return L.init_params(param_specs(cfg), gen)


def abstract(cfg: EncDecConfig) -> dict:
    return L.abstract_params(param_specs(cfg))


def param_axes(cfg: EncDecConfig) -> dict:
    return L.param_axes_tree(param_specs(cfg))


def param_count(cfg: EncDecConfig) -> int:
    return L.param_count(param_specs(cfg))


def params_from_jax(tree: Any, device=torch.device("cuda"),
                    dtype: torch.dtype | None = None) -> dict:
    """The reference's ``encdec.init`` pytree as the port's parameters on
    ``device``, bit for bit unless ``dtype`` casts the floating
    leaves."""
    return L.tree_from_numpy(tree, device, dtype)


def _layer(params: dict, i: int) -> dict:
    return L.tree_map(lambda t: t[i], params)


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)
            ).expand(b, s)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


ACT_RES = ("batch", "act_res", None)
ACT_ALL = ("batch", None, None)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, H * D] -> [B, S, d_model]. The attention output is in the
    values' dtype: over the bf16 cross cache of an fp32 model it is
    bf16, and, as JAX's promotion does, it is widened before the
    product."""
    b, s = out.shape[:2]
    return out.reshape(b, s, -1).to(torch.promote_types(out.dtype,
                                                        wo.dtype)) @ wo


def _self_attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: EncDecConfig, causal: bool,
                    cache: dict | None = None, cache_len=None,
                    attn_mode: str = "auto") -> torch.Tensor:
    """Bidirectional (encoder) or causal (decoder) self-attention on the
    flash kernel; with ``cache``, one decode step written in place at
    ``cache_len`` and attended by the plain ``decode_attention``. On
    DTensors each rank runs its heads (``layers.sharded_attention``)."""
    s = x.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = S.with_logical_constraint(x, ACT_ALL)
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    cache_t = () if cache is None else (cache["k"], cache["v"])
    pos = positions[:1]
    idx = None if cache is None else int(cache_len)

    def body(q, k, v, sh, *c):
        bl, sl = q.shape[:2]
        q = L.apply_rope(q.reshape(bl, sl, -1, hd),
                         pos[:, sh.seq0:sh.seq0 + sl], cfg.rope_theta)
        k = L.apply_rope(k.reshape(bl, s, -1, hd), pos, cfg.rope_theta)
        v = v.reshape(bl, s, -1, hd)
        rep, hl = hq // hkv, q.shape[2]
        if not c:
            out = L.blockwise_attention(
                q, sh.kv_for(k, hl, rep), sh.kv_for(v, hl, rep),
                causal=causal, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                kv_offset=sh.seq0 if causal else 0, mode=attn_mode)
        else:
            L.cache_write(c[0], sh.cache_part(k, c[0].shape[2]), idx,
                          sh.cache_seq0)
            L.cache_write(c[1], sh.cache_part(v, c[1].shape[2]), idx,
                          sh.cache_seq0)
            h0 = sh.cache_head0
            out = L.decode_attention(q, sh.kv_for(c[0], hl, rep, h0),
                                     sh.kv_for(c[1], hl, rep, h0),
                                     kv_len=idx + s, kv_start=sh.cache_seq0,
                                     seq_groups=sh.seq_groups)
        return out.reshape(bl, sl, -1)

    out = L.sharded_attention(body, q, (k, v), hq=hq, hkv=hkv, dq=hd,
                              cache=cache_t, decode=cache is not None)
    return _out_proj(out, p["wo"])


def _cross_attention(p: dict, x: torch.Tensor, memory: torch.Tensor | None,
                     cfg: EncDecConfig, kv_cache: dict | None = None,
                     attn_mode: str = "auto") -> torch.Tensor:
    """Non-causal attention from the decoder to the encoder: K/V from
    ``memory`` [B, S_src, M] (train / prefill), or precomputed in
    ``kv_cache`` (decode). One flash launch either way. On DTensors each
    rank runs its heads; a cross cache split over its positions is
    gathered whole first."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = S.with_logical_constraint(x, ACT_ALL)
    q = x @ p["wq"]
    if kv_cache is not None:
        kv, cache_t = (), (kv_cache["k"], kv_cache["v"])
    else:
        memory = S.with_logical_constraint(memory, ACT_ALL)
        kv, cache_t = (memory @ p["wk"], memory @ p["wv"]), ()

    def body(q, *rest):
        bl, sl = q.shape[:2]
        q = q.reshape(bl, sl, -1, hd)
        rep, hl = hq // hkv, q.shape[2]
        if kv:
            sh = rest[2]
            k, v = (t.reshape(bl, t.shape[1], -1, hd) for t in rest[:2])
            k, v = sh.kv_for(k, hl, rep), sh.kv_for(v, hl, rep)
        else:
            sh, (k, v) = rest[0], rest[1:]
            for g in reversed(sh.seq_groups):
                k, v = (S.all_gather(t, 1, g) for t in (k, v))
            k = sh.kv_for(k, hl, rep, sh.cache_head0)
            v = sh.kv_for(v, hl, rep, sh.cache_head0)
        out = L.blockwise_attention(q, k, v, causal=False,
                                    q_chunk=cfg.q_chunk,
                                    kv_chunk=cfg.kv_chunk, mode=attn_mode)
        return out.reshape(bl, sl, -1)

    out = L.sharded_attention(body, q, kv, hq=hq, hkv=hkv, dq=hd,
                              cache=cache_t, decode=kv_cache is not None)
    return _out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# Encoder / decoder stacks
# ---------------------------------------------------------------------------


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h`` held at the reference's ``act_res`` (on DTensors)."""
    return S.with_logical_constraint(
        x + S.with_logical_constraint(h, ACT_RES), ACT_RES)


def encode(params: dict, frames: torch.Tensor, cfg: EncDecConfig,
           attn_mode: str = "auto") -> torch.Tensor:
    """frames: [B, S_src, d_model] precomputed frame embeddings (stub
    frontend), cast to the model dtype. Returns the encoder memory
    [B, S_src, d_model]."""
    b, s, _ = frames.shape
    positions = _positions(b, s, 0, frames.device)
    x = S.with_logical_constraint(frames.to(cfg.param_dtype), ACT_RES)
    for i in range(cfg.n_enc_layers):
        def inner(x, p=_layer(params["enc_layers"], i)):
            p = S.gather_params(p)
            x = _residual(x, _self_attention(
                p["attn"], L.rmsnorm(x, p["ln_attn"], cfg.norm_eps),
                positions, cfg, causal=False, attn_mode=attn_mode))
            return _residual(x, L.mlp_apply(
                p["mlp"], L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps), cfg.act))
        # the reference checkpoints a layer only for remat == "full"
        x = L.remat(inner, "full" if cfg.remat == "full" else "none")(x)
    return L.rmsnorm(x, params["ln_enc"], cfg.norm_eps)


def _decoder_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   memory: torch.Tensor, cfg: EncDecConfig,
                   attn_mode: str = "auto") -> torch.Tensor:
    for i in range(cfg.n_dec_layers):
        def inner(x, memory, p=_layer(params["dec_layers"], i)):
            p = S.gather_params(p)
            x = _residual(x, _self_attention(
                p["self_attn"], L.rmsnorm(x, p["ln_self"], cfg.norm_eps),
                positions, cfg, causal=True, attn_mode=attn_mode))
            x = _residual(x, _cross_attention(
                p["cross_attn"], L.rmsnorm(x, p["ln_cross"], cfg.norm_eps),
                memory, cfg, attn_mode=attn_mode))
            return _residual(x, L.mlp_apply(
                p["mlp"], L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps), cfg.act))
        x = L.remat(inner, "full" if cfg.remat == "full" else "none")(
            x, memory)
    return x


def _logits(params: dict, x: torch.Tensor, cfg: EncDecConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> torch.Tensor:
    x = L.rmsnorm(x, params["ln_dec"], cfg.norm_eps)
    x = S.with_logical_constraint(x, ACT_ALL)
    if last_only:
        x = x[:, -1:]
    logits = S.with_logical_constraint(
        (x @ S.gather_params(params["unembed"])).float(),
        ("batch", None, "vocab_act"))
    return logits[..., :cfg.vocab] if slice_vocab else logits


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return S.with_logical_constraint(
        S.vocab_parallel_embed(params["embed"], tokens), ACT_RES)


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: EncDecConfig, attn_mode: str = "auto",
            last_only: bool = False, slice_vocab: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward: encode ``frames``, then the decoder over
    ``tokens`` [B, S]. Returns (logits [B, S, vocab] fp32, aux = 0);
    ``last_only`` keeps the last position, ``slice_vocab=False`` the
    padded vocab."""
    memory = encode(params, frames, cfg, attn_mode)
    b, s = tokens.shape
    positions = _positions(b, s, 0, tokens.device)
    x = _decoder_stack(params, _embed(params, tokens), positions, memory,
                       cfg, attn_mode)
    return (_logits(params, x, cfg, last_only, slice_vocab),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: EncDecConfig, batch: int, max_tgt: int, src: int,
                dtype=torch.bfloat16) -> dict:
    """Per decoder layer, self K/V [B, max_tgt, Hkv, D] and cross K/V
    [B, src, Hkv, D] (which ``build_cross_cache`` replaces)."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "kv_seq", "act_kv_heads", None)
    layer = {
        name: {"k": ParamSpec((batch, n, hkv, hd), axes, dtype, "zeros"),
               "v": ParamSpec((batch, n, hkv, hd), axes, dtype, "zeros")}
        for name, n in (("self", max_tgt), ("cross", src))}
    return {"layers": L.stack_specs(layer, cfg.n_dec_layers)}


def init_cache(cfg: EncDecConfig, batch: int, max_tgt: int, src: int,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> dict:
    return L.init_constants(cache_specs(cfg, batch, max_tgt, src, dtype),
                            device)


def build_cross_cache(params: dict, memory: torch.Tensor, cfg: EncDecConfig,
                      cache: dict, dtype=torch.bfloat16) -> dict:
    """The static cross-attention K/V of every decoder layer from the
    encoder memory, in ``dtype`` (bf16 by default, as in the reference,
    whatever the model's dtype). Returns a new cache whose cross K/V are
    [n_dec, B, S_src, Hkv, D], the memory's length; the self K/V are the
    given cache's tensors. On DTensors the cross K/V take the cache
    rules' layout ``("batch", "kv_seq", "act_kv_heads", None)``."""
    b, src, _ = memory.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    p = S.gather_params(params["dec_layers"]["cross_attn"])
    memory = S.with_logical_constraint(memory, ACT_ALL)
    ks, vs = ([_cache_layout((memory @ w[i]), b, src, hkv, hd, dtype)
               for i in range(cfg.n_dec_layers)] for w in (p["wk"], p["wv"]))
    layers = dict(cache["layers"])
    layers["cross"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return {**cache, "layers": layers}


def _cache_layout(t: torch.Tensor, b: int, src: int, hkv: int, hd: int,
                  dtype) -> torch.Tensor:
    """[B, S, Hkv * D] as a cross cache entry [B, S, Hkv, D] in
    ``dtype``; on DTensors in the cache rules' layout (the reshape on
    local columns that hold whole heads)."""
    if not S.is_dtensor(t):
        return t.reshape(b, src, hkv, hd).to(dtype)
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    want = S.spec_placements(("batch", "kv_seq", "act_kv_heads", None),
                             (b, src, hkv, hd), mesh)
    src_pl = tuple(Shard(2) if p == Shard(2) else
                   (Shard(0) if p == Shard(0) else Replicate())
                   for p in want)
    whole = S.local_region(
        lambda x: x.reshape(x.shape[0], x.shape[1], -1, hd).to(dtype),
        mesh, [t], [src_pl], src_pl)
    return S.with_logical_constraint(
        whole, ("batch", "kv_seq", "act_kv_heads", None))


def decode_step(params: dict, token: torch.Tensor, cache: dict, cache_len,
                cfg: EncDecConfig, attn_mode: str = "auto"
                ) -> tuple[torch.Tensor, dict]:
    """One decoder token [B, 1]; the cross K/V must already be in the
    cache. Returns (logits [B, vocab], cache), the self K/V written in
    place at ``cache_len``. Each layer's cross-attention is one flash
    launch (the decode form) on the card."""
    b = token.shape[0]
    idx = int(cache_len)
    positions = _positions(b, 1, idx, token.device)
    x = _embed(params, token)
    for i in range(cfg.n_dec_layers):
        p = S.gather_params(_layer(params["dec_layers"], i))
        c = _layer(cache["layers"], i)
        x = _residual(x, _self_attention(
            p["self_attn"], L.rmsnorm(x, p["ln_self"], cfg.norm_eps),
            positions, cfg, causal=True, cache=c["self"], cache_len=idx))
        x = _residual(x, _cross_attention(
            p["cross_attn"], L.rmsnorm(x, p["ln_cross"], cfg.norm_eps),
            None, cfg, kv_cache=c["cross"], attn_mode=attn_mode))
        x = _residual(x, L.mlp_apply(
            p["mlp"], L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps), cfg.act))
    return _logits(params, x, cfg)[:, 0], cache
