"""Decoder-only LM of the dense, MoE, MLA and VLM families, in PyTorch.

The counterpart of ``repro.models.lm`` (llama3.2-1b, qwen3-8b,
gemma-7b, yi-34b, qwen3-moe-235b-a22b, deepseek-v2-236b, qwen2-vl-2b):
GQA or MHA, qk-norm after the head split (qwen3), the silu or gelu
gated MLP (gemma's GeGLU) or, with ``moe`` set, the MoE layer
(``layers.moe_apply``; ``forward`` sums its load-balance and z-loss
``aux``) on every layer after an optional dense prefix
(``n_dense_prefix`` layers of ``d_ff_dense``, deepseek's first),
DeepSeek-V2's multi-head latent attention (``mla``: low-rank q and kv
projections, 192-wide keys of 128 + 64 rotary columns over 128-wide
values, a compressed cache of [B, S, kv_lora + rope] a layer and the
absorbed decode), Qwen2-VL's M-RoPE (``mrope_sections``; text
positions drive all three components), precomputed frontend
embeddings added to the token embedding (``extra_embed``), tied
embeddings and the int8 KV cache (``kv_cache_quant``: prefill
calibrates per-head scales, decode clips into them). With
``hetero_quant`` set, every attention projection runs the reference's
hybrid fake-quant forward (paper §4, QAT form; the launcher's
``--quantize``). Layers are stacked as in the reference (a leading
"layers" axis on every leaf, the dense prefix a list of unstacked
layers) and walked by a Python loop where the reference scans. Prefill
attention runs on the flash-attention kernel (MLA's at key size 192,
value size 128); decode attention is plain torch over the cache.

Entry points:
  param_specs / init / params_from_jax  — parameters
  param_count / active_param_count      — sizes (from the specs alone)
  forward(params, tokens, cfg)          — causal logits over a prompt
  init_cache / prefill / decode_step    — KV-cache serving
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding as S
from repro_torch.quant.hybrid import LayerQuantConfig
from repro_torch.quant.uniform import fit_scale, qrange


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora: int = 512
    q_lora: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class HeteroQuantConfig:
    """Paper §4/§5 knobs applied to every projection of the LM."""
    w_bits_lut: int = 4
    a_bits: int = 4
    ratio: float = 0.5         # columns on the flexible (bitplane) path

    def layer_cfg(self) -> LayerQuantConfig:
        return LayerQuantConfig(w_bits_lut=self.w_bits_lut,
                                a_bits=self.a_bits, ratio=self.ratio)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields, dtypes as torch dtypes.

    ``remat`` ("none" | "full" | "dots") checkpoints each layer of a
    forward under grad mode, as the reference's ``jax.checkpoint`` does
    (:func:`_remat_wrap`); serving, outside grad mode, runs it plainly.
    ``scan_unroll`` and ``dense_attn_max`` are kept so configs read the
    same; ``scan_unroll`` means nothing here (layers are a Python loop).
    """
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    vocab_pad_multiple: int = 256
    rope_theta: float = 10000.0
    qk_norm: bool = False                 # qwen3
    act: str = "silu"                     # gemma: "gelu" (GeGLU)
    moe: Any = None
    n_dense_prefix: int = 0               # deepseek: 1 dense layer first
    d_ff_dense: int | None = None         # ff of the dense-prefix layers
    mla: MLAConfig | None = None
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl
    tie_embeddings: bool = False          # gemma / llama3.2 / qwen2-vl
    hetero_quant: Any = None
    param_dtype: torch.dtype = torch.bfloat16
    norm_eps: float = 1e-6
    remat: str = "none"
    scan_unroll: bool = False
    kv_cache_quant: bool = False
    dense_attn_max: int = 8192            # dense softmax below, blockwise above
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def qk_dim(self) -> int:
        if self.mla:
            return self.mla.qk_nope_dim + self.mla.qk_rope_dim
        return self.head_dim

    @property
    def v_head_dim(self) -> int:
        return self.mla.v_dim if self.mla else self.head_dim


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _attn_specs(cfg: LMConfig) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    if cfg.mla:
        a, h = cfg.mla, cfg.n_heads
        return {
            "wq_a": ParamSpec((d, a.q_lora), ("embed", None), dt),
            "q_norm": L.rmsnorm_spec(a.q_lora, dt),
            "wq_b": ParamSpec((a.q_lora, h * (a.qk_nope_dim + a.qk_rope_dim)),
                              (None, "heads"), dt, fan_in=a.q_lora),
            "wkv_a": ParamSpec((d, a.kv_lora + a.qk_rope_dim),
                               ("embed", None), dt),
            "kv_norm": L.rmsnorm_spec(a.kv_lora, dt),
            "wkv_b": ParamSpec((a.kv_lora, h * (a.qk_nope_dim + a.v_dim)),
                               (None, "heads"), dt, fan_in=a.kv_lora),
            "wo": ParamSpec((h * a.v_dim, d), ("heads", "embed"), dt),
        }
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, hq * hd), ("embed", "heads"), dt),
        "wk": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wv": ParamSpec((d, hkv * hd), ("embed", "kv_heads"), dt),
        "wo": ParamSpec((hq * hd, d), ("heads", "embed"), dt),
    }
    if cfg.qk_norm:
        specs["q_norm"] = L.rmsnorm_spec(hd, dt)
        specs["k_norm"] = L.rmsnorm_spec(hd, dt)
    return specs


def _layer_specs(cfg: LMConfig, moe_layer: bool) -> dict:
    d, dt = cfg.d_model, cfg.param_dtype
    specs = {
        "ln_attn": L.rmsnorm_spec(d, dt),
        "attn": _attn_specs(cfg),
        "ln_mlp": L.rmsnorm_spec(d, dt),
    }
    if moe_layer and cfg.moe is not None:
        specs["moe"] = L.moe_specs(d, cfg.moe, dt)
    else:
        specs["mlp"] = L.mlp_specs(d, cfg.d_ff_dense or cfg.d_ff, dt)
    return specs


def param_specs(cfg: LMConfig) -> dict:
    """The reference's tree: the scanned stack holds the ``n_layers -
    n_dense_prefix`` MoE (or dense) layers, ``dense_prefix`` a list of
    the dense layers that run first."""
    if cfg.act not in L.ACTIVATIONS:
        raise ValueError(f"{cfg.name}: unknown activation {cfg.act!r}; "
                         f"have {sorted(L.ACTIVATIONS)}")
    dt = cfg.param_dtype
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), dt, "embed"),
        "layers": L.stack_specs(_layer_specs(cfg, moe_layer=True),
                                cfg.n_layers - cfg.n_dense_prefix),
        "ln_f": L.rmsnorm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"), dt)
    if cfg.n_dense_prefix:
        specs["dense_prefix"] = [_layer_specs(cfg, moe_layer=False)
                                 for _ in range(cfg.n_dense_prefix)]
    return specs


def init(cfg: LMConfig, gen: torch.Generator) -> dict:
    """Random weights by the reference's laws, made on ``gen``'s device
    (no host copy of the 1.24 B numbers of llama3.2-1b)."""
    return L.init_params(param_specs(cfg), gen)


def abstract(cfg: LMConfig) -> dict:
    return L.abstract_params(param_specs(cfg))


def param_axes(cfg: LMConfig) -> dict:
    return L.param_axes_tree(param_specs(cfg))


def param_count(cfg: LMConfig) -> int:
    return L.param_count(param_specs(cfg))


def active_param_count(cfg: LMConfig) -> int:
    """Parameters touched per token (MoE: top_k + shared experts only;
    the dense prefix has none to leave out)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    expert_params = 3 * cfg.d_model * cfg.moe.d_ff     # gate/up/down
    n_scan = cfg.n_layers - cfg.n_dense_prefix
    return total - n_scan * (e - k) * expert_params


def params_from_jax(tree: Any, device=torch.device("cuda"),
                    dtype: torch.dtype | None = None) -> dict:
    """The reference's ``lm.init`` pytree (nested dicts of numpy or JAX
    arrays, the layer axis stacked; an MoE layer's ``moe`` subtree with
    its fp32 router; a ``dense_prefix`` list) as the port's parameters on
    ``device``: the same structure and, unless ``dtype`` casts the
    floating leaves, the same bits."""
    return L.tree_from_numpy(tree, device, dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """Projection with optional hybrid fake-quant (paper §4, QAT form),
    cast for cast the reference's: fp32 quantization, the weight
    rounded back to its dtype before the product, straight-through
    forms. Every division is by a tensor on ``x``'s device (IEEE
    division on the card too)."""
    hq = cfg.hetero_quant
    if hq is None:
        return x @ w
    if S.is_dtensor(x):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid fake-quant projection has no "
            f"tensor-parallel form (it takes per-column maxima of whole "
            f"weights); run it on one device")
    out = w.shape[-1]
    n_serial = int(round(hq.ratio * out))
    # Column split without data-dependent permutation (the KL allocation
    # is applied at deploy time; the boundary is static).
    is_serial = torch.arange(out, device=w.device) < n_serial

    def fq_w(w, bits):
        hi = 2 ** (bits - 1) - 1
        lim = torch.amax(torch.abs(w), dim=0, keepdim=True)
        s = torch.clamp(lim.float(), min=1e-8) / torch.tensor(
            float(hi), dtype=torch.float32, device=w.device)
        q = torch.clamp(torch.round(w.float() / s), -(hi + 1), hi) * s
        return w + (q.to(w.dtype) - w).detach()

    w_q = torch.where(is_serial[None, :], fq_w(w, hq.w_bits_lut),
                      fq_w(w, 4))
    s_a = fit_scale(x.detach().float(), hq.a_bits)
    lo, hi = qrange(hq.a_bits)
    x_q = torch.clamp(torch.round(x.float() / s_a), lo, hi) * s_a
    x_q = x + (x_q.to(x.dtype) - x).detach()
    return x_q @ w_q


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters (views into the stacked leaves)."""
    return L.tree_map(lambda t: t[i], params)


ACT_RES = ("batch", "act_res", None)


def _attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: LMConfig, cache: dict | None = None,
               cache_len: int | None = None, attn_mode: str = "auto"
               ) -> torch.Tensor:
    """Self-attention: full causal when ``cache`` is None, else a
    prefill (S > 1) or one decode step writing at ``cache_len``; the
    cache (with an int8 cache, its scales too) is updated in place.
    On DTensors the attention runs on each rank's heads (or query rows),
    ``layers.sharded_attention``: the reference's q / k / cache / out
    constraints."""
    if cfg.mla:
        return _mla_attention(p, x, positions, cfg, cache, cache_len,
                              attn_mode)
    s = x.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = S.with_logical_constraint(x, ("batch", None, None))
    q, k, v = (_proj(x, p[w], cfg) for w in ("wq", "wk", "wv"))
    norms = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else ()
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_cache_quant else \
        ("k", "v")
    cache_t = () if cache is None else tuple(cache[n] for n in names)
    pos = positions[:1]                    # every row is the same
    idx = None if cache is None else int(cache_len)

    def body(q, k, v, sh, *rest):
        nl = rest[:len(norms)]
        c = rest[len(norms):]
        bl, sl = q.shape[:2]
        q = q.reshape(bl, sl, -1, hd)
        k = k.reshape(bl, s, -1, hd)
        v = v.reshape(bl, s, -1, hd)
        if nl:
            q = L.rmsnorm(q, nl[0], cfg.norm_eps)
            k = L.rmsnorm(k, nl[1], cfg.norm_eps)
        q_pos = pos[:, sh.seq0:sh.seq0 + sl]
        if cfg.mrope_sections:
            # text positions drive all three (t, h, w) components
            q = L.apply_mrope(q, q_pos[None].expand(3, *q_pos.shape),
                              cfg.mrope_sections, cfg.rope_theta)
            k = L.apply_mrope(k, pos[None].expand(3, *pos.shape),
                              cfg.mrope_sections, cfg.rope_theta)
        else:
            q = L.apply_rope(q, q_pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
        rep = hq // hkv
        hl = q.shape[2]
        if not c:
            kk, vv = sh.kv_for(k, hl, rep), sh.kv_for(v, hl, rep)
            if s <= cfg.dense_attn_max:
                out = L.dense_attention(q, kk, vv, causal=True,
                                        kv_offset=sh.seq0)
            else:
                out = L.blockwise_attention(q, kk, vv, causal=True,
                                            q_chunk=cfg.q_chunk,
                                            kv_chunk=cfg.kv_chunk,
                                            kv_offset=sh.seq0,
                                            mode=attn_mode)
            return out.reshape(bl, sl, -1)
        ck, cv = c[0], c[1]
        k_new, v_new = sh.cache_part(k, ck.shape[2]), \
            sh.cache_part(v, cv.shape[2])
        k_sc = v_sc = None
        if cfg.kv_cache_quant:
            if s > 1:  # prefill calibrates the per-head scales
                c[2].copy_(L.kv_scale_from(k_new))
                c[3].copy_(L.kv_scale_from(v_new))
            # decode clips into the prefill-calibrated scales
            k_sc, v_sc = c[2], c[3]
            k_new = L.quantize_kv(k_new, k_sc)
            v_new = L.quantize_kv(v_new, v_sc)
        L.cache_write(ck, k_new, idx, sh.cache_seq0)
        L.cache_write(cv, v_new, idx, sh.cache_seq0)
        if s == 1:
            h0 = sh.cache_head0
            ks, vs = sh.kv_for(ck, hl, rep, h0), sh.kv_for(cv, hl, rep, h0)
            if k_sc is not None:
                k_sc = sh.kv_for(k_sc[:, None], hl, rep, h0)[:, 0]
                v_sc = sh.kv_for(v_sc[:, None], hl, rep, h0)[:, 0]
            out = L.decode_attention(q, ks, vs, kv_len=idx + s,
                                     k_scale=k_sc, v_scale=v_sc,
                                     kv_start=sh.cache_seq0,
                                     seq_groups=sh.seq_groups)
        else:
            # prefill: attend within the freshly written prompt
            out = L.blockwise_attention(q, sh.kv_for(k, hl, rep),
                                        sh.kv_for(v, hl, rep), causal=True,
                                        q_chunk=cfg.q_chunk,
                                        kv_chunk=cfg.kv_chunk,
                                        kv_offset=sh.seq0, mode=attn_mode)
        return out.reshape(bl, sl, -1)

    out = L.sharded_attention(body, q, (k, v), hq=hq, hkv=hkv, dq=hd,
                              extras=norms, cache=cache_t,
                              decode=cache is not None and s == 1)
    return _proj(out, p["wo"], cfg)


def _mla_attention(p: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: LMConfig, cache: dict | None, cache_len,
                   attn_mode: str = "auto") -> torch.Tensor:
    """DeepSeek-V2 MLA. The full form (no cache, and the prefill, which
    first writes the compressed cache ``c`` / ``k_rope`` in place)
    expands the latent into per-head keys [B, S, H, 192] and values
    [B, S, H, 128] and attends on the flash kernel at scale 192^-0.5;
    the absorbed decode scores and reads in the compressed space with
    fp32 einsums over the cache, as the reference does (no kernel). On
    DTensors each rank runs its heads (the latent and the cache are
    whole over "model", unless ``kv_seq`` splits the cache's
    positions)."""
    a = cfg.mla
    s = x.shape[1]
    h = cfg.n_heads
    dqk = a.qk_nope_dim + a.qk_rope_dim
    scale = dqk ** -0.5
    x = S.with_logical_constraint(x, ("batch", None, None))
    q = _proj(L.rmsnorm(_proj(x, p["wq_a"], cfg), p["q_norm"], cfg.norm_eps),
              p["wq_b"], cfg)                              # [B,S,H*192]
    ckv = _proj(x, p["wkv_a"], cfg)                        # [B,S,lora+rope]
    c, k_rope = torch.split(ckv, [a.kv_lora, a.qk_rope_dim], dim=-1)
    c = L.rmsnorm(c, p["kv_norm"], cfg.norm_eps)
    decode = cache is not None and s == 1
    kv = () if decode else (c @ p["wkv_b"],)               # [B,S,H*256]
    cache_t = () if cache is None else (cache["c"], cache["k_rope"])
    extras = (c, k_rope) + ((p["wkv_b"],) if decode else ())
    pos = positions[:1]
    idx = None if cache is None else int(cache_len)

    def body(q, *rest):
        kv_l = rest[:len(kv)]
        sh = rest[len(kv)]
        c, k_rope = rest[len(kv) + 1:len(kv) + 3]
        c_cache = rest[len(kv) + 3 + decode:]
        bl, sl = q.shape[:2]
        q = q.reshape(bl, sl, -1, dqk)
        hl = q.shape[2]
        q_nope, q_rope = torch.split(q, [a.qk_nope_dim, a.qk_rope_dim],
                                     dim=-1)
        q_rope = L.apply_rope(q_rope, pos[:, sh.seq0:sh.seq0 + sl],
                              cfg.rope_theta)
        k_rope = L.apply_rope(k_rope[:, :, None, :], pos, cfg.rope_theta)
        if c_cache:
            L.cache_write(c_cache[0], c, idx, sh.cache_seq0)
            L.cache_write(c_cache[1], k_rope[:, :, 0, :], idx,
                          sh.cache_seq0)
        if not decode:
            kvl = sh.kv_for(kv_l[0].reshape(bl, s, -1,
                                            a.qk_nope_dim + a.v_dim), hl, 1)
            k_nope, v = torch.split(kvl, [a.qk_nope_dim, a.v_dim], dim=-1)
            k = torch.cat([k_nope, k_rope.expand(bl, s, hl, a.qk_rope_dim)],
                          dim=-1)
            qf = torch.cat([q_nope, q_rope], dim=-1)
            out = L.blockwise_attention(qf, k, v, causal=True,
                                        q_chunk=cfg.q_chunk,
                                        kv_chunk=cfg.kv_chunk,
                                        kv_offset=sh.seq0,
                                        softmax_scale=scale, mode=attn_mode)
            return out.reshape(bl, sl, -1)
        # Absorbed decode: score and read directly in the compressed space.
        wkv_b = rest[len(kv) + 3].reshape(a.kv_lora, h,
                                          a.qk_nope_dim + a.v_dim)
        wkv_b = wkv_b[:, sh.q_head0:sh.q_head0 + hl]
        c_all, r_all = c_cache[0].float(), c_cache[1].float()
        wk, wv = torch.split(wkv_b.float(), [a.qk_nope_dim, a.v_dim], dim=-1)
        q_c = torch.einsum("bqhd,chd->bqhc", q_nope.float(), wk)
        s_c = torch.einsum("bqhc,bkc->bhqk", q_c, c_all)
        s_r = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), r_all)
        logits = (s_c + s_r) * scale
        mask = sh.cache_seq0 + torch.arange(c_all.shape[1],
                                            device=q.device) >= idx + s
        logits = logits.masked_fill(mask, L.NEG_INF)
        if not sh.seq_groups:
            pattn = torch.softmax(logits, dim=-1)
        else:
            e = torch.exp(logits - L.reduce_over(
                torch.amax(logits, -1, keepdim=True), sh.seq_groups, "max"))
            pattn = e / L.reduce_over(torch.sum(e, -1, keepdim=True),
                                      sh.seq_groups)
        o_c = L.reduce_over(torch.einsum("bhqk,bkc->bqhc", pattn, c_all),
                            sh.seq_groups)
        out = torch.einsum("bqhc,chd->bqhd", o_c, wv).to(q.dtype)
        return out.reshape(bl, sl, -1)

    out = L.sharded_attention(body, q, kv, hq=h, hkv=h, dq=dqk,
                              extras=extras, cache=cache_t, decode=decode)
    return _proj(out, p["wo"], cfg)


def _layer_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: LMConfig, cache: dict | None = None, cache_len=None,
                 attn_mode: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Pre-norm block. Returns (x, aux loss: the MoE layer's, else 0);
    the layer's cache, if any, is updated in place. On DTensors the
    layer's weights are gathered over the batch axes first and the
    residual stream is held at the reference's ``act_res``."""
    p = S.gather_params(p)
    h_attn = _attention(p["attn"], L.rmsnorm(x, p["ln_attn"], cfg.norm_eps),
                        positions, cfg, cache, cache_len, attn_mode)
    x = S.with_logical_constraint(
        x + S.with_logical_constraint(h_attn, ACT_RES), ACT_RES)
    h_norm = L.rmsnorm(x, p["ln_mlp"], cfg.norm_eps)
    if "moe" in p:
        h_ffn, aux = L.moe_apply(p["moe"], h_norm, cfg.moe, cfg.act)
    else:
        h_ffn, aux = L.mlp_apply(p["mlp"], h_norm, cfg.act), 0.0
    x = S.with_logical_constraint(
        x + S.with_logical_constraint(h_ffn, ACT_RES), ACT_RES)
    return x, aux


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> torch.Tensor:
    """Final norm and (tied) unembedding in the model dtype, then fp32,
    sliced from the padded vocab to ``vocab`` unless ``slice_vocab`` is
    False (the loss masks the padded columns instead: slicing a
    vocab-sharded DTensor gathers it); ``last_only`` keeps the last
    position. On DTensors the logits are constrained to the reference's
    ``("batch", None, "vocab_act")``."""
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    x = S.with_logical_constraint(x, ("batch", None, None))
    if last_only:
        x = x[:, -1:]
    unembed = S.gather_params(params["embed"].T if cfg.tie_embeddings
                              else params["unembed"])
    logits = S.with_logical_constraint((x @ unembed).float(),
                                       ("batch", None, "vocab_act"))
    return logits[..., :cfg.vocab] if slice_vocab else logits


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(s, dtype=torch.int32, device=device)
            ).expand(b, s)


def _embed(params: dict, tokens: torch.Tensor,
           extra_embed: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings, plus a frontend's precomputed [B, S, d_model]
    embeddings (patches, frames) where given, cast to the model dtype.
    On DTensors the lookup is vocab-parallel and the result is held at
    ``act_res``."""
    x = S.with_logical_constraint(
        S.vocab_parallel_embed(params["embed"], tokens), ACT_RES)
    if extra_embed is not None:
        x = x + S.with_logical_constraint(extra_embed.to(x.dtype), ACT_RES)
    return x


def _remat_wrap(fn, cfg: LMConfig):
    """A layer's body under ``cfg.remat``: ``"full"`` recomputes it in the
    backward pass, ``"dots"`` keeps its matrix products' outputs and
    recomputes the rest (``layers.remat``)."""
    return L.remat(fn, cfg.remat)


def _stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
           cfg: LMConfig, cache: dict | None = None, cache_len=None,
           attn_mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """The dense-prefix layers, then the stacked ones, each with its
    cache if there is one, each under ``cfg.remat`` when there is none.
    Returns (x, the MoE layers' aux loss summed)."""
    aux = 0.0
    blocks = [(params["dense_prefix"][i],
               None if cache is None else cache["dense_prefix"][i])
              for i in range(cfg.n_dense_prefix)]
    blocks += [(_layer(params["layers"], i),
                None if cache is None else _layer(cache["layers"], i))
               for i in range(cfg.n_layers - cfg.n_dense_prefix)]
    for p_layer, c_layer in blocks:
        if c_layer is None:
            def body(x, p=p_layer):
                return _layer_apply(p, x, positions, cfg,
                                    attn_mode=attn_mode)
            x, aux_i = _remat_wrap(body, cfg)(x)
        else:
            x, aux_i = _layer_apply(p_layer, x, positions, cfg, c_layer,
                                    cache_len, attn_mode)
        aux = aux + aux_i
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            extra_embed: torch.Tensor | None = None,
            attn_mode: str = "auto", last_only: bool = False,
            slice_vocab: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal logits over a prompt, no cache. tokens: [B, S] int;
    ``extra_embed`` [B, S, d_model] is added to the token embedding.
    Returns (logits [B, S, vocab] fp32, aux loss: the MoE layers' load
    balance and z-loss summed, 0 for a dense config); ``last_only``
    keeps the last position, ``slice_vocab=False`` the padded vocab.
    Only MLA's attention runs on the flash kernel here (the others' is
    the full-softmax ``dense_attention`` below 8192 tokens, as in the
    reference)."""
    b, s = tokens.shape
    positions = _positions(b, s, 0, tokens.device)
    x, aux = _stack(params, _embed(params, tokens, extra_embed), positions,
                    cfg, attn_mode=attn_mode)
    return _logits(params, x, cfg, last_only, slice_vocab), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def cache_specs(cfg: LMConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16) -> dict:
    """K / V [B, max_seq, Hkv, D] a layer; with ``kv_cache_quant`` int8
    codes and fp32 per-(batch, head) scales [B, Hkv], initialised to 1;
    with MLA the compressed latent ``c`` [B, max_seq, kv_lora] and the
    rotary key ``k_rope`` [B, max_seq, rope]. The dense prefix's layers
    are a list beside the stack, as in the parameters."""
    if cfg.mla:
        a = cfg.mla
        axes = ("batch", "kv_seq", None)
        layer = {"c": ParamSpec((batch, max_seq, a.kv_lora), axes, dtype,
                                "zeros"),
                 "k_rope": ParamSpec((batch, max_seq, a.qk_rope_dim), axes,
                                     dtype, "zeros")}
    else:
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kv_dt = torch.int8 if cfg.kv_cache_quant else dtype
        axes = ("batch", "kv_seq", "act_kv_heads", None)
        layer = {"k": ParamSpec(shape, axes, kv_dt, "zeros"),
                 "v": ParamSpec(shape, axes, kv_dt, "zeros")}
        if cfg.kv_cache_quant:
            for name in ("k_scale", "v_scale"):
                layer[name] = ParamSpec((batch, cfg.n_kv_heads),
                                        ("batch", "act_kv_heads"),
                                        torch.float32, "ones")
    specs = {"layers": L.stack_specs(layer, cfg.n_layers - cfg.n_dense_prefix)}
    if cfg.n_dense_prefix:
        specs["dense_prefix"] = [dict(layer)
                                 for _ in range(cfg.n_dense_prefix)]
    return specs


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> dict:
    return L.init_constants(cache_specs(cfg, batch, max_seq, dtype), device)


def prefill(params: dict, tokens: torch.Tensor, cache: dict, cfg: LMConfig,
            extra_embed: torch.Tensor | None = None,
            attn_mode: str = "auto", last_only: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """Score the prompt AND fill the KV cache (positions [0, S)).

    Returns (logits [B, S, vocab], or [B, 1, vocab] with ``last_only``,
    cache); the cache is written in place. Subsequent ``decode_step``
    calls continue from cache_len = S. Each layer's attention is one
    flash-attention launch on the card (on each rank's heads, on a
    mesh).
    """
    b, s = tokens.shape
    positions = _positions(b, s, 0, tokens.device)
    x, _ = _stack(params, _embed(params, tokens, extra_embed), positions,
                  cfg, cache, 0, attn_mode)
    return _logits(params, x, cfg, last_only), cache


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cache_len: int, cfg: LMConfig,
                extra_embed: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. token: [B, 1] int; returns (logits [B, vocab],
    cache), the cache written in place at ``cache_len`` (the number of
    valid positions before this token)."""
    b = token.shape[0]
    idx = int(cache_len)
    positions = _positions(b, 1, idx, token.device)
    x, _ = _stack(params, _embed(params, token, extra_embed), positions,
                  cfg, cache, idx)
    return _logits(params, x, cfg)[:, 0], cache
