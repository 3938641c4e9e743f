"""Jamba-style hybrid LM: Mamba + attention interleaved 1:7, with MoE,
in PyTorch.

The counterpart of ``repro.models.hybrid``. Structure (period of 8
layers, Jamba's attention-to-Mamba ratio):

    [mamba, mamba, mamba, ATTN, mamba, mamba, mamba, mamba]

Every layer is followed by an FFN; MoE replaces the dense MLP on every
second layer (odd in-period indices). The parameter tree is the
reference's: periods stacked on the leading axis and, within a period,
the Mamba, MoE and MLP sublayers stacked over a second one, so
:func:`params_from_jax` carries the reference's weights across leaf for
leaf. Periods and sublayers are walked by Python loops where the
reference scans. The attention sublayer is ``lm._attention`` on
:meth:`HybridConfig.as_lm`: the full-softmax ``dense_attention`` over a
prompt (below 8192 tokens, as in the reference, so the forward launches
no kernel of the port), and a decode step over the cache. The Mamba
sublayers are ``ssm.block_apply``.

Decode carries a hybrid cache per period: 7 recurrent SSD states and
conv windows, and 1 KV cache, all updated in place. The compiler also
walks a ``HybridConfig`` into projection GEMMs (``compiler/networks.py``)
and the decode sessions run them with their own glue
(``compiler/runtime/session.py``).

Entry points:
  param_specs / init / params_from_jax  — parameters
  param_count / active_param_count      — sizes (from the specs alone)
  forward(params, tokens, cfg)          — causal logits and MoE aux loss
  init_cache / decode_step              — hybrid-cache decoding
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.models import lm as lm_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import MoEConfig, ParamSpec
from repro_torch.parallel import sharding as S

PERIOD = 8
ATTN_POS = 3            # in-period index of the attention layer
MOE_POS = (1, 3, 5, 7)  # in-period indices with MoE FFN (every 2nd layer)


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


# ---------------------------------------------------------------------------
# Param specs (one period, stacked over periods)
# ---------------------------------------------------------------------------


def _period_specs(cfg: HybridConfig) -> dict:
    dt = cfg.param_dtype
    n_moe = len(MOE_POS)
    return {
        "mamba": L.stack_specs(
            {"ln": L.rmsnorm_spec(cfg.d_model, dt),
             "ssm": ssm_mod.block_specs(cfg.ssm, dt)}, PERIOD - 1,
            axis_name="sublayers"),
        "attn": {"ln": L.rmsnorm_spec(cfg.d_model, dt),
                 "attn": lm_mod._attn_specs(cfg.as_lm())},
        "moe": L.stack_specs(
            {"ln": L.rmsnorm_spec(cfg.d_model, dt),
             "ffn": L.moe_specs(cfg.d_model, cfg.moe, dt)}, n_moe,
            axis_name="sublayers"),
        "mlp": L.stack_specs(
            {"ln": L.rmsnorm_spec(cfg.d_model, dt),
             "ffn": L.mlp_specs(cfg.d_model, cfg.d_ff, dt)}, PERIOD - n_moe,
            axis_name="sublayers"),
    }


def param_specs(cfg: HybridConfig) -> dict:
    dt = cfg.param_dtype
    return {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), dt, "embed"),
        "periods": L.stack_specs(_period_specs(cfg), cfg.n_periods),
        "ln_f": L.rmsnorm_spec(cfg.d_model, dt),
        "unembed": ParamSpec((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab"), dt),
    }


def init(cfg: HybridConfig, gen: torch.Generator) -> dict:
    """Random weights by the reference's laws on ``gen``'s device (the
    Mamba sublayers' ``a_log`` and ``dt_bias`` zeros, as the reference's
    hybrid leaves them)."""
    return L.init_params(param_specs(cfg), gen)


def abstract(cfg: HybridConfig) -> dict:
    return L.abstract_params(param_specs(cfg))


def param_axes(cfg: HybridConfig) -> dict:
    return L.param_axes_tree(param_specs(cfg))


def param_count(cfg: HybridConfig) -> int:
    return L.param_count(param_specs(cfg))


def active_param_count(cfg: HybridConfig) -> int:
    total = param_count(cfg)
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    expert_params = 3 * cfg.d_model * cfg.moe.d_ff
    return total - cfg.n_periods * len(MOE_POS) * (e - k) * expert_params


def params_from_jax(tree: Any, device=torch.device("cuda"),
                    dtype: torch.dtype | None = None) -> dict:
    """The reference's ``hybrid.init`` pytree (periods, then sublayers,
    stacked) as the port's parameters on ``device``: the same structure
    and, unless ``dtype`` casts the floating leaves, the same bits."""
    return L.tree_from_numpy(tree, device, dtype)


# ---------------------------------------------------------------------------
# Period body
# ---------------------------------------------------------------------------


def _period_apply(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: HybridConfig, cache: dict | None = None,
                  cache_len=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One period's 8 sublayers. Returns (x, the MoE sublayers' aux loss
    summed); the period's cache, if any, is updated in place. On
    DTensors the period's weights are gathered over the batch axes first
    and the residual stream is held at the reference's ``act_res`` after
    each sublayer (the attention, Mamba and MoE pieces are
    ``lm``'s, ``ssm``'s and ``layers``' tensor-parallel forms)."""
    lm_cfg = cfg.as_lm()
    p = S.gather_params(p)
    aux = 0.0
    i_mamba = i_moe = i_mlp = 0
    for pos in range(PERIOD):
        # ---- token mixer
        if pos == ATTN_POS:
            pa = p["attn"]
            h = lm_mod._attention(
                pa["attn"], L.rmsnorm(x, pa["ln"], cfg.norm_eps), positions,
                lm_cfg, cache=None if cache is None else cache["attn"],
                cache_len=cache_len)
        else:
            pm = lm_mod._layer(p["mamba"], i_mamba)
            h, _ = ssm_mod.block_apply(
                pm["ssm"], L.rmsnorm(x, pm["ln"], cfg.norm_eps), cfg.ssm,
                cache=None if cache is None
                else lm_mod._layer(cache["mamba"], i_mamba))
            i_mamba += 1
        x = S.with_logical_constraint(
            x + S.with_logical_constraint(h, ACT_RES), ACT_RES)
        # ---- FFN
        if pos in MOE_POS:
            pf = lm_mod._layer(p["moe"], i_moe)
            h, aux_i = L.moe_apply(pf["ffn"],
                                   L.rmsnorm(x, pf["ln"], cfg.norm_eps),
                                   cfg.moe, cfg.act)
            aux = aux + aux_i
            i_moe += 1
        else:
            pf = lm_mod._layer(p["mlp"], i_mlp)
            h = L.mlp_apply(pf["ffn"], L.rmsnorm(x, pf["ln"], cfg.norm_eps),
                            cfg.act)
            i_mlp += 1
        x = S.with_logical_constraint(
            x + S.with_logical_constraint(h, ACT_RES), ACT_RES)
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


# ---------------------------------------------------------------------------
# Forward / decode
# ---------------------------------------------------------------------------


ACT_RES = ("batch", "act_res", None)


def _logits(params: dict, x: torch.Tensor, cfg: HybridConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> torch.Tensor:
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    x = S.with_logical_constraint(x, ("batch", None, None))
    if last_only:
        x = x[:, -1:]
    logits = S.with_logical_constraint(
        (x @ S.gather_params(params["unembed"])).float(),
        ("batch", None, "vocab_act"))
    return logits[..., :cfg.vocab] if slice_vocab else logits


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return S.with_logical_constraint(
        S.vocab_parallel_embed(params["embed"], tokens), ACT_RES)


def forward(params: dict, tokens: torch.Tensor, cfg: HybridConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal logits over a prompt from empty states. tokens: [B, S]
    int. Returns (logits [B, S, vocab] fp32, aux loss: the MoE
    sublayers' load balance and z-loss summed); ``last_only`` keeps the
    last position, ``slice_vocab=False`` the padded vocab."""
    b, s = tokens.shape
    positions = lm_mod._positions(b, s, 0, tokens.device)
    x = _embed(params, tokens)
    aux = 0.0
    for i in range(cfg.n_periods):
        def inner(x, p=lm_mod._layer(params["periods"], i)):
            return _period_apply(p, x, positions, cfg)
        # the reference checkpoints a period only for remat == "full"
        x, aux_i = L.remat(inner, "full" if cfg.remat == "full"
                           else "none")(x)
        aux = aux + aux_i
    return _logits(params, x, cfg, last_only, slice_vocab), aux


def cache_specs(cfg: HybridConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16) -> dict:
    """Per period: the 7 Mamba sublayers' states (fp32) and conv windows
    stacked, and the attention sublayer's K / V [B, max_seq, Hkv, D]."""
    kv = ParamSpec((batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
                   ("batch", "kv_seq", "act_kv_heads", None), dtype, "zeros")
    period = {
        "mamba": L.stack_specs(
            ssm_mod.block_cache_specs(cfg.ssm, batch, dtype), PERIOD - 1,
            axis_name="sublayers"),
        "attn": {"k": kv, "v": kv},
    }
    return {"periods": L.stack_specs(period, cfg.n_periods)}


def init_cache(cfg: HybridConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> dict:
    return L.init_constants(cache_specs(cfg, batch, max_seq, dtype), device)


def decode_step(params: dict, token: torch.Tensor, cache: dict, cache_len,
                cfg: HybridConfig) -> tuple[torch.Tensor, dict]:
    """One decode step. token: [B, 1] int; returns (logits [B, vocab],
    cache), every period's states, conv windows and KV cache written in
    place (the KV cache at ``cache_len``)."""
    b = token.shape[0]
    idx = int(cache_len)
    positions = lm_mod._positions(b, 1, idx, token.device)
    x = _embed(params, token)
    for i in range(cfg.n_periods):
        x, _ = _period_apply(lm_mod._layer(params["periods"], i), x,
                             positions, cfg,
                             cache=lm_mod._layer(cache["periods"], i),
                             cache_len=idx)
    return _logits(params, x, cfg)[:, 0], cache
