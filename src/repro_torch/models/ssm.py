"""Mamba2 — state-space duality (SSD), chunked, in PyTorch.

The counterpart of ``repro.models.ssm``. The SSD form computes the
selective-SSM recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t ⊗ x_t),   y_t = C_t · h_t

as a block decomposition over sequence chunks: a quadratic
*intra-chunk* term (a masked attention-like product) plus a linear
*inter-chunk* recurrence over per-chunk states. The reference scans
over chunks and over layers (``lax.scan``); here both are Python loops.
Every product is a plain fp32 einsum, as in the reference: the model is
attention-free and launches no kernel of the port.

Decode keeps a recurrent state [B, H, P, N] and a short conv window;
both are updated in place, as the LM's KV cache is.

Layer structure (Mamba2 block):
    in: z, x = W_z u, W_x u;  B, C = W_b u, W_c u;  dt = softplus(W_dt u + bias)
    x, B, C <- causal depthwise conv (kernel 4) + silu
    y = SSD(x, dt, A, B, C) + D ⊙ x
    out = W_o (rmsnorm(y) * silu(z))        (gated norm)

``SSMLMConfig`` is also what the compiler walks into projection GEMMs
(``compiler/networks.py``) and the decode sessions run
(``compiler/runtime/session.py``).

Entry points:
  param_specs / init / params_from_jax / param_count  — parameters
  forward(params, tokens, cfg)                         — causal logits
  init_cache / decode_step                             — recurrent decoding
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding as S


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


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


def block_specs(cfg: SSMConfig, dtype=torch.bfloat16) -> dict:
    m, di, gn, h = cfg.d_model, cfg.d_inner, cfg.n_groups * cfg.d_state, \
        cfg.n_heads
    k = cfg.conv_kernel
    return {
        "wz": ParamSpec((m, di), ("embed", "mlp"), dtype),
        "wx": ParamSpec((m, di), ("embed", "mlp"), dtype),
        "wb": ParamSpec((m, gn), ("embed", None), dtype),
        "wc": ParamSpec((m, gn), ("embed", None), dtype),
        "wdt": ParamSpec((m, h), ("embed", None), dtype),
        "conv_x": ParamSpec((k, di), (None, "mlp"), dtype),
        "conv_b": ParamSpec((k, gn), (None, None), dtype),
        "conv_c": ParamSpec((k, gn), (None, None), dtype),
        "a_log": ParamSpec((h,), (None,), torch.float32, "zeros"),
        "d_skip": ParamSpec((h,), (None,), torch.float32, "ones"),
        "dt_bias": ParamSpec((h,), (None,), torch.float32, "zeros"),
        "norm": L.rmsnorm_spec(di, dtype),
        "wo": ParamSpec((di, m), ("mlp", "embed"), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 window: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [K, C]. ``window``
    ([B, K-1, C]) prepends decode history instead of zero padding. The
    taps accumulate in fp32, in the reference's order."""
    k = w.shape[0]
    if window is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([window.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):                       # small static unroll (k = 4)
        out = out + xp[:, i:i + s].float() * w[i].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked SSD
# ---------------------------------------------------------------------------


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, cfg: SSMConfig,
                initial_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,H,P]; dt: [B,S,H] (positive); a: [H] (negative);
    b, c: [B,S,G,N]. Returns (y [B,S,H,P], final_state [B,H,P,N])."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    lc = min(cfg.chunk, s)
    pad = (-s) % lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // lc
    rep = h // g

    xc = x.reshape(bs, nc, lc, h, p).float()
    dtc = dt.reshape(bs, nc, lc, h).float()
    bc = b.reshape(bs, nc, lc, g, n).float()
    cc = c.reshape(bs, nc, lc, g, n).float()
    bh = bc.repeat_interleave(rep, dim=3)                # [B,nc,Lc,H,N]
    ch = cc.repeat_interleave(rep, dim=3)

    da = dtc * a[None, None, None, :]                    # [B,nc,Lc,H] (<0)
    da_cs = torch.cumsum(da, dim=2)

    # intra-chunk (masked quadratic term)
    seg = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]   # [B,nc,i,j,H]
    ii = torch.arange(lc, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))
    cb = torch.einsum("bcihn,bcjhn->bcijh", ch, bh)
    att = cb * decay * dtc[:, :, None, :, :]             # weight by dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # chunk states: S_c = sum_j exp(da_cs[last] - da_cs[j]) dt_j B_j x_j^T
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # [B,nc,Lc,H]
    states = torch.einsum("bclh,bclhn,bclhp->bchpn",
                          decay_states * dtc, bh, xc)    # [B,nc,H,P,N]

    # inter-chunk recurrence over chunk states (the reference's scan)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])          # [B,nc,H]
    h_run = (initial_state.float() if initial_state is not None
             else torch.zeros((bs, h, p, n), device=x.device))
    h_prevs = []
    for ci in range(nc):                                 # state *before*
        h_prevs.append(h_run)
        h_run = h_run * chunk_decay[:, ci, :, None, None] + states[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)                 # [B,nc,H,P,N]

    # inter-chunk contribution: y_i += C_i · (exp(da_cs_i) * h_prev)
    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           ch * torch.exp(da_cs)[..., None], h_prev)

    y = (y_intra + y_inter).reshape(bs, nc * lc, h, p)[:, :s]
    return y.to(x.dtype), h_run


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. x: [B,H,P]; dt: [B,H]; b, c: [B,G,N];
    state: [B,H,P,N]. Returns (y [B,H,P], new_state)."""
    h, g = x.shape[1], b.shape[1]
    rep = h // g
    bh = b.repeat_interleave(rep, dim=1).float()         # [B,H,N]
    ch = c.repeat_interleave(rep, dim=1).float()
    da = dt.float() * a[None, :]
    decay = torch.exp(da)[..., None, None]               # [B,H,1,1]
    inc = (dt.float()[..., None, None] * x.float()[..., None]
           * bh[:, :, None, :])
    new_state = state.float() * decay + inc
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x.dtype), new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block forward
# ---------------------------------------------------------------------------


def _heads_split(mesh, bs: int, s: int, cfg: SSMConfig) -> bool:
    """Whether the reference's ``("batch", None, "act_heads", None)`` on
    the heads [B, S, H, P] puts the heads over "model" under the active
    rules."""
    from torch.distributed.tensor import Shard
    md = S.mesh_dim(mesh, "model")
    pl = S.spec_placements(("batch", None, "act_heads", None),
                           (bs, s, cfg.n_heads, cfg.head_dim), mesh)
    return md is not None and pl[md] == Shard(2)


def block_apply(p: dict, u: torch.Tensor, cfg: SSMConfig,
                cache: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """u: [B, S, M]. With ``cache`` (decode): S == 1, cache holds
    {"state": [B,H,P,N], "conv": [B,K-1, d_inner + 2GN]}, both updated
    in place and returned.

    On DTensors the projections are DTensor products and the conv, the
    SSD and the gated norm run on each rank's heads (the reference's
    ``act_heads`` on the heads): z / x and ``conv_x`` by columns, B / C
    and dt whole, the per-head vectors sliced, the norm's mean of
    squares all-reduced over "model". A decode step reads the conv
    window whole and writes its own columns of it."""
    bs, s, _ = u.shape
    h, pdim, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    gn = g * n
    u = S.with_logical_constraint(u, ("batch", None, None))
    z = u @ p["wz"]
    x = u @ p["wx"]
    b = u @ p["wb"]
    c = u @ p["wc"]
    dt_raw = (u @ p["wdt"]).float()
    vecs = (p["a_log"], p["dt_bias"], p["d_skip"], p["norm"],
            p["conv_b"], p["conv_c"])

    def body(z, x, b, c, dt_raw, conv_x, a_log, dt_bias, d_skip, norm,
             conv_b, conv_c, *cache_l, h0=0, group=None, window_full=None,
             cols=None):
        hl = x.shape[-1] // pdim
        bl = x.shape[0]
        xbc = torch.cat([x, b, c], dim=-1)
        conv_w = torch.cat([conv_x, conv_b, conv_c], dim=-1)
        if not cache_l:
            xbc_conv = _causal_conv(xbc, conv_w)
        else:
            state, window = cache_l
            full = window if window_full is None else window_full
            di_cols = torch.cat([full[..., h0 * pdim:(h0 + hl) * pdim],
                                 full[..., cfg.d_inner:]], dim=-1)
            xbc_conv = _causal_conv(xbc, conv_w, window=di_cols)
            row = xbc if group is None else torch.cat(
                [S.all_gather(x, x.dim() - 1, group), b, c], dim=-1)
            new = torch.cat([full[:, 1:], row.to(window.dtype)], dim=1)
            window.copy_(new if cols is None else new[..., cols[0]:cols[1]])
        xbc_conv = F.silu(xbc_conv)
        x, b, c = torch.split(xbc_conv, [hl * pdim, gn, gn], dim=-1)
        a = -torch.exp(a_log[h0:h0 + hl])
        dt = F.softplus(dt_raw[..., h0:h0 + hl]
                        + dt_bias[h0:h0 + hl][None, None, :])
        xh = x.reshape(bl, s, hl, pdim)
        rep = h // g
        g0, ng = h0 // rep, max(1, hl // rep)
        bg = b.reshape(bl, s, g, n)[:, :, g0:g0 + ng]
        cg = c.reshape(bl, s, g, n)[:, :, g0:g0 + ng]
        if not cache_l:
            y, _ = ssd_chunked(xh, dt, a, bg, cg, cfg)
        else:
            y1, new_state = ssd_step(xh[:, 0], dt[:, 0], a, bg[:, 0],
                                     cg[:, 0], cache_l[0])
            y = y1[:, None]
            cache_l[0].copy_(new_state)
        y = y + xh * d_skip[h0:h0 + hl][None, None, :, None].to(y.dtype)
        y = y.reshape(bl, s, hl * pdim)
        if group is None:
            y = L.rmsnorm(y, norm)
        else:
            scale = norm[h0 * pdim:(h0 + hl) * pdim]
            y32 = y.float()
            var = S.all_reduce_autograd(
                torch.sum(torch.square(y32), dim=-1, keepdim=True), group,
                backward="sum") / cfg.d_inner
            y = (y32 * torch.rsqrt(var + 1e-6) * scale.float()).to(y.dtype)
        return y * F.silu(z)

    cache_t = () if cache is None else (cache["state"], cache["conv"])
    if not S.is_dtensor(u):
        y = body(z, x, b, c, dt_raw, p["conv_x"], *vecs, *cache_t)
        return y @ p["wo"], cache
    from torch.distributed.tensor import Replicate, Shard
    mesh = u.device_mesh
    md = S.mesh_dim(mesh, "model")
    split = _heads_split(mesh, bs, s, cfg)
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate()
                 for pl in u.placements)
    col = tuple(Shard(2) if d == md and split else pl
                for d, pl in enumerate(rows))
    conv_pl = tuple(Shard(1) if d == md and split else Replicate()
                    for d in range(len(rows)))
    whole = tuple(Replicate() for _ in rows)
    r = S.axis_index(mesh, "model")
    hl = h // S.axis_size(mesh, "model") if split else h
    kw = {"h0": r * hl if split else 0,
          "group": (mesh, md) if split else None}
    args = [z, x, b, c, dt_raw, p["conv_x"], *vecs]
    in_pl = [col, col, rows, rows, rows, conv_pl] + [whole] * len(vecs)
    if cache is not None:
        window = cache["conv"]
        kw["window_full"] = window.redistribute(mesh, rows).to_local()
        wpl = window.placements[md] if md is not None else Replicate()
        if isinstance(wpl, Shard):
            w = window.to_local().shape[-1]
            kw["cols"] = (r * w, (r + 1) * w)
        args += [cache["state"], window]
        in_pl += [None, None]
    y = S.local_region(lambda *a: body(*a, **kw), mesh, args, in_pl, col)
    return y @ p["wo"], cache


def block_cache_specs(cfg: SSMConfig, batch: int,
                      dtype=torch.bfloat16) -> dict:
    gn = cfg.n_groups * cfg.d_state
    return {
        "state": ParamSpec((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           ("batch", "act_heads", None, None), torch.float32,
                           "zeros"),
        "conv": ParamSpec((batch, cfg.conv_kernel - 1, cfg.d_inner + 2 * gn),
                          ("batch", None, "mlp"), dtype, "zeros"),
    }


# ---------------------------------------------------------------------------
# Mamba2 LM
# ---------------------------------------------------------------------------


def param_specs(cfg: SSMLMConfig) -> dict:
    dt = cfg.param_dtype
    layer = {
        "ln": L.rmsnorm_spec(cfg.d_model, dt),
        "ssm": block_specs(cfg.ssm, dt),
    }
    specs = {
        "embed": ParamSpec((cfg.padded_vocab, cfg.d_model),
                           ("vocab", "embed"), dt, "embed"),
        "layers": L.stack_specs(layer, cfg.n_layers),
        "ln_f": L.rmsnorm_spec(cfg.d_model, dt),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"), dt)
    return specs


def init(cfg: SSMLMConfig, gen: torch.Generator) -> dict:
    """Random weights by the reference's laws on ``gen``'s device, then
    the reference's ``a_log`` / ``dt_bias`` law: A in [1, 16] (the
    mamba2 default) and dt_bias the inverse softplus of a log-uniform dt
    in [dt_min, dt_max], the same for every layer."""
    params = L.init_params(param_specs(cfg), gen)
    h, dev = cfg.ssm.n_heads, gen.device
    a0 = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                  device=dev))
    dt0 = torch.exp(torch.linspace(math.log(cfg.ssm.dt_min),
                                   math.log(cfg.ssm.dt_max), h,
                                   dtype=torch.float32, device=dev))
    ssm_p = params["layers"]["ssm"]
    ssm_p["a_log"].copy_(a0.expand_as(ssm_p["a_log"]))
    ssm_p["dt_bias"].copy_(torch.log(torch.expm1(dt0)).expand_as(
        ssm_p["dt_bias"]))
    return params


def abstract(cfg: SSMLMConfig) -> dict:
    return L.abstract_params(param_specs(cfg))


def param_axes(cfg: SSMLMConfig) -> dict:
    return L.param_axes_tree(param_specs(cfg))


def param_count(cfg: SSMLMConfig) -> int:
    return L.param_count(param_specs(cfg))


def params_from_jax(tree: Any, device=torch.device("cuda"),
                    dtype: torch.dtype | None = None) -> dict:
    """The reference's ``ssm.init`` pytree as the port's parameters on
    ``device``: the same structure and, unless ``dtype`` casts the
    floating leaves, the same bits."""
    return L.tree_from_numpy(tree, device, dtype)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views into the stacked leaves)."""
    return L.tree_map(lambda t: t[i], tree)


def _logits(params: dict, x: torch.Tensor, cfg: SSMLMConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> torch.Tensor:
    x = L.rmsnorm(x, params["ln_f"], cfg.norm_eps)
    x = S.with_logical_constraint(x, ("batch", None, None))
    if last_only:
        x = x[:, -1:]
    unembed = S.gather_params(params["embed"].T if cfg.tie_embeddings
                              else params["unembed"])
    logits = S.with_logical_constraint((x @ unembed).float(),
                                       ("batch", None, "vocab_act"))
    return logits[..., :cfg.vocab] if slice_vocab else logits


ACT_RES = ("batch", "act_res", None)


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return S.with_logical_constraint(
        S.vocab_parallel_embed(params["embed"], tokens), ACT_RES)


def forward(params: dict, tokens: torch.Tensor, cfg: SSMLMConfig,
            last_only: bool = False, slice_vocab: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal logits over a prompt from a zero state. tokens: [B, S]
    int. Returns (logits [B, S, vocab] fp32, aux loss 0); ``last_only``
    keeps the last position, ``slice_vocab=False`` the padded vocab. On
    DTensors the residual stream is held at ``act_res``."""
    x = _embed(params, tokens)
    for i in range(cfg.n_layers):
        def inner(x, p=_layer(params["layers"], i)):
            p = S.gather_params(p)
            y, _ = block_apply(p["ssm"], L.rmsnorm(x, p["ln"], cfg.norm_eps),
                               cfg.ssm)
            return S.with_logical_constraint(
                x + S.with_logical_constraint(y, ACT_RES), ACT_RES)
        # the reference checkpoints a layer only for remat == "full"
        x = L.remat(inner, "full" if cfg.remat == "full" else "none")(x)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _logits(params, x, cfg, last_only, slice_vocab), aux


def cache_specs(cfg: SSMLMConfig, batch: int, max_seq: int = 0,
                dtype=torch.bfloat16) -> dict:
    del max_seq  # recurrent state is O(1) in sequence length
    return {"layers": L.stack_specs(
        block_cache_specs(cfg.ssm, batch, dtype), cfg.n_layers)}


def init_cache(cfg: SSMLMConfig, batch: int, max_seq: int = 0,
               dtype=torch.bfloat16, device=torch.device("cuda")) -> dict:
    return L.init_constants(cache_specs(cfg, batch, max_seq, dtype), device)


def decode_step(params: dict, token: torch.Tensor, cache: dict, cache_len,
                cfg: SSMLMConfig) -> tuple[torch.Tensor, dict]:
    """One recurrent step. token: [B, 1] int; returns (logits [B, vocab],
    cache), the state and conv window written in place."""
    del cache_len  # state is positionless
    x = _embed(params, token)
    for i in range(cfg.n_layers):
        p = S.gather_params(_layer(params["layers"], i))
        y, _ = block_apply(p["ssm"], L.rmsnorm(x, p["ln"], cfg.norm_eps),
                           cfg.ssm, cache=_layer(cache["layers"], i))
        x = S.with_logical_constraint(
            x + S.with_logical_constraint(y, ACT_RES), ACT_RES)
    return _logits(params, x, cfg)[:, 0], cache
