"""Model building blocks of the serving path, in PyTorch.

The counterpart of ``repro.models.layers`` for what the LMs (dense, MoE,
MLA, VLM), Mamba2, the Jamba hybrid and the encoder-decoder serve with:
parameter declarations and their initialisation, RMSNorm and LayerNorm,
rotary embeddings (standard, and Qwen2-VL's multimodal M-RoPE), the
gated MLPs (silu, gemma's tanh-approximate gelu, seamless's relu), the
GShard-style MoE layer (plain
torch einsums, as in the reference, which computes it outside any
Pallas kernel), the KV-cache write and its int8 quantizer, and the
three attention forms. Every ``ParamSpec`` carries the reference's
logical axes (``param_axes_tree``, which the parallel layer's sharding
rules resolve onto a mesh); the models make no activation sharding
constraints (no tensor parallelism yet). Parameters are nested dicts
of tensors; a layer-stacked leaf carries a leading "layers" axis, which
the model walks with a Python loop where the reference scans.

Numerics follow the reference: norms and softmax statistics in fp32,
attention scores as fp32 products of widened operands (exact for bf16,
where JAX's ``preferred_element_type=float32`` keeps them unrounded),
and probabilities rounded to the value type before ``p . v``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.kernels.flash_attention import NEG_INF, flash_attention


# ---------------------------------------------------------------------------
# ParamSpec machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter leaf: its shape, its logical axis
    names (one per dimension, None for "no preference"; the sharding
    rules of ``repro_torch.parallel.sharding`` read them) and its
    initialisation law."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # normal | zeros | ones | embed
    fan_in: int | None = None     # for "normal": std = 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} / axes {self.axes} rank "
                             "mismatch")


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of nested dicts, lists and dataclasses
    (a train state, its optimizer state); a ``ParamSpec`` is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(
            tree, (type, ParamSpec)):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts / lists in the reference's pytree order
    (a dict's keys sorted, a list in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_leaves`' order) in the structure of
    ``like``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def init_params(spec_tree: Any, gen: torch.Generator) -> Any:
    """Materialize a ParamSpec tree on ``gen``'s device.

    The laws are the reference's: ``normal`` draws N(0, 1/fan_in) with
    fan_in the second-to-last extent, ``embed`` N(0, 1), in fp32 and
    then cast; ``zeros`` / ``ones`` are constant. The bits differ from
    ``jax.random``'s; :func:`tree_from_numpy` (behind the models'
    ``params_from_jax``) carries the reference's own weights across
    where bits matter.
    """
    device = gen.device

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        x = torch.randn(spec.shape, generator=gen, device=device)
        if spec.init == "embed":
            return x.to(spec.dtype)
        fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                              else spec.shape[-1])
        return x.mul_(1.0 / math.sqrt(max(fan, 1))).to(spec.dtype)

    return tree_map(make, spec_tree)


def init_constants(spec_tree: Any, device) -> Any:
    """Materialize a tree of ``zeros`` / ``ones`` specs (a cache) on
    ``device``."""
    def make(spec: ParamSpec) -> torch.Tensor:
        fill = {"zeros": 0, "ones": 1}[spec.init]
        return torch.full(spec.shape, fill, dtype=spec.dtype, device=device)
    return tree_map(make, spec_tree)


def tree_from_numpy(tree: Any, device,
                    dtype: torch.dtype | None = None) -> Any:
    """A tree of numpy (or JAX) arrays as tensors on ``device``, bit for
    bit (ml_dtypes' bfloat16 as ``torch.bfloat16``), unless ``dtype``
    casts the floating leaves."""
    def convert(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)
    return tree_map(convert, tree)


def stack_specs(spec_tree: Any, n: int, axis_name: str = "layers") -> Any:
    """Prefix every leaf with a stacked layer dimension named
    ``axis_name``."""
    return tree_map(lambda s: dataclasses.replace(
        s, shape=(n,) + s.shape, axes=(axis_name,) + s.axes), spec_tree)


def abstract_params(spec_tree: Any) -> Any:
    """Stand-ins on the ``meta`` device with each spec's shape and dtype:
    no storage is allocated (the counterpart of the reference's
    ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), spec_tree)


def param_axes_tree(spec_tree: Any) -> Any:
    """Logical-axes tree congruent with the params (for sharding rules)."""
    return tree_map(lambda s: s.axes, spec_tree)


def param_count(spec_tree: Any) -> int:
    specs: list[ParamSpec] = []
    tree_map(specs.append, spec_tree)
    return sum(math.prod(s.shape) for s in specs)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="dots"``: keep the outputs of
    matrix products without batch dimensions (``aten.mm`` / ``addmm``,
    which ``x @ w`` becomes), recompute everything else; the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn: Callable, policy: str) -> Callable:
    """``fn`` under the reference's ``jax.checkpoint`` policy ``policy``:
    ``"full"`` saves only its inputs and recomputes its forward in the
    backward pass (``torch.utils.checkpoint``, non-reentrant), ``"dots"``
    also keeps the outputs of its matrix products, ``"none"`` is ``fn``.
    Outside grad mode (serving) every policy is ``fn``: nothing is saved
    for a backward there."""
    if policy not in ("none", "full", "dots"):
        raise ValueError(f"remat must be none | full | dots, got {policy!r}")
    if policy == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if policy == "dots":
            kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
                _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ---------------------------------------------------------------------------
# Norms and rotary embeddings
# ---------------------------------------------------------------------------


def rmsnorm_spec(dim: int, dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec((dim,), (None,), dtype, "ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)                       # [head_dim//2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] int. Split-half rotation: the
    halves [x1, x2] rotate together, angles in fp32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the frequency bands of each head are
    split into ``sections`` (t, h, w) groups, each rotated by its own
    position component. x: [B, S, H, D]; positions: [3, B, S] int. With
    all three components equal (text only) it is :func:`apply_rope`."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"sections {sections} must sum to head_dim/2="
                         f"{d // 2}")
    freqs = rope_frequencies(d, theta, x.device)           # [d/2]
    # which position component drives each frequency band
    comp = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                      for i, n in enumerate(sections)])
    picked = torch.movedim(positions.float(), 0, -1)       # [B, S, 3]
    angles = picked[..., comp] * freqs                     # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_chunk: int = 512,
                        kv_chunk: int = 1024, kv_offset: int = 0,
                        softmax_scale: float | None = None,
                        mode: str = "auto") -> torch.Tensor:
    """Online-softmax attention. q: [B, Sq, Hq, D]; k: [B, Skv, Hkv, D];
    v: [B, Skv, Hkv, DV] (MLA's DV differs from D), Hq % Hkv == 0.

    On the card this is the flash-attention CUDA kernel (one launch);
    on CPU tensors, or with ``mode="ref"``, its plain version with the
    reference's ``q_chunk`` x ``kv_chunk`` schedule.
    """
    return flash_attention(q, k, v, causal=causal, kv_offset=kv_offset,
                           scale=softmax_scale, q_chunk=q_chunk,
                           kv_chunk=kv_chunk, mode=mode)


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                idx: int) -> torch.Tensor:
    """Write ``new`` [B, S, H, D] into ``cache`` [B, S_cache, H, D] at
    sequence position ``idx``, **in place**, and return ``cache``.

    Unlike the reference, which returns a new array, the cache tensor is
    updated where it lies. The semantics are the reference's: a write as
    long as the cache replaces it; a longer write (a prompt into a
    longer cache) fills positions [0, S) and zeroes the rest; a single
    position is written at ``idx``.
    """
    s_cache, s_new = cache.shape[1], new.shape[1]
    if s_new == s_cache:
        return cache.copy_(new)
    if s_new > 1:
        cache[:, :s_new] = new
        cache[:, s_new:] = 0
        return cache
    cache[:, idx:idx + 1] = new
    return cache


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_offset: int = 0,
                    softmax_scale: float | None = None) -> torch.Tensor:
    """Full-softmax attention in one einsum pair, plain torch."""
    _, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    rep = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + kv_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def quantize_kv(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> int8 with per-(batch, head) ``scale`` [B, H]."""
    s = scale[:, None, :, None]
    return torch.clamp(torch.round(x.float() / torch.clamp(s, min=1e-8)),
                       -127, 127).to(torch.int8)


def kv_scale_from(x: torch.Tensor) -> torch.Tensor:
    """Prefill-calibrated per-(batch, head) int8 scale: max|x|/127 (an
    IEEE division on the card too: by a tensor on ``x``'s device)."""
    hi = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    return torch.amax(torch.abs(x.float()), dim=(1, 3)) / hi + 1e-8


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: int, *,
                     softmax_scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Single-token attention over a partly filled cache, plain torch.

    q: [B, 1, Hq, D]; caches: [B, Skv, Hkv, D]; keys at positions
    ``>= kv_len`` are masked (a prefix mask, not a causal one). An int8
    cache is read as bf16, as the reference does, with ``k_scale`` /
    ``v_scale`` ([B, Hkv], fp32), its per-head dequantization scales,
    applied to the fp32 scores and outputs.
    """
    b, _, hq, d = q.shape
    _, skv, hkv, _ = k_cache.shape
    rep = hq // hkv
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    int8_cache = k_cache.dtype == torch.int8
    qk_dtype = torch.bfloat16 if int8_cache else k_cache.dtype
    pv_dtype = torch.bfloat16 if int8_cache else v_cache.dtype
    qr = q.reshape(b, hkv, rep, d)
    s = torch.einsum("bhrd,bkhd->bhrk", qr.to(qk_dtype).float(),
                     k_cache.to(qk_dtype).float()) * scale
    if k_scale is not None:
        s = s * k_scale[:, :, None, None]
    mask = torch.arange(skv, device=q.device) >= kv_len
    s = s.masked_fill(mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p.to(pv_dtype).float(),
                       v_cache.to(pv_dtype).float())
    if v_scale is not None:
        out = out * v_scale[:, :, None, None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Gated MLP
# ---------------------------------------------------------------------------


ACTIVATIONS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def mlp_specs(d_model: int, d_ff: int, dtype=torch.bfloat16) -> dict:
    return {
        "gate": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
        "up": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype),
        "down": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = ACTIVATIONS[act](x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard-style grouped dispatch, token dropping)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden
    n_shared: int = 0               # shared (always-on) experts
    capacity_factor: float = 1.25
    group_size: int = 512           # tokens per dispatch group
    router_z_loss: float = 1e-3


def moe_specs(d_model: int, cfg: MoEConfig, dtype=torch.bfloat16) -> dict:
    specs = {
        "router": ParamSpec((d_model, cfg.n_experts), ("embed", None),
                            torch.float32, fan_in=d_model),
        "gate": ParamSpec((cfg.n_experts, d_model, cfg.d_ff),
                          ("experts", "embed", None), dtype, fan_in=d_model),
        "up": ParamSpec((cfg.n_experts, d_model, cfg.d_ff),
                        ("experts", "embed", None), dtype, fan_in=d_model),
        "down": ParamSpec((cfg.n_experts, cfg.d_ff, d_model),
                          ("experts", None, "embed"), dtype, fan_in=cfg.d_ff),
    }
    if cfg.n_shared:
        specs["shared"] = mlp_specs(d_model, cfg.d_ff * cfg.n_shared, dtype)
    return specs


def _top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch/combine tensors with capacity-based token dropping.

    probs: [G, S, E] router probabilities.
    Returns (dispatch [G,S,E,C] 0/1 in probs' dtype, combine [G,S,E,C]).

    The top k come from a stable descending sort, so among equal
    probabilities the lower expert index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` leaves the order of ties
    unspecified). Ties are not rare: a padded tail group's zero rows
    have uniform probabilities, pick experts 0..k-1 and take capacity
    slots there. A dropped assignment's one-hot row is all zero: it is
    one-hot over ``capacity + 1`` classes with the last one cut off.
    """
    g, s, e = probs.shape
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]       # [G, S, k]
    prev_counts = torch.zeros((g, e), dtype=torch.int64, device=probs.device)
    dispatch = torch.zeros((g, s, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for slot in range(top_k):
        sel = F.one_hot(topi[:, :, slot], e)                 # [G, S, E]
        pos = torch.cumsum(sel, dim=1) - 1 + prev_counts[:, None, :]
        prev_counts = prev_counts + torch.sum(sel, dim=1)
        keep = (pos < capacity) & (sel > 0)
        pos_c = F.one_hot(torch.where(keep, pos, capacity),
                          capacity + 1)[..., :capacity].to(probs.dtype)
        d_slot = sel.to(probs.dtype)[..., None] * pos_c      # [G,S,E,C]
        dispatch = dispatch + d_slot
        combine = combine + d_slot * topv[:, :, slot][:, :, None, None]
    return dispatch, combine


@contextlib.contextmanager
def _ieee_fp32_matmul():
    """fp32 matmuls in IEEE fp32 for the duration, whatever the process's
    ``torch.set_float32_matmul_precision`` (TF32 on the card rounds the
    operands to 10 mantissa bits, which would move router logits and so
    routing); the setting is restored after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str = "silu"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, M] -> (out [B, S, M], aux_loss scalar fp32).

    Tokens are regrouped into dispatch groups of ``group_size`` so the
    dispatch tensors stay O(T * E * C / E) rather than O(T * E * S).
    Tokens beyond a group's ``capacity`` slots at an expert are dropped
    (a decode step at batch 8 has capacity 1 at 128 experts top 8), as
    in the reference. The router product runs in IEEE fp32; the expert
    products in the parameters' dtype, as plain torch einsums.
    """
    b, s, m = x.shape
    tokens = b * s
    gs = min(cfg.group_size, tokens)
    g = tokens // gs
    xt = x.reshape(tokens, m)
    # Tail tokens beyond g*gs fall into the last group via padding.
    if g * gs < tokens:
        g += 1
        xt = F.pad(xt, (0, 0, 0, g * gs - tokens))
    xg = xt.reshape(g, gs, m)

    with _ieee_fp32_matmul():
        logits = xg.float() @ p["router"]                  # [G, S, E]
    probs = torch.softmax(logits, dim=-1)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    # load-balance auxiliary loss (Switch style)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(torch.argmax(probs, dim=-1),
                              cfg.n_experts).float(), dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * ce) + z_loss

    capacity = max(1, int(math.ceil(gs * cfg.top_k * cfg.capacity_factor
                                    / cfg.n_experts)))
    dispatch, combine = _top_k_dispatch(probs, cfg.top_k, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    xe = torch.einsum("gsm,gsec->gecm", xg, dispatch)      # [G, E, C, M]
    h = ACTIVATIONS[act](torch.einsum("gecm,emf->gecf", xe, p["gate"])) \
        * torch.einsum("gecm,emf->gecf", xe, p["up"])
    ye = torch.einsum("gecf,efm->gecm", h, p["down"])
    yg = torch.einsum("gecm,gsec->gsm", ye, combine)       # [G, S, M]

    y = yg.reshape(g * gs, m)[:tokens].reshape(b, s, m)
    if cfg.n_shared:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux
