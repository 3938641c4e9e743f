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
rules resolve onto a mesh). Parameters are nested dicts of tensors; a
layer-stacked leaf carries a leading "layers" axis, which the model
walks with a Python loop where the reference scans.

Tensor parallelism: on DTensor inputs (``repro_torch.parallel.sharding``)
the MLP makes the reference's ``act_mlp`` constraint, the MoE layer its
``expert_group`` / ``act_experts`` layout (the router on each rank's
groups, the experts on each "model" rank's slice of them), and
:func:`head_layout` with :func:`sharded_attention` run an attention on
each rank's heads (or query rows, where the rules put ``act_seq_attn``
on "model"), on local tensors: the flash kernel sees no DTensor.

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
from repro_torch.parallel import sharding as S


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
                idx: int, start: int = 0) -> torch.Tensor:
    """Write ``new`` [B, S, H, D] into ``cache`` [B, S_cache, H, D] at
    sequence position ``idx``, **in place**, and return ``cache``.

    Unlike the reference, which returns a new array, the cache tensor is
    updated where it lies. The semantics are the reference's: a write as
    long as the cache replaces it; a longer write (a prompt into a
    longer cache) fills positions [0, S) and zeroes the rest; a single
    position is written at ``idx``. ``start`` is the global position of
    the cache's first row, where it holds one rank's slice of a cache
    split over its positions: a prompt fills the part of [0, S) that
    falls in the slice, a single position lands only if it falls there.
    """
    s_cache, s_new = cache.shape[1], new.shape[1]
    if start == 0 and s_new == s_cache:
        return cache.copy_(new)
    if s_new > 1:
        hi = min(max(s_new - start, 0), s_cache)
        cache[:, :hi] = new[:, start:start + hi]
        cache[:, hi:] = 0
        return cache
    if start <= idx < start + s_cache:
        cache[:, idx - start:idx - start + 1] = new
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
                     v_scale: torch.Tensor | None = None,
                     kv_start: int = 0, seq_groups: tuple = ()
                     ) -> torch.Tensor:
    """Single-token attention over a partly filled cache, plain torch.

    q: [B, 1, Hq, D]; caches: [B, Skv, Hkv, D]; keys at positions
    ``>= kv_len`` are masked (a prefix mask, not a causal one). An int8
    cache is read as bf16, as the reference does, with ``k_scale`` /
    ``v_scale`` ([B, Hkv], fp32), its per-head dequantization scales,
    applied to the fp32 scores and outputs.

    With ``seq_groups`` (``(mesh, dim)`` pairs) the caches are this rank's
    slice of positions, the first at ``kv_start``: the softmax's max and
    sum and the output are all-reduced over the groups, so the
    probabilities are rounded at the same point as on one device.
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
    mask = kv_start + torch.arange(skv, device=q.device) >= kv_len
    s = s.masked_fill(mask, NEG_INF)
    if not seq_groups:
        p = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - reduce_over(torch.amax(s, dim=-1, keepdim=True),
                                      seq_groups, "max"))
        p = e / reduce_over(torch.sum(e, dim=-1, keepdim=True), seq_groups)
    out = torch.einsum("bhrk,bkhd->bhrd", p.to(pv_dtype).float(),
                       v_cache.to(pv_dtype).float())
    out = reduce_over(out, seq_groups)
    if v_scale is not None:
        out = out * v_scale[:, :, None, None]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def reduce_over(t: torch.Tensor, groups: tuple, op: str = "sum"
                ) -> torch.Tensor:
    """``t`` all-reduced over each of ``groups`` in turn (none: ``t``)."""
    for g in groups:
        t = S.all_reduce_autograd(t, g, op=op)
    return t


# ---------------------------------------------------------------------------
# Attention on a mesh: each rank's heads, or its query rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Shards:
    """Where one rank's pieces of an attention sit in the global problem
    (all 0 / empty on one device): its first query head, the first KV
    head of its k / v, its first query position (query rows split over
    "model"), its cache's first KV head and first position, and, in a
    decode step, the groups that split the cache's positions."""
    q_head0: int = 0
    kv_head0: int = 0
    seq0: int = 0
    cache_head0: int = 0
    cache_seq0: int = 0
    seq_groups: tuple = ()

    def kv_for(self, t: torch.Tensor, hq_local: int, rep: int,
               head0: int | None = None) -> torch.Tensor:
        """The KV heads of ``t`` [B, S, H, ...] that the local query heads
        read (query head h reads KV head h // rep); ``t``'s first head is
        global head ``head0`` (default: k / v's, ``kv_head0``)."""
        lo = self.q_head0 // rep - (self.kv_head0 if head0 is None
                                    else head0)
        if hq_local % rep == 0:
            n = hq_local // rep
        elif rep % hq_local == 0:
            n = 1
        else:
            raise ValueError(f"{hq_local} local query heads straddle the "
                             f"{rep}-head KV groups")
        return t[:, :, lo:lo + n]

    def cache_part(self, t: torch.Tensor, n_heads: int) -> torch.Tensor:
        """The KV heads of ``t`` (k / v) that the local cache holds."""
        lo = self.cache_head0 - self.kv_head0
        return t[:, :, lo:lo + n_heads]


def head_layout(mesh, b: int, s: int, hq: int, hkv: int, dq: int, *,
                skv: int | None = None, cache_placements=None,
                decode: bool = False):
    """Placements of an attention's projections [B, S, H * D] on ``mesh``
    and this rank's :class:`Shards`.

    The query follows the reference's ``("batch", "act_seq_attn",
    "act_heads", None)`` under the active rules: its heads, or its rows
    (yi-34b, qwen2-vl-2b), or nothing over "model". K / V keep their
    heads split over "model" only where the query's are and the KV heads
    divide (``act_kv_heads``) and the cache, if any, is split the same
    way; otherwise they are whole over "model" (a key split by rows
    needs every row). A decode step against a cache whose positions are
    split over "model" (``kv_seq``) takes the whole query, and one split
    over any mesh axes reduces its softmax over them; against a cache
    split by heads, the query splits by the same heads. Returns (q
    placements, k / v placements, this rank's Shards)."""
    from torch.distributed.tensor import Replicate, Shard
    md = S.mesh_dim(mesh, "model")
    n = S.axis_size(mesh, "model")
    r = S.axis_index(mesh, "model")
    q_pl = list(S.spec_placements(("batch", "act_seq_attn", "act_heads",
                                   None), (b, s, hq, dq), mesh))
    cache_mode = None
    if cache_placements is not None and md is not None:
        cache_mode = {Shard(1): "seq", Shard(2): "heads"}.get(
            cache_placements[md], "rep")
    if md is not None and decode and cache_mode in ("seq", "heads"):
        # a decode step reads the cache where it lies: every query head
        # against a cache split by positions; a cache split by heads (its
        # KV heads divide, so the query's do) on the same heads
        q_pl[md] = Replicate() if cache_mode == "seq" else Shard(2)
    q_mode = "rep" if md is None else {Shard(1): "seq", Shard(2): "heads"}.get(
        q_pl[md], "rep")
    kv_pl = [p if p == Shard(0) else Replicate() for p in q_pl]
    if md is not None:
        kv_pl[md] = Replicate()
        if q_mode == "heads" and hkv % n == 0 and cache_mode in (
                None, "heads"):
            kv_pl[md] = Shard(2)
    seq_dims = [d for d, p in enumerate(cache_placements or ())
                if p == Shard(1)]
    seq_index = 0
    for d in seq_dims:
        seq_index = seq_index * mesh.shape[d] + mesh.get_local_rank(d)
    seq_len = (skv or s) // math.prod(mesh.shape[d] for d in seq_dims)
    sh = Shards(
        q_head0=r * (hq // n) if q_mode == "heads" else 0,
        kv_head0=r * (hkv // n) if md is not None and kv_pl[md] == Shard(2)
        else 0,
        seq0=r * (s // n) if q_mode == "seq" else 0,
        cache_head0=r * (hkv // n) if cache_mode == "heads" else 0,
        cache_seq0=seq_index * seq_len,
        seq_groups=tuple((mesh, d) for d in seq_dims) if decode else ())
    return tuple(q_pl), tuple(kv_pl), sh


def sharded_attention(body: Callable, q: torch.Tensor, kv: tuple, *,
                      hq: int, hkv: int, dq: int, extras: tuple = (),
                      cache: tuple = (), decode: bool = False
                      ) -> torch.Tensor:
    """``body(q, *kv, shards, *extras, *cache)`` on this rank's pieces.

    ``q`` [B, S, Hq * dq] and the ``kv`` projections [B, Skv, Hkv * d];
    on DTensors they are laid out by :func:`head_layout` and ``body``
    gets local tensors, its :class:`Shards`, the ``extras`` whole over
    "model" (norm scales, MLA's latent) and the local ``cache``
    tensors, laid out as they are, which it updates in place; its output
    [B_local, S_local, H_local * dv] comes back in the query's layout
    (split by rows, it is handed on split by columns). On plain tensors
    ``body`` runs as it is, with ``Shards()``."""
    if not S.is_dtensor(q):
        return body(q, *kv, Shards(), *extras, *cache)
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    b, s, _ = q.shape
    skv = cache[0].shape[1] if cache else (kv[0].shape[1] if kv else s)
    q_pl, kv_pl, sh = head_layout(
        mesh, b, s, hq, hkv, dq, skv=skv,
        cache_placements=cache[0].placements if cache else None,
        decode=decode)
    md = S.mesh_dim(mesh, "model")
    ex_pl = [tuple(Replicate() if d == md else p
                   for d, p in enumerate(e.placements)) for e in extras]
    args = [q, *kv, sh, *extras, *cache]
    in_pl = [q_pl] + [kv_pl] * len(kv) + [None] + ex_pl + \
        [None] * len(cache)
    out = S.local_region(body, mesh, args, in_pl, q_pl)
    if md is not None and q_pl[md] == Shard(1):
        # rows split over "model": hand the output projection its heads'
        # columns instead (DTensor plans a product of a row-split operand
        # whose batch is split over two mesh axes by a search over every
        # placement, seconds a call)
        n = S.axis_size(mesh, "model")
        out = S.redistribute(out, mesh, [
            (Shard(2) if out.shape[2] % n == 0 else Replicate())
            if d == md else p for d, p in enumerate(out.placements)])
    return out


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
    """The gated MLP. On DTensors the input is gathered over "model"
    first (off the sequence-parallel residual), the hidden layer is
    constrained to the reference's ``("batch", None, "act_mlp")`` (its
    columns over "model") and the down product's partial sums are
    returned as DTensor leaves them (``Partial`` over "model")."""
    x = S.with_logical_constraint(x, ("batch", None, None))
    h = ACTIVATIONS[act](x @ p["gate"]) * (x @ p["up"])
    h = S.with_logical_constraint(h, ("batch", None, "act_mlp"))
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


def _top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int,
                    e0: int = 0, n_e: int | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard dispatch/combine tensors with capacity-based token dropping.

    probs: [G, S, E] router probabilities.
    Returns (dispatch [G,S,E,C] 0/1 in probs' dtype, combine [G,S,E,C]),
    or only experts ``e0`` to ``e0 + n_e`` of them (a rank's slice: an
    expert's slots depend on its own column alone).

    The top k come from a stable descending sort, so among equal
    probabilities the lower expert index comes first, as in
    ``jax.lax.top_k`` (``torch.topk`` leaves the order of ties
    unspecified). Ties are not rare: a padded tail group's zero rows
    have uniform probabilities, pick experts 0..k-1 and take capacity
    slots there. A dropped assignment's one-hot row is all zero: it is
    one-hot over ``capacity + 1`` classes with the last one cut off.
    """
    g, s, e = probs.shape
    n_e = e if n_e is None else n_e
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]       # [G, S, k]
    experts = torch.arange(e0, e0 + n_e, device=probs.device)
    prev_counts = torch.zeros((g, n_e), dtype=torch.int64,
                              device=probs.device)
    dispatch = torch.zeros((g, s, n_e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for slot in range(top_k):
        # one-hot over the held experts         [G, S, n_e]
        sel = (topi[:, :, slot, None] == experts).to(torch.int64)
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


def _router(p: dict, xg: torch.Tensor, cfg: MoEConfig
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities [G, S, E] of the groups ``xg``, the means over
    its tokens of the probabilities and of the argmax one-hots [E] (the
    load-balance term's factors) and its z-loss (0-d), in fp32."""
    with _ieee_fp32_matmul():
        logits = xg.float() @ p["router"]                  # [G, S, E]
    probs = torch.softmax(logits, dim=-1)
    z_loss = cfg.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits, dim=-1)))
    # load-balance auxiliary loss (Switch style)
    me = torch.mean(probs, dim=(0, 1))
    ce = torch.mean(F.one_hot(torch.argmax(probs, dim=-1),
                              cfg.n_experts).float(), dim=(0, 1))
    return probs, me, ce, z_loss


def _groups(x: torch.Tensor, gs: int) -> torch.Tensor:
    """[B, S, M] tokens as [G, gs, M] groups, the tail group padded."""
    m = x.shape[-1]
    xt = x.reshape(-1, m)
    g = -(-xt.shape[0] // gs)
    if g * gs > xt.shape[0]:
        xt = F.pad(xt, (0, 0, 0, g * gs - xt.shape[0]))
    return xt.reshape(g, gs, m)


def _experts(p: dict, x: torch.Tensor, probs: torch.Tensor, cfg: MoEConfig,
             act: str, gs: int, e0: int = 0) -> torch.Tensor:
    """The dispatch, the experts held in ``p`` (global experts ``e0`` on)
    and the combine over the groups of ``x`` [B, S, M]; [B, S, M], the
    sum over the held experts only."""
    b, s, m = x.shape
    xg = _groups(x, gs)
    capacity = max(1, int(math.ceil(gs * cfg.top_k * cfg.capacity_factor
                                    / cfg.n_experts)))
    n_e = p["gate"].shape[0]
    held = () if n_e == cfg.n_experts else (e0, n_e)
    dispatch, combine = _top_k_dispatch(probs, cfg.top_k, capacity, *held)
    dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)

    xe = torch.einsum("gsm,gsec->gecm", xg, dispatch)      # [G, E, C, M]
    h = ACTIVATIONS[act](torch.einsum("gecm,emf->gecf", xe, p["gate"])) \
        * torch.einsum("gecm,emf->gecf", xe, p["up"])
    ye = torch.einsum("gecf,efm->gecm", h, p["down"])
    yg = torch.einsum("gecm,gsec->gsm", ye, combine)       # [G, S, M]
    return yg.reshape(-1, m)[:b * s].reshape(b, s, m)


def _all_gather_rows(x: torch.Tensor, groups: list) -> torch.Tensor:
    """``x`` concatenated along dim 0 over each group in turn (the last
    group's ranks innermost, as the batch rows are laid out); the
    gradient is the sum of every rank's, scattered back."""
    for group in reversed(groups):
        x = S.all_gather(x, 0, group)
    return x


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str = "silu"
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, M] -> (out [B, S, M], aux_loss scalar fp32).

    Tokens are regrouped into dispatch groups of ``group_size`` so the
    dispatch tensors stay O(T * E * C / E) rather than O(T * E * S).
    Tokens beyond a group's ``capacity`` slots at an expert are dropped
    (a decode step at batch 8 has capacity 1 at 128 experts top 8), as
    in the reference. The router product runs in IEEE fp32; the expert
    products in the parameters' dtype, as plain torch einsums.

    The groups are the global batch's, as in the reference, wherever
    the tokens lie. Data-parallel (plain tensors, each rank its rows,
    under a :func:`~repro_torch.parallel.sharding.use_mesh` mesh whose
    batch axes have more than one rank): where a rank's rows hold whole
    groups, each rank routes its own and the per-expert sums of the
    load-balance term are all-reduced over the batch axes before the
    product (it is a product of global-batch means); otherwise the rows
    are gathered, every rank runs the global groups (GSPMD's replicated
    group axis) and keeps its rows. On DTensors (tensor parallel) the
    groups follow ``("expert_group", None, None)`` and the experts
    ``act_experts``: every "model" rank routes all of its groups' tokens
    and runs its slice of the experts, and the combine is a partial sum
    over "model".
    """
    if S.is_dtensor(x):
        return _moe_sharded(p, x, cfg, act)
    b, s, m = x.shape
    groups, n_dp = S.batch_groups(S.current_mesh())
    gs = min(cfg.group_size, b * s * n_dp)
    if n_dp > 1 and (b * s) % gs:
        y, aux = _moe_local(p, _all_gather_rows(x, groups), cfg, act, gs,
                            [], 1)
        r = _dp_index(groups)
        return y[r * b:(r + 1) * b], aux
    return _moe_local(p, x, cfg, act, gs, groups, n_dp)


def _moe_local(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
               gs: int, groups: list, n_dp: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on plain tensors in groups of ``gs``; the
    load-balance factors averaged over ``groups`` (``n_dp`` ranks)."""
    probs, me, ce, z_loss = _router(p, _groups(x, gs), cfg)
    for group in groups:           # the global-batch means
        me = S.all_reduce_autograd(me, group, backward="sum")
        ce = S.all_reduce_autograd(ce, group)
    if n_dp > 1:
        me, ce = me / n_dp, ce / n_dp
    # z_loss stays this rank's mean: the step averages the loss parts
    aux = cfg.n_experts * torch.sum(me * ce) + z_loss
    y = _experts(p, x, probs, cfg, act, gs)
    if cfg.n_shared:
        y = y + mlp_apply(p["shared"], x, act)
    return y, aux


def _dp_index(groups: list) -> int:
    """This rank's row-major index over the batch groups."""
    import torch.distributed as dist
    i = 0
    for g in groups:
        i = i * dist.get_world_size(g) + dist.get_rank(g)
    return i


def _moe_sharded(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on DTensors (see there)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    b, s, m = x.shape
    tokens = b * s
    gs = min(cfg.group_size, tokens)
    g = -(-tokens // gs)
    x = S.with_logical_constraint(x, ("batch", None, None))
    grp = S.spec_placements(("expert_group", None, None), (g, gs, m), mesh)
    md = S.mesh_dim(mesh, "model")
    # groups split over a batch axis only where x's rows are split the
    # same way and the groups are whole (no padded tail)
    rows = [Shard(0) if (p_x == Shard(0) and p_g == Shard(0)
                         and g * gs == tokens) else Replicate()
            for p_x, p_g in zip(x.placements, grp)]
    if md is not None:
        rows[md] = Replicate()
    rows = tuple(rows)
    partial = tuple(Partial() if p_r == Shard(0) else Replicate()
                    for p_r in rows)

    n_split = math.prod(mesh.shape[d] for d, p_r in enumerate(rows)
                        if p_r == Shard(0))

    def route(xl, router):
        probs, me, ce, z = _router({"router": router}, _groups(xl, gs), cfg)
        # each rank's share of the global means: partial sums
        return probs, me / n_split, ce / n_split, z / n_split
    probs, me, ce, z_loss = S.local_region(
        route, mesh, [x, p["router"]], [rows, tuple(Replicate()
                                                    for _ in rows)],
        (rows, partial, partial, partial))
    aux = cfg.n_experts * torch.sum(me * ce) + z_loss

    e_split = md is not None and p["gate"].placements[md] == Shard(0)
    e_pl = tuple(Shard(0) if d == md and e_split else Replicate()
                 for d in range(len(rows)))
    out_pl = tuple(Partial() if d == md and e_split else p_r
                   for d, p_r in enumerate(rows))
    e_local = cfg.n_experts // S.axis_size(mesh, "model") if e_split else \
        cfg.n_experts
    e0 = S.axis_index(mesh, "model") * e_local if e_split else 0
    y = S.local_region(
        lambda xl, pr, gate, up, down: _experts(
            {"gate": gate, "up": up, "down": down}, xl, pr, cfg, act, gs,
            e0),
        mesh, [x, probs, p["gate"], p["up"], p["down"]],
        [rows, rows, e_pl, e_pl, e_pl], out_pl)
    y = S.with_logical_constraint(y, ("batch", "act_res", None))
    if cfg.n_shared:
        y = y + S.with_logical_constraint(mlp_apply(p["shared"], x, act),
                                          ("batch", "act_res", None))
    return y, aux
