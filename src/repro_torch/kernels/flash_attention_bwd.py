"""Flash attention (backward): the gradient of the training path's
attention.

The reference trains by XLA's derivative of ``models/layers.py::
blockwise_attention`` (its Pallas kernel has no backward). In the port
the forward of that schedule is the CUDA kernel of ``flash_attention``,
so its gradient is the CUDA kernel of ``csrc/flash_attention_bwd.cu``,
FlashAttention-2's backward on Hopper's wgmma and TMA in two entry
points, launched in this order:

  flash_attention_bwd_dq   — dq, one block per (64-row query tile, query
                             head, batch) over the KV tiles; it also
                             computes its rows' delta = rowsum(dout *
                             out), fp32 [B, Hq, Sq], and writes it for
                             dkdv;
  flash_attention_bwd_dkdv — dk and dv, one block per (64-key tile, KV
                             head, batch) over the query tiles of the KV
                             head's query heads (no two blocks add into
                             one dk or dv, and no floating-point atomics,
                             so the gradients are bitwise repeatable).

Each recomputes p = exp(s - lse) from the forward's log-sum-exp, with the
forward's causal, ``kv_offset`` and ragged masks, for the (key, value)
head sizes :data:`BWD_HEAD_DIMS`, bf16 in and out: two blocks an SM at
(64, 64) and (128, 128); at (192, 128) and (256, 256), whose dk and dv
accumulators do not fit one warpgroup's registers, one block an SM whose
dkdv splits the four products over two warpgroups (s, p and dv in one,
dp, ds and dk in the other, p passed through shared memory), so that s
is computed once. At the training shapes the products bound both
(``chip_smoke.bwd_bound_ms``); the source's header says what each
instance does about it.
fp32 operands go to ``csrc/flash_attention_f32.cu``'s two entry points
(:data:`F32_ENTRY_POINTS`, in the same order, on fp32 FMA, for the fp32
kernel's head sizes), whose launch :func:`f32_bwd_plan` mirrors: dkdv's
row tiles split over the blocks of a thread-block cluster, the ranks'
partial sums added in rank order. :func:`flash_attention_bwd` launches
them and counts each launch; ``FlashAttentionFn`` (in
``flash_attention``) calls it. :func:`flash_attention_bwd_plain` is the
plain version, autograd through ``flash_attention_plain``,
:func:`bwd_prep_plain` the plain version of delta, and
:func:`f32_dkdv_ranked_plain` dk and dv summed by the plan's ranks; the
tests and ``chip_smoke.py`` compare the kernel with them, and no path of
the port takes them on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import launch
from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, \
    F32_MAX_HEAD, check_kernel_operands, f32_pair, flash_attention_plain, \
    vec_of

#: in launch order: dq writes the delta that dkdv reads
ENTRY_POINTS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
#: the fp32 kernel's, in the same order and with the same arguments
F32_ENTRY_POINTS = ("flash_attention_f32_bwd_dq",
                    "flash_attention_f32_bwd_dkdv")


#: the fp32 backward's compiled (D, DV) pairs, the smoke configs'; every
#: other ``f32_pair`` runs the (0, 0) instance, which reads them at run time
F32_BWD_PAIRS = ((8, 8), (12, 12), (16, 16), (24, 16), (32, 32))
F32_THREADS = 128           # a block of either entry point
F32_ROWS = 32               # (position, head-of-group) rows of a row tile
F32_KEYS = 64               # keys of a key tile
F32_STAGES = 2              # ring stages of the streamed tiles
F32_MAX_SPLIT = 8           # dkdv: blocks of one cluster, at most
F32_SLOTS = 132 * 8         # dkdv's split: 132 SMs x 8 blocks


class F32BwdPlan(NamedTuple):
    """The fp32 backward's launches (``flash_attention_f32.cu``): dq's
    blocks, dkdv's ``split`` blocks a cluster over ``dkdv_blocks``; per
    key tile, each rank's row tiles [first, end) (``ranges``); each
    launch's dynamic shared memory in bytes; the compiled (D, DV)
    instance ((0, 0): head sizes read at run time) and dq's key slices."""
    dq_blocks: int
    dkdv_blocks: int
    split: int
    ranges: tuple[tuple[tuple[int, int], ...], ...]
    dq_smem: int
    dkdv_smem: int
    instance: tuple[int, int]
    key_slices: int


def _pad4(n: int) -> int:
    """A shared row's stride: n or n + 4 floats, an odd number of 16
    bytes."""
    return n if (n // 4) % 2 else n + 4


def f32_bwd_plan(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                 dv: int, causal: bool, kv_offset: int) -> F32BwdPlan:
    """What the fp32 backward's C entry points launch for this call (the
    source's header says why): the row tiles that see each 64-key tile,
    under a causal mask from the first position that sees its first key;
    the cluster size S, the smallest power of two with heavy / S <= total
    / ``F32_SLOTS`` (heavy: the most row tiles a key tile has; total:
    all (key tile, row tile) pairs), at most 8 and at most heavy rounded
    up to a power of two; rank r's share [t0 + r nt / S, t0 + (r + 1) nt
    / S) of a key tile's nt row tiles from t0."""
    rep = hq // hkv
    nrt = -(-sq * rep // F32_ROWS)
    tiles = []
    for k0 in range(0, skv, F32_KEYS):
        first = max(0, k0 - kv_offset) * rep if causal else 0
        t0 = min(first // F32_ROWS, nrt)
        tiles.append((t0, nrt - t0))
    total = sum(nt for _, nt in tiles)
    heavy = max(nt for _, nt in tiles)
    s = 1
    while s < F32_MAX_SPLIT and s < heavy and heavy * F32_SLOTS > s * total:
        s *= 2
    ranges = tuple(tuple((t0 + r * nt // s, t0 + (r + 1) * nt // s)
                         for r in range(s)) for t0, nt in tiles)
    inst = (d, dv) if (d, dv) in F32_BWD_PAIRS else (0, 0)
    ks = 1 if inst == (0, 0) else 8  # dq's key slices
    while ks > 1 and 8 * (d // 4) * ks > F32_THREADS:
        ks //= 2
    sd, sdv = _pad4(d), _pad4(dv)
    ring = F32_STAGES * F32_KEYS * (sd + sdv)
    dq_smem = 4 * (F32_ROWS * (sd + sdv) + 2 * F32_ROWS +
                   F32_KEYS * (F32_ROWS + 4) + max(ring, ks * F32_ROWS * d))
    dkdv_smem = 4 * max(
        F32_KEYS * (sd + sdv) +
        F32_STAGES * (F32_ROWS * (sd + sdv) + 2 * F32_ROWS) +
        2 * F32_ROWS * (F32_KEYS + 8), F32_KEYS * (d + dv))
    return F32BwdPlan(nrt * hkv * b, len(tiles) * hkv * b * s, s, ranges,
                      dq_smem, dkdv_smem, inst, ks)


def entry_points(dtype: torch.dtype) -> tuple[str, str]:
    """The backward entry points for operands of ``dtype``, in launch
    order."""
    return F32_ENTRY_POINTS if dtype == torch.float32 else ENTRY_POINTS


def bwd_prep_plain(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta [B, Hq, Sq] fp32: the sum over the head dimension of
    ``dout * out`` ([B, Sq, Hq, D] each), widened to fp32 first (what the
    dq launch writes)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, kv_offset: int = 0,
                              scale: float | None = None, q_chunk: int = 512,
                              kv_chunk: int = 1024
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_plain`` at ``dout``, by autograd
    on detached copies of q, k and v (each gradient in its input's
    dtype)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = flash_attention_plain(q, k, v, causal=causal,
                                    kv_offset=kv_offset, scale=scale,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
        return torch.autograd.grad(out, (q, k, v), dout)


def f32_dkdv_ranked_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          dout: torch.Tensor, *, causal: bool = True,
                          kv_offset: int = 0, scale: float | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) summed as the fp32 dkdv launch sums them, for the tests:
    per key tile, each rank of :func:`f32_bwd_plan` sums its row tiles
    (32 (position, head-of-group) rows each) one by one, each tile's sum
    taken apart, and the ranks' partial sums are added in rank order; p
    and ds from the plain version's log-sum-exp and delta. No path takes
    it."""
    b, sq, hq, d = q.shape
    _, skv, hkv, d_v = v.shape
    rep = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    out, lse = flash_attention_plain(q, k, v, causal=causal,
                                     kv_offset=kv_offset, scale=scale,
                                     return_lse=True)
    delta = bwd_prep_plain(out, dout)

    def rows(t, w):  # [B, Sq, Hq, w] -> [B, Hkv, Sq * rep, w]
        return t.reshape(b, sq, hkv, rep, w).permute(0, 2, 1, 3, 4) \
            .reshape(b, hkv, sq * rep, w)

    def stats(t):  # [B, Hq, Sq] -> [B, Hkv, Sq * rep]
        return t.reshape(b, hkv, rep, sq).transpose(2, 3) \
            .reshape(b, hkv, sq * rep)
    qr, dor = rows(q.float(), d), rows(dout.float(), d_v)
    lr, dl = stats(lse.float()), stats(delta)
    dev = q.device
    pos = torch.arange(sq * rep, device=dev) // rep
    kt, vt = k.float().transpose(1, 2), v.float().transpose(1, 2)
    plan = f32_bwd_plan(b, sq, skv, hq, hkv, d, d_v, causal, kv_offset)
    dk = torch.zeros(b, hkv, skv, d, device=dev)
    dvv = torch.zeros(b, hkv, skv, d_v, device=dev)
    for i, shares in enumerate(plan.ranges):
        k0, k1 = i * F32_KEYS, min((i + 1) * F32_KEYS, skv)
        keys = torch.arange(k0, k1, device=dev)
        parts = []
        for first, end in shares:
            part_k = torch.zeros(b, hkv, k1 - k0, d, device=dev)
            part_v = torch.zeros(b, hkv, k1 - k0, d_v, device=dev)
            for t in range(first, end):
                r = slice(t * F32_ROWS, min((t + 1) * F32_ROWS, sq * rep))
                s = torch.einsum("bhkd,bhrd->bhkr", kt[:, :, k0:k1],
                                 qr[:, :, r]) * scale
                p = torch.exp(s - lr[:, :, None, r])
                if causal:
                    hide = keys[:, None] > pos[r][None, :] + kv_offset
                    p = p.masked_fill(hide, 0.0)
                dp = torch.einsum("bhkd,bhrd->bhkr", vt[:, :, k0:k1],
                                  dor[:, :, r])
                ds = p * (dp - dl[:, :, None, r])
                part_v = part_v + torch.einsum("bhkr,bhrd->bhkd", p,
                                               dor[:, :, r])
                part_k = part_k + torch.einsum("bhkr,bhrd->bhkd", ds,
                                               qr[:, :, r])
            parts.append((part_k, part_v))
        sum_k, sum_v = parts[0]
        for part_k, part_v in parts[1:]:
            sum_k, sum_v = sum_k + part_k, sum_v + part_v
        dk[:, :, k0:k1], dvv[:, :, k0:k1] = sum_k * scale, sum_v
    return dk.transpose(1, 2).contiguous(), dvv.transpose(1, 2).contiguous()


def entry_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
               delta: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
               dv: torch.Tensor, scale: float, causal: bool,
               kv_offset: int) -> dict[str, tuple]:
    """Each entry point's arguments before the stream, keyed by
    :func:`entry_points` of q's dtype (the bf16 and fp32 entry points
    take the same): dq writes ``dq`` and ``delta`` (from ``out`` and
    ``dout``); dkdv writes ``dk`` and ``dv`` from ``lse`` and
    ``delta``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, d_v = v.shape
    tail = (float(scale), int(causal), int(kv_offset))
    qkv = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    name_dq, name_dkdv = entry_points(q.dtype)
    return {
        name_dq: (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, sq, skv, hq, hkv, d, d_v, *qkv,
            *out.stride()[:3], *dout.stride()[:3], *tail),
        name_dkdv: (
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, hq, hkv, d, d_v, *qkv,
            *dout.stride()[:3], *tail),
    }


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, scale: float, causal: bool,
                        kv_offset: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) on the card: each entry point launched once, in the
    order of :func:`entry_points`, and counted. q [B, Sq, Hq, D], k [B,
    Skv, Hkv, D], v [B, Skv, Hkv, DV], out / dout [B, Sq, Hq, DV], all
    bf16 (with (D, DV) in :data:`BWD_HEAD_DIMS`) or all fp32 (D and DV
    multiples of 4 up to ``F32_MAX_HEAD``); ``dout`` is made contiguous,
    which autograd's cotangent usually already is; ``lse`` [B, Hq, Sq]
    fp32 from the forward launch. The gradients are contiguous, in their
    inputs' dtype and shapes."""
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    dtype = q.dtype
    if any(t.dtype != dtype for t in (k, v, out, dout)) or \
            dtype not in (torch.bfloat16, torch.float32) or \
            lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: q, k, v, out and dout must "
                         "be all bf16 or all fp32, and lse fp32")
    if dtype == torch.bfloat16 and (d, dv) not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention_bwd: head sizes (key, value) {(d, dv)} are "
            f"not instantiated {BWD_HEAD_DIMS} in bf16")
    if dtype == torch.float32 and not f32_pair(d, dv):
        raise NotImplementedError(
            f"flash_attention_bwd: head sizes (key, value) {(d, dv)} are "
            f"not instantiated in fp32 (multiples of 4 up to "
            f"{F32_MAX_HEAD})")
    dout = dout.contiguous()
    check_kernel_operands("flash_attention_bwd", q, k, v, out, dout,
                          vec=vec_of(dtype))
    lse = lse.contiguous()
    delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty((b, skv, hkv, d), dtype=dtype, device=q.device)
    dvv = torch.empty((b, skv, hkv, dv), dtype=dtype, device=q.device)
    args = entry_args(q, k, v, out, dout, lse, delta, dq, dk, dvv, scale,
                      causal, kv_offset)
    for name in entry_points(dtype):
        launch(name, q, *args[name])
    return dq, dk, dvv
