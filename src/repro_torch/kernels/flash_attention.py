"""Flash attention (forward): the serving path's prefill attention.

The CUDA kernel (``csrc/flash_attention.cu``, entry ``flash_attention``)
stands in for the JAX package's Pallas kernel ``kernels/flash_attention.py
::flash_attention`` and computes what ``models/layers.py::
blockwise_attention`` computes there: online-softmax attention with fp32
running statistics, a causal mask offset by ``kv_offset``, ragged
sequence lengths masked in the kernel, and grouped-query attention by
mapping query head ``h`` to KV head ``h // (Hq // Hkv)`` (no repeated
K or V). The value head size may differ from the key's: MLA's 192-wide
keys (128 + 64 rotary columns) over 128-wide values. Both products are
bf16 tensor-core ``mma.sync`` with fp32 accumulators; K and V tiles
stream through a ``cp.async`` ring.

:func:`flash_plan` picks the launch. The prefill form runs one block per
(64-row query tile, query head, batch) and walks the KV tiles in a loop,
skipping those wholly above the causal diagonal. The decode form, taken
when ``Sq * Hq / Hkv <= 16``, runs one block per (KV head, batch) that
packs the query heads sharing the KV head, times the ``Sq`` positions,
into the 16 rows of one tensor-core tile, so each K and V tile is read
once for all of them.

:func:`flash_attention` launches the kernel on CUDA tensors and counts
the launch, or raises; on CPU tensors, or with ``mode="ref"``, it
computes :func:`flash_attention_plain`, the chunked online softmax of
``blockwise_attention`` in plain PyTorch, whose autograd is the
gradient there.

fp32. fp32 queries go to ``csrc/flash_attention_f32.cu`` (entry
``flash_attention_f32``): the same function on the CUDA cores' fp32 FMA
(no TF32), for any key and value head sizes that are multiples of 4 up
to :data:`F32_MAX_HEAD` (the smoke configs' 8-32), over fp32 K and V or
a bf16 cache (widened in the kernel; p is then rounded to bf16 before
``p . v``, as the plain version rounds it to the value dtype).

Training. On CUDA tensors that need a gradient (grad mode on and q, k or
v requiring it) the call goes through :class:`FlashAttentionFn`: the
forward launch also writes each row's log-sum-exp, and the backward is
the hand-written kernel of ``flash_attention_bwd`` (two launches): in
bf16 for the (key, value) head sizes :data:`BWD_HEAD_DIMS`, in fp32 for
those of the fp32 kernel. A pair or dtype no kernel has raises at
forward time (:func:`kernel_route`) rather than return an output without
a ``grad_fn``. Under ``no_grad`` / ``inference_mode`` serving launches
the forward alone, with no log-sum-exp.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.build import launch

NEG_INF = -1e30
MODES = ("auto", "ref")
#: the (key, value) head sizes the kernel is instantiated for (it takes
#: bf16): three with equal sizes, and MLA's 192-wide keys over 128-wide
#: values
KERNEL_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
#: the (key, value) head sizes the bf16 backward kernel is instantiated
#: for: the forward's four, all on wgmma and TMA (two blocks an SM at (64,
#: 64) and (128, 128); one block an SM at (192, 128) and (256, 256), where
#: dkdv's dk and dv live in two warpgroups, which pass p between them)
BWD_HEAD_DIMS = KERNEL_HEAD_DIMS
#: the fp32 kernel (forward and backward) takes key and value head sizes
#: that are multiples of 4 up to this
F32_MAX_HEAD = 64
#: the kernel's launch forms, in the order of the entry point's ``form``
FORMS = ("prefill", "decode")
BLOCK_Q = 64                # prefill: query rows per block (4 warps x 16)
BLOCK_KV = 64               # keys per staged K or V tile
DECODE_ROWS = 16            # decode: packed (position, head) rows a block


def stages(form: str, d: int, dv: int | None = None) -> int:
    """K / V ring stages of ``form`` at key head size ``d`` and value
    head size ``dv`` (default ``d``), as the kernel's ``stages<DQK, DV,
    DEC>()``: 2 in the prefill form, 4 in the decode form but 3 where
    ``d + dv`` exceeds 384 (at (256, 256) 4 stages and the Q tile would
    need 264 KiB of shared memory)."""
    dv = d if dv is None else dv
    return {"prefill": 2, "decode": 3 if d + dv > 384 else 4}[form]


class FlashPlan(NamedTuple):
    """How one call launches (128 threads a block): the form, its grid
    (x, y, z) and its dynamic shared-memory bytes."""
    form: str
    grid: tuple[int, int, int]
    smem: int


def flash_plan(b: int, sq: int, skv: int, hq: int, hkv: int,
               d: int, dv: int | None = None) -> FlashPlan:
    """The launch of one call at key head size ``d`` and value head size
    ``dv`` (default ``d``): the decode form when the ``Hq / Hkv`` query
    heads of a KV head times the ``Sq`` positions fill at most one
    16-row tile (grid (Hkv, B, 1)), else the prefill form (grid (Hq, B,
    ceil(Sq / 64)), the query tile slowest). Shared memory holds the bf16
    Q tile [rows, d] and the ring of :func:`stages` stages of a K tile
    [64, d] and a V tile [64, dv]. The wrapper passes only the form; the
    C entry point works out the same grid and shared memory itself."""
    dv = d if dv is None else dv
    if min(b, sq, skv, hq, hkv, d, dv) <= 0 or hq % hkv:
        raise ValueError(f"flash_plan: no launch for B={b} Sq={sq} "
                         f"Skv={skv} Hq={hq} Hkv={hkv} D={d} DV={dv}")
    if sq * (hq // hkv) <= DECODE_ROWS:
        form, grid, rows = "decode", (hkv, b, 1), DECODE_ROWS
    else:
        form, grid, rows = "prefill", (hq, b, -(-sq // BLOCK_Q)), BLOCK_Q
    smem = 2 * (rows * d + stages(form, d, dv) * BLOCK_KV * (d + dv))
    return FlashPlan(form, grid, smem)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, kv_offset: int = 0,
                          scale: float | None = None, q_chunk: int = 512,
                          kv_chunk: int = 1024, return_lse: bool = False):
    """Plain version of :func:`flash_attention`: ``blockwise_attention``'s
    schedule, an online softmax over ``kv_chunk`` keys for each
    ``q_chunk`` of queries. With ``return_lse`` it returns (out, lse):
    each row's fp32 ``m + log(l)`` [B, Hq, Sq], what the kernel writes
    for its backward.

    q: [B, Sq, Hq, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, DV], Hq %
    Hkv == 0; the output is [B, Sq, Hq, DV]. Scores,
    statistics and the accumulator are fp32 (bf16 operands are widened
    before each product, which is exact); p is rounded to the value
    type before ``p . v``, as the reference does, and that rounding's
    gradient is the identity in fp32 (the reference's autodiff rounds
    the cotangent of p to bf16 there; the backward kernel does not, and
    neither does this plain version). A ragged last chunk
    is sliced rather than padded: padded keys would be masked to
    -1e30 and add exactly 0.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    rep = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    out = torch.empty((b, sq, hq, v.shape[-1]), dtype=v.dtype,
                      device=q.device)
    lse = torch.empty((b, hq, sq), device=q.device) if return_lse else None
    for q0 in range(0, sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].float()
        rows = qi.shape[1]
        qpos = q0 + torch.arange(rows, device=q.device) + kv_offset
        m = torch.full((b, hq, rows), NEG_INF, device=q.device)
        l = torch.zeros((b, hq, rows), device=q.device)
        acc = torch.zeros((b, hq, rows, v.shape[-1]), device=q.device)
        for k0 in range(0, skv, kv_chunk):
            kj = k[:, k0:k0 + kv_chunk].repeat_interleave(rep, dim=2)
            vj = v[:, k0:k0 + kv_chunk].repeat_interleave(rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qi, kj.float()) * scale
            if causal:
                kpos = k0 + torch.arange(kj.shape[1], device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = p.to(v.dtype).float()
            if pv.requires_grad:
                # the same value, whose gradient is the identity in fp32:
                # autograd through .to(bf16).float() would round the
                # cotangent dp to bf16 before ds = p (dp - delta), which
                # cancels (pv - p is exact, so p + (pv - p) is pv)
                pv = p + (pv - p).detach()
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pv, vj.float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + rows] = o.permute(0, 2, 1, 3).to(v.dtype)
        if return_lse:
            lse[:, :, q0:q0 + rows] = m + torch.log(torch.clamp(l, min=1e-30))
    return (out, lse) if return_lse else out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_offset: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, D]")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[-1] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
    if kv_offset < 0:
        raise ValueError(f"flash_attention: kv_offset {kv_offset} < 0")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    # k and v share a dtype; q has it too, or is fp32 over a narrower
    # cache (the reference's encoder-decoder decodes fp32 queries over
    # its bf16 cross cache: the plain version widens each operand, the
    # kernel refuses anything but bf16)
    if k.dtype != v.dtype or q.dtype not in (k.dtype, torch.float32):
        raise ValueError("flash_attention: q, k, v of different dtypes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, kv_offset: int = 0,
                    scale: float | None = None, q_chunk: int = 512,
                    kv_chunk: int = 1024, mode: str = "auto"
                    ) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, DV] ->
    [B, Sq, Hq, DV].

    Any strides with the last dimension contiguous (``[B, H, S, D]``
    tensors transposed to ``[B, S, H, D]`` views need no copy). The
    kernels take bf16 with (D, DV) in :data:`KERNEL_HEAD_DIMS`, and fp32
    queries (over fp32 or bf16 K and V) with D and DV multiples of 4 up
    to :data:`F32_MAX_HEAD`; anything else raises on the card. The
    output has v's dtype. ``q_chunk`` / ``kv_chunk`` set only the plain
    version's schedule.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _check(q, k, v, kv_offset)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    if mode == "ref" or not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal,
                                     kv_offset=kv_offset, scale=scale,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    route = kernel_route(d, dv, q.dtype, needs_grad, k.dtype)
    check_kernel_operands("flash_attention", q, k, v, vec=vec_of(q.dtype))
    if skv == 0:
        raise ValueError("flash_attention: no keys")
    if route == "autograd":
        return FlashAttentionFn.apply(q, k, v, float(scale), bool(causal),
                                      int(kv_offset))
    return _forward_kernel(q, k, v, scale, causal, kv_offset)[0]


def f32_pair(d: int, dv: int) -> bool:
    """Whether the fp32 kernel takes key and value head sizes (d, dv)."""
    return all(0 < n <= F32_MAX_HEAD and n % 4 == 0 for n in (d, dv))


def kernel_route(d: int, dv: int, dtype: torch.dtype, needs_grad: bool,
                 kv_dtype: torch.dtype | None = None) -> str:
    """How a call on CUDA tensors runs: ``"forward"`` (one launch, no
    gradient), or ``"autograd"`` (:class:`FlashAttentionFn`: the forward
    with its log-sum-exp, and the backward kernel) where a gradient is
    needed. ``dtype`` (the queries') picks the kernel: bf16 the bf16
    kernels at :data:`KERNEL_HEAD_DIMS`, fp32 the fp32 kernel at
    :func:`f32_pair` sizes (over fp32 K and V, or a bf16 cache
    ``kv_dtype`` without a gradient). Raises for a dtype or head sizes no
    kernel is built for: a gradient never falls back to the plain
    version, and is never dropped."""
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    if dtype == torch.bfloat16:
        if (d, dv) not in KERNEL_HEAD_DIMS:
            raise NotImplementedError(
                f"flash_attention: head sizes (key, value) {(d, dv)} are "
                f"not instantiated {KERNEL_HEAD_DIMS} in bf16")
    elif dtype == torch.float32:
        if not f32_pair(d, dv):
            raise NotImplementedError(
                f"flash_attention: head sizes (key, value) {(d, dv)} are "
                f"not instantiated in fp32 (multiples of 4 up to "
                f"{F32_MAX_HEAD})")
        if needs_grad and kv_dtype != torch.float32:
            raise NotImplementedError(
                f"flash_attention: a gradient is needed through {kv_dtype} "
                f"keys and values under fp32 queries, which no backward "
                f"kernel takes")
    else:
        raise ValueError(f"flash_attention: the kernels take bf16 or fp32, "
                         f"got {dtype}")
    return "autograd" if needs_grad else "forward"


def check_kernel_operands(kernel: str, *ts: torch.Tensor,
                          vec: int = 8) -> None:
    """Raise unless every tensor is one the kernels copy ``vec`` elements
    at a time: the last dimension contiguous, the other strides
    multiples of ``vec`` elements, the data aligned to ``vec`` elements.
    The bf16 kernels copy 16-byte rows of 8; the fp32 kernel 4 (16 bytes
    of fp32, 8 of a bf16 cache)."""
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{kernel}: the head dimension must be "
                         "contiguous")
    if any(st % vec for t in ts
           for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1) or \
            any(t.data_ptr() % (vec * t.element_size()) for t in ts):
        nbytes = sorted({vec * t.element_size() for t in ts})
        raise ValueError(
            f"{kernel}: the kernel copies rows {vec} elements at a time "
            f"({'/'.join(map(str, nbytes))}-byte chunks): strides must be "
            f"multiples of {vec} elements and the data "
            f"{'/'.join(map(str, nbytes))}-byte aligned")


def _forward_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool, kv_offset: int,
                    with_lse: bool = False):
    """One forward launch: (out, lse), lse [B, Hq, Sq] fp32 when
    ``with_lse``, else None (the kernel is passed no buffer)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    out = torch.empty((b, sq, hq, dv), dtype=v.dtype, device=q.device)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    if q.dtype == torch.float32:
        launch("flash_attention_f32", q,
               *f32_kernel_args(q, k, v, out, scale, causal, kv_offset, lse))
        return out, lse
    plan = flash_plan(b, sq, skv, hq, hkv, d, dv)
    launch("flash_attention", q,
           *kernel_args(q, k, v, out, scale, causal, kv_offset, plan, lse))
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The kernel with its gradient: the forward launch writes the
    log-sum-exp beside the output, and the backward launches
    ``flash_attention_bwd``'s two entry points on the saved q, k, v,
    output and log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, kv_offset):
        out, lse = _forward_kernel(q, k, v, scale, causal, kv_offset,
                                   with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = (scale, causal, kv_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention_bwd import \
            flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, *ctx.attn)
        return dq, dk, dv, None, None, None


def kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, scale: float, causal: bool,
                kv_offset: int, plan: FlashPlan,
                lse: torch.Tensor | None = None) -> tuple:
    """The entry point's arguments before the stream, for ``plan``'s
    form; ``lse`` (fp32 [B, Hq, Sq], contiguous) receives each row's
    log-sum-exp, or None passes a null pointer."""
    b, sq, hq, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], hq, k.shape[2], d, v.shape[-1], *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            None if lse is None else lse.data_ptr(),
            float(scale), int(causal), int(kv_offset),
            FORMS.index(plan.form))


def vec_of(dtype: torch.dtype) -> int:
    """The elements a kernel of queries of ``dtype`` copies at a time
    (:func:`check_kernel_operands`): 8 for the bf16 kernels, 4 for the
    fp32 one."""
    return 4 if dtype == torch.float32 else 8


def f32_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, scale: float, causal: bool,
                    kv_offset: int, lse: torch.Tensor | None = None
                    ) -> tuple:
    """``flash_attention_f32``'s arguments before the stream: q fp32, k
    and v fp32 or bf16 (the last argument says which), ``out`` [B, Sq,
    Hq, DV] in v's dtype, contiguous; ``lse`` as :func:`kernel_args`."""
    b, sq, hq, d = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            k.shape[1], hq, k.shape[2], d, v.shape[-1], *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3],
            None if lse is None else lse.data_ptr(),
            float(scale), int(causal), int(kv_offset),
            int(k.dtype == torch.bfloat16))
