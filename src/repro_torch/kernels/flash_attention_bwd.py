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
(:data:`F32_ENTRY_POINTS`: the same plan and order, on fp32 FMA, for the
fp32 kernel's head sizes). :func:`flash_attention_bwd` launches them and
counts each launch; ``FlashAttentionFn`` (in ``flash_attention``) calls
it. :func:`flash_attention_bwd_plain` is the
plain version, autograd through ``flash_attention_plain``, and
:func:`bwd_prep_plain` the plain version of delta; the tests and
``chip_smoke.py`` compare the kernel with them, and no path of the port
takes them on the card.
"""
from __future__ import annotations

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
