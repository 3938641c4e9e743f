"""Gradient compression with error feedback, in plain PyTorch.

The counterpart of ``repro.parallel.compress``: per-leaf symmetric int8
codes with one fp32 max-abs scale, and error feedback (EF-SGD): the
quantization residual of step t is added back to the gradient of step
t + 1 before it is compressed, so what was lost is sent later. The
train step's ``compress_grads`` path runs it on one device, where the
all-reduce is the identity: each leaf is compressed, decompressed and
its residual kept, with the reference's arithmetic.

The cross-pod all-reduce of the compressed codes (``axis_name``) belongs
to the parallel layer (ROADMAP queue 1, item 2) and raises until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class CompressionState:
    """Error-feedback residual, congruent with the grad tree (fp32)."""
    residual: Any


def init_compression_state(grads: Any) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def compress_int8(g: torch.Tensor, eps: float = 1e-12
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: (codes int8, scale fp32),
    scale = max(max |g|, eps) / 127 and codes = clip(round(g / scale)),
    rounding half to even. The division is by a tensor on ``g``'s device,
    an IEEE division on the card too."""
    hi = torch.tensor(127.0, dtype=torch.float32, device=g.device)
    scale = torch.clamp(torch.amax(torch.abs(g.float())), min=eps) / hi
    codes = torch.clamp(torch.round(g.float() / scale), -127, 127)
    return codes.to(torch.int8), scale.to(torch.float32)


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compressed_grad_allreduce(grads: Any, state: CompressionState,
                              axis_name: str | None = None,
                              n_replicas: int | None = None
                              ) -> tuple[Any, CompressionState]:
    """Error-feedback int8 compression of every leaf of ``grads``.

    With ``axis_name=None`` (one device) each leaf is compressed with its
    residual added, decompressed in its dtype, and the new residual is
    what the codes did not carry: the reference's arithmetic outside
    ``shard_map``. ``axis_name`` names the pod all-reduce of the
    parallel layer, which is not ported yet (ROADMAP queue 1, item 2)."""
    if axis_name is not None or n_replicas is not None:
        raise NotImplementedError(
            f"compressed_grad_allreduce: the all-reduce over "
            f"{axis_name!r} is the parallel layer's (ROADMAP queue 1, "
            f"item 2), not ported yet; pass axis_name=None")
    new_grads, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(state.residual)):
        g32 = g.float() + r
        codes, scale = compress_int8(g32)
        deq = decompress_int8(codes, scale)
        new_res.append(g32 - deq)                   # error feedback
        new_grads.append(deq.to(g.dtype))
    return (tree_unflatten(grads, new_grads),
            CompressionState(tree_unflatten(grads, new_res)))


def compression_ratio(grads: Any) -> float:
    """Bytes(int8 codes + scales) / bytes(original) for a grad tree."""
    leaves = tree_leaves(grads)
    orig = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() + 4 for g in leaves)
    return comp / max(orig, 1)
