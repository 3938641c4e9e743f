"""Gradient compression with error feedback, in plain PyTorch.

The counterpart of ``repro.parallel.compress``: per-leaf symmetric int8
codes with one fp32 max-abs scale, and error feedback (EF-SGD): the
quantization residual of step t is added back to the gradient of step
t + 1 before it is compressed, so what was lost is sent later.

With ``axis_name=None`` (the train step's ``compress_grads``) each leaf
is compressed, decompressed and its residual kept: the reference's
arithmetic outside ``shard_map``. With ``axis_name`` the int32 sum of
the codes and the sum of the scales are all-reduced over that dimension
of the current mesh (``use_mesh``) or of ``mesh=``, with
``torch.distributed``: the pod all-reduce, which moves a quarter of the
bytes of fp32 gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

# the module, not its names: models.layers imports this package
from repro_torch.models import layers as _layers


@dataclasses.dataclass
class CompressionState:
    """Error-feedback residual, congruent with the grad tree (fp32)."""
    residual: Any


def init_compression_state(grads: Any) -> CompressionState:
    return CompressionState(residual=_layers.tree_map(
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
                              n_replicas: int | None = None,
                              mesh=None) -> tuple[Any, CompressionState]:
    """Error-feedback int8 all-reduce over ``axis_name``.

    ``axis_name`` names a dimension of ``mesh`` or, without one, of the
    current mesh (``parallel.sharding.use_mesh``); without either it
    raises (it never runs locally in its place). Each leaf's codes are
    summed as int32 and its scales as fp32 over that dimension's process
    group, and ``reduced = summed * (scale_sum / n) / n`` with ``n`` =
    ``n_replicas`` or the group's size (the mean scale for the sum of
    codes: exact when the scales match). With ``axis_name=None`` this is
    compress / decompress with error feedback, the reference's
    arithmetic outside ``shard_map``. Either way the new residual is the
    error against the local dequantized value."""
    group = None
    if axis_name is not None:
        from repro_torch.parallel.sharding import current_mesh
        mesh = mesh if mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError(f"compressed_grad_allreduce: axis_name "
                             f"{axis_name!r} needs a mesh (use_mesh or "
                             f"mesh=)")
        group = mesh.get_group(axis_name)
    new_grads, new_res = [], []
    for g, r in zip(_layers.tree_leaves(grads), _layers.tree_leaves(state.residual)):
        g32 = g.float() + r
        codes, scale = compress_int8(g32)
        local_deq = decompress_int8(codes, scale)
        if group is not None:
            summed = codes.to(torch.int32)
            scale_sum = scale.clone()
            dist.all_reduce(summed, group=group)
            dist.all_reduce(scale_sum, group=group)
            n = n_replicas or dist.get_world_size(group)
            # codes were scaled per replica; use the mean scale for the
            # sum of codes (exact when scales match, tight otherwise)
            reduced = summed.to(torch.float32) * (scale_sum / n) / n
        else:
            reduced = local_deq
        new_res.append(g32 - local_deq)             # error feedback
        new_grads.append(reduced.to(g.dtype))
    return (_layers.tree_unflatten(grads, new_grads),
            CompressionState(_layers.tree_unflatten(grads, new_res)))


def compression_ratio(grads: Any) -> float:
    """Bytes(int8 codes + scales) / bytes(original) for a grad tree."""
    leaves = _layers.tree_leaves(grads)
    orig = sum(g.numel() * g.element_size() for g in leaves)
    comp = sum(g.numel() + 4 for g in leaves)
    return comp / max(orig, 1)
