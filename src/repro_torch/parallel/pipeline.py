"""Opt-in pipeline parallelism over a mesh axis (GPipe schedule).

The baseline multi-pod plan treats "pod" as pure data parallelism. For
models whose weights exceed one pod's memory, this module provides the
alternative: the layer stack is split into ``n_stages`` contiguous
stages (one per rank of the axis), micro-batches stream through the
stages, and only stage-boundary activations cross between ranks:
O(micro_batch x d_model) per tick instead of O(grad bytes).

The counterpart of ``repro.parallel.pipeline`` on ``torch.distributed``.
Each rank of the axis runs its own stage; a GPipe schedule runs
``n_micro + n_stages - 1`` ticks, and each tick point-to-point sends
move the boundary activations stage -> stage + 1 within the axis's
process group. Bubble fraction = (n_stages - 1) / (n_micro + n_stages -
1): choose n_micro >> n_stages. The transport follows the group's
backend: NCCL sends device tensors; gloo has no send or receive for
CUDA tensors, so there each boundary tensor is copied to host memory,
sent, and copied back to the device explicitly (the body itself still
runs on the device). Forward only (inference / evaluation path), as in
the reference.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

# the module, not its names: models.layers imports this package
from repro_torch.models import layers as _layers


def _local_row(p, stage: int):
    """This stage's row of a stacked leaf: the local shard of a DTensor
    split ``Shard(0)`` over the stage axis (leading dim 1), else row
    ``stage`` of a full tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(p, DTensor):
        local = p.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"stage params: a DTensor leaf's local shard "
                             f"has {local.shape[0]} rows; shard its "
                             f"leading dim over the stage axis")
        return local[0]
    return p[stage]


def _exchange(out: torch.Tensor, stage: int, n_stages: int, group,
              host: bool) -> torch.Tensor:
    """Send ``out`` to stage + 1 and receive stage - 1's (zeros at stage
    0, as ``ppermute`` leaves a stage that nobody sends to)."""
    wire = out.cpu() if host else out.contiguous()
    buf = torch.zeros_like(wire)
    ops = []
    if stage < n_stages - 1:
        ops.append(dist.P2POp(dist.isend, wire,
                              dist.get_global_rank(group, stage + 1), group))
    if stage > 0:
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, stage - 1), group))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    return buf.to(out.device) if host else buf


def gpipe(body: Callable, mesh, axis: str, n_micro: int):
    """Build a pipelined apply: (stage_params, x) -> y.

    ``body(stage_params, x_mb) -> y_mb`` is one stage's computation on
    one micro-batch (same output shape as input). ``stage_params``
    leaves have a leading stage dimension of size ``mesh[axis].size()``
    (full tensors, each stage taking its row) or are DTensors sharded
    ``Shard(0)`` on ``axis``; ``x`` (the whole batch, the same on every
    rank) has a leading batch dim that ``n_micro`` divides. Every rank
    of the axis returns the whole output.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    last = n_stages - 1

    def pipelined(stage_params: Any, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} % n_micro {n_micro} != 0")
        mbs = x.reshape(n_micro, b // n_micro, *x.shape[1:])
        params_local = _layers.tree_map(lambda p: _local_row(p, stage), stage_params)
        host = x.is_cuda and dist.get_backend(group) == "gloo"
        carry = torch.zeros_like(mbs[0])
        outs = torch.zeros_like(mbs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects micro-batch t; the others take the wire
            inp = mbs[min(t, n_micro - 1)] if stage == 0 else carry
            out = body(params_local, inp)
            # the last stage commits micro-batch t - (n_stages - 1)
            oi = t - last
            if stage == last and oi >= 0:
                outs[oi] = out
            if t < n_micro + last - 1:         # the last tick sends nothing on
                carry = _exchange(out, stage, n_stages, group, host)
        # broadcast the last stage's outputs to every stage member
        dist.broadcast(outs, dist.get_global_rank(group, last), group=group)
        return outs.reshape(b, *x.shape[1:])

    return pipelined


def stage_params_from_stack(params_stacked: Any, n_stages: int) -> Any:
    """[L, ...] layer-stacked params -> [n_stages, L/n_stages, ...]."""
    def split(p):
        n = p.shape[0]
        if n % n_stages:
            raise ValueError(f"layers {n} % stages {n_stages} != 0")
        return p.reshape(n_stages, n // n_stages, *p.shape[1:])
    return _layers.tree_map(split, params_stacked)
