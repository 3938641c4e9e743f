"""AdamW in plain PyTorch, written out as the reference writes it.

The counterpart of ``repro.train.optimizer``: fp32 moments whatever the
parameters' dtype (bf16 Adam moments diverge), the update in fp32 and
cast back to the parameter's dtype, decoupled weight decay on matrices
only (``ndim >= 2``), global-norm clipping and the warm-up + cosine
schedule. Trees are the models' nested dicts and lists of tensors; the
step count is a 0-d int32 tensor on the parameters' device, as the
reference's ``count`` is an int32 scalar. ``torch.optim.AdamW`` is not
used: its update differs in the order of its operations and in where
it applies the decay and the bias corrections.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class OptState:
    m: Any
    v: Any
    count: torch.Tensor


def _device_of(tree: Any) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params: Any) -> OptState:
    """Zero fp32 moments congruent with ``params`` (DTensors laid out as
    the parameters are) and count 0, on the parameters' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=_device_of(params)))


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_ratio * lr`` at ``total_steps``; fp32 arithmetic."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32. DTensor leaves
    (the tensor-parallel step): each rank sums its local shards, once
    for each replicated copy (the rank at coordinate 0 of a leaf's
    replicated mesh axes counts it), and the sums are all-reduced over
    the mesh; a plain 0-d tensor comes back."""
    leaves = tree_leaves(tree)
    if leaves and _is_dtensor(leaves[0]):
        return _sharded_global_norm(leaves)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded_global_norm(leaves: list) -> torch.Tensor:
    import torch.distributed._functional_collectives as funcol
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = None
    for x in leaves:
        if any(coord[d] != 0 for d, p in enumerate(x.placements)
               if p.is_replicate()):
            continue
        part = torch.sum(torch.square(x.to_local().float()))
        total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), device=leaves[0].to_local().device)
    for d in range(mesh.ndim):
        total = funcol.wait_tensor(funcol.all_reduce(total, "sum",
                                                     (mesh, d)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled by min(1, max_norm / norm) (in fp32, cast back to
    each leaf's dtype), and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(params: Any, grads: Any, opt: OptState, cfg: AdamWConfig
                 ) -> tuple[Any, OptState, dict]:
    """One AdamW step. Returns (new_params, new_opt, metrics): new trees,
    the inputs left as they are."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = opt.count + 1
    lr = cosine_schedule(cfg, count)
    c32 = count.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=c32.device), c32)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=c32.device), c32)

    def upd(p, g, m, v):
        g32 = g.float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * g32
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mhat = m_new / b1c
        vhat = v_new / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * step).to(p.dtype)
        return p_new, m_new, v_new

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(tree_leaves(params), tree_leaves(grads), tree_leaves(opt.m),
               tree_leaves(opt.v))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, OptState(m=new_m, v=new_v, count=count), metrics
