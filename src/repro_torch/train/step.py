"""Train-step factory: loss, gradients, compression, AdamW.

The counterpart of ``repro.train.step``. ``make_train_step(arch)``
builds

    train_step(state: TrainState, batch: dict) -> (TrainState, metrics)

for every model family of the registry (the batch carries what the
family needs: ``tokens``, an encoder-decoder's ``frames``, a vision
arch's ``extra_embed``). The loss is next-token cross entropy plus 0.01
times the MoE auxiliary losses. The step runs the forward under grad
mode (each layer checkpointed as the config's ``remat`` says), takes
the gradient of every parameter leaf by ``torch.autograd.grad``,
optionally compresses it with error feedback, and applies
``adamw_update``; it returns a new state (the old one is left as it
was) and ``{loss, ce, aux, grad_norm, lr}`` as 0-d tensors on the
parameters' device. On the card the attention of every
``blockwise_attention`` call, and its gradient, are the flash kernels.

``make_train_step(..., mesh=)`` trains on a mesh. Where its "model"
axis has one rank the step is data-parallel over the batch axes ("pod",
"data", whichever it has): each rank runs the step on its rows of the
global batch, the gradients are averaged over those axes' ranks
(:func:`reduce_gradients`: the fp32 sum of every leaf in one bucket,
divided by the rank count and cast back, the reduction GSPMD performs
for the reference), then compressed and applied as on one device, so
every rank keeps the same parameters; the loss parts are averaged the
same way, so the metrics are the global batch's. An MoE arch's
load-balance term is a product of global-batch means, which
``layers.moe_apply`` all-reduces over the batch axes (the step runs the
model inside ``use_mesh``).

Where the "model" axis has more than one rank the step is
tensor-parallel as the reference's plan lays the state out
(``launch/dryrun.py``): the parameters and both AdamW moments are
DTensors with the rule-resolved placements (:func:`shard_train_state`;
heads, mlp, experts and vocab over "model", "embed" over "data"), the
batch is split by the "batch" rule, the model runs on them (the
reference's activation constraints, a vocab-parallel cross entropy on
the padded vocab), and :func:`reduce_gradients` sums each gradient's
partial sums on its local shard over the mesh axes where it is partial
(the batch axes, and "model" for weights used on sequence-split
activations) in fp32 buckets. AdamW runs on the local shards; the
gradient norm is one sum over the mesh. ``train_state_axes`` is the
state's logical-axes tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.parallel import sharding as S
from repro_torch.parallel.compress import CompressionState, \
    compressed_grad_allreduce, init_compression_state
from repro_torch.train.optimizer import AdamWConfig, OptState, adamw_init, \
    adamw_update


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: OptState
    step: torch.Tensor
    compress: CompressionState | None = None


def train_state_axes(param_axes: Any) -> TrainState:
    """Logical-axes tree congruent with TrainState (for shardings)."""
    scalar = ()
    return TrainState(
        params=param_axes,
        opt=OptState(m=param_axes, v=param_axes, count=scalar),
        step=scalar,
        compress=None)


def init_train_state(params: Any, compress_grads: bool = False
                     ) -> TrainState:
    """Zero moments and step 0 (an int32 0-d tensor) on the parameters'
    device; with ``compress_grads`` a zero error-feedback residual."""
    opt = adamw_init(params)
    return TrainState(
        params=params, opt=opt,
        step=torch.zeros((), dtype=torch.int32, device=opt.count.device),
        compress=init_compression_state(params) if compress_grads else None)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    vocab: int | None = None) -> torch.Tensor:
    """Mean CE of logits[:, :-1] predicting tokens[:, 1:], in fp32.

    The port's models return logits sliced to the vocab; padded columns,
    where a caller passes them with ``vocab``, are masked to -1e30 (they
    add exp(-1e30 - m) = 0 to the log-sum-exp, as slicing would). On
    DTensor logits (padded, vocab-sharded) it is
    :func:`~repro_torch.parallel.sharding.vocab_parallel_ce`."""
    if S.is_dtensor(logits):
        return S.vocab_parallel_ce(logits, tokens, vocab or logits.shape[-1])
    lg = logits[:, :-1].float()
    if vocab is not None and vocab < lg.shape[-1]:
        pad = torch.arange(lg.shape[-1], device=lg.device) >= vocab
        lg = lg.masked_fill(pad, -1e30)
    tgt = tokens[:, 1:].long()
    log_z = torch.logsumexp(lg, dim=-1)
    correct = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return torch.mean(log_z - correct)


def make_loss_fn(arch, attn_mode: str = "auto") -> Callable:
    """loss_fn(params, batch) -> (loss + 0.01 aux, {"ce", "aux"}).
    ``attn_mode="ref"`` runs the attention of the LM and encoder-decoder
    families on its plain version (the comparison run). On DTensor
    parameters the model returns the padded vocab's logits, which the
    cross entropy masks rather than gathers."""
    mod = arch.model_module()
    cfg = arch.model

    def loss_fn(params, batch):
        kw = {"slice_vocab": False} if S.is_dtensor(batch["tokens"]) else {}
        if arch.module == "encdec":
            logits, aux = mod.forward(params, batch["frames"],
                                      batch["tokens"], cfg,
                                      attn_mode=attn_mode, **kw)
        elif arch.module == "lm":
            logits, aux = mod.forward(params, batch["tokens"], cfg,
                                      extra_embed=batch.get("extra_embed"),
                                      attn_mode=attn_mode, **kw)
        else:
            logits, aux = mod.forward(params, batch["tokens"], cfg, **kw)
        loss = next_token_loss(logits, batch["tokens"], vocab=cfg.vocab)
        if S.is_dtensor(loss) and not S.is_dtensor(aux):
            aux = _replicated(aux, loss.device_mesh)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux}

    return loss_fn


def _replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reduce_gradients(grads: Any, mesh) -> Any:
    """The mean of ``grads`` over the mesh's batch axes: every leaf in one
    fp32 bucket, summed over each batch axis's group in turn
    (``all_reduce``), divided by the rank count and cast back to the
    leaf's dtype. Raises where the group's backend cannot reduce the
    bucket on its device.

    DTensor gradients (the tensor-parallel step) are sums already: each
    leaf that is ``Partial`` over some mesh axes is summed there on its
    local shard, the leaves partial over the same axes in one fp32
    bucket, and comes back with those axes ``Replicate``."""
    leaves = tree_leaves(grads)
    if leaves and S.is_dtensor(leaves[0]):
        return tree_unflatten(grads, _reduce_partials(leaves))
    groups, n = S.batch_groups(mesh)
    if n == 1 or not leaves:
        return grads
    bucket = torch.cat([g.reshape(-1).float() for g in leaves])
    for group in groups:
        dist.all_reduce(bucket, group=group)
    bucket.div_(n)
    out, i = [], 0
    for g in leaves:
        out.append(bucket[i:i + g.numel()].view(g.shape).to(g.dtype))
        i += g.numel()
    return tree_unflatten(grads, out)


def _reduce_partials(leaves: list) -> list:
    """:func:`reduce_gradients` on DTensor leaves (see there)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    out = list(leaves)
    by_dims: dict[tuple, list[int]] = {}
    for i, g in enumerate(leaves):
        dims = tuple(d for d, p in enumerate(g.placements) if p.is_partial())
        if dims:
            by_dims.setdefault(dims, []).append(i)
    for dims, idx in by_dims.items():
        mesh = leaves[idx[0]].device_mesh
        locs = [leaves[i].to_local() for i in idx]
        bucket = torch.cat([t.reshape(-1).float() for t in locs])
        for d in dims:
            bucket = funcol.wait_tensor(funcol.all_reduce(bucket, "sum",
                                                          (mesh, d)))
        k = 0
        for i, t in zip(idx, locs):
            g = leaves[i]
            pl = [Replicate() if p.is_partial() else p for p in g.placements]
            out[i] = DTensor.from_local(
                bucket[k:k + t.numel()].view(t.shape).to(t.dtype), mesh, pl,
                run_check=False, shape=g.shape, stride=g.stride())
            k += t.numel()
    return out


def arch_rules(arch) -> S.AxisRules:
    """``DEFAULT_RULES`` with ``arch``'s overrides."""
    return S.DEFAULT_RULES.replace(**arch.rule_overrides)


def tensor_parallel(mesh) -> bool:
    """Whether ``mesh`` has a "model" axis of more than one rank."""
    return mesh is not None and S.axis_size(mesh, "model") > 1


def shard_train_state(state: TrainState, param_axes: Any, mesh,
                      rules: S.AxisRules) -> TrainState:
    """``state``'s parameters and moments as DTensors on ``mesh`` with the
    placements ``rules`` give their logical axes (the moments like the
    parameters); the counts stay plain tensors."""
    def put(tree):
        return S.shard_params_tree(tree, param_axes, mesh, rules)
    return dataclasses.replace(
        state, params=put(state.params),
        opt=OptState(m=put(state.opt.m), v=put(state.opt.v),
                     count=state.opt.count))


def make_train_step(arch, opt_cfg: AdamWConfig = AdamWConfig(),
                    compress_grads: bool = False,
                    attn_mode: str = "auto", mesh=None,
                    rules: S.AxisRules | None = None) -> Callable:
    """The train step; with ``mesh``, data-parallel over its batch axes,
    and tensor-parallel where its "model" axis has more than one rank
    (see the module docstring: the state must then be
    :func:`shard_train_state`'s, and a batch of plain tensors is the
    global batch, split here). ``rules`` defaults to the arch's."""
    loss_fn = make_loss_fn(arch, attn_mode)
    rules = rules or arch_rules(arch)
    groups, n_dp = S.batch_groups(mesh)
    sharded = tensor_parallel(mesh)
    if sharded and compress_grads:
        raise ValueError("gradient compression runs on whole gradients; "
                         "the tensor-parallel step does not compress")

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        if sharded and not S.is_dtensor(batch["tokens"]):
            batch = S.shard_batch(batch, mesh, rules)
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad(), _mesh_scope(mesh, rules):
            loss, parts = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        params = tree_unflatten(state.params,
                                [p.detach() for p in leaves])
        parts = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                 "aux": parts["aux"].detach()}
        if sharded:
            grads = reduce_gradients(grads, mesh)
            parts = {k: v.full_tensor() if S.is_dtensor(v) else v
                     for k, v in parts.items()}
        elif n_dp > 1:
            grads = reduce_gradients(grads, mesh)
            vec = torch.stack([parts[k].float() for k in parts])
            for group in groups:
                dist.all_reduce(vec, group=group)
            vec.div_(n_dp)
            parts = {k: vec[i] for i, k in enumerate(parts)}

        compress_state = state.compress
        if compress_grads and compress_state is not None:
            grads, compress_state = compressed_grad_allreduce(
                grads, compress_state)

        with _replication(sharded):
            params, opt, opt_metrics = adamw_update(params, grads,
                                                    state.opt, opt_cfg)
        metrics = {**parts, **opt_metrics}
        new_state = TrainState(params=params, opt=opt,
                               step=state.step + 1,
                               compress=compress_state)
        return new_state, metrics

    return train_step


def _mesh_scope(mesh, rules):
    return contextlib.nullcontext() if mesh is None else \
        S.use_mesh(mesh, rules)


def _replication(on: bool):
    """DTensor's implicit replication (plain 0-d tensors, the learning
    rate and the clip scale, meet DTensor leaves) where ``on``."""
    if not on:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()
