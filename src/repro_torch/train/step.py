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

``make_train_step(..., mesh=)`` trains data-parallel over the mesh's
batch axes ("pod", "data", whichever it has): each rank runs the step
on its rows of the global batch, the gradients are averaged over those
axes' ranks (:func:`reduce_gradients`: the fp32 sum of every leaf in
one bucket, divided by the rank count and cast back, the reduction GSPMD
performs for the reference), then compressed and applied as on one
device, so every rank keeps the same parameters; the loss parts are
averaged the same way, so the metrics are the global batch's. The
parameters stay whole on every rank: the "model" axis runs replicated
(no tensor parallelism yet). ``train_state_axes`` is the state's
logical-axes tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.layers import tree_leaves, tree_unflatten
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
    add exp(-1e30 - m) = 0 to the log-sum-exp, as slicing would)."""
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
    families on its plain version (the comparison run)."""
    mod = arch.model_module()
    cfg = arch.model

    def loss_fn(params, batch):
        if arch.module == "encdec":
            logits, aux = mod.forward(params, batch["frames"],
                                      batch["tokens"], cfg,
                                      attn_mode=attn_mode)
        elif arch.module == "lm":
            logits, aux = mod.forward(params, batch["tokens"], cfg,
                                      extra_embed=batch.get("extra_embed"),
                                      attn_mode=attn_mode)
        else:
            logits, aux = mod.forward(params, batch["tokens"], cfg)
        loss = next_token_loss(logits, batch["tokens"], vocab=cfg.vocab)
        return loss + 0.01 * aux, {"ce": loss, "aux": aux}

    return loss_fn


#: the mesh axes a batch is split over (``DEFAULT_RULES``' "batch")
BATCH_AXES = ("pod", "data")


def batch_groups(mesh) -> tuple[list, int]:
    """The process groups of ``mesh``'s batch axes of size > 1, and the
    number of data-parallel ranks they make (1 without a mesh)."""
    if mesh is None:
        return [], 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    axes = [a for a in BATCH_AXES if sizes.get(a, 1) > 1]
    n = 1
    for a in axes:
        n *= sizes[a]
    return [mesh.get_group(a) for a in axes], n


def reduce_gradients(grads: Any, mesh) -> Any:
    """The mean of ``grads`` over the mesh's batch axes: every leaf in one
    fp32 bucket, summed over each batch axis's group in turn
    (``all_reduce``), divided by the rank count and cast back to the
    leaf's dtype. Raises where the group's backend cannot reduce the
    bucket on its device."""
    groups, n = batch_groups(mesh)
    leaves = tree_leaves(grads)
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


def has_moe(arch) -> bool:
    """Whether ``arch``'s loss carries the MoE load-balance aux."""
    return arch.module == "hybrid" or getattr(arch.model, "moe",
                                              None) is not None


def make_train_step(arch, opt_cfg: AdamWConfig = AdamWConfig(),
                    compress_grads: bool = False,
                    attn_mode: str = "auto", mesh=None) -> Callable:
    """The train step; with ``mesh``, data-parallel over its batch axes
    (see the module docstring). An MoE arch at more than one
    data-parallel rank raises: its load-balance aux (``moe_apply``'s
    E * sum(mean(p) * mean(onehot))) is a product of global means, which
    per-rank means do not reproduce."""
    loss_fn = make_loss_fn(arch, attn_mode)
    groups, n_dp = batch_groups(mesh)
    if n_dp > 1 and has_moe(arch):
        raise ValueError(
            f"{arch.arch_id}: data-parallel training over {n_dp} ranks is "
            f"not supported for MoE archs: the load-balance aux is a "
            f"product of global-batch means that per-rank means do not "
            f"reproduce (ROADMAP queue 3)")

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(state.params)]
        params = tree_unflatten(state.params, leaves)
        with torch.enable_grad():
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
        if n_dp > 1:
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

        params, opt, opt_metrics = adamw_update(params, grads, state.opt,
                                                opt_cfg)
        metrics = {**parts, **opt_metrics}
        new_state = TrainState(params=params, opt=opt,
                               step=state.step + 1,
                               compress=compress_state)
        return new_state, metrics

    return train_step
