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

The logical-axes tree of the state (``train_state_axes``) belongs to the
parallel layer (ROADMAP queue 1, item 2) and is not here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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


def make_train_step(arch, opt_cfg: AdamWConfig = AdamWConfig(),
                    compress_grads: bool = False,
                    attn_mode: str = "auto") -> Callable:
    loss_fn = make_loss_fn(arch, attn_mode)

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

        compress_state = state.compress
        if compress_grads and compress_state is not None:
            grads, compress_state = compressed_grad_allreduce(
                grads, compress_state)

        params, opt, opt_metrics = adamw_update(params, grads, state.opt,
                                                opt_cfg)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "aux": parts["aux"].detach(),
                   **opt_metrics}
        new_state = TrainState(params=params, opt=opt,
                               step=state.step + 1,
                               compress=compress_state)
        return new_state, metrics

    return train_step
