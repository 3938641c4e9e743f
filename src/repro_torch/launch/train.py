"""Training launcher: data -> train_step -> checkpoints, fault-tolerant.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch seamless-m4t-large-v2 --batch 8 --seq 256 --steps 5

The counterpart of ``repro.launch.train``, with its flags and log lines,
plus ``--device`` (default ``cuda``). Weights are random, made on the
device from ``--seed``; tokens come from ``SyntheticTokens`` with the
same seed (the reference's stream); an encoder-decoder also gets
:func:`step_frames`, the stub audio frontend's 0.1 N(0, 1) frames, new
each step. Each step is ``make_train_step`` (forward under the config's
``remat``, ``torch.autograd.grad``, optional int8 compression with error
feedback, AdamW), timed by ``StepWatchdog`` (heartbeat in
``--ckpt-dir``); ``CheckpointManager`` saves every ``--ckpt-every``
steps and at the end, and a run finds the newest checkpoint in
``--ckpt-dir`` and resumes from it. On the card every
``blockwise_attention`` (the encoder-decoder's attentions, MLA's, a
dense model's or the hybrid's above 8192 tokens) runs on the flash
kernel and its gradient on the backward kernel: in bf16 at every
published config's (key, value) head sizes ((64, 64), (128, 128),
deepseek-v2's (192, 128), gemma-7b's (256, 256)), and in fp32 at the
smoke configs' (multiples of 4 up to 64), so ``--smoke`` trains on the
card too. A config that no kernel takes raises before anything is
built; ``--device cpu`` runs the plain versions.

Data parallelism, as the reference runs under ``make_host_mesh()``: if a
default process group is initialized the launcher uses it; otherwise,
under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
environment) it makes one, NCCL with one rank per card on ``cuda``
(``cuda:LOCAL_RANK``) and gloo on ``cpu``; otherwise it runs as one
process, exactly as without this layer. With a group it trains on
``make_host_mesh`` ((world, 1) over ("data", "model")), or on the
production mesh with ``--production-mesh`` (which exits 2, naming the
device count it needs, on any other world size). Every rank draws the
global batch from the same seeded stream (and, for an encoder-decoder,
the same frames) and keeps the rows that ``logical_to_spec(("batch",
None))`` gives its mesh coordinates: a batch that the data axis does
not divide is replicated by that rule, so every rank computes it whole.
An N-rank run thus sees exactly the tokens of the one-process run. The
train step averages the gradients over the ranks (an MoE arch's
load-balance term over the global batch too); only rank 0 prints, and
only rank 0 writes checkpoints. On the production mesh the run is
tensor-parallel over its "model" axis as well: the state is sharded by
the rules (``train.step.shard_train_state``, after a resume reads the
checkpoint whole), every rank passes the global batch and the step
splits it by the "batch" rule.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch seamless-m4t-large-v2 --batch 8 --seq 256 --steps 5
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager, StepWatchdog
from repro_torch.configs import registry
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels.flash_attention import kernel_route
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.parallel.sharding import entry_axes, logical_to_spec
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import arch_rules, init_train_state, \
    make_train_step, shard_train_state, tensor_parallel


def train_flash_heads(arch, seq: int) -> tuple[int, int] | None:
    """The (key, value) head sizes of the flash launches that a train
    step of ``arch`` at sequence length ``seq`` makes, None where it
    makes none: the encoder-decoder's attentions and MLA's always; a
    dense LM's or the hybrid's above ``dense_attn_max`` tokens (below it
    their attention is the full-softmax ``dense_attention``); the ssm
    never."""
    cfg = arch.model
    if arch.module == "encdec":
        return cfg.head_dim, cfg.head_dim
    if arch.module == "lm" and cfg.mla is not None:
        return cfg.qk_dim, cfg.v_head_dim
    if arch.module in ("lm", "hybrid") and seq > getattr(
            cfg, "dense_attn_max", 8192):
        return cfg.head_dim, cfg.head_dim
    return None


def step_frames(gen: torch.Generator, batch: int, seq: int, d_model: int,
                device) -> torch.Tensor:
    """One step's stub frames for an encoder-decoder: 0.1 N(0, 1) of
    shape [batch, seq, d_model] in fp32 from ``gen``."""
    return 0.1 * torch.randn((batch, seq, d_model), generator=gen,
                             device=device)


def init_distributed(device: torch.device) -> tuple[bool, bool]:
    """(whether a default process group is in use, whether this call made
    it): the initialized one, else one from ``torchrun``'s environment
    (NCCL on ``cuda`` after ``set_device(LOCAL_RANK)``, gloo on ``cpu``),
    else none."""
    if dist.is_initialized():
        return True, False
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False, False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True, True


def batch_rows(mesh, rules, batch: int, seq: int) -> slice:
    """The rows of the global [batch, seq] batch that this rank keeps:
    ``logical_to_spec(("batch", None), mesh, rules, shape)`` splits dim 0
    over some mesh axes (row-major over them) or replicates it."""
    spec = logical_to_spec(("batch", None), mesh, rules, shape=(batch, seq))
    axes = entry_axes(spec[0] if len(spec) else None)
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = [mesh.shape[names.index(a)] for a in axes]
    index = 0
    for a, n in zip(axes, sizes):
        index = index * n + coord[names.index(a)]
    rows = batch // math.prod(sizes)
    return slice(index * rows, (index + 1) * rows)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Train; returns the final state, each step's metrics and host
    seconds, the run's tokens per second and, under a process group,
    its mesh and the rows of each global batch this rank trained on."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--production-mesh", action="store_true",
                    help="(16,16) mesh — requires 256 devices (one rank "
                         "each; exits 2 on any other world size)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    arch = registry.get(args.arch)
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke)
    device = torch.device(args.device)
    cfg = arch.model
    heads = train_flash_heads(arch, args.seq)
    if device.type == "cuda" and heads is not None:
        # a config whose head sizes or dtype no flash kernel trains fails
        # here, before anything is built (no fallback to plain attention,
        # no dropped gradient)
        kernel_route(*heads, cfg.param_dtype, needs_grad=True)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available; pass --device cpu "
                         "to train on the CPU")

    distributed, made_group = init_distributed(device)
    try:
        return _train(args, arch, device, distributed)
    finally:
        if made_group:
            dist.destroy_process_group()


def _fail(message: str) -> None:
    print(f"error: {message}", file=sys.stderr)
    raise SystemExit(2)


def _train(args, arch, device: torch.device, distributed: bool) -> dict:
    cfg = arch.model
    rules = arch_rules(arch)
    mesh, rows, rank0 = None, slice(None), True
    if args.production_mesh:
        try:
            mesh = make_production_mesh(device_type=device.type)
        except ValueError as e:
            _fail(str(e))
    elif distributed:
        mesh = make_host_mesh(device.type)
    sharded = tensor_parallel(mesh)
    if mesh is not None:
        rank0 = dist.get_rank() == 0
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if not sharded:
            rows = batch_rows(mesh, rules, args.batch, args.seq)
    log = print if rank0 else (lambda *a, **k: None)
    if mesh is not None:
        log(f"# {'tensor' if sharded else 'data'} parallel: world "
            f"{dist.get_world_size()} over {dist.get_backend()}, mesh "
            f"{tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)}")

    mod = arch.model_module()
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
    try:
        train_step = make_train_step(arch, opt_cfg,
                                     compress_grads=args.compress_grads,
                                     mesh=mesh, rules=rules)
    except ValueError as e:       # compression on the tensor-parallel step
        _fail(str(e))
    data = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=args.seed)
    frame_gen = (torch.Generator(device=device).manual_seed(args.seed + 1)
                 if arch.module == "encdec" else None)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    dog = StepWatchdog(
        heartbeat_path=(f"{args.ckpt_dir}/heartbeat.json"
                        if args.ckpt_dir and rank0 else None))

    params = mod.init(cfg, torch.Generator(device=device).manual_seed(
        args.seed))
    state = init_train_state(params, compress_grads=args.compress_grads)
    del params
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(state, step=start)
        log(f"# resumed from checkpoint step {start}")
    if sharded:
        state = shard_train_state(state, mod.param_axes(cfg), mesh, rules)

    metrics_log, step_s = [], []
    _sync(device)
    t0 = time.time()
    for step in range(start, args.steps):
        dog.start_step(step)
        batch = {k: v[rows].to(device)
                 for k, v in data.next_batch().items()}
        if frame_gen is not None:
            batch["frames"] = step_frames(frame_gen, args.batch, args.seq,
                                          cfg.d_model, device)[rows]
        t_step = time.perf_counter()
        state, metrics = train_step(state, batch)
        _sync(device)
        step_s.append(time.perf_counter() - t_step)
        metrics_log.append(metrics)
        if dog.end_step():
            log(f"# straggler flagged at step {step} "
                f"({dog.times[-1]:.2f}s vs median "
                f"{dog.median_step_s():.2f}s)")
        if (step + 1) % args.log_every == 0:
            log(f"step {step + 1:5d}  loss {float(metrics['loss']):.4f}"
                f"  |g| {float(metrics['grad_norm']):.3f}"
                f"  lr {float(metrics['lr']):.2e}")
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, state)
    if mgr is not None:
        mgr.save(args.steps, state, blocking=True)
    dt = time.time() - t0
    n = args.steps - start
    tok_s = n * args.batch * args.seq / max(dt, 1e-9)
    log(f"# {n} steps in {dt:.1f}s ({tok_s:.0f} tok/s)")
    return {"state": state, "metrics": metrics_log, "step_s": step_s,
            "start": start, "tok_per_s": tok_s, "seconds": dt,
            "mesh": mesh, "rows": rows}


if __name__ == "__main__":
    main()
