"""Multi-rank helpers of the port's CPU tests: spawn gloo ranks, and the
bodies they run.

``run_ranks(body, world, tmp_path, *args)`` runs ``body(rank, world,
tmp_path, *args)`` on ``world`` gloo ranks through
``repro_torch.launch.ranks.run_ranks``: one thread each, a new
``file://`` store under ``tmp_path``, killed past ``timeout`` seconds.
Bodies write what the test compares into ``tmp_path`` (``torch.save``).
This module imports no JAX, so a rank starts in the time torch takes to
import.
"""
from __future__ import annotations

import os
import uuid
from pathlib import Path

import torch

from repro_torch.launch import ranks


def run_ranks(body, world: int, tmp_path, *args, timeout: float = 120.0,
              backend: str | None = "gloo") -> None:
    tmp = Path(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    store = tmp / f"store-{uuid.uuid4().hex[:8]}"
    ranks.run_ranks(body, world, tmp, *args, backend=backend,
                    init_method=f"file://{store}", timeout=timeout,
                    threads=1)


def load(path) -> dict:
    return torch.load(path, weights_only=False)


# ---------------------------------------------------------------------------
# Bodies
# ---------------------------------------------------------------------------


def shard_body(rank, world, tmp, cases):
    """Each case (name, mesh shape, mesh axes, logical axes, array): the
    array distributed by ``shard_params_tree`` on a cpu ``DeviceMesh``;
    writes this rank's local shard, its mesh coordinate and the
    placements; the first case's DTensor again after
    ``with_logical_constraint(d, (None, "mlp"))`` under ``use_mesh``.
    Also the host mesh's shape and names."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.sharding import shard_params_tree, use_mesh, \
        with_logical_constraint
    out = {}
    for name, shape, axes, logical, arr in cases:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        d = shard_params_tree({"w": torch.from_numpy(arr)},
                              {"w": logical}, mesh)["w"]
        out[name] = {"local": d.to_local().clone(),
                     "coord": mesh.get_coordinate(),
                     "placements": list(d.placements),
                     "full": d.full_tensor()}
        if name == "data_model":             # redistributed by its axes
            with use_mesh(mesh):
                r = with_logical_constraint(d, (None, "mlp"))
            out["constrained"] = {"local": r.to_local().clone(),
                                  "coord": mesh.get_coordinate(),
                                  "placements": list(r.placements)}
    host = make_host_mesh("cpu")
    out["host_mesh"] = {"names": host.mesh_dim_names,
                        "shape": tuple(host.shape)}
    torch.save(out, tmp / f"shard_{rank}.pt")


def pipeline_body(rank, world, tmp, ws, x, n_micro):
    """``gpipe`` over a 1-D "pod" mesh of ``world`` stages: layers
    ``tanh(x @ w)``, stage params from the stack (full on every rank)
    and, a second time, as DTensors sharded ``Shard(0)`` on the stage
    axis."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.parallel.pipeline import gpipe, stage_params_from_stack
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))

    def stage_body(params_local, h):          # [L / stages, D, D]
        for w in params_local:
            h = torch.tanh(h @ w)
        return h

    pipelined = gpipe(stage_body, mesh, "pod", n_micro=n_micro)
    stacked = stage_params_from_stack(torch.from_numpy(ws), world)
    y_full = pipelined(stacked, torch.from_numpy(x))
    sharded = distribute_tensor(stacked, mesh, [Shard(0)])
    y_dt = pipelined(sharded, torch.from_numpy(x))
    torch.save({"full": y_full, "dtensor": y_dt}, tmp / f"pipe_{rank}.pt")


def compress_body(rank, world, tmp, grads_per_rank, residuals, n_replicas):
    """``compressed_grad_allreduce(axis_name="data")`` on a (world,) mesh
    inside ``use_mesh``, and with ``mesh=`` and ``n_replicas``, from this
    rank's gradients and residuals; also the codes' int32 sum."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.layers import tree_from_numpy, tree_leaves, \
        tree_unflatten
    from repro_torch.parallel import compress
    from repro_torch.parallel.sharding import use_mesh
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    grads = tree_from_numpy(grads_per_rank[rank], "cpu")
    state = compress.CompressionState(tree_from_numpy(residuals[rank], "cpu"))
    with use_mesh(mesh):
        out, new = compress.compressed_grad_allreduce(grads, state,
                                                      axis_name="data")
    out_n, new_n = compress.compressed_grad_allreduce(
        grads, state, axis_name="data", n_replicas=n_replicas, mesh=mesh)
    sums = []
    for g, r in zip(tree_leaves(grads), tree_leaves(state.residual)):
        s = compress.compress_int8(g.float() + r)[0].to(torch.int32)
        dist.all_reduce(s)
        sums.append(s)
    sums = tree_unflatten(grads, sums)
    torch.save({"out": out, "residual": new.residual, "out_n": out_n,
                "residual_n": new_n.residual, "code_sums": sums},
               tmp / f"compress_{rank}.pt")


def elastic_save_body(rank, world, tmp, state, step):
    """Save ``state`` ({"w": fp32, "b": bf16, "step"}) through
    ``CheckpointManager`` from a (2, 2) mesh: "w" sharded P("data",
    "model"), "b" P("model"), "step" replicated; rank 0 writes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel.sharding import P, placements
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    specs = {"w": P("data", "model"), "b": P("model"), "step": P()}
    sharded = {k: distribute_tensor(v, mesh, placements(specs[k], mesh))
               for k, v in state.items()}
    mgr = CheckpointManager(str(tmp / "ckpt"))
    mgr.save(step, sharded, blocking=True)
    # every rank returns only once the write is published
    if mgr.latest_step() != step:
        raise AssertionError(f"rank {rank}: steps {mgr.all_steps()}")


def elastic_restore_body(rank, world, tmp, like):
    """Restore onto a (1, 2) mesh: "w" P(None, "model"), "step" P(),
    "b" with no sharding (a plain tensor like ``like``'s)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel.sharding import NamedSharding, P
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    sh = {"w": NamedSharding(mesh, P(None, "model")), "b": None,
          "step": NamedSharding(mesh, P())}
    got = CheckpointManager(str(tmp / "ckpt")).restore(like, shardings=sh)
    torch.save({"local": got["w"].to_local().clone(),
                "full": got["w"].full_tensor(),
                "placements": list(got["w"].placements),
                "want": list(sh["w"].placements),
                "step": got["step"].full_tensor(),
                "step_placements": list(got["step"].placements),
                "b": got["b"]},
               tmp / f"restore_{rank}.pt")


def launcher_body(rank, world, tmp, runs):
    """``repro_torch.launch.train.main`` for each (name, argv) of ``runs``
    under this gloo group: the final state's parameters and first
    moments, the metrics and the rows, or the exit code and stderr where
    it exits."""
    import contextlib
    import io

    from repro_torch.launch import train
    out = {}
    for name, argv in runs:
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                res = train.main(argv)
        except SystemExit as e:
            out[name] = {"exit": e.code, "stderr": err.getvalue()}
            continue
        out[name] = {"params": res["state"].params,
                     "moments": res["state"].opt.m,
                     "metrics": [{k: v.clone() for k, v in m.items()}
                                 for m in res["metrics"]],
                     "rows": res["rows"],
                     "mesh": (res["mesh"].mesh_dim_names,
                              tuple(res["mesh"].shape))}
    torch.save(out, tmp / f"launch_{rank}.pt")


def torchrun_body(rank, world, tmp, port, argv):
    """``repro_torch.launch.train.main(argv)`` as a ``torchrun`` child runs
    it: no process group exists, and RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT are set. Writes the final parameters,
    the lines printed, and whether a group is left afterwards."""
    import contextlib
    import io

    import torch.distributed as dist

    from repro_torch.launch import train
    if dist.is_initialized():
        raise AssertionError("a process group exists before the launcher")
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        res = train.main(argv)
    torch.save({"params": res["state"].params,
                "log": log.getvalue().splitlines(),
                "group_left": dist.is_initialized()},
               tmp / f"torchrun_{rank}.pt")


# ---------------------------------------------------------------------------
# Tensor parallelism (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def serve_steps(arch, params, batch: dict, mesh=None, rules=None) -> dict:
    """The serving path the tensor-parallel tests hold, in the port: an
    LM's prefill (last position) into an fp32 cache of S + 2 and one
    decode step of ``tokens[:, :1]`` at S; the recurrent families' two
    decode steps from an empty state; the encoder-decoder's encode, its
    bf16 cross cache and one decode step. ``batch`` holds the global
    tensors; with ``mesh`` the parameters are DTensors already, and the
    batch and the cache are laid out here by ``rules``; the results come
    back whole."""
    from repro_torch.models.layers import param_axes_tree
    from repro_torch.parallel import sharding as S
    mod, cfg = arch.model_module(), arch.model
    whole = batch["tokens"]
    b, s = whole.shape

    def cache_of(specs, make):
        c = make()
        return c if mesh is None else S.shard_params_tree(
            c, param_axes_tree(specs), mesh, rules)

    def tok(t):
        return t if mesh is None else S.shard_batch({"t": t}, mesh, rules)["t"]

    if mesh is not None:
        batch = S.shard_batch(batch, mesh, rules)
    tokens = batch["tokens"]
    out = {}
    if arch.module == "lm":
        cache = cache_of(mod.cache_specs(cfg, b, s + 2, torch.float32),
                         lambda: mod.init_cache(cfg, b, s + 2, torch.float32,
                                                device="cpu"))
        out["prefill"], cache = mod.prefill(
            params, tokens, cache, cfg, extra_embed=batch.get("extra_embed"),
            last_only=True)
        out["decode"], _ = mod.decode_step(params, tok(whole[:, :1]), cache,
                                           s, cfg)
    elif arch.module in ("ssm", "hybrid"):
        kw = {} if arch.module == "ssm" else {"max_seq": s + 2}
        cache = cache_of(mod.cache_specs(cfg, b, kw.get("max_seq", 0),
                                         torch.float32),
                         lambda: mod.init_cache(cfg, b, dtype=torch.float32,
                                                device="cpu", **kw))
        out["decode0"], _ = mod.decode_step(params, tok(whole[:, :1]),
                                            cache, 0, cfg)
        out["decode1"], _ = mod.decode_step(params, tok(whole[:, 1:2]),
                                            cache, 1, cfg)
    else:
        cache = cache_of(mod.cache_specs(cfg, b, s + 2, s, torch.float32),
                         lambda: mod.init_cache(cfg, b, s + 2, s,
                                                torch.float32, device="cpu"))
        memory = mod.encode(params, batch["frames"], cfg)
        cache = mod.build_cross_cache(params, memory, cfg, cache)
        out["decode"], _ = mod.decode_step(params, tok(whole[:, :1]), cache,
                                           0, cfg)
    return {k: v.full_tensor() if S.is_dtensor(v) else v
            for k, v in out.items()}


def tp_body(rank, world, tmp, shape, cases):
    """Each case (arch id, the reference's initial params as numpy, the
    batch as numpy) on a ``shape`` mesh over ("data", "model"): the
    params through ``params_from_jax`` and ``shard_params_tree``; the
    forward's logits and aux, :func:`serve_steps`, the loss and its
    gathered gradients, and one ``make_train_step`` step (metrics, the
    new params and first moments gathered). Rank 0 writes them."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.models.layers import tree_leaves, tree_unflatten
    from repro_torch.parallel import sharding as S
    from repro_torch.train import step as T
    from repro_torch.train.optimizer import AdamWConfig
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    for arch_id, np_params, np_batch in cases:
        base = registry.get(arch_id)
        arch = dataclasses.replace(base, model=base.smoke)
        mod, cfg = arch.model_module(), arch.model
        rules = T.arch_rules(arch)
        params = mod.params_from_jax(np_params, "cpu")
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        with S.use_mesh(mesh, rules):
            dp = S.shard_params_tree(params, mod.param_axes(cfg), mesh,
                                     rules)
            db = S.shard_batch(batch, mesh, rules)
            if arch.module == "encdec":
                logits, aux = mod.forward(dp, db["frames"], db["tokens"],
                                          cfg)
            elif arch.module == "lm":
                logits, aux = mod.forward(
                    dp, db["tokens"], cfg, extra_embed=db.get("extra_embed"))
            else:
                logits, aux = mod.forward(dp, db["tokens"], cfg)
            got = {"logits": logits.full_tensor(),
                   "aux": aux.full_tensor() if S.is_dtensor(aux) else aux,
                   "serve": serve_steps(arch, dp, batch, mesh, rules)}
            leaves = [p.detach().requires_grad_() for p in tree_leaves(dp)]
            loss, _ = T.make_loss_fn(arch)(tree_unflatten(dp, leaves), db)
            grads = T.reduce_gradients(
                list(torch.autograd.grad(loss, leaves)), mesh)
            got["loss"] = loss.full_tensor()
            got["grads"] = [g.full_tensor() for g in grads]
        state = T.shard_train_state(T.init_train_state(params),
                                    mod.param_axes(cfg), mesh, rules)
        step = T.make_train_step(arch, AdamWConfig(lr=3e-4, total_steps=1),
                                 mesh=mesh)
        new, metrics = step(state, batch)
        got["metrics"] = {k: v.clone() for k, v in metrics.items()}
        got["params"] = [p.full_tensor() for p in tree_leaves(new.params)]
        got["moments"] = [m.full_tensor() for m in tree_leaves(new.opt.m)]
        out[arch_id] = got
    if rank == 0:
        torch.save(out, tmp / f"tp_{'x'.join(map(str, shape))}.pt")
