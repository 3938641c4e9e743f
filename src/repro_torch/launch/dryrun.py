"""Multi-pod dry-run of the port: run every (arch x shape x mesh) cell's
step once on a fake production mesh, with no device and no data.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --multi-pod --out dryrun.json

The counterpart of ``repro.launch.dryrun``: the proof that the
distribution plan is coherent without the hardware. One process joins a
fake process group of 256 ranks (512 with ``--multi-pod``;
``torch.testing._internal.distributed.fake_pg``: collectives return at
once), builds the production ``DeviceMesh`` over it, and plays rank 0.
Each cell's inputs are ``meta`` DTensors laid out by the reference's
rules (``resolve_rules``: the arch's and the shape's overrides;
``_shard_struct``, ``_shard_batch``, ``abstract_train_state``,
``abstract_cache``), and ``build_step`` gives the step the reference
lowers: the train step, a prefill (an LM's, writing a ``seq_len``
cache) or the forward's last position, or one decode step against a
``seq_len`` cache. The step runs eagerly on the meta tensors under
:class:`CostMode`, which sees each rank-local operation (DTensor
desugars into them and into its collectives inside the mode) and
records what the reference reads off the compiled program:

  * ``flops_per_device``: ``torch.utils.flop_counter``'s formulas on the
    local shapes (matrix products; elementwise work is not counted, as
    XLA's "flops" hardly counts it);
  * ``bytes_per_device``: every local operation's input and output
    bytes summed, views and metadata operations left out: what XLA's
    "bytes accessed" counts for each HLO op;
  * ``collective_bytes_per_device``: the result bytes of each functional
    collective, under the reference's keys ``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all`` and
    ``collective-permute`` (the reference sums the collectives' result
    shapes), ``collective_bytes_total``, and the same ops counted
    (``collective_counts_per_device``). The fake mesh is a CPU mesh, on
    which DTensor moves a dim's split to another dim (yi-34b's and
    qwen2-vl-2b's query, heads to rows) by an all-gather and a chunk
    where a card's mesh would use an all-to-all;
  * ``mem_argument_size_in_bytes`` (the local shards of the step's
    inputs), ``mem_output_size_in_bytes`` (its outputs, less those that
    are inputs written in place) and ``mem_temp_size_in_bytes`` (the
    peak of the bytes the step allocated and still held: storages
    tracked by the mode, freed when their last view dies).

A train or prefill cell runs the model at one and at two layers
(``_reduced_model``) and reports F1 + (L - 1)(F2 - F1) for the FLOPs,
bytes, collectives and outputs, exact for stacks of identical layers,
as the reference fits its scanned programs. The peak is not additive:
a train cell's grows by the layer inputs that rematerialisation keeps,
fitted from two and three layers (the first layer's transients do not
recur), and a prefill's does not grow with depth (the larger of the
two). A decode cell runs at full depth.
``host_s`` is the cell's seconds on the host, not a device time. Every
figure is a prediction of the port's plan on its ranks, not a
measurement.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import registry
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.launch.mesh import PRODUCTION_SHAPES
from repro_torch.models import layers as mlayers
from repro_torch.parallel.sharding import DEFAULT_RULES, AxisRules, \
    logical_to_spec, placements
from repro_torch.train.optimizer import OptState
from repro_torch.train.step import TrainState, make_train_step


# ---------------------------------------------------------------------------
# The fake production mesh
# ---------------------------------------------------------------------------


def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on a fake process group
    of prod(shape) ranks, this process rank 0 (a group already made is
    reused when its size matches)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_production_mesh(multi_pod: bool = False):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return fake_mesh(shape, axes)


# ---------------------------------------------------------------------------
# Abstract (meta DTensor) inputs laid out by the rules
# ---------------------------------------------------------------------------


def resolve_rules(arch: registry.ArchConfig,
                  shape: registry.ShapeSpec) -> AxisRules:
    return DEFAULT_RULES.replace(**arch.rule_overrides,
                                 **shape.rule_overrides)


def _meta(shape, dtype, axes, mesh, rules: AxisRules):
    """A meta DTensor of global ``shape`` laid out by logical ``axes``."""
    from torch.distributed.tensor import DTensor, Shard
    pl = placements(logical_to_spec(axes, mesh, rules, shape=shape), mesh)
    local = list(shape)
    for d, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.shape[d]
    t = torch.empty(local, dtype=dtype, device="meta")
    return DTensor.from_local(t, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _shard_struct(spec_tree: Any, mesh, rules: AxisRules) -> Any:
    """ParamSpec tree -> meta DTensor tree with the rules' placements."""
    return mlayers.tree_map(
        lambda s: _meta(s.shape, s.dtype, s.axes, mesh, rules), spec_tree)


def _shard_batch(batch_specs: dict, mesh, rules: AxisRules) -> dict:
    return {k: _meta(s.shape, s.dtype,
                     ("batch",) + (None,) * (s.dim() - 1), mesh, rules)
            for k, s in batch_specs.items()}


def abstract_train_state(arch: registry.ArchConfig, mesh, rules: AxisRules
                         ) -> TrainState:
    """Params, and fp32 moments laid out as the params (not ZeRO-1)."""
    pspecs = arch.model_module().param_specs(arch.model)
    f32 = mlayers.tree_map(lambda s: dataclasses.replace(
        s, dtype=torch.float32), pspecs)
    scalar = torch.zeros((), dtype=torch.int32, device="meta")
    return TrainState(
        params=_shard_struct(pspecs, mesh, rules),
        opt=OptState(m=_shard_struct(f32, mesh, rules),
                     v=_shard_struct(f32, mesh, rules), count=scalar),
        step=scalar, compress=None)


def abstract_cache(arch: registry.ArchConfig, shape: registry.ShapeSpec,
                   mesh, rules: AxisRules) -> Any:
    mod = arch.model_module()
    b, s = shape.global_batch, shape.seq_len
    if arch.module == "ssm":
        cspecs = mod.cache_specs(arch.model, b)
    elif arch.module == "encdec":
        cspecs = mod.cache_specs(arch.model, b, max_tgt=s, src=s)
    else:
        cspecs = mod.cache_specs(arch.model, b, s)
    return _shard_struct(cspecs, mesh, rules)


# ---------------------------------------------------------------------------
# Step builders per shape kind
# ---------------------------------------------------------------------------


def build_step(arch: registry.ArchConfig, shape: registry.ShapeSpec,
               mesh, rules: AxisRules):
    """Returns (fn, args): the cell's step and its abstract inputs."""
    mod = arch.model_module()
    cfg = arch.model
    params = None if shape.kind == "train" else \
        _shard_struct(mod.param_specs(cfg), mesh, rules)
    batch = _shard_batch(make_batch_specs(arch, shape), mesh, rules)

    if shape.kind == "train":
        step = make_train_step(arch, mesh=mesh, rules=rules)
        return step, (abstract_train_state(arch, mesh, rules), batch)

    if shape.kind == "prefill":
        if arch.module == "lm":
            cache = abstract_cache(arch, shape, mesh, rules)

            def prefill_step(params, batch, cache):
                return mod.prefill(params, batch["tokens"], cache, cfg,
                                   extra_embed=batch.get("extra_embed"),
                                   last_only=True)
            return prefill_step, (params, batch, cache)

        def fwd_step(params, batch):
            if arch.module == "encdec":
                logits, _ = mod.forward(params, batch["frames"],
                                        batch["tokens"], cfg, last_only=True)
            elif arch.module == "lm":
                logits, _ = mod.forward(params, batch["tokens"], cfg,
                                        extra_embed=batch.get("extra_embed"),
                                        last_only=True)
            else:
                logits, _ = mod.forward(params, batch["tokens"], cfg,
                                        last_only=True)
            return logits
        return fwd_step, (params, batch)

    # decode: one token against a cache of seq_len (the last position)
    cache = abstract_cache(arch, shape, mesh, rules)
    pos = shape.seq_len - 1

    def serve_step(params, token, cache):
        return mod.decode_step(params, token, cache, pos, cfg)
    return serve_step, (params, batch["token"], cache)


# ---------------------------------------------------------------------------
# What a rank does: FLOPs, bytes, collectives, live memory
# ---------------------------------------------------------------------------

#: the functional (and c10d) collectives, by the reference's HLO names
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: operations that move no bytes: views, metadata, the collectives' waits
_FREE = {"view", "_unsafe_view", "expand", "t", "transpose", "permute",
         "slice", "select", "as_strided", "detach", "alias", "unsqueeze",
         "squeeze", "split", "split_with_sizes", "unbind", "reshape",
         "_reshape_alias", "view_as", "wait_tensor", "empty",
         "empty_strided", "lift_fresh", "_to_copy_noop", "clone_noop"}


def _tensors(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts one rank's local work (see the module docstring): DTensor
    operations are handed back to DTensor (``NotImplemented``), whose
    local operations and collectives then come through the mode."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._collected = 0
        self._seen: set[int] = set()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        weakref.finalize(st, self._free, key, n)
        if self.live > self.peak:
            if self.live > max(1.1 * self._collected, 2 ** 26):
                # a new high: first free what only reference cycles
                # hold (Python's collector would, at its own moment),
                # so the peak counts live tensors, within 10%
                gc.collect()
                self._collected = self.live
            self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            return out       # DTensor's sharding propagation, not the rank
        name = func._overloadpacket.__name__
        if name in COLLECTIVE_KINDS:
            kind = COLLECTIVE_KINDS[name]
            n = sum(_nbytes(t) for t in _tensors(out))
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + n
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        elif name not in _FREE:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in _tensors(out))
            f = self._flops.get(func._overloadpacket)
            if f is not None:
                self.flops += f(*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self._track(t)
        return out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    total, seen = 0, set()
    for t in _tensors(_leaves(tree)):
        loc = t.to_local() if isinstance(t, DTensor) else t
        key = loc.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += _nbytes(loc)
    return total


def _leaves(tree) -> list:
    if isinstance(tree, (TrainState, OptState)):
        return [_leaves(getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [_leaves(v) for v in tree.values()]
    if isinstance(tree, (list, tuple)):
        return [_leaves(v) for v in tree]
    return tree


def _run_once(arch, shape, mesh, rules) -> dict:
    """Build the cell's inputs, run its step once under :class:`CostMode`,
    and return the rank's figures."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import use_mesh
    fn, args = build_step(arch, shape, mesh, rules)
    in_keys = {(t.to_local() if isinstance(t, DTensor) else t)
               .untyped_storage()._cdata for t in _tensors(_leaves(args))}
    mode = CostMode()
    gc.collect()
    gc.freeze()              # the mode's collections scan the step's objects
    try:
        with use_mesh(mesh, rules), mode:
            out = fn(*args)
    finally:
        gc.unfreeze()
    outs = [t.to_local() if isinstance(t, DTensor) else t
            for t in _tensors(_leaves(out))]
    fresh = {t.untyped_storage()._cdata: _nbytes(t) for t in outs
             if t.untyped_storage()._cdata not in in_keys}
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "coll": dict(mode.coll_bytes), "counts": dict(mode.coll_counts),
            "arg": _local_bytes(args), "out": sum(fresh.values()),
            "temp": mode.peak}


def _reduced_model(arch: registry.ArchConfig, n_scan: int = 2):
    """Same config with the layer stack cut to ``n_scan`` trips, "fully
    unrolled" (``scan_unroll``, which the port's loops ignore, set as the
    reference sets it): a point of the two-point cost fit. Returns
    (arch, the real trip count, ``n_scan``)."""
    m = arch.model
    if arch.module == "hybrid":
        small = dataclasses.replace(m, n_layers=n_scan * 8,
                                    scan_unroll=True)
        real_trips = m.n_periods
    elif arch.module == "encdec":
        # enc and dec scale together; use the (equal) layer counts
        small = dataclasses.replace(m, n_enc_layers=n_scan,
                                    n_dec_layers=n_scan, scan_unroll=True)
        real_trips = m.n_enc_layers
    else:
        prefix = getattr(m, "n_dense_prefix", 0)
        small = dataclasses.replace(m, n_layers=prefix + n_scan,
                                    scan_unroll=True)
        real_trips = m.n_layers - prefix
    return dataclasses.replace(arch, model=small), real_trips, n_scan


def two_point(f1: float, f2: float, trips: int) -> float:
    """F1 + (L - 1)(F2 - F1): exact for L identical trips when F1 and F2
    are the costs at one and at two."""
    return f1 + (trips - 1) * (f2 - f1)


def run_cell(arch_id: str, shape_name, multi_pod: bool = False,
             verbose: bool = True, mesh=None) -> dict:
    """Run one (arch, shape, mesh) cell and derive its per-rank costs (see
    the module docstring). ``shape_name`` names one of ``SHAPES`` or is a
    ``ShapeSpec`` of its own; ``mesh`` (default: the fake production
    mesh) may be any mesh over ("pod",) "data", "model"."""
    arch = registry.get(arch_id)
    shape = registry.SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    shape_name = shape.name
    if shape_name in arch.skip_shapes:
        return {"arch": arch_id, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch skips long_500k"}
    t0 = time.time()
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod)
    rules = resolve_rules(arch, shape)
    full_arg = _local_bytes(build_step(arch, shape, mesh, rules)[1])
    param_bytes = _local_bytes(_shard_struct(
        arch.model_module().param_specs(arch.model), mesh, rules))
    if shape.kind == "decode":
        # decode steps are small: full depth, exact
        c = _run_once(arch, shape, mesh, rules)
        figures = {k: c[k] for k in ("flops", "bytes", "out", "temp")}
        coll, counts = c["coll"], c["counts"]
    else:
        one, trips, _ = _reduced_model(arch, 1)
        two, _, _ = _reduced_model(arch, 2)
        c1 = _run_once(one, shape, mesh, rules)
        c2 = _run_once(two, shape, mesh, rules)
        figures = {k: two_point(c1[k], c2[k], trips)
                   for k in ("flops", "bytes", "out")}
        if shape.kind == "train":
            # the saved layer inputs grow the peak by one layer's worth a
            # trip; the first trip's transients do not recur: fit it
            # past them, from two and three trips
            c3 = _run_once(_reduced_model(arch, 3)[0], shape, mesh, rules)
            figures["temp"] = max(c2["temp"], c3["temp"]) + (trips - 3) * \
                max(0, c3["temp"] - c2["temp"])
        else:
            # a forward frees each layer's activations: no growth
            figures["temp"] = max(c1["temp"], c2["temp"])
        coll = {k: int(max(0, two_point(c1["coll"].get(k, 0),
                                        c2["coll"].get(k, 0), trips)))
                for k in set(c1["coll"]) | set(c2["coll"])}
        counts = {k: int(max(0, two_point(c1["counts"].get(k, 0),
                                          c2["counts"].get(k, 0), trips)))
                  for k in set(c1["counts"]) | set(c2["counts"])}
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": list(mesh.shape),
        "status": "ok",
        "n_chips": math.prod(mesh.shape),
        "flops_per_device": figures["flops"],
        "bytes_per_device": figures["bytes"],
        "collective_bytes_per_device": coll,
        "collective_bytes_total": int(sum(coll.values())),
        "collective_counts_per_device": counts,
        "param_bytes_per_device": int(param_bytes),
        "mem_argument_size_in_bytes": int(full_arg),
        "mem_output_size_in_bytes": int(figures["out"]),
        "mem_temp_size_in_bytes": int(figures["temp"]),
        "host_s": round(time.time() - t0, 2),
    }
    if verbose:
        print(json.dumps(rec))
        sys.stdout.flush()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = registry.list_archs() if args.arch == "all" else [args.arch]
    shapes = (list(registry.SHAPES) if args.shape == "all"
              else [args.shape])

    records = []
    failures = 0
    try:
        for a in archs:
            for s in shapes:
                try:
                    records.append(run_cell(a, s, multi_pod=args.multi_pod))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures += 1
                    traceback.print_exc()
                    records.append({"arch": a, "shape": s,
                                    "status": "error",
                                    "error": f"{type(e).__name__}: {e}"})
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"] == "skipped")
    print(f"# dry-run: {ok} ok, {sk} skipped, {failures} failed "
          f"(mesh={'2x16x16' if args.multi_pod else '16x16'})")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
