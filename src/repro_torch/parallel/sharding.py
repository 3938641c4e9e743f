"""Logical-axis sharding rules, and their resolution onto a torch mesh.

Every parameter and activation in the model zoo carries a tuple of
logical axis names (one per dimension, ``None`` for "no preference").
``AxisRules`` maps logical names to mesh axis names; ``logical_to_spec``
resolves a logical tuple into a ``PartitionSpec`` under a concrete mesh,
enforcing two invariants:

  1. a mesh axis is consumed at most once per spec (first logical dim
     that claims it wins; later claims fall back to replication);
  2. a dimension is only sharded if its size divides evenly by the
     product of the mesh axes assigned to it (uneven shards fall back to
     replication).

The default rules implement the baseline distribution plan: batch ->
(pod, data); heads / mlp / experts / vocab -> model; everything else
replicated. ZeRO-1 additionally shards optimizer state over "data"
(``zero1_spec``).

The counterpart of ``repro.parallel.sharding`` on
``torch.distributed.tensor``. A mesh is a ``DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or, where only axis names and sizes
are read (``logical_to_spec``, ``spec_tree_for``, ``zero1_spec``), a
device-free :class:`MeshShape`. ``PartitionSpec`` is the port's own: a
tuple of per-dimension entries (a mesh axis name, a tuple of them, or
None), so ``tuple(port_spec) == tuple(jax_spec)``. :func:`placements`
turns a spec into DTensor ``Shard`` / ``Replicate`` placements, one per
mesh dimension; :func:`shard_params_tree` distributes a tree with them.
The current mesh is :func:`use_mesh`'s, the counterpart of ``with
mesh:``, and so are the current rules (:func:`active_rules`).

Tensor parallelism. Under a mesh the models take DTensor parameters
(:func:`shard_params_tree`) and DTensor inputs (:func:`shard_batch`);
their matrix products, norms and residual adds are DTensor operations,
and they make the reference's ``with_logical_constraint`` calls, which
redistribute (the residual stream's ``act_res`` over "model" is
Megatron-style sequence parallelism: the row-parallel products' partial
sums are reduce-scattered onto it and all-gathered off it). A weight
is gathered over the batch axes where it is used (:func:`gather_params`:
the rules shard its "embed" dim over "data", FSDP-style, as XLA does
for the reference). Whatever DTensor does not propagate runs on local
shards through :func:`local_region`: attention on the local heads (the
flash kernel gets local CUDA tensors, never DTensors), the MoE dispatch,
the SSD, the cache writes, and the vocab-parallel pieces, the embedding
lookup on a vocab-sharded table (:func:`vocab_parallel_embed`) and the
cross entropy over vocab-sharded logits (:func:`vocab_parallel_ce`).
Collectives inside a region are the autograd-aware
:func:`all_reduce_autograd` and :func:`all_gather` over a mesh
dimension.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

import torch


MeshAxes = tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Ordered logical-name -> mesh-axes mapping."""
    rules: tuple[tuple[str, MeshAxes], ...]

    def lookup(self, name: str) -> MeshAxes:
        for n, axes in self.rules:
            if n == name:
                return axes
        return ()

    def replace(self, **overrides: MeshAxes | None) -> "AxisRules":
        """Return a copy with some logical names remapped (None removes)."""
        out = []
        seen = set()
        for n, axes in self.rules:
            if n in overrides:
                seen.add(n)
                if overrides[n] is not None:
                    out.append((n, tuple(overrides[n])))
            else:
                out.append((n, axes))
        for n, axes in overrides.items():
            if n not in seen and axes is not None:
                out.append((n, tuple(axes)))
        return AxisRules(tuple(out))


# Baseline rules. "pod" only exists on the multi-pod mesh; mesh axes not
# present in the mesh are dropped at resolution time.
DEFAULT_RULES = AxisRules((
    ("batch", ("pod", "data")),
    ("expert_group", ("pod", "data")),   # MoE dispatch group dim
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    # --- activation names (model code constraints). A name MISSING from
    # this table silently means "replicate": an absent "vocab_act" rule
    # cost a 67 GB/step fp32 logits all-gather on gemma train_4k before
    # these entries existed. Keep every constraint name listed.
    ("vocab_act", ("model",)),
    ("act_heads", ("model",)),
    ("act_kv_heads", ("model",)),
    ("act_seq_attn", ()),                # bound to ("model",) for archs
                                         # whose heads don't divide the mesh
    ("act_mlp", ("model",)),
    ("act_experts", ("model",)),
    ("kv_seq", ()),                      # decode KV cache seq: replicated in
                                         # baseline; hillclimb shards it
    ("act_res", ("model",)),             # Megatron-style sequence-parallel
                                         # residual stream: layer-boundary
                                         # activations sharded over model —
                                         # shrinks saved scan carries 16x
    ("embed", ("data",)),                # FSDP/ZeRO-3: weight embed dims
                                         # sharded over data; XLA all-gathers
                                         # per layer and frees after use
    ("seq", ()),
    ("layers", ()),
    ("head_dim", ()),
    ("state", ()),
    ("capacity", ()),
))

# Sequence-parallel variant used by the hillclimb configs: long KV caches
# sharded over the model axis, combined with an online-softmax reduction.
KV_SHARDED_RULES = DEFAULT_RULES.replace(kv_seq=("model",))

#: Logical axes whose sharding means "split output filters/columns".
#: Single source of truth shared with the NN→ISA compiler: rule tables
#: that map any of these onto a mesh axis translate to filter-parallel
#: (shard-N) multi-device plans in ``repro_torch.compiler.partition``, while
#: a sharded "layers" axis translates to pipeline stages.
FILTER_PARALLEL_AXES = ("mlp", "heads", "experts", "vocab")


# ---------------------------------------------------------------------------
# Meshes and specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices: what the spec
    functions read of a ``DeviceMesh``."""
    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} / shape "
                             f"{self.shape} length mismatch")


class PartitionSpec(tuple):
    """Per tensor dimension: a mesh axis name, a tuple of them (the dim is
    split over their product, row-major in the tuple's order), or None
    (replicated). Missing trailing entries are None."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.shape))
    if mesh.mesh_dim_names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve "
                         "logical axes")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(d) -> tuple[str, ...]:
    """The mesh axes of one spec entry (a name, a tuple of them, or
    None), as a tuple."""
    if d is None:
        return ()
    return (d,) if isinstance(d, str) else tuple(d)


def logical_to_spec(axes: Sequence[str | None] | None, mesh,
                    rules: AxisRules = DEFAULT_RULES,
                    shape: Sequence[int] | None = None) -> PartitionSpec:
    """Resolve logical axis names into a PartitionSpec for ``mesh``.

    ``shape`` (optional) enables the divisibility fallback: a dim whose
    size is not divisible by its assigned mesh axes is replicated.
    """
    if axes is None:
        return PartitionSpec()
    sizes = _mesh_axis_sizes(mesh)
    used: set[str] = set()
    dims: list[Any] = []
    for d, name in enumerate(axes):
        if name is None:
            dims.append(None)
            continue
        want = [a for a in rules.lookup(name) if a in sizes and a not in used]
        if not want:
            dims.append(None)
            continue
        if shape is not None:
            prod = math.prod(sizes[a] for a in want)
            while want and shape[d] % prod != 0:
                # Drop trailing mesh axes until the dim divides evenly.
                want = want[:-1]
                prod = math.prod(sizes[a] for a in want)
        if not want:
            dims.append(None)
            continue
        used.update(want)
        dims.append(tuple(want) if len(want) > 1 else want[0])
    # Trim trailing Nones for a tidy spec (semantically identical).
    while dims and dims[-1] is None:
        dims.pop()
    return PartitionSpec(*dims)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and not isinstance(
        x, PartitionSpec) and all(isinstance(e, (str, type(None)))
                                  for e in x))


def _map_axes(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the logical-axes leaves of ``tree`` (tuples of names or
    None, inside dicts, lists and dataclasses), with the congruent leaves
    of the trees in ``rest``."""
    if _is_axes(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_axes(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_axes(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"not a logical-axes tree leaf: {tree!r}")


def spec_tree_for(axes_tree: Any, mesh, rules: AxisRules = DEFAULT_RULES,
                  shape_tree: Any = None) -> Any:
    """Map ``logical_to_spec`` over a tree of logical-axes tuples.

    ``axes_tree`` leaves are tuples of axis names (or None); it must be
    structure-congruent with ``shape_tree`` when given (whose leaves are
    shapes: tuples of ints, or ``torch.Size``).
    """
    if shape_tree is None:
        return _map_axes(lambda a: logical_to_spec(a, mesh, rules),
                         axes_tree)
    return _map_axes(lambda a, s: logical_to_spec(a, mesh, rules, shape=s),
                     axes_tree, shape_tree)


def zero1_spec(spec: PartitionSpec, shape: Sequence[int], mesh,
               axis: str = "data") -> PartitionSpec:
    """ZeRO-1 rule: additionally shard the first replicated dim of an
    optimizer-state leaf over the data axis (when it divides evenly)."""
    sizes = _mesh_axis_sizes(mesh)
    if axis not in sizes:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for d in dims for a in entry_axes(d)}
    if axis in used:
        return spec
    for i, d in enumerate(dims):
        if d is None and shape[i] % sizes[axis] == 0 and shape[i] >= sizes[axis]:
            dims[i] = axis
            return PartitionSpec(*dims)
    return spec


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per mesh dimension:
    ``Shard(d)`` for the mesh axis that splits tensor dim ``d``, else
    ``Replicate()``. A dim split over several mesh axes is split by each
    in mesh order, so its shards are indexed row-major over them: JAX's
    order when the spec lists them in mesh order, as the rules do. A
    spec that lists them in another order is refused (DTensor would
    index its shards differently), and so is an axis the mesh lacks."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    shard_of: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: mesh axis {a!r} not in the "
                                 f"mesh's {tuple(names)}")
            if a in shard_of:
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            shard_of[a] = d
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} lists mesh axes {axes} "
                             f"out of the mesh's order {tuple(names)}")
    return tuple(Shard(shard_of[n]) if n in shard_of else Replicate()
                 for n in names)


class NamedSharding:
    """A spec on a mesh: a leaf of the sharding trees that
    ``CheckpointManager.restore(shardings=...)`` takes."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def shard_params_tree(params: Any, axes_tree: Any, mesh,
                      rules: AxisRules | None = None) -> Any:
    """Distribute a materialized tree (parameters, a cache: the same full
    tensors on every rank, on the mesh's device type) onto ``mesh`` per
    ``rules`` (default :func:`active_rules`): each leaf a DTensor with
    its resolved placements. Every rank cuts its own shard (no
    collective), and a shard owns its storage (a copy where it is a view
    into the full tensor), so the full tree can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    rules = rules or active_rules()

    def put(axes, p):
        pl = placements(logical_to_spec(axes, mesh, rules, shape=p.shape),
                        mesh)
        d = distribute_tensor(p, mesh, pl, src_data_rank=None)
        local = d.to_local()
        if local.untyped_storage().nbytes() != \
                local.numel() * local.element_size():
            d = DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                   shape=d.shape, stride=d.stride())
        return d
    return _map_axes(put, axes_tree, params)


# The (mesh, rules) of the open use_mesh blocks, innermost last: a
# process-wide stack, which autograd's device threads (they recompute a
# checkpointed layer in the backward pass) see as the caller does.
_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh, rules: AxisRules | None = None):
    """Make ``mesh`` the current mesh inside the block (the counterpart of
    ``with mesh:``), and ``rules`` (default ``DEFAULT_RULES``) the rules
    the models' constraints resolve with; the previous ones are restored
    on exit."""
    _ACTIVE.append((mesh, rules or DEFAULT_RULES))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def _current():
    return _ACTIVE[-1] if _ACTIVE else None


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or None."""
    cur = _current()
    return None if cur is None else cur[0]


def active_rules() -> AxisRules:
    """The innermost :func:`use_mesh` block's rules, else
    ``DEFAULT_RULES``."""
    cur = _current()
    return DEFAULT_RULES if cur is None else cur[1]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_placements(axes: Sequence[str | None], shape: Sequence[int], mesh,
                    rules: AxisRules | None = None) -> tuple:
    """The placements of a tensor of ``shape`` with logical ``axes`` on
    ``mesh`` under ``rules`` (default: :func:`active_rules`)."""
    spec = logical_to_spec(axes, mesh, rules or active_rules(), shape=shape)
    return placements(spec, mesh)


def with_logical_constraint(x: torch.Tensor, axes: Sequence[str | None],
                            mesh=None,
                            rules: AxisRules | None = None) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical ``axes``
    (the counterpart of ``lax.with_sharding_constraint`` via logical
    names) under ``rules`` (default :func:`active_rules`), on its own
    mesh unless ``mesh`` is given. The identity on a plain tensor, so
    model code runs unchanged on one device."""
    if not is_dtensor(x):
        return x
    mesh = mesh or x.device_mesh
    return redistribute(x, mesh, spec_placements(axes, x.shape, mesh, rules))


def redistribute(x, mesh, want) -> torch.Tensor:
    """DTensor ``x`` redistributed to placements ``want``; a mesh dim that
    moves its split from one tensor dim to another goes through
    ``Replicate`` first (an all-gather, then a local chunk), which keeps
    DTensor from searching its plans over every mesh dim (seconds a call
    on a 3-D mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(want)
    if tuple(x.placements) == want:
        return x
    moved = [isinstance(p, Shard) and isinstance(w, Shard) and p != w
             for p, w in zip(x.placements, want)]
    if any(moved):
        x = x.redistribute(mesh, [Replicate() if m else p for m, p in
                                  zip(moved, x.placements)])
    return x.redistribute(mesh, want)


def shard_batch(batch: dict, mesh, rules: AxisRules | None = None) -> dict:
    """A batch dict ({"tokens": [B, S], "frames": [B, S, M], ...}, the same
    global tensors on every rank) as DTensors split on dim 0 by the
    "batch" rule."""
    return {k: shard_params_tree(v, ("batch",) + (None,) * (v.dim() - 1),
                                 mesh, rules) for k, v in batch.items()}


#: the mesh axes a batch is split over (``DEFAULT_RULES``' "batch")
BATCH_AXES = ("pod", "data")


def batch_groups(mesh) -> tuple[list, int]:
    """The process groups of ``mesh``'s batch axes of size > 1, and the
    number of data-parallel ranks they make (1 without a mesh)."""
    if mesh is None:
        return [], 1
    axes = [a for a in BATCH_AXES if axis_size(mesh, a) > 1]
    return ([mesh.get_group(a) for a in axes],
            math.prod(axis_size(mesh, a) for a in axes))


def _batch_dims(mesh) -> list[int]:
    """The mesh dimensions that are not "model": the batch axes, over
    which a weight's "embed" dim may be sharded (FSDP)."""
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n != "model"]


def gather_params(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` replicated over the batch axes, its
    "model" placement kept: the per-use all-gather of an FSDP-sharded
    weight (its gradient is reduce-scattered back). Plain tensors pass
    through."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.layers import tree_map

    def one(w):
        if not is_dtensor(w):
            return w
        dims = _batch_dims(w.device_mesh)
        if all(isinstance(w.placements[d], Replicate) for d in dims):
            return w
        want = [Replicate() if d in dims else p
                for d, p in enumerate(w.placements)]
        return w.redistribute(w.device_mesh, want)
    return tree_map(one, tree)


def mesh_dim(mesh, name: str) -> int | None:
    names = list(mesh.mesh_dim_names)
    return names.index(name) if name in names else None


def axis_size(mesh, name: str) -> int:
    d = mesh_dim(mesh, name)
    return 1 if d is None else mesh.shape[d]


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along mesh axis ``name`` (0 without it)."""
    d = mesh_dim(mesh, name)
    return 0 if d is None else mesh.get_local_rank(d)


def local_region(fn, mesh, args: Sequence[Any], in_placements: Sequence,
                 out_placements: Sequence) -> Any:
    """``fn`` on the local shards of ``args``, its outputs made DTensors
    again (the explicit form of ``local_map``).

    ``in_placements[i]`` is what DTensor ``args[i]`` is redistributed to
    first (None: as it is; a plain argument passes unchanged). Each
    output gets ``out_placements[j]`` (a single placements tuple for a
    single output; None: the output is returned as ``fn`` gave it).
    Outputs must be even shards: ``Shard`` for distinct pieces,
    ``Partial`` for partial sums, ``Replicate`` where every rank holds
    the same value.

    Gradients: the region is split over every mesh dimension on which
    some input is sharded; there each replicated input's gradient is
    declared ``Partial`` (every rank holds its own contribution), so a
    replicated weight used on local heads, or on local rows, gets the
    sum of the ranks' contributions.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    fixed = []
    for a, pl in zip(args, in_placements):
        if isinstance(a, DTensor) and pl is not None:
            a = redistribute(a, mesh, pl)
        fixed.append(a)
    split = {d for a in fixed if isinstance(a, DTensor)
             for d, p in enumerate(a.placements) if isinstance(p, Shard)}
    local = []
    for a in fixed:
        if isinstance(a, DTensor):
            grad_pl = [Partial() if isinstance(p, Replicate) and d in split
                       else p for d, p in enumerate(a.placements)]
            a = a.to_local(grad_placements=grad_pl)
        local.append(a)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = (out_placements,) if single else tuple(out_placements)
    wrapped = tuple(
        o if pl is None or not isinstance(o, torch.Tensor)
        else DTensor.from_local(o, mesh, pl, run_check=False)
        for o, pl in zip(outs, pls))
    return wrapped[0] if single else wrapped


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, group, backward):
        import torch.distributed._functional_collectives as funcol
        ctx.group, ctx.backward = group, backward
        return funcol.wait_tensor(funcol.all_reduce(x, op, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        if ctx.backward == "sum":
            g = funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum",
                                                     ctx.group))
        return g, None, None, None


def all_reduce_autograd(x: torch.Tensor, group, op: str = "sum",
                        backward: str = "identity") -> torch.Tensor:
    """All-reduce ``x`` over ``group`` (a process group, or ``(mesh,
    dim)``) as a functional collective. ``backward="identity"`` passes
    the gradient through (Megatron's reduce-from: what follows runs the
    same on every rank, each holding the whole gradient);
    ``backward="sum"`` all-reduces it (every rank's loss is its own
    share, as in the data-parallel step). ``op="max"`` has no
    gradient."""
    if op != "sum":
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x.detach(), op, group))
    return _AllReduce.apply(x, op, group, backward)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        import torch.distributed._functional_collectives as funcol
        ctx.dim, ctx.group = dim, group
        return funcol.wait_tensor(funcol.all_gather_tensor(x.contiguous(),
                                                           dim, group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.group)), None, None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` concatenated along ``dim`` over ``group`` (a process group,
    or ``(mesh, dim)``) in rank order, as a functional collective; the
    gradient is the sum of every rank's, each rank's piece scattered
    back to it."""
    return _AllGather.apply(x, dim, group)


def vocab_parallel_embed(table: torch.Tensor, tokens: torch.Tensor
                         ) -> torch.Tensor:
    """``table[tokens]`` for a DTensor ``table`` [V, M] (its vocab dim
    sharded over "model", or not) and DTensor ``tokens`` [B, S]: each
    rank looks up the tokens in its slice of rows and zeroes the rest,
    and the result is the ``Partial`` sum over "model" (exact: one rank
    contributes each row). Plain tensors: ``table[tokens]``."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    table = gather_params(table)
    md = mesh_dim(mesh, "model")
    sharded = md is not None and isinstance(table.placements[md], Shard)
    tok_pl = tuple(Replicate() if d == md else p
                   for d, p in enumerate(tokens.placements))
    out_pl = tuple(Partial() if (d == md and sharded) else p
                   for d, p in enumerate(tok_pl))

    def body(tab, tok):
        if not sharded:
            return tab[tok]
        lo = axis_index(mesh, "model") * tab.shape[0]
        idx = tok.long() - lo
        ok = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[torch.where(ok, idx, 0)]
        return rows * ok[..., None].to(rows.dtype)
    return local_region(body, mesh, [table, tokens], [None, tok_pl], out_pl)


def vocab_parallel_ce(logits: torch.Tensor, tokens: torch.Tensor,
                      vocab: int) -> torch.Tensor:
    """Mean next-token cross entropy of DTensor ``logits`` [B, S, Vp]
    (fp32, padded vocab sharded over "model" or not) against ``tokens``
    [B, S]: the log-sum-exp and the target's logit are all-reduced over
    "model" from each rank's columns (columns >= ``vocab`` masked to
    -1e30 first, as ``next_token_loss`` masks them), so no rank gathers
    the logits. Returns a 0-d DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    md = mesh_dim(mesh, "model")
    last = logits.dim() - 1
    sharded = md is not None and logits.placements[md] == Shard(last)
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in logits.placements]
    lg_pl = tuple(Shard(last) if d == md and sharded else p
                  for d, p in enumerate(rows))
    tok_pl = out_pl = tuple(rows)
    group = (mesh, md) if sharded else None

    def body(lg, tok):
        lg = lg[:, :-1].float()
        lo = axis_index(mesh, "model") * lg.shape[-1] if sharded else 0
        cols = lo + torch.arange(lg.shape[-1], device=lg.device)
        lg = lg.masked_fill(cols >= vocab, -1e30)
        tgt = tok[:, 1:].long() - lo
        ok = (tgt >= 0) & (tgt < lg.shape[-1])
        correct = torch.gather(lg, -1, torch.where(ok, tgt, 0)[..., None])
        correct = correct[..., 0] * ok.to(lg.dtype)
        m = torch.amax(lg, dim=-1).detach()
        if group is not None:
            m = all_reduce_autograd(m, group, op="max")
        sumexp = torch.sum(torch.exp(lg - m[..., None]), dim=-1)
        if group is not None:
            sumexp = all_reduce_autograd(sumexp, group)
            correct = all_reduce_autograd(correct, group)
        return m + torch.log(sumexp) - correct       # [B, S-1]
    per_token = local_region(body, mesh, [logits, tokens], [lg_pl, tok_pl],
                             out_pl)
    return torch.mean(per_token)
