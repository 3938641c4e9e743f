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
mesh:``. The models make no ``with_logical_constraint`` calls yet: no
tensor parallelism, so a "model" axis of size > 1 runs replicated.
"""
from __future__ import annotations

import contextlib
import contextvars
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
                      rules: AxisRules = DEFAULT_RULES) -> Any:
    """Distribute a materialized param tree (the same full tensors on every
    rank, on the mesh's device type) onto ``mesh`` per the rules: each
    leaf a DTensor with its resolved placements."""
    from torch.distributed.tensor import distribute_tensor

    def put(axes, p):
        spec = logical_to_spec(axes, mesh, rules, shape=p.shape)
        return distribute_tensor(p, mesh, placements(spec, mesh))
    return _map_axes(put, axes_tree, params)


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the current mesh inside the block (the counterpart of
    ``with mesh:``); the previous one is restored on exit."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The innermost :func:`use_mesh` mesh, or None."""
    return _MESH.get()


def with_logical_constraint(x: torch.Tensor, axes: Sequence[str | None],
                            mesh=None,
                            rules: AxisRules = DEFAULT_RULES) -> torch.Tensor:
    """Redistribute a DTensor to the placements of its logical ``axes``
    (the counterpart of ``lax.with_sharding_constraint`` via logical
    names). The identity outside a mesh and on a plain tensor, so model
    code runs unchanged on one device."""
    from torch.distributed.tensor import DTensor
    mesh = mesh or current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, mesh, rules, shape=x.shape)
    return x.redistribute(mesh, placements(spec, mesh))
