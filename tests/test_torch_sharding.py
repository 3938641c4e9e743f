"""The port's sharding rules, spec trees, meshes and DTensor placements
against the JAX package's.

Every spec comparison resolves the same logical axes and shapes on the
same mesh shape in both packages: JAX on a mesh of one CPU device
repeated (as tests/test_sharding.py builds it), the port on a
device-free ``MeshShape``; ``tuple(port) == tuple(jax)``. The placement
check spawns 4 gloo ranks (tests/_torch_ranks.py) and holds each rank's
``distribute_tensor`` shard to the slice that JAX's spec assigns to its
mesh coordinates.
"""
import math

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh, PartitionSpec as JP

import _torch_ranks
from repro.configs import registry as jregistry
from repro.parallel import sharding as jsh
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import tree_map
from repro_torch.parallel import sharding as sh
from repro_torch.train import step as tstep


def _jmesh(shape, axes):
    devs = np.array(jax.devices()[:1] * math.prod(shape)).reshape(shape)
    return Mesh(devs, axes)


def _pair(shape, axes):
    return _jmesh(shape, axes), sh.MeshShape(axes, shape)


MESH = _pair((4, 2), ("data", "model"))
MESH1D = _pair((2,), ("model",))
MESH3 = _pair((2, 2, 2), ("pod", "data", "model"))
OVERRIDE = dict(act_heads=(), act_seq_attn=("model",))

# tests/test_sharding.py's nine cases: (mesh, logical axes, shape,
# rule overrides, the spec it asserts)
SPEC_CASES = {
    "basic_mapping": (MESH, ("batch", None, "mlp"), (8, 3, 16), {},
                      ("data", None, "model")),
    "divisibility_fallback": (MESH, ("batch", "mlp"), (6, 16), {},
                              (None, "model")),
    "mesh_axis_used_once": (MESH, ("mlp", "heads"), (16, 16), {},
                            ("model",)),
    "missing_mesh_axes_dropped": (MESH1D, ("batch", "mlp"), (8, 16), {},
                                  (None, "model")),
    "rule_overrides": (MESH, ("batch", "act_seq_attn", "act_heads", None),
                       (8, 16, 7, 4), OVERRIDE, ("data", "model")),
    "multi_axis_dim": (MESH3, ("batch", None), (8, 3), {},
                       (("pod", "data"),)),
    "partial_multi_axis_fallback": (MESH3, ("batch",), (2,), {}, ("pod",)),
    "embed_rule_is_fsdp": (MESH, ("embed", "mlp"), (64, 32), {},
                           ("data", "model")),
}


@pytest.mark.parametrize("name", list(SPEC_CASES) + ["zero1_spec"])
def test_specs_match_test_sharding_cases(name):
    if name == "zero1_spec":
        jm, tm = MESH
        for spec, shape, want in [(("__", "model"), (8, 16),
                                   ("data", "model")),
                                  (("data", None), (8, 16), ("data", None))]:
            spec = tuple(None if d == "__" else d for d in spec)
            got = sh.zero1_spec(sh.P(*spec), shape, tm)
            ref = jsh.zero1_spec(JP(*spec), shape, jm)
            assert tuple(got) == tuple(ref) == want
        return
    (jm, tm), axes, shape, over, want = SPEC_CASES[name]
    got = sh.logical_to_spec(axes, tm, sh.DEFAULT_RULES.replace(**over),
                             shape=shape)
    ref = jsh.logical_to_spec(axes, jm, jsh.DEFAULT_RULES.replace(**over),
                              shape=shape)
    assert isinstance(got, sh.PartitionSpec)
    assert tuple(got) == tuple(ref) == want


NAMES = [n for n, _ in jsh.DEFAULT_RULES.rules] + ["not_a_rule"]
RULE_SETS = ["DEFAULT_RULES", "KV_SHARDED_RULES", "yi-34b", "qwen2-vl-2b"]
MESH_AXES = [("model",), ("data",), ("data", "model"), ("pod", "data"),
             ("pod", "data", "model")]


def _rules(which):
    """(port, JAX) rules: a module's table by name, or an arch's
    overrides applied to the default table."""
    if which.endswith("_RULES"):
        return getattr(sh, which), getattr(jsh, which)
    over = registry.get(which).rule_overrides
    assert over == jregistry.get(which).rule_overrides
    return sh.DEFAULT_RULES.replace(**over), jsh.DEFAULT_RULES.replace(**over)


@settings(max_examples=300, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_logical_to_spec_property(seed):
    """Random logical tuples (names of every rule, None and an unknown
    name), shapes, 1- to 3-axis meshes and the four rule sets: the
    port's spec equals JAX's, with and without a shape, and so does its
    zero1 spec."""
    rng = np.random.default_rng(seed)
    axes_names = MESH_AXES[rng.integers(len(MESH_AXES))]
    mshape = tuple(int(rng.choice([1, 2, 3, 4, 16])) for _ in axes_names)
    jm, tm = _jmesh(mshape, axes_names), sh.MeshShape(axes_names, mshape)
    tr, jr = _rules(RULE_SETS[rng.integers(len(RULE_SETS))])
    rank = int(rng.integers(0, 5))
    logical = tuple(None if rng.random() < 0.25 else
                    NAMES[rng.integers(len(NAMES))] for _ in range(rank))
    shape = tuple(int(rng.choice([1, 2, 3, 6, 8, 12, 32, 48])) for _ in
                  range(rank))
    for s in (None, shape):
        got = sh.logical_to_spec(logical, tm, tr, shape=s)
        ref = jsh.logical_to_spec(logical, jm, jr, shape=s)
        assert tuple(got) == tuple(ref), (logical, shape, mshape, axes_names)
    z = sh.zero1_spec(got, shape, tm)
    jz = jsh.zero1_spec(ref, shape, jm)
    assert tuple(z) == tuple(jz)


ARCHS = registry.list_archs()


def _pairs(arch_id):
    j, t = jregistry.get(arch_id), registry.get(arch_id)
    return [(j.model_module(), jc, t.model_module(), tc)
            for jc, tc in ((j.model, t.model), (j.smoke, t.smoke))]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_axes_match_jax(arch_id):
    """``param_axes`` leaf for leaf, published and smoke configs; the
    decode caches' axes too."""
    for jmod, jc, tmod, tc in _pairs(arch_id):
        assert tmod.param_axes(tc) == jmod.param_axes(jc)
        jspec = jmod.cache_specs(jc, 2, 16) if arch_id != \
            "seamless-m4t-large-v2" else jmod.cache_specs(jc, 2, 16, 8)
        tspec = tmod.cache_specs(tc, 2, 16) if arch_id != \
            "seamless-m4t-large-v2" else tmod.cache_specs(tc, 2, 16, 8)
        assert tree_map(lambda s: s.axes, tspec) == jax.tree.map(
            lambda s: s.axes, jspec,
            is_leaf=lambda x: hasattr(x, "axes"))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_abstract_on_meta_matches_jax(arch_id):
    for jmod, jc, tmod, tc in _pairs(arch_id):
        got = tmod.abstract(tc)
        leaves = []
        tree_map(leaves.append, got)
        assert all(t.device.type == "meta" for t in leaves)
        assert tree_map(lambda t: (tuple(t.shape), _dtype_name(t.dtype)),
                        got) == jax.tree.map(
            lambda s: (tuple(s.shape), str(s.dtype)), jmod.abstract(jc))


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_spec_tree_on_production_meshes(arch_id, multi_pod):
    """``spec_tree_for`` over the published params on the (16, 16) and
    (2, 16, 16) mesh shapes, with the arch's rule overrides, and the
    ZeRO-1 spec of each leaf."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    jm, tm = _jmesh(shape, axes), sh.MeshShape(axes, shape)
    tr, jr = _rules(arch_id)
    jmod, jc, tmod, tc = _pairs(arch_id)[0]
    tshapes = tree_map(lambda t: tuple(t.shape), tmod.abstract(tc))
    jshapes = jax.tree.map(lambda s: tuple(s.shape), jmod.abstract(jc))
    got = sh.spec_tree_for(tmod.param_axes(tc), tm, tr, shape_tree=tshapes)
    ref = jsh.spec_tree_for(jmod.param_axes(jc), jm, jr, shape_tree=jshapes)
    assert _spec_tuples(got) == _spec_tuples(ref)
    # without shapes too
    assert _spec_tuples(sh.spec_tree_for(tmod.param_axes(tc), tm, tr)) == \
        _spec_tuples(jsh.spec_tree_for(jmod.param_axes(jc), jm, jr))
    jleaves = jax.tree.leaves(ref, is_leaf=lambda x: isinstance(x, JP))
    tleaves, shapes = _flat(got), _flat(tshapes)
    assert len(tleaves) == len(jleaves) == len(shapes)
    for s, js, shp in zip(tleaves, jleaves, shapes):
        assert tuple(sh.zero1_spec(s, shp, tm)) == tuple(
            jsh.zero1_spec(js, shp, jm))


def _flat(tree) -> list:
    """The leaves of a dict / list tree in JAX's order (dict keys
    sorted); tuples (specs, shapes) are leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def test_train_state_axes_match_jax():
    cfg = registry.get("llama3.2-1b").smoke
    jcfg = jregistry.get("llama3.2-1b").smoke
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    got = tstep.train_state_axes(tlm.param_axes(cfg))
    ref = jstep.train_state_axes(jlm.param_axes(jcfg))
    assert got.params == ref.params
    assert got.opt.m == ref.opt.m and got.opt.v == ref.opt.v
    assert got.opt.count == ref.opt.count == ()
    assert got.step == ref.step == () and got.compress is ref.compress
    # the spec tree of the whole state on a (4, 2) mesh equals JAX's
    jm, tm = MESH
    tspec = sh.spec_tree_for(got, tm)
    jspec = jsh.spec_tree_for(ref, jm)
    assert _spec_tuples(tspec.params) == _spec_tuples(jspec.params)
    assert tuple(tspec.opt.count) == tuple(jspec.opt.count) == ()


#: (name, mesh shape, mesh axes, logical axes, array shape) of the
#: placement check on 4 ranks
SHARD_CASES = [
    ("data_model", (2, 2), ("data", "model"), ("embed", "mlp"), (8, 6)),
    ("pod_data", (2, 2), ("pod", "data"), ("batch", None), (8, 3)),
    ("host", (4, 1), ("data", "model"), ("batch", "mlp"), (12, 5)),
    ("pod_data_model", (1, 2, 2), ("pod", "data", "model"),
     ("batch", "heads"), (6, 4)),
    ("replicated", (2, 2), ("data", "model"), ("layers", "embed"), (3, 5)),
]


def _jax_slice(arr, spec, axes, mshape, coord):
    """The block of ``arr`` that JAX's ``spec`` gives the device at mesh
    coordinates ``coord``: per dim, the row-major index over the dim's
    mesh axes picks one of their product's equal chunks."""
    sizes = dict(zip(axes, mshape))
    pos = dict(zip(axes, coord))
    idx = []
    for d in range(arr.ndim):
        entry = spec[d] if d < len(spec) else None
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        i, n = 0, 1
        for a in names:
            i, n = i * sizes[a] + pos[a], n * sizes[a]
        step = arr.shape[d] // n
        idx.append(slice(i * step, (i + 1) * step))
    return arr[tuple(idx)]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard")
    rng = np.random.default_rng(0)
    cases = [(name, m, a, lg, rng.standard_normal(s).astype(np.float32))
             for name, m, a, lg, s in SHARD_CASES]
    _torch_ranks.run_ranks(_torch_ranks.shard_body, 4, tmp, cases)
    return cases, [_torch_ranks.load(tmp / f"shard_{r}.pt")
                   for r in range(4)]


@pytest.mark.parametrize("case", [c[0] for c in SHARD_CASES])
def test_distribute_tensor_shards_follow_jax_spec(shards, case):
    cases, ranks = shards
    name, mshape, axes, logical, arr = next(c for c in cases
                                            if c[0] == case)
    spec = jsh.logical_to_spec(logical, _jmesh(mshape, axes),
                               jsh.DEFAULT_RULES, shape=arr.shape)
    seen = set()
    for out in ranks:
        got = out[name]
        want = _jax_slice(arr, spec, axes, mshape, got["coord"])
        np.testing.assert_array_equal(got["local"].numpy(), want)
        np.testing.assert_array_equal(got["full"].numpy(), arr)
        seen.add(tuple(got["coord"]))
    assert len(seen) == 4


def test_with_logical_constraint_redistributes_a_dtensor(shards):
    """On a DTensor inside ``use_mesh`` the constraint redistributes it to
    its logical axes' placements: each rank's shard is JAX's slice of
    P(None, "model")."""
    from torch.distributed.tensor import Replicate, Shard
    cases, ranks = shards
    _, mshape, axes, _, arr = cases[0]
    for out in ranks:
        got = out["constrained"]
        assert got["placements"] == [Replicate(), Shard(1)]
        want = _jax_slice(arr, JP(None, "model"), axes, mshape,
                          got["coord"])
        np.testing.assert_array_equal(got["local"].numpy(), want)


def test_make_host_mesh_shape(shards):
    """Mirrors tests/test_dryrun_unit.py::test_make_host_mesh_shape on 4
    gloo ranks: (world, 1) over ("data", "model")."""
    for out in shards[1]:
        assert out["host_mesh"] == {"names": ("data", "model"),
                                    "shape": (4, 1)}


def test_make_production_mesh_needs_its_device_count():
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_placements_refuse_what_dtensor_cannot_index():
    """Mesh axes out of the mesh's order in one dim, and axes the mesh
    lacks, are refused (on a 1-device cpu mesh shape, no ranks needed:
    ``placements`` reads only the names)."""
    class Names:
        mesh_dim_names = ("pod", "data", "model")
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(sh.P(("pod", "data"), "model"), Names) == (
        Shard(0), Shard(0), Shard(1))
    assert sh.placements(sh.P(), Names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sh.placements(sh.P(("data", "pod")), Names)
    with pytest.raises(ValueError, match="not in the mesh"):
        sh.placements(sh.P("expert"), Names)


def test_with_logical_constraint_is_identity_off_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert sh.with_logical_constraint(x, ("batch", None)) is x
    with sh.use_mesh(sh.MeshShape(("data",), (2,))):
        assert sh.current_mesh() is not None
        assert sh.with_logical_constraint(x, ("batch", None)) is x
    assert sh.current_mesh() is None
