"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's plan, with no device.

Mirrors ``tests/test_dryrun_unit.py``: the trip counts of
``_reduced_model`` and the two-point fit's algebra; the shape set
(``SHAPES``, ``shapes()`` and the skipped cells) and ``make_batch_specs``
equal to the JAX package's for the ten archs and four shapes. The JAX
dry-run module is not imported (it sets ``XLA_FLAGS`` at import): the
reference's registry, synthetic data, model specs and sharding rules
stand in for it. One cell, llama3.2-1b at ``decode_32k`` on a fake
(16, 16) world of 256 ranks, runs in a subprocess (the fake process
group stays there): its per-rank parameter bytes equal the sum over the
reference's parameter leaves of bytes / shard count under the
reference's rule resolution, and its collectives are the ones the plan
implies (see :func:`test_decode_cell_on_a_fake_256_rank_world`).
"""
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.parallel import sharding as jsharding
from repro_torch.configs import registry
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reduced_model_trip_counts():
    for arch_id, want_real in [("qwen3-8b", 36), ("deepseek-v2-236b", 59),
                               ("jamba-v0.1-52b", 4), ("mamba2-780m", 48),
                               ("seamless-m4t-large-v2", 24)]:
        small, real, small_trips = dryrun._reduced_model(
            registry.get(arch_id))
        assert real == want_real, (arch_id, real)
        assert small_trips == 2
        assert small.model.scan_unroll is True


def test_two_point_fit_algebra():
    """total = F1 + (L-1)(F2-F1) is exact for homogeneous stacks."""
    c_body, c_out, L = 7.0, 3.0, 36
    f1 = c_body + c_out                 # one layer
    f2 = 2 * c_body + c_out             # two layers
    assert dryrun.two_point(f1, f2, L) == pytest.approx(L * c_body + c_out)


def test_shapes_and_skipped_cells_equal_the_reference():
    assert list(registry.SHAPES) == list(jregistry.SHAPES)
    for name, s in registry.SHAPES.items():
        j = jregistry.SHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind, s.rule_overrides) == \
            (j.seq_len, j.global_batch, j.kind, j.rule_overrides)
    assert registry.list_archs() == jregistry.list_archs()
    for arch_id in registry.list_archs():
        a, j = registry.get(arch_id), jregistry.get(arch_id)
        assert a.skip_shapes == j.skip_shapes, arch_id
        assert [s.name for s in a.shapes()] == [s.name for s in j.shapes()]
    full_attention = [a for a in registry.list_archs()
                      if "long_500k" in registry.get(a).skip_shapes]
    assert len(full_attention) == 8
    assert sorted(set(registry.list_archs()) - set(full_attention)) == \
        ["jamba-v0.1-52b", "mamba2-780m"]


@pytest.mark.parametrize("shape", list(registry.SHAPES))
def test_batch_specs_equal_the_reference(shape):
    for arch_id in registry.list_archs():
        got = make_batch_specs(registry.get(arch_id), registry.SHAPES[shape])
        want = jsynthetic.make_batch_specs(jregistry.get(arch_id),
                                           jregistry.SHAPES[shape])
        assert sorted(got) == sorted(want), arch_id
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch_id, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), \
                (arch_id, k)


CELL = """
import json, sys
from repro_torch.launch import dryrun
rec = dryrun.run_cell("llama3.2-1b", "decode_32k", verbose=False)
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps(rec))
"""


def _reference_param_bytes(arch_id: str, shape: str) -> int:
    """Sum over the reference's parameter leaves of bytes / shard count,
    the specs resolved by the reference's ``logical_to_spec`` on a
    (16, 16) ("data", "model") mesh stand-in under the arch's and the
    shape's rule overrides."""
    arch, s = jregistry.get(arch_id), jregistry.SHAPES[shape]
    rules = jsharding.DEFAULT_RULES.replace(**arch.rule_overrides,
                                            **s.rule_overrides)
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((16, 16)))
    sizes = {"data": 16, "model": 16}
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)
    walk(arch.model_module().param_specs(arch.model))
    total = 0
    for leaf in leaves:
        spec = jsharding.logical_to_spec(leaf.axes, mesh, rules,
                                         shape=leaf.shape)
        count = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                count *= sizes[a]
        total += math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize \
            // count
    return total


def test_decode_cell_on_a_fake_256_rank_world():
    """llama3.2-1b (16 layers, 32 query and 8 KV heads) at decode_32k
    (``kv_seq`` on "model", ``act_kv_heads`` replicated) on (16, 16).

    The plan, per layer: every weight with an "embed" dim is gathered
    over "data" where it is used (wq, wk, wv, wo, gate, up, down: 7
    all-gathers); the K / V projections' columns, split over "model" by
    the weight rule, are gathered whole (``act_kv_heads`` is
    replicated: 2); the query is gathered whole for the softmax over a
    cache split by positions (1); that softmax all-reduces its max, its
    sum and its output (3); the attention's and the MLP's row-parallel
    partial sums are all-reduced (the one-token residual does not divide
    over "model": 2). So 10 all-gathers and 5 all-reduces a layer, plus
    the vocab-sharded embedding's gather over "data" and its partial
    lookup's all-reduce, and the tied unembedding's gather (2
    all-gathers, 1 all-reduce)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", CELL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["mesh"] == [16, 16]
    assert rec["n_chips"] == 256
    assert rec["param_bytes_per_device"] == _reference_param_bytes(
        "llama3.2-1b", "decode_32k")
    layers = 16
    assert rec["collective_counts_per_device"] == {
        "all-gather": 10 * layers + 2, "all-reduce": 5 * layers + 1}
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device", "collective_bytes_total",
              "mem_argument_size_in_bytes", "mem_output_size_in_bytes",
              "mem_temp_size_in_bytes", "host_s"):
        assert k in rec
    assert rec["flops_per_device"] > 0 and rec["mem_temp_size_in_bytes"] > 0
    # the cache (bf16 K / V, 16 layers, [128, 32768, 8, 64] split 16 x 16)
    # and the token are arguments too
    cache = 2 * layers * 128 * 32768 * 8 * 64 * 2 // 256
    assert rec["mem_argument_size_in_bytes"] == \
        rec["param_bytes_per_device"] + cache + 128 * 4 // 16


def test_main_reports_skipped_cells_and_exit_code(tmp_path):
    """``main`` on a full-attention arch at long_500k: one skipped cell,
    exit 0, the reference's closing line; a missing arch: exit 1."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out_file = tmp_path / "cells.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "long_500k", "--out", str(out_file)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "# dry-run: 0 ok, 1 skipped, 0 failed (mesh=16x16)"
    assert json.loads(out_file.read_text()) == [
        {"arch": "qwen3-8b", "shape": "long_500k", "status": "skipped",
         "reason": "full-attention arch skips long_500k"}]
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "decode_32k"],
        env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1
    assert bad.stdout.strip().splitlines()[-1] == \
        "# dry-run: 0 ok, 0 skipped, 1 failed (mesh=16x16)"


def test_local_shapes_follow_the_rules():
    """``_meta`` lays a leaf out as ``logical_to_spec`` says, its local
    shape the global one divided by the mesh axes of each dim."""
    out = subprocess.run([sys.executable, "-c", """
import json
from repro_torch.launch import dryrun
from repro_torch.parallel.sharding import DEFAULT_RULES
import torch
mesh = dryrun.fake_mesh((2, 16, 16), ("pod", "data", "model"))
t = dryrun._meta((4096, 8192), torch.bfloat16, ("embed", "mlp"), mesh,
                 DEFAULT_RULES)
b = dryrun._meta((256, 4096), torch.int32, ("batch", None), mesh,
                 DEFAULT_RULES)
print(json.dumps([list(t.to_local().shape), list(t.shape),
                  list(b.to_local().shape), [str(p) for p in b.placements]]))
import torch.distributed as dist
dist.destroy_process_group()
"""], env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    local, glob, blocal, bpl = json.loads(out.stdout.strip().splitlines()[-1])
    assert local == [4096 // 16, 8192 // 16] and glob == [4096, 8192]
    assert blocal == [256 // 32, 4096]
    assert bpl == ["S(0)", "S(0)", "R"]
