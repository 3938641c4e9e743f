"""The port's checkpointing and watchdog (``repro_torch.checkpoint``)
against the JAX package's, on the CPU.

The manager keeps the reference's on-disk format, so besides the
reference's own tests (``tests/test_train_infra.py:105-182``, mirrored
here) a ``TrainState`` written by either package restores in the other
bit for bit, and the same state written by both gives the same files
byte for byte. The watchdog is a copy of the reference's module (held
by ``tests/test_torch_compiler.py``); its tests run on the port's.
Nothing here has a tolerance: every comparison is bitwise.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.data.synthetic import make_host_batch as jmake_host_batch
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.checkpoint import CheckpointManager, StepWatchdog
from repro_torch.configs import registry
from repro_torch.models import layers, lm
from repro_torch.train import step as tstep

CPU = torch.device("cpu")


def _tree():
    return {"layers": {"w": torch.arange(12, dtype=torch.float32).reshape(
        3, 4), "b": torch.ones((4,), dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32)}


def _same(a: torch.Tensor, b) -> None:
    """Equal dtype, shape and bits; ``b`` a tensor or a numpy array (an
    ml_dtypes bfloat16 one too)."""
    if isinstance(b, np.ndarray):
        b = layers.tree_from_numpy(b, CPU)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.contiguous().view(-1).view(torch.uint8).equal(
        b.contiguous().view(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# the reference's checkpoint tests, mirrored
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = _tree()
    mgr.save(3, state, blocking=True)
    like = layers.tree_map(torch.zeros_like, state)
    got = mgr.restore(like)
    for a, b in zip(layers.tree_leaves(got), layers.tree_leaves(state)):
        _same(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_crash_safety(tmp_path):
    """A stale tmp dir (simulated crash mid-write) is invisible to
    restore and GC'd by the next manager."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    fake = tmp_path / "step_0000000002.tmp-deadbeef"
    fake.mkdir()
    (fake / "manifest.json").write_text("{corrupt")
    assert mgr.latest_step() == 1          # tmp dir ignored
    mgr2 = CheckpointManager(str(tmp_path))
    assert not fake.exists()               # GC'd on construction
    assert mgr2.latest_step() == 1


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    bad = _tree()
    bad["layers"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError):
        mgr.restore(bad)
    missing = _tree()
    missing["extra"] = torch.zeros(2)
    with pytest.raises(KeyError):
        mgr.restore(missing)


def test_checkpoint_elastic_restore_onto_another_dtype(tmp_path):
    """Stored arrays are full host arrays: the restore puts each leaf on
    ``like``'s device in ``like``'s dtype (here fp32 -> bf16 and fp64,
    bf16 -> fp32), the cast of the stored value."""
    mgr = CheckpointManager(str(tmp_path))
    state = _tree()
    mgr.save(5, state, blocking=True)
    like = {"layers": {"w": torch.zeros((3, 4), dtype=torch.bfloat16),
                       "b": torch.zeros((4,), dtype=torch.float32)},
            "step": torch.zeros((), dtype=torch.int64)}
    got = mgr.restore(like)
    _same(got["layers"]["w"], state["layers"]["w"].to(torch.bfloat16))
    _same(got["layers"]["b"], state["layers"]["b"].float())
    assert got["step"].dtype == torch.int64 and int(got["step"]) == 7
    got = mgr.restore({**like, "layers": {
        "w": torch.zeros((3, 4), dtype=torch.float64, device="meta"),
        "b": like["layers"]["b"]}})
    assert got["layers"]["w"].device.type == "meta"


def test_async_save_publishes_atomically(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.latest_step() == 2
    assert not list(tmp_path.glob("*.tmp-*"))


def test_async_save_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr._write = lambda step, host: (_ for _ in ()).throw(OSError("disk"))
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()


# ---------------------------------------------------------------------------
# TrainState across the packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def states():
    """One step of llama3.2-1b's smoke config in bf16 in both packages
    from the same weights and batch: (JAX state, port state) after step
    1, so the moments are non-zero and the params bf16."""
    jarch, tarch = (dataclasses.replace(r.get("llama3.2-1b"),
                                        model=dataclasses.replace(
                                            r.get("llama3.2-1b").smoke,
                                            param_dtype=dt))
                    for r, dt in ((jregistry, jnp.bfloat16),
                                  (registry, torch.bfloat16)))
    jp = jlm.init(jarch.model, jax.random.key(0))
    batch = jax.tree.map(np.asarray, jmake_host_batch(
        jregistry.get("llama3.2-1b"), batch=2, seq=16))
    jstate, _ = jax.jit(jstep.make_train_step(jarch))(
        jstep.init_train_state(jp), batch)
    tp = lm.params_from_jax(jax.tree.map(np.asarray, jp), CPU)
    tstate, _ = tstep.make_train_step(tarch)(
        tstep.init_train_state(tp),
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    return jstate, tstate


def _port_like(jstate):
    """A zero port TrainState of the same tree as ``jstate``."""
    params = lm.params_from_jax(jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jstate.params), CPU)
    return tstep.init_train_state(params)


def test_train_state_keys_are_the_reference_keys(tmp_path, states):
    jstate, tstate = states
    JCheckpointManager(str(tmp_path / "jax")).save(1, jstate, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(1, tstate, blocking=True)
    jm = json.loads((tmp_path / "jax/step_0000000001/manifest.json"
                     ).read_text())
    tm = json.loads((tmp_path / "port/step_0000000001/manifest.json"
                     ).read_text())
    assert jm == tm           # keys, leaf files, shapes and dtypes
    keys = set(tm["leaves"])
    assert {".params//layers//attn//wq", ".opt//.m//layers//attn//wq",
            ".opt//.count", ".step"} <= keys
    assert tm["leaves"][".params//embed"]["dtype"] == "bfloat16"
    assert tm["leaves"][".opt//.v//embed"]["dtype"] == "float32"


def test_jax_checkpoint_restores_in_the_port(tmp_path, states):
    """The reference's manager writes, the port's restores: every leaf
    bit for bit, bf16 params and fp32 moments included."""
    jstate, _ = states
    JCheckpointManager(str(tmp_path)).save(1, jstate, blocking=True)
    got = CheckpointManager(str(tmp_path)).restore(_port_like(jstate))
    assert isinstance(got, tstep.TrainState) and int(got.step) == 1
    for a, b in zip(layers.tree_leaves(got.params)
                    + layers.tree_leaves(got.opt.m)
                    + layers.tree_leaves(got.opt.v)
                    + [got.opt.count, got.step],
                    [np.asarray(x) for x in jax.tree.leaves(jstate.params)
                     + jax.tree.leaves(jstate.opt.m)
                     + jax.tree.leaves(jstate.opt.v)
                     + [jstate.opt.count, jstate.step]]):
        _same(a, b)


def test_port_checkpoint_restores_in_jax(tmp_path, states):
    """The port's manager writes, the reference's restores: bit for bit,
    and the files are the reference's own byte for byte when both write
    the same state."""
    jstate, tstate = states
    CheckpointManager(str(tmp_path / "port")).save(1, tstate,
                                                   blocking=True)
    got = JCheckpointManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(layers.tree_leaves(tstate.params)
                    + layers.tree_leaves(tstate.opt.m)
                    + layers.tree_leaves(tstate.opt.v)
                    + [tstate.opt.count, tstate.step],
                    jax.tree.leaves(got.params) + jax.tree.leaves(got.opt.m)
                    + jax.tree.leaves(got.opt.v)
                    + [got.opt.count, got.step]):
        _same(a, np.asarray(b))
    # the JAX state carried into the port and written by both managers
    JCheckpointManager(str(tmp_path / "jax")).save(1, jstate, blocking=True)
    carried = CheckpointManager(str(tmp_path / "jax")).restore(
        _port_like(jstate))
    CheckpointManager(str(tmp_path / "j2p")).save(1, carried, blocking=True)
    for f in sorted((tmp_path / "jax/step_0000000001").iterdir()):
        assert f.read_bytes() == (tmp_path / "j2p/step_0000000001" /
                                  f.name).read_bytes(), f.name


def test_restored_state_trains_on(tmp_path, states):
    """A restored state steps as the one saved: step 2 from the restore
    is bitwise step 2 from the live state."""
    _, tstate = states
    arch = dataclasses.replace(registry.get("llama3.2-1b"),
                               model=dataclasses.replace(
                                   registry.get("llama3.2-1b").smoke,
                                   param_dtype=torch.bfloat16))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tstate, blocking=True)
    like = layers.tree_map(torch.zeros_like, tstate.params)
    restored = mgr.restore(tstep.init_train_state(like))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (2, 16)).astype(np.int32))}
    step = tstep.make_train_step(arch)
    a, ma = step(tstate, batch)
    b, mb = step(restored, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    for x, y in zip(layers.tree_leaves(a.params) + layers.tree_leaves(a.opt.v),
                    layers.tree_leaves(b.params) + layers.tree_leaves(b.opt.v)):
        _same(x, y)


# ---------------------------------------------------------------------------
# watchdog (tests/test_train_infra.py:167-182)
# ---------------------------------------------------------------------------


def test_watchdog_flags_straggler(tmp_path):
    hb = str(tmp_path / "hb.json")
    dog = StepWatchdog(heartbeat_path=hb, threshold=5.0)
    for s in range(6):
        dog.start_step(s)
        time.sleep(0.01)
        assert not dog.end_step()
    dog.start_step(6)
    time.sleep(0.2)                        # 20x the median
    assert dog.end_step()
    assert dog.stragglers == [6]
    age = StepWatchdog.heartbeat_age(hb)
    assert age is not None and age < 5.0


def test_heartbeat_age_missing():
    assert StepWatchdog.heartbeat_age("/nonexistent/hb.json") is None
