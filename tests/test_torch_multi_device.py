"""The port's multi-device bundles against the JAX package, on the CPU.

The mirror of ``tests/test_multi_device.py`` for ``repro_torch``:

  * plans: the axis-rule table is the reference's, the plan kinds,
    stages and shards derive the same way;
  * images: ``N3HBUND1`` bytes and ``disassemble_bundle`` text equal
    the JAX package's (both plan kinds, ``-O 0`` / ``-O 1``, the toy
    chain, registry llama3.2-1b, 2-device resnet18); round trips; the
    cross-device token-pairing check raises the reference's messages;
  * execution: ``MultiDeviceExecutor`` (``cuda`` on CPU tensors, i.e.
    the kernels' plain versions, and ``golden``) is bitwise equal to
    the port's single-device run for 2 and 3 devices, per layer on
    llama3.2-1b, on a reduced mobilenet_v2 ``filter`` bundle (the
    depthwise channel slice), and to JAX's ``MultiDeviceExecutor`` on
    the same bundle image and input;
  * the bundle simulation's makespan and per-device cycles equal JAX's;
  * the CLI: a 2-device bundle's checksum equals the single-device
    run's, and ``--format bin -o`` round-trips a bundle.

Every comparison is exact: the GEMMs accumulate in int32 and the
requant and the tails are the executors' own, bit for bit the
reference's.
"""
import dataclasses
import struct

import numpy as np
import pytest
import torch

from repro.compiler import GoldenExecutor as JGoldenExecutor
from repro.compiler import MultiDeviceExecutor as JMultiDeviceExecutor
from repro.compiler import PartitionError as JPartitionError
from repro.compiler import asm as jasm
from repro.compiler import bind_synthetic as jbind_synthetic
from repro.compiler import cli as jcli
from repro.compiler import lower_partitioned as jlower_partitioned
from repro.compiler import validate_bundle as jvalidate_bundle
from repro.core import scheduler as jscheduler
from repro.parallel import sharding as jsharding
from repro_torch.compiler import (
    GemmLayer,
    MultiDeviceExecutor,
    PartitionError,
    asm,
    bind_synthetic,
    compile_network,
    derive_plan,
    from_bundle_binary,
    get_backend,
    kind_from_rules,
    lower_network,
    lower_partitioned,
    optimize_bundle,
    to_bundle_binary,
    validate_bundle,
)
from repro_torch.compiler.cli import main as cli_main
from repro_torch.compiler.program import CROSS_DEVICE_CHANNELS
from repro_torch.core import isa
from repro_torch.core.scheduler import (
    XC7Z020,
    DspCoreConfig,
    GemmDims,
    LutCoreConfig,
    simulate_program,
)
from repro_torch.kernels.build import LAUNCHES
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import DEFAULT_RULES

CPU = torch.device("cpu")
LUT = LutCoreConfig(m=8, n=16, k=128)
DSP = DspCoreConfig(n_reg_row_a=13)
KINDS = ("pipeline", "filter")
BACKENDS = ("cuda", "golden")

#: FC-chained toy network (n_i == k_{i+1}) so run() exercises the
#: cross-device hand-off end to end, including boundary requantization.
CHAIN = [GemmLayer("fc0", GemmDims(24, 32, 48)),
         GemmLayer("fc1", GemmDims(24, 48, 40)),
         GemmLayer("fc2", GemmDims(24, 40, 36)),
         GemmLayer("fc3", GemmDims(24, 36, 20))]


def _jchain():
    """The same chain as the JAX package's layer objects."""
    from repro.compiler import GemmLayer as JGemmLayer
    return [JGemmLayer(gl.name, jscheduler.GemmDims(*dataclasses.astuple(
        gl.dims))) for gl in CHAIN]


def _chain_bundle(kind, n_devices, opt_level=0, layers=CHAIN, **kw):
    plan = derive_plan(layers, n_devices, kind)
    return lower_partitioned("toy", layers, plan, LUT, DSP, XC7Z020,
                             bits_w_lut=6, bits_a=4, opt_level=opt_level,
                             **kw)


def _jchain_bundle(kind, n_devices, opt_level=0):
    from repro.compiler import derive_plan as jderive_plan
    layers = _jchain()
    plan = jderive_plan(layers, n_devices, kind)
    return jlower_partitioned(
        "toy", layers, plan, jscheduler.LutCoreConfig(m=8, n=16, k=128),
        jscheduler.DspCoreConfig(n_reg_row_a=13), jscheduler.XC7Z020,
        bits_w_lut=6, bits_a=4, opt_level=opt_level)


def _single(layers=CHAIN, opt_level=0):
    return lower_network("toy", layers, LUT, DSP, XC7Z020,
                         bits_w_lut=6, bits_a=4, opt_level=opt_level)


def _bound_single(prog, backend="cuda"):
    ex = get_backend(backend)(prog, device=CPU)
    for lp in prog.layers:
        bind_synthetic(ex, lp)
    return ex


def _bound_multi(mdp, backend="cuda", **kw):
    mex = MultiDeviceExecutor(mdp, backend=backend, device=CPU, **kw)
    for gi in range(mdp.n_layers):
        mex.bind_synthetic(gi)
    return mex


def _x(m=24, k=32, seed=0):
    return np.random.default_rng(seed).integers(
        -8, 8, (m, k)).astype(np.int8)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def test_axis_rules_are_the_references():
    assert DEFAULT_RULES.rules == jsharding.DEFAULT_RULES.rules
    assert sharding.FILTER_PARALLEL_AXES == jsharding.FILTER_PARALLEL_AXES
    over = {"layers": ("model",), "vocab": None, "new": ("data",)}
    assert DEFAULT_RULES.replace(**over).rules == \
        jsharding.DEFAULT_RULES.replace(**over).rules
    for name in ("batch", "mlp", "seq", "missing"):
        assert DEFAULT_RULES.lookup(name) == \
            jsharding.DEFAULT_RULES.lookup(name)


def test_kind_derived_from_axis_rules():
    # stock rules shard mlp/heads over "model" -> filter-parallel
    assert kind_from_rules(DEFAULT_RULES) == "filter"
    # rules that shard the layer axis ask for pipeline stages
    assert kind_from_rules(
        DEFAULT_RULES.replace(layers=("model",))) == "pipeline"
    # no sharded axes at all -> pipeline
    bare = DEFAULT_RULES.replace(**{n: () for n in
                                    ("mlp", "heads", "experts", "vocab")})
    assert kind_from_rules(bare) == "pipeline"
    # an unspecified kind derives from the default rules
    assert derive_plan(CHAIN, 2).kind == "filter"


def test_pipeline_stages_balanced_and_contiguous():
    plan = derive_plan(CHAIN, 2, "pipeline")
    (a0, a1), (b0, b1) = plan.stages
    assert a0 == 0 and a1 == b0 and b1 == len(CHAIN)
    from repro.compiler import derive_plan as jderive_plan
    assert plan.stages == jderive_plan(_jchain(), 2, "pipeline").stages
    with pytest.raises(PartitionError):
        derive_plan(CHAIN, 5, "pipeline")   # more devices than layers


def test_filter_shards_cover_every_layer():
    plan = derive_plan(CHAIN, 2, "filter")
    for gl, bounds in zip(CHAIN, plan.shards):
        assert bounds[0] == 0 and bounds[-1] == gl.dims.n
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))
    with pytest.raises(PartitionError):
        derive_plan([GemmLayer("n1", GemmDims(4, 4, 1))], 2, "filter")


@pytest.mark.parametrize("kind", KINDS)
def test_one_device_plan_is_legacy_program(kind):
    single = _single()
    mdp = _chain_bundle(kind, 1)
    assert mdp.n_devices == 1 and not mdp.edges
    assert mdp.devices[0] == single
    assert mdp.devices[0].words() == single.words()


def test_lower_network_plan_path():
    plan = derive_plan(CHAIN, 2, "pipeline")
    mdp = lower_network("toy", CHAIN, LUT, DSP, XC7Z020, bits_w_lut=6,
                        bits_a=4, plan=plan)
    assert mdp.n_devices == 2 and mdp.plan is plan
    assert mdp == _chain_bundle("pipeline", 2)


# ---------------------------------------------------------------------------
# Bundle images: the JAX package's bytes and text, round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("opt", (0, 1))
def test_bundle_image_equals_reference(kind, opt):
    mdp = _chain_bundle(kind, 2, opt_level=opt)
    jmdp = _jchain_bundle(kind, 2, opt_level=opt)
    blob = to_bundle_binary(mdp)
    assert blob[:8] == b"N3HBUND1"
    assert blob == jasm.to_bundle_binary(jmdp)
    assert asm.disassemble_bundle(mdp) == jasm.disassemble_bundle(jmdp)
    rt = from_bundle_binary(blob)
    assert rt == mdp
    assert to_bundle_binary(rt) == blob    # canonical re-pack
    assert asm.disassemble_bundle(rt) == asm.disassemble_bundle(mdp)


@pytest.mark.parametrize("kind", KINDS)
def test_bundle_image_equals_reference_registry_lm(kind):
    kw = dict(seq_len=4, devices=2, partition=kind, opt_level=1)
    mdp = compile_network("llama3.2-1b", **kw)
    blob = to_bundle_binary(mdp)
    assert blob == jasm.to_bundle_binary(
        jcli.compile_network("llama3.2-1b", **kw))
    rt = from_bundle_binary(blob)
    assert rt == mdp
    validate_bundle(rt)


@pytest.mark.parametrize("kind", KINDS)
def test_cnn_compiles_two_devices(kind):
    mdp = compile_network("resnet18", devices=2, partition=kind)
    validate_bundle(mdp)
    assert mdp.n_layers == 21
    assert to_bundle_binary(mdp) == jasm.to_bundle_binary(
        jcli.compile_network("resnet18", devices=2, partition=kind))
    if kind == "filter":
        assert all(len(p.layers) == 21 for p in mdp.devices)
        gather = [s for s in mdp.devices[0].memory.segments
                  if s.name.endswith(".gather")]
        assert len(gather) == 20       # one per layer boundary
    else:
        assert sum(len(p.layers) for p in mdp.devices) == 21


def test_bundle_binary_rejects_garbage():
    with pytest.raises(ValueError):
        from_bundle_binary(b"NOTABUND" + b"\x00" * 16)
    blob = to_bundle_binary(_chain_bundle("pipeline", 2))
    with pytest.raises(ValueError):
        from_bundle_binary(blob + b"\x00")   # trailing bytes
    with pytest.raises(ValueError):
        from_bundle_binary(b"N3HBUND1" + struct.pack("<I", 2) + b"{}"
                           + struct.pack("<I", 0))


def test_gather_dma_offsets_are_staging_ordinals():
    mdp = _chain_bundle("filter", 3)
    for prog in mdp.devices:
        for lp in prog.layers[:-1]:
            cp = lp.lut if lp.lut is not None else lp.dsp
            offs = [op.instr.ddr_offset for op in cp.streams["fetch"]
                    if isinstance(op.instr, isa.FetchInstr)
                    and op.instr.stage_ctrl == 3]
            assert offs == [0, 1]


def test_gather_overlap_beats_serialized_gathers():
    over = _chain_bundle("filter", 2)
    serial = _chain_bundle("filter", 2, gather_overlap=False)
    assert simulate_program(over).latency_cycles < \
        simulate_program(serial).latency_cycles


# ---------------------------------------------------------------------------
# Cross-device token-pairing validation, with the reference's messages
# ---------------------------------------------------------------------------


def _first_xdev(stream_ops, want_wait, isa_mod=isa,
                channels=CROSS_DEVICE_CHANNELS):
    for i, op in enumerate(stream_ops):
        if (op.channel in channels
                and isinstance(op.instr, isa_mod.SyncInstr)
                and bool(op.instr.is_wait) == want_wait):
            return i
    raise AssertionError("no cross-device sync found")


def _drop_send(mdp, **pkg):
    lp = mdp.devices[0].layers[mdp.edges[0].src_layer]
    cp = lp.lut if lp.lut is not None else lp.dsp
    del cp.streams["result"][_first_xdev(cp.streams["result"], False,
                                         **pkg)]


def _dup_wait(mdp, **pkg):
    e = mdp.edges[0]
    lp = mdp.devices[e.dst_device].layers[e.dst_layer]
    cp = lp.lut if lp.lut is not None else lp.dsp
    i = _first_xdev(cp.streams["fetch"], want_wait=True, **pkg)
    cp.streams["fetch"].insert(i, cp.streams["fetch"][i])


def _message(fn, exc):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("corrupt", [_drop_send, _dup_wait],
                         ids=["dropped_send", "duplicated_wait"])
@pytest.mark.parametrize("kind", KINDS)
def test_validate_bundle_catches_bad_pairing(kind, corrupt):
    mdp, jmdp = _chain_bundle(kind, 2), _jchain_bundle(kind, 2)
    validate_bundle(mdp)
    from repro.compiler.program import CROSS_DEVICE_CHANNELS as jchannels
    from repro.core import isa as jisa
    corrupt(mdp)
    corrupt(jmdp, isa_mod=jisa, channels=jchannels)
    got = _message(lambda: validate_bundle(mdp), PartitionError)
    assert "token pairing" in got
    assert got == _message(lambda: jvalidate_bundle(jmdp), JPartitionError)
    with pytest.raises(PartitionError):
        MultiDeviceExecutor(mdp, device=CPU)


def test_optimize_bundle_validates_pairing():
    for kind in KINDS:
        mdp = optimize_bundle(_chain_bundle(kind, 2), 1)
        validate_bundle(mdp)
        for prog in mdp.devices:
            assert prog.opt_stats


# ---------------------------------------------------------------------------
# Execution: multi-device == single-device == JAX, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,n_devices",
                         [("pipeline", 2), ("pipeline", 3), ("filter", 2),
                          ("filter", 3)])
def test_chained_run_bit_exact_vs_single(kind, n_devices, backend):
    ref = _bound_single(_single(), backend).run(_x())
    before = dict(LAUNCHES)
    mex = _bound_multi(_chain_bundle(kind, n_devices), backend)
    got = mex.run(_x())
    assert dict(LAUNCHES) == before       # plain versions on the CPU
    assert got.device == CPU and torch.equal(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_chained_run_pass_invariant_and_unfused(kind):
    ref = _bound_multi(_chain_bundle(kind, 2)).run(_x())
    opt = _bound_multi(_chain_bundle(kind, 2, opt_level=1))
    assert torch.equal(opt.run(_x()), ref)
    unfused = _bound_multi(_chain_bundle(kind, 2), fused=False)
    assert torch.equal(unfused.run(_x()), ref)


@pytest.mark.parametrize("kind,n_devices",
                         [("pipeline", 2), ("filter", 2), ("filter", 3)])
def test_chained_run_equals_jax_executor(kind, n_devices):
    """The JAX package's ``MultiDeviceExecutor`` on the same bundle
    image (decoded by each package's ``asm``) and the same input."""
    blob = to_bundle_binary(_chain_bundle(kind, n_devices, opt_level=1))
    jmex = JMultiDeviceExecutor(jasm.from_bundle_binary(blob),
                                backend="golden")
    for gi in range(jmex.bundle.n_layers):
        jmex.bind_synthetic(gi)
    want = np.asarray(jmex.run(_x()))
    got = _bound_multi(from_bundle_binary(blob)).run(_x())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
def test_registry_lm_per_layer_bit_exact(kind):
    single = compile_network("llama3.2-1b", seq_len=4)
    mdp = compile_network("llama3.2-1b", seq_len=4, devices=2,
                          partition=kind, opt_level=1)
    ex = _bound_single(single)
    mex = _bound_multi(mdp)
    jex = JGoldenExecutor(jcli.compile_network("llama3.2-1b", seq_len=4))
    for lp in jex.program.layers:
        jbind_synthetic(jex, lp)
    for gi, lp in enumerate(single.layers):
        x = _x(lp.dims.m, lp.dims.k, seed=100 + gi)
        out_s = ex.run_layer(gi, x)
        out_m = mex.run_layer(gi, x)
        assert torch.equal(out_s, out_m), f"layer {gi} ({lp.name})"
        np.testing.assert_array_equal(out_m.numpy(),
                                      np.asarray(jex.run_layer(gi, x)))


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduced_mobilenet_filter_bundle(backend):
    """Depthwise filter shards take their channels' slice of the
    spatial input; the chained logits equal the single-device run."""
    kw = dict(in_hw=32, width=0.25)
    single = compile_network("mobilenet_v2", **kw)
    mdp = compile_network("mobilenet_v2", devices=2, partition="filter",
                          **kw)
    assert any(gl.depthwise and len(gl.placements) == 2
               for gl in MultiDeviceExecutor(mdp, device=CPU).layers)
    x = np.random.default_rng(0).integers(
        -8, 8, single.layers[0].geometry.in_shape).astype(np.int8)
    ref = _bound_single(single, backend).run(x)
    got = _bound_multi(mdp, backend).run(x)
    assert torch.equal(got, ref)


def test_bind_layer_checks_full_layer_columns():
    mex = MultiDeviceExecutor(_chain_bundle("filter", 2), device=CPU)
    gl = mex.layers[0]
    w = np.zeros((gl.dims.k, gl.n_lut + 1), np.int32)
    s = np.ones(gl.n_lut + 1, np.float32)
    with pytest.raises(ValueError, match="full layer"):
        mex.bind_layer(0, w_lut=w, s_lut=s)


# ---------------------------------------------------------------------------
# Simulation: cross-device makespan, equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_bundle_sim_equals_reference(kind):
    mdp, jmdp = _chain_bundle(kind, 2), _jchain_bundle(kind, 2)
    bs = simulate_program(mdp, batches=4)
    jbs = jscheduler.simulate_program(jmdp, batches=4)
    assert (bs.total_cycles, bs.latency_cycles, bs.interval_cycles) == \
        (jbs.total_cycles, jbs.latency_cycles, jbs.interval_cycles)
    assert [s.total_cycles for s in bs.device_sims] == \
        [s.total_cycles for s in jbs.device_sims]
    assert bs.total_cycles == bs.latency_cycles + 3 * bs.interval_cycles
    assert bs.n_instructions == sum(s.n_instructions
                                    for s in bs.device_sims)
    assert set(bs.decomposition("lut")) == \
        {"l_wait", "l_run", "l_sig", "l_rst"}
    o1 = simulate_program(mdp, opt_level=1, batches=1).n_instructions
    assert o1 < simulate_program(mdp, batches=1).n_instructions


def test_pipeline_two_devices_beat_one_on_registry_arch():
    batches = 8
    single = compile_network("llama3.2-1b", seq_len=16, opt_level=1)
    base = simulate_program(single).total_cycles * batches
    mdp = compile_network("llama3.2-1b", seq_len=16, devices=2,
                          partition="pipeline", opt_level=1)
    bs = simulate_program(mdp, batches=batches)
    assert bs.kind == "pipeline" and bs.batches == batches
    assert bs.total_cycles < base
    assert bs.interval_cycles < simulate_program(single).total_cycles


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_bundle_checksum_equals_single(capsys):
    base = ["resnet18", "--in-hw", "32", "--width", "0.25", "--execute",
            "--torch-device", "cpu"]
    assert cli_main(base) == 0
    single = capsys.readouterr().out.splitlines()[-1]
    assert cli_main(base + ["--devices", "2", "--partition", "filter"]) == 0
    out = capsys.readouterr().out
    assert "filter x2" in out
    bundle = out.splitlines()[-1]
    assert "x2 devices" in bundle
    assert single.split("|out| sum")[1] == bundle.split("|out| sum")[1]
    assert cli_main(["llama3.2-1b", "--devices", "0"]) == 2
    assert "--devices must be >= 1" in capsys.readouterr().err


def test_cli_bundle_summary_equals_reference(capsys):
    argv = ["llama3.2-1b", "--seq-len", "4", "--devices", "2",
            "--partition", "pipeline", "-O", "1"]
    assert cli_main(argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    assert "bundle" in got and "pipeline x2" in got


def test_cli_bundle_bin_and_asm_round_trip(tmp_path, capsys):
    argv = ["llama3.2-1b", "--seq-len", "4", "--devices", "2",
            "--partition", "filter"]
    path = tmp_path / "bundle.n3h"
    assert cli_main(argv + ["--format", "bin", "-o", str(path)]) == 0
    mdp = from_bundle_binary(path.read_bytes())
    assert mdp.n_devices == 2
    validate_bundle(mdp)
    assert path.read_bytes() == to_bundle_binary(
        compile_network("llama3.2-1b", seq_len=4, devices=2,
                        partition="filter"))
    text = tmp_path / "bundle.s"
    assert cli_main(argv + ["--format", "asm", "-o", str(text)]) == 0
    jtext = tmp_path / "jbundle.s"
    assert jcli.main(argv + ["--format", "asm", "-o", str(jtext)]) == 0
    assert text.read_text() == jtext.read_text() == \
        asm.disassemble_bundle(mdp)
