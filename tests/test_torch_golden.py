"""The port's ``GoldenExecutor`` against the reference's.

Both interpreters walk the same compiled programs (the port's compiler
is a copy of the reference's, so the instruction streams are identical)
and compute every tile through exact integer oracles, so the tolerance
is zero: reduced resnet18 and mobilenet_v2 (``in_hw=32, width=0.25``)
at ``-O 0`` and ``-O 1`` give bitwise-equal logits in both packages on
the same ``bind_synthetic`` codes and image, and the port's golden is
bitwise equal to every ``CudaExecutor`` path (on the CPU, the kernels'
plain versions). Each contract check of ``golden.py`` is planted, by
``dataclasses.replace`` on one instruction, identically in both
packages' programs, and both must raise ``ExecutionError`` with the
same message. The checks the copied compiler cannot reach yet (decode
programs, cross-device gathers) are planted on a dense program.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.compiler import GoldenExecutor as GoldenJax
from repro.compiler import bind_synthetic as bind_synthetic_jax
from repro.compiler import compile_network as compile_jax
from repro.compiler import lower_network as lower_jax
from repro.compiler.program import GemmLayer as GemmLayerJax
from repro.compiler.runtime import ExecutionError as ExecutionErrorJax
from repro.core.scheduler import XC7Z020 as XC7Z020_JAX
from repro.core.scheduler import DspCoreConfig as DspJax
from repro.core.scheduler import GemmDims as GemmDimsJax
from repro.core.scheduler import LutCoreConfig as LutJax
from repro_torch.compiler import CudaExecutor, ExecutionError, GemmLayer, \
    GoldenExecutor, bind_synthetic, compile_network, execute_report, \
    lower_network, optimize_program
from repro_torch.compiler.lower import EW_STAGE, KV_APPEND_STAGE, \
    KV_READ_STAGE
from repro_torch.compiler.runtime import BACKENDS
from repro_torch.core import isa
from repro_torch.core.scheduler import XC7Z020, DspCoreConfig, GemmDims, \
    LutCoreConfig
from repro_torch.core.workloads import ConvSpec
from repro_torch.models import cnn
from repro_torch.models.cnn import CNNConfig, specs_for

REDUCED = {"in_hw": 32, "width": 0.25}
LUT = LutCoreConfig(m=8, n=16, k=128)
DSP = DspCoreConfig(n_reg_row_a=13)
CUDA_PATHS = {"fused": {}, "fused=False": {"fused": False},
              "mode=ref": {"mode": "ref"}}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.int8 else a


def _bound(cls, prog, **kw):
    ex = cls(prog, **kw)
    for lp in prog.layers:
        bind_synthetic(ex, lp, seed=lp.index)
    return ex


def _image(prog, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -8, 8, prog.layers[0].geometry.in_shape).astype(np.int8)


# ---------------------------------------------------------------------------
# Whole reduced networks: port golden == reference golden == every path
# ---------------------------------------------------------------------------


NETS = [(arch, o) for arch in ("resnet18", "mobilenet_v2") for o in (0, 1)]


@pytest.fixture(scope="module")
def golden_runs():
    """Per (arch, -O): the port's program, image and golden logits, held
    bitwise against the reference's golden on the same codes."""
    runs = {}

    def get(arch, opt):
        if (arch, opt) not in runs:
            prog_jax = compile_jax(arch, opt_level=opt, **REDUCED)
            prog = compile_network(arch, opt_level=opt, **REDUCED)
            assert prog.fingerprint() == prog_jax.fingerprint()
            ex_jax = GoldenJax(prog_jax)
            for lp in prog_jax.layers:
                bind_synthetic_jax(ex_jax, lp, seed=lp.index)
            x = _image(prog)
            want = np.asarray(ex_jax.run(x))
            got = _bound(GoldenExecutor, prog, device="cpu").run(x)
            runs[arch, opt] = prog, x, want, got
        return runs[arch, opt]
    return get


@pytest.mark.parametrize("arch,opt", NETS, ids=[f"{a}-O{o}" for a, o in NETS])
def test_golden_bitwise_equal_reference_golden(golden_runs, arch, opt):
    prog, _, want, got = golden_runs(arch, opt)
    assert got.dtype == torch.float32 and got.shape == (1, 1000)
    assert np.isfinite(got.numpy()).all() and np.abs(want).sum() > 0
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("path", sorted(CUDA_PATHS))
@pytest.mark.parametrize("arch,opt", NETS, ids=[f"{a}-O{o}" for a, o in NETS])
def test_golden_bitwise_equal_every_cuda_path(golden_runs, arch, opt, path):
    prog, x, _, got = golden_runs(arch, opt)
    ex = _bound(CudaExecutor, prog, device="cpu", **CUDA_PATHS[path])
    assert torch.equal(ex.run(x).view(torch.int32), got.view(torch.int32))


def test_golden_is_registered():
    assert BACKENDS["golden"] is GoldenExecutor
    assert GoldenExecutor(compile_network("resnet18", **REDUCED),
                          device="cpu").check_timing


def test_golden_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = compile_network("resnet18", **REDUCED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GoldenExecutor(prog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_report(prog, backend="golden")


@pytest.mark.parametrize("arch", ["resnet18", "mobilenet_v2"])
def test_execute_report_golden_checksum_equals_cuda(arch):
    prog = compile_network(arch, **REDUCED)
    lines = {b: execute_report(prog, backend=b, device="cpu")
             for b in ("golden", "cuda")}
    n = len(prog.layers)
    assert lines["golden"].startswith(
        f"executed  {n}/{n} layers end to end via golden backend")
    assert lines["golden"].split("|out| sum")[1] \
        == lines["cuda"].split("|out| sum")[1]


def test_cli_executes_golden_on_cpu(capsys):
    from repro_torch.compiler.cli import main
    want = execute_report(compile_network("mobilenet_v2", **REDUCED),
                          backend="cuda", device="cpu").split("|out| sum")[1]
    assert main(["mobilenet_v2", "--in-hw", "32", "--width", "0.25",
                 "--execute", "--backend", "golden",
                 "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "executed  53/53 layers end to end via golden backend" in out
    assert f"|out| sum{want}" in out


# ---------------------------------------------------------------------------
# Planted contract faults: same ExecutionError, same message, both packages
# ---------------------------------------------------------------------------


def _fc(pkg: str, opt_level: int = 1):
    """A two-sided dense layer ([8, 32] x 160, 96 LUT filters) whose
    ``-O 1`` streams carry fused DMA bursts on both cores."""
    if pkg == "jax":
        return lower_jax("fc", [GemmLayerJax("fc", GemmDimsJax(8, 32, 160))],
                         LutJax(m=8, n=16, k=128), DspJax(n_reg_row_a=13),
                         XC7Z020_JAX, bits_w_lut=4, bits_a=4, n_luts=[96],
                         opt_level=opt_level)
    return lower_network("fc", [GemmLayer("fc", GemmDims(8, 32, 160))],
                         LUT, DSP, XC7Z020, bits_w_lut=4, bits_a=4,
                         n_luts=[96], opt_level=opt_level)


def _where(cp, engine, kind, stage=None):
    """Indices of ``engine``'s ops whose instruction is a ``kind``
    (Fetch/Execute/Result/Sync by class name), of ``stage`` if given."""
    return [n for n, op in enumerate(cp.streams[engine])
            if type(op.instr).__name__ == kind
            and (stage is None or op.instr.stage_ctrl == stage)]


def _edit(cp, engine, n, **fields):
    op = cp.streams[engine][n]
    cp.streams[engine][n] = dataclasses.replace(
        op, instr=dataclasses.replace(op.instr, **fields))


def _segment_base(prog, core):
    return prog.memory[f"L0.wgt.{core}"].base


def _plant(prog, case: str, core: str) -> None:
    """Plant ``case`` in ``core``'s streams of layer 0 (the same edit
    whichever package compiled ``prog``)."""
    cp = getattr(prog.layers[0], core)
    wgt = _segment_base(prog, core)
    w_fetch = _where(cp, "fetch", "FetchInstr", 0)
    a_fetch = _where(cp, "fetch", "FetchInstr", 1)
    results = _where(cp, "result", "ResultInstr")
    if case == "weight-fetch-address":
        _edit(cp, "fetch", w_fetch[0], ddr_base=wgt + 0x40)
    elif case == "activation-fetch-address":
        _edit(cp, "fetch", a_fetch[0], ddr_base=wgt)
    elif case == "gather-fetch-address":
        _edit(cp, "fetch", a_fetch[0], stage_ctrl=3)
    elif case == "residual-fetch-address":
        _edit(cp, "fetch", w_fetch[0], stage_ctrl=EW_STAGE)
    elif case == "persistent-read":
        _edit(cp, "fetch", w_fetch[0], stage_ctrl=KV_READ_STAGE)
    elif case in ("undefined-stage-2", "undefined-stage-7"):
        _edit(cp, "fetch", w_fetch[0], stage_ctrl=int(case[-1]))
    elif case == "no-activation-fetch":
        for n in a_fetch:
            _edit(cp, "fetch", n, stage_ctrl=0, ddr_base=wgt, ddr_offset=0)
    elif case == "execute-before-fetch":
        for n in w_fetch:
            op = cp.streams["fetch"][n]
            _edit(cp, "fetch", n, ddr_offset=op.instr.ddr_offset + 10_000)
    elif case == "tile-count":
        del cp.streams["execute"][_where(cp, "execute", "ExecuteInstr")[-1]]
    elif case == "persistent-write":
        _edit(cp, "result", results[0], stage_ctrl=KV_APPEND_STAGE)
    elif case == "write-back-address":
        _edit(cp, "result", results[0], stage_ctrl=EW_STAGE, ddr_base=wgt)
    elif case == "result-address":
        _edit(cp, "result", results[0], ddr_base=wgt)
    elif case == "written-twice":
        first = cp.streams["result"][results[0]].instr
        _edit(cp, "result", results[1], ddr_offset=first.ddr_offset)
    elif case == "never-executed":
        _edit(cp, "result", results[-1], ddr_offset=10_000)
    elif case == "drained-count":
        _edit(cp, "result", results[-1], stage_ctrl=EW_STAGE)
    elif case == "sync-deadlock":
        sends = [n for n in _where(cp, "fetch", "SyncInstr")
                 if not cp.streams["fetch"][n].instr.is_wait]
        del cp.streams["fetch"][sends[0]]
    else:
        raise AssertionError(case)


#: (case, core, a phrase of the message golden.py / base.py raises)
FAULTS = [
    ("weight-fetch-address", "lut", "weight fetch addresses"),
    ("weight-fetch-address", "dsp", "weight fetch addresses"),
    ("activation-fetch-address", "lut", "activation fetch addresses"),
    ("activation-fetch-address", "dsp", "activation fetch addresses"),
    ("gather-fetch-address", "lut", "gather fetch addresses"),
    ("residual-fetch-address", "dsp", "elementwise residual fetch"),
    ("persistent-read", "lut", "persistent read"),
    ("undefined-stage-2", "lut", "stage_ctrl=2 is not a defined"),
    ("undefined-stage-7", "dsp", "stage_ctrl=7 is not a defined"),
    ("no-activation-fetch", "lut", "no activation fetch"),
    ("no-activation-fetch", "dsp", "no activation fetch"),
    ("execute-before-fetch", "lut", "before any fetch"),
    ("execute-before-fetch", "dsp", "before any fetch"),
    ("tile-count", "lut", "execute instructions do not tile"),
    ("tile-count", "dsp", "execute instructions do not tile"),
    ("persistent-write", "dsp", "persistent write"),
    ("write-back-address", "lut", "elementwise write-back"),
    ("result-address", "dsp", "result writes"),
    ("written-twice", "lut", "written twice"),
    ("written-twice", "dsp", "written twice"),
    ("never-executed", "lut", "never executed"),
    ("drained-count", "dsp", "result stream drained"),
    ("sync-deadlock", "lut", "streams deadlock"),
]


@pytest.mark.parametrize("case,core,phrase", FAULTS,
                         ids=[f"{c}-{k}" for c, k, _ in FAULTS])
def test_planted_fault_raises_as_reference(case, core, phrase):
    progs = {"jax": _fc("jax"), "torch": _fc("torch")}
    assert progs["jax"].fingerprint() == progs["torch"].fingerprint()
    for prog in progs.values():
        _plant(prog, case, core)
    assert progs["jax"].fingerprint() == progs["torch"].fingerprint()
    lp = progs["torch"].layers[0]
    x = np.random.default_rng(5).integers(-8, 8, (8, 32)).astype(np.int8)
    ex_jax = GoldenJax(progs["jax"])
    bind_synthetic_jax(ex_jax, progs["jax"].layers[0])
    with pytest.raises(ExecutionErrorJax) as want:
        ex_jax.run_layer(0, x)
    ex = GoldenExecutor(progs["torch"], device="cpu")
    bind_synthetic(ex, lp)
    with pytest.raises(ExecutionError) as got:
        ex.run_layer(0, x)
    assert phrase in str(want.value)
    assert str(got.value) == str(want.value)


def test_unplanted_program_runs_in_both():
    """The fault programs' baseline: unplanted, both goldens agree."""
    x = np.random.default_rng(5).integers(-8, 8, (8, 32)).astype(np.int8)
    ex_jax = GoldenJax(_fc("jax"))
    bind_synthetic_jax(ex_jax, ex_jax.program.layers[0])
    ex = GoldenExecutor(_fc("torch"), device="cpu")
    bind_synthetic(ex, ex.program.layers[0])
    assert np.array_equal(_bits(ex.run_layer(0, x).numpy()),
                          _bits(ex_jax.run_layer(0, x)))


# ---------------------------------------------------------------------------
# Mirrors of the reference's own golden tests
# ---------------------------------------------------------------------------


def test_golden_executor_chains_fc_network():
    layers = [GemmLayer("fc1", GemmDims(8, 16, 24)),
              GemmLayer("fc2", GemmDims(8, 24, 12))]
    prog = lower_network("mlp", layers, LUT, DSP, XC7Z020,
                         bits_w_lut=4, bits_a=4, n_luts=[12, 6])
    ex = GoldenExecutor(prog, device="cpu")
    rng = np.random.default_rng(0)
    for i, lp in enumerate(prog.layers):
        k, n_lut, n_dsp = lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut
        ex.bind_layer(
            i,
            w_lut=rng.integers(-8, 8, (k, n_lut)), s_lut=np.ones(n_lut),
            w_dsp=rng.integers(-8, 8, (k, n_dsp)), s_dsp=np.ones(n_dsp))
    x_q = rng.integers(-8, 8, (8, 16)).astype(np.int8)
    out = ex.run(x_q).numpy()
    assert out.shape == (8, 12)
    assert np.isfinite(out).all()


def test_golden_executor_validates_contract():
    prog = lower_network("tiny", [GemmLayer("l0", GemmDims(24, 32, 40))],
                         LUT, DSP, XC7Z020, bits_w_lut=6, bits_a=4,
                         n_luts=[18])
    ex = GoldenExecutor(prog, device="cpu")
    with pytest.raises(ExecutionError, match="no bound weights"):
        ex.run_layer(0, torch.zeros((24, 32), dtype=torch.int8))
    rng = np.random.default_rng(1)
    ex.bind_layer(0, w_lut=rng.integers(-32, 32, (32, 18)),
                  s_lut=np.ones(18), w_dsp=rng.integers(-8, 8, (32, 22)),
                  s_dsp=np.ones(22))
    with pytest.raises(ExecutionError, match="activations must be"):
        ex.run_layer(0, torch.zeros((24, 99), dtype=torch.int8))
    with pytest.raises(ValueError, match="exceed"):
        ex.bind_layer(0, w_lut=np.full((32, 18), 99), s_lut=np.ones(18),
                      w_dsp=rng.integers(-8, 8, (32, 22)), s_dsp=np.ones(22))


def test_dma_fusion_emits_bursts_golden_still_exact():
    p0 = _fc("torch", opt_level=0)
    p1 = optimize_program(p0, 1)
    bursts = [op.instr for lp in p1.layers for cp in lp.cores()
              for op in cp.ops()
              if isinstance(op.instr, (isa.FetchInstr, isa.ResultInstr))
              and op.instr.onchip_base >= 2]
    assert bursts, "expected at least one fused DMA burst"
    g0 = GoldenExecutor(p0, device="cpu")
    g1 = GoldenExecutor(p1, device="cpu")
    for g in (g0, g1):
        bind_synthetic(g, g.program.layers[0])
    x = np.random.default_rng(2).integers(-8, 8, (8, 32)).astype(np.int8)
    assert torch.equal(g0.run_layer(0, x), g1.run_layer(0, x))


def _dw_program(opt_level=0):
    return lower_network(
        "dwnet",
        [GemmLayer("fc0", GemmDims(64, 9, 32)),
         GemmLayer("dw", GemmDims(64, 9, 32), depthwise=True)],
        LUT, DSP, XC7Z020, n_luts=[16, 16], opt_level=opt_level)


def test_depthwise_executes_bit_exact_on_both_backends():
    prog = _dw_program()
    golden = GoldenExecutor(prog, device="cpu")
    fused = CudaExecutor(prog, device="cpu")
    lp = prog.layers[1]
    bind_synthetic(golden, lp)
    bind_synthetic(fused, lp)
    x = np.random.default_rng(3).integers(-8, 8, (64, 9, 32)).astype(np.int8)
    out_g = golden.run_layer(1, x)
    assert out_g.shape == (64, 32)
    assert torch.equal(out_g, fused.run_layer(1, x))
    # grouped semantics: channel c only sees slice c
    w = golden._weights[1]
    want0 = (x[:, :, 0].astype(np.int64)
             @ w.w_lut[:, 0].numpy().astype(np.int64))
    want0 = want0.astype(np.float32) * np.float32(w.s_lut[0].item())
    assert (out_g[:, 0].numpy() == want0).all()


def test_depthwise_rejects_wrong_activation_shape():
    prog = _dw_program()
    ex = GoldenExecutor(prog, device="cpu")
    bind_synthetic(ex, prog.layers[1])
    with pytest.raises(ExecutionError, match="staged"):
        ex.run_layer(1, np.zeros((64, 9), np.int8))


@pytest.mark.parametrize("backend", ["golden", "cuda"])
def test_execute_report_covers_depthwise(backend):
    """A geometry-less program runs layer by layer on the reference
    report's activations, so the checksums agree."""
    from repro.compiler.cli import execute_report as execute_report_jax
    want = execute_report_jax(lower_jax(
        "dwnet",
        [GemmLayerJax("fc0", GemmDimsJax(64, 9, 32)),
         GemmLayerJax("dw", GemmDimsJax(64, 9, 32), depthwise=True)],
        LutJax(m=8, n=16, k=128), DspJax(n_reg_row_a=13), XC7Z020_JAX,
        n_luts=[16, 16]), backend="golden")
    report = execute_report(_dw_program(), backend=backend, device="cpu")
    assert report.startswith(f"executed  2/2 layers via {backend} backend")
    assert report.split("|out| sum")[1] == want.split("|out| sum")[1]


CONV_CASES = [
    ConvSpec("k3s1", 5, 24, 3, 1, 10),
    ConvSpec("k3s2", 7, 20, 3, 2, 9),
    ConvSpec("k7s2", 3, 18, 7, 2, 16),        # the ResNet stem shape
    ConvSpec("k1s1", 12, 30, 1, 1, 6),        # pointwise
    ConvSpec("k1s2", 8, 16, 1, 2, 8),         # downsample shortcut
    ConvSpec("dw3s1", 20, 20, 3, 1, 8, depthwise=True),
    ConvSpec("dw3s2", 24, 24, 3, 2, 9, depthwise=True),
]


@pytest.mark.parametrize("spec", CONV_CASES, ids=lambda s: s.name)
def test_golden_matches_cnn_reference_conv(spec):
    """Im2col staging + (grouped) GEMM == the port's ``cnn.conv2d`` on
    the same codes: small integers accumulate exactly in both, then the
    same per-filter fp32 scale applies."""
    gl = GemmLayer.from_conv(spec)
    n_lut = gl.dims.n // 3
    prog = lower_network("one", [gl], LUT, DSP, XC7Z020, n_luts=[n_lut])
    ex = _bound(GoldenExecutor, prog, device="cpu")
    x = np.random.default_rng(7).integers(
        -8, 8, gl.geometry.in_shape).astype(np.int8)
    got = ex.run_layer(0, x)
    w = ex._weights[0]
    codes = torch.cat([c for c in (w.w_lut, w.w_dsp) if c is not None], 1)
    s = torch.cat([c for c in (w.s_lut, w.s_dsp) if c is not None])
    kk, ci = spec.kernel, 1 if spec.depthwise else spec.c_in
    w_hwio = codes.reshape(kk, kk, ci, spec.c_out).to(torch.float32)
    ref = cnn.conv2d(torch.from_numpy(x).to(torch.float32)[None], w_hwio,
                     spec)[0].reshape(-1, spec.c_out) * s[None, :]
    assert got.shape == (gl.dims.m, gl.dims.n)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("arch", ["resnet18", "mobilenet_v2"])
def test_cnn_end_to_end_cuda_bit_exact_vs_golden(arch):
    cfg = CNNConfig(arch=arch, n_classes=10, in_hw=28, width=0.25)
    prog = lower_network(arch, [GemmLayer.from_conv(s)
                                for s in specs_for(cfg)],
                         LUT, DSP, XC7Z020)
    x = _image(prog)
    out_g = _bound(GoldenExecutor, prog, device="cpu").run(x)
    out_c = _bound(CudaExecutor, prog, device="cpu").run(x)
    assert out_g.shape == (1, 10)
    assert float(out_g.abs().sum()) > 0
    assert torch.equal(out_g, out_c)


def test_chain_rejects_wrong_input_shape():
    prog = compile_network("resnet18", **REDUCED)
    ex = _bound(GoldenExecutor, prog, device="cpu")
    with pytest.raises(ExecutionError, match="spatial"):
        ex.run(np.zeros((5, 5, 3), np.int8))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs golden there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["resnet18", "mobilenet_v2"])
def test_golden_on_card_equals_cpu_and_kernels(cuda, arch):
    prog = compile_network(arch, **REDUCED)
    x = _image(prog)
    card = _bound(GoldenExecutor, prog, device=cuda).run(x)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(),
                       _bound(GoldenExecutor, prog, device="cpu").run(x))
    assert torch.equal(card, _bound(CudaExecutor, prog).run(x))
