"""The port's depthwise (grouped) contraction against the reference.

The reference runs depthwise layers as an exact int32 einsum
(``repro.kernels.ref`` grouped oracles, ``repro.kernels.ops`` grouped
wrappers); the port runs them through one hand-written CUDA kernel
(``repro_torch.kernels.depthwise_gemm``) whose wrappers compute their
plain versions on CPU tensors. Everything accumulates exactly in int32
and dequantizes with one fp32 multiply, and the CNN path has no
transcendentals, so the tolerance is zero everywhere: the oracles, the
wrappers, single depthwise layers and the whole reduced mobilenet_v2
chain (``in_hw=32, width=0.25``; its first depthwise layer is all-DSP)
on all three ``CudaExecutor`` paths must be bitwise equal to the
reference. The CUDA kernel itself runs only on a card (marker
``cuda``); ``chip_smoke.py`` holds it to its plain version at
full-width mobilenet_v2's shapes.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import PallasExecutor
from repro.compiler import bind_synthetic as bind_synthetic_jax
from repro.compiler import compile_network as compile_jax
from repro.compiler import lower_network as lower_jax
from repro.compiler.cli import execute_report as execute_report_jax
from repro.compiler.program import GemmLayer as GemmLayerJax
from repro.compiler.runtime import ExecutionError as ExecutionErrorJax
from repro.compiler.runtime.base import chain_layers as chain_jax
from repro.core.scheduler import XC7Z020 as XC7Z020_JAX
from repro.core.scheduler import DspCoreConfig as DspJax
from repro.core.scheduler import LutCoreConfig as LutJax
from repro.core.workloads import ConvSpec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.compiler import CudaExecutor, ExecutionError, GemmLayer, \
    bind_numpy_weights, compile_network, execute_report, lower_network
from repro_torch.compiler.runtime.base import chain_layers, im2col_patches
from repro_torch.core.scheduler import XC7Z020, DspCoreConfig, LutCoreConfig
from repro_torch.core.workloads import ConvSpec as ConvSpecTorch
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.depthwise_gemm import depthwise_conv_gemm, \
    depthwise_conv_gemm_plain, grouped_gemm, grouped_gemm_plain

REDUCED = {"in_hw": 32, "width": 0.25}
#: the reference's depthwise conv specs (``tests/test_conv_exec.py``):
#: (name, c, kernel, stride, in_hw); N = c channels, K = 9 taps
DW_SPECS = [("dw3s1", 20, 3, 1, 8), ("dw3s2", 24, 3, 2, 9)]
#: odd channel counts beside the specs' even ones
DW_CASES = [(*s, n) for s in DW_SPECS for n in (s[1], s[1] - 1)]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.int8 else a


def _same(a, b) -> bool:
    """Bitwise equality of a torch tensor and a JAX/numpy array."""
    a = a.numpy()
    b = np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(_bits(a), _bits(b))


def _stack(rng, c, kernel, stride, in_hw, n):
    """Seed-made int8 spatial block [in_hw, in_hw, n] and its per-channel
    im2col stack [m, kernel**2, n] (pad 1 for the 3x3 specs)."""
    pad = kernel // 2
    out_hw = (in_hw + 2 * pad - kernel) // stride + 1
    x_sp = rng.integers(-128, 128, (in_hw, in_hw, n)).astype(np.int8)
    x_col = ref.conv_patches_ref(torch.from_numpy(x_sp), kernel, stride, pad,
                                 out_hw)
    return x_sp, x_col.numpy(), (kernel, stride, pad, out_hw)


def _codes(rng, k, n, bits):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    return rng.integers(lo, hi, (k, n)).astype(np.int32), \
        rng.uniform(0.5, 2.0, n).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _split(rng, k, n, n_lut, bits):
    """numpy (w_lut, s_lut, w_dsp, s_dsp), None for an absent side."""
    w_lut, s_lut = _codes(rng, k, n_lut, bits) if n_lut else (None, None)
    w_dsp, s_dsp = _codes(rng, k, n - n_lut, 4) if n - n_lut else \
        (None, None)
    return w_lut, s_lut, w_dsp, s_dsp


# ---------------------------------------------------------------------------
# The grouped oracles against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("case", DW_CASES, ids=lambda c: f"{c[0]}n{c[-1]}")
def test_bitserial_grouped_oracle_matches_reference(case, bits):
    name, c, kernel, stride, in_hw, n = case
    rng = np.random.default_rng(bits * 10 + n)
    _, x_col, _ = _stack(rng, c, kernel, stride, in_hw, n)
    w, s = _codes(rng, kernel * kernel, n, bits)
    got = ref.bitserial_grouped_gemm_ref(_t(x_col), _t(w), _t(s), bits)
    assert _same(got, jref.bitserial_grouped_gemm_ref(
        jnp.asarray(x_col), jnp.asarray(w), jnp.asarray(s), bits))


@pytest.mark.parametrize("case", DW_CASES, ids=lambda c: f"{c[0]}n{c[-1]}")
def test_int4_grouped_oracle_matches_reference(case):
    name, c, kernel, stride, in_hw, n = case
    rng = np.random.default_rng(n)
    _, x_col, _ = _stack(rng, c, kernel, stride, in_hw, n)
    w, s = _codes(rng, kernel * kernel, n, 4)
    got = ref.int4_grouped_gemm_ref(_t(x_col), _t(w), _t(s))
    assert _same(got, jref.int4_grouped_gemm_ref(
        jnp.asarray(x_col), jnp.asarray(w), jnp.asarray(s)))


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("lut_share", [0, 3, 1], ids=["dsp", "split", "lut"])
@pytest.mark.parametrize("case", DW_CASES, ids=lambda c: f"{c[0]}n{c[-1]}")
def test_fused_grouped_oracle_matches_reference(case, lut_share, bits):
    """n_lut in {0, N // 3, N}: all-DSP, split, all-LUT."""
    name, c, kernel, stride, in_hw, n = case
    n_lut = {0: 0, 3: n // 3, 1: n}[lut_share]
    rng = np.random.default_rng(bits + n_lut)
    _, x_col, _ = _stack(rng, c, kernel, stride, in_hw, n)
    w = _split(rng, kernel * kernel, n, n_lut, bits)
    got = ref.fused_hetero_grouped_gemm_ref(_t(x_col), *map(_t, w[:2]), bits,
                                            *map(_t, w[2:]))
    want = jref.fused_hetero_grouped_gemm_ref(jnp.asarray(x_col),
                                              *map(_j, w[:2]), bits,
                                              *map(_j, w[2:]))
    assert _same(got, want)


def test_grouped_dot_is_exact_at_the_extremes():
    """|x| = 128 against |w| = 128 over 32 taps stays exact in int32."""
    x = torch.full((3, 32, 5), -128, dtype=torch.int8)
    w = torch.full((32, 5), -128, dtype=torch.int32)
    assert torch.equal(ref.grouped_dot(x, w),
                       torch.full((3, 5), 128 * 128 * 32, dtype=torch.int32))
    planes = ref.bitplane_decompose(w, 8)
    assert torch.equal(ref.bitplane_grouped_dot(x, planes),
                       ref.grouped_dot(x, w))


# ---------------------------------------------------------------------------
# The wrappers: plain versions on prepared weights, the codes surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("lut_share", [0, 3, 1], ids=["dsp", "split", "lut"])
@pytest.mark.parametrize("case", DW_CASES, ids=lambda c: f"{c[0]}n{c[-1]}")
def test_plain_wrappers_match_oracle(case, lut_share, bits):
    """Every entry point on prepared ``SplitWeights`` — the kernel
    wrappers (plain on the CPU), their ``*_plain`` versions, ``mode="ref"``
    and the one-side-alone forms — equals the oracle on the codes."""
    name, c, kernel, stride, in_hw, n = case
    n_lut = {0: 0, 3: n // 3, 1: n}[lut_share]
    rng = np.random.default_rng(100 + bits + n_lut)
    x_sp, x_col, geom = _stack(rng, c, kernel, stride, in_hw, n)
    w = [_t(a) for a in _split(rng, kernel * kernel, n, n_lut, bits)]
    want = ref.fused_hetero_grouped_gemm_ref(_t(x_col), w[0], w[1], bits,
                                             w[2], w[3])
    k = kernel * kernel
    sw = ops.prepare_split(k, w[0], w[1], bits, w[2], w[3],
                           torch.device("cpu"))
    xs, xc = _t(x_sp), _t(x_col)
    args = (sw.planes, sw.packed, sw.scale, bits, sw.n_lut, sw.n_dsp)
    for got in (grouped_gemm(xc, *args), grouped_gemm_plain(xc, *args),
                depthwise_conv_gemm(xs, *args, *geom),
                depthwise_conv_gemm_plain(xs, *args, *geom),
                ops.split_grouped_matmul(xc, sw),
                ops.split_grouped_matmul(xc, sw, mode="ref"),
                ops.split_depthwise_matmul(xs, *geom, sw),
                ops.split_depthwise_matmul(xs, *geom, sw, mode="ref")):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if n_lut:
        got = ops.lut_grouped_matmul(xc[:, :, :n_lut], sw)
        assert torch.equal(got, want[:, :n_lut])
    if n - n_lut:
        got = ops.dsp_grouped_matmul(xc[:, :, n_lut:], sw)
        assert torch.equal(got, want[:, n_lut:])


@pytest.mark.parametrize("mode", ["auto", "ref"])
@pytest.mark.parametrize("n_lut", [0, 7, 20])
def test_codes_wrappers_match_reference(n_lut, mode):
    """The counterparts of the reference's grouped wrappers, on codes."""
    name, c, kernel, stride, in_hw = DW_SPECS[0]
    rng = np.random.default_rng(n_lut)
    x_sp, x_col, geom = _stack(rng, c, kernel, stride, in_hw, c)
    w = _split(rng, kernel * kernel, c, n_lut, 5)
    tw, jw = [_t(a) for a in w], [_j(a) for a in w]
    xs, xc = _t(x_sp), _t(x_col)
    assert _same(ops.fused_grouped_matmul(xc, *tw[:2], 5, *tw[2:], mode=mode),
                 jops.fused_grouped_matmul(jnp.asarray(x_col), *jw[:2], 5,
                                           *jw[2:]))
    assert _same(ops.fused_depthwise_matmul(xs, *geom, *tw[:2], 5, *tw[2:],
                                            mode=mode),
                 jops.fused_depthwise_matmul(jnp.asarray(x_sp), *geom,
                                             *jw[:2], 5, *jw[2:]))
    if n_lut:
        assert _same(ops.bitserial_grouped_matmul(xc[:, :, :n_lut], tw[0],
                                                  tw[1], 5, mode=mode),
                     jops.bitserial_grouped_matmul(
                         jnp.asarray(x_col[:, :, :n_lut]), jw[0], jw[1], 5))
    if c - n_lut:
        assert _same(ops.int4_grouped_matmul(xc[:, :, n_lut:], tw[2], tw[3],
                                             mode=mode),
                     jops.int4_grouped_matmul(
                         jnp.asarray(x_col[:, :, n_lut:]), jw[2], jw[3]))


def _prepared(n_lut=7, n=12, bits=4):
    rng = np.random.default_rng(5)
    w = [_t(a) for a in _split(rng, 9, n, n_lut, bits)]
    return ops.prepare_split(9, w[0], w[1], bits, w[2], w[3],
                             torch.device("cpu"))


def test_wrappers_reject_bad_operands():
    sw = _prepared()
    args = (sw.planes, sw.packed, sw.scale, 4, 7, 5)
    x = torch.zeros((6, 9, 12), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        grouped_gemm(x.to(torch.int32), *args)
    with pytest.raises(ValueError, match="shape"):
        grouped_gemm(x[:, :, :11].contiguous(), *args)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm(x.transpose(0, 1).contiguous().transpose(0, 1), *args)
    with pytest.raises(ValueError, match="shape"):          # wrong bits
        grouped_gemm(x, sw.planes, sw.packed, sw.scale, 3, 7, 5)
    with pytest.raises(ValueError, match="empty"):
        grouped_gemm(x[:, :, :0], sw.planes[:, :, :0], sw.packed[:, :0],
                     sw.scale[:0], 4, 0, 0)
    big = torch.zeros((2, 36, 1), dtype=torch.int8)         # 6x6 taps
    with pytest.raises(ValueError, match="taps"):
        grouped_gemm(big, torch.zeros((4, 36, 1), dtype=torch.int8),
                     torch.zeros((36, 0), dtype=torch.int8),
                     torch.ones(1), 4, 1, 0)
    x_sp = torch.zeros((5, 5, 12), dtype=torch.int8)
    with pytest.raises(ValueError, match="does not give"):
        depthwise_conv_gemm(x_sp, *args, 3, 1, 1, 4)
    with pytest.raises(ValueError, match="shape"):
        depthwise_conv_gemm(x_sp[:, :, :10].contiguous(), *args, 3, 1, 1, 5)
    with pytest.raises(ValueError, match="mode"):
        ops.split_grouped_matmul(x, sw, mode="kernel")
    with pytest.raises(ValueError, match="empty"):
        ops.fused_grouped_matmul(x, None, None, 4, None, None)


def test_cpu_tensors_launch_nothing():
    before = dict(build.LAUNCHES)
    sw = _prepared()
    x = torch.ones((6, 9, 12), dtype=torch.int8)
    ops.split_grouped_matmul(x, sw)
    ops.lut_grouped_matmul(x[:, :, :7], sw)
    ops.dsp_grouped_matmul(x[:, :, 7:], sw)
    ops.split_depthwise_matmul(torch.ones((4, 4, 12), dtype=torch.int8),
                               3, 2, 1, 2, sw)
    assert dict(build.LAUNCHES) == before


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


@pytest.mark.parametrize("source", sorted(build.SOURCES))
def test_entry_points_match_their_c_signatures(source):
    """Each entry point's ctypes argtypes in ``build.SOURCES`` match the
    C signature in its source (the card's compiler is the first to see
    the source, so this is checked here)."""
    text = build.source_path(source).read_text()
    block = text[text.index('extern "C" {'):]
    found = {}
    for m in re.finditer(r"^int (\w+)\(([^)]*)\)", block, re.M):
        params = [" ".join(p.split()[:-1]) for p in m.group(2).split(",")]
        found[m.group(1)] = [_C_TYPES[p] for p in params]
    assert found == build.SOURCES[source]


# ---------------------------------------------------------------------------
# Single depthwise layers through the executors
# ---------------------------------------------------------------------------


def _one_layer(spec_args, n_lut):
    name, c, kernel, stride, in_hw = spec_args
    spec_j = ConvSpec(name, c, c, kernel, stride, in_hw, depthwise=True)
    spec_t = ConvSpecTorch(name, c, c, kernel, stride, in_hw, depthwise=True)
    pj = lower_jax("one", [GemmLayerJax.from_conv(spec_j)],
                   LutJax(m=8, n=16, k=128), DspJax(n_reg_row_a=13),
                   XC7Z020_JAX, n_luts=[n_lut])
    pt = lower_network("one", [GemmLayer.from_conv(spec_t)],
                       LutCoreConfig(m=8, n=16, k=128),
                       DspCoreConfig(n_reg_row_a=13), XC7Z020,
                       n_luts=[n_lut])
    assert pt.fingerprint() == pj.fingerprint()
    return pj, pt


@pytest.mark.parametrize("lut_share", [0, 3, 1], ids=["dsp", "split", "lut"])
@pytest.mark.parametrize("spec", DW_SPECS, ids=lambda s: s[0])
def test_single_depthwise_layer_every_path(spec, lut_share):
    """A depthwise layer on spatial and staged input, one-sided splits
    included, through each port path against the reference executor."""
    c = spec[1]
    n_lut = {0: 0, 3: c // 3, 1: c}[lut_share]
    pj, pt = _one_layer(spec, n_lut)
    ex_j = PallasExecutor(pj)
    bind_synthetic_jax(ex_j, pj.layers[0], seed=3)
    w = tuple(None if a is None else np.asarray(a)
              for a in (ex_j._weights[0].w_lut, ex_j._weights[0].s_lut,
                        ex_j._weights[0].w_dsp, ex_j._weights[0].s_dsp))
    lp = pt.layers[0]
    x_sp = np.random.default_rng(7).integers(
        -8, 8, lp.geometry.in_shape).astype(np.int8)
    want = np.asarray(ex_j.run_layer(0, x_sp))
    staged = im2col_patches(torch.from_numpy(x_sp), lp.geometry)
    assert tuple(staged.shape) == (lp.dims.m, lp.dims.k, lp.dims.n)
    assert _same(staged, np.asarray(ex_j._staged_activations(
        pj.layers[0], jnp.asarray(x_sp))))
    for kw in ({}, {"fused": False}, {"mode": "ref"}):
        ex = CudaExecutor(pt, device="cpu", **kw)
        bind_numpy_weights(ex, {0: w})
        for x in (x_sp, staged):
            assert _same(ex.run_layer(0, x), want), (kw, tuple(x.shape))


def test_malformed_depthwise_inputs_raise_as_reference():
    pj, pt = _one_layer(DW_SPECS[1], 8)
    ex_j = PallasExecutor(pj)
    bind_synthetic_jax(ex_j, pj.layers[0], seed=0)
    ex = CudaExecutor(pt, device="cpu")
    with pytest.raises(ExecutionError, match="no bound weights"):
        ex.run_layer(0, np.zeros(pt.layers[0].geometry.in_shape, np.int8))
    bind_numpy_weights(ex, {0: tuple(
        None if a is None else np.asarray(a)
        for a in (ex_j._weights[0].w_lut, ex_j._weights[0].s_lut,
                  ex_j._weights[0].w_dsp, ex_j._weights[0].s_dsp))})
    lp = pt.layers[0]
    m, k, n = lp.dims.m, lp.dims.k, lp.dims.n
    for shape in [(m, k), (m, k, n - 1), (m * k, n), (9, 9, n - 1)]:
        x = np.zeros(shape, np.int8)
        with pytest.raises(ExecutionErrorJax) as want:
            ex_j.run_layer(0, x)
        for e in (ex, CudaExecutor(pt, device="cpu", fused=False)):
            if e is not ex:
                bind_numpy_weights(e, {0: tuple(
                    None if a is None else a.numpy()
                    for a in (ex._weights[0].w_lut, ex._weights[0].s_lut,
                              ex._weights[0].w_dsp, ex._weights[0].s_dsp))})
            with pytest.raises(ExecutionError) as got:
                e.run_layer(0, x)
            assert str(got.value) == str(want.value)
            assert "depthwise layer 0 activations must be" in str(got.value)


# ---------------------------------------------------------------------------
# Reduced mobilenet_v2 end to end
# ---------------------------------------------------------------------------


def _recording(run_layer, store):
    """Wrap ``run_layer`` to keep each layer's input codes and output."""
    def run(index, x):
        out = run_layer(index, x)
        store[index] = (np.asarray(x), np.asarray(out))
        return out
    return run


@pytest.fixture(scope="module")
def reference():
    """The reference run of reduced mobilenet_v2: program, bound
    weights, image, logits and the per-layer (input codes, GEMM output)
    of the chain."""
    prog = compile_jax("mobilenet_v2", **REDUCED)
    ex = PallasExecutor(prog)
    for lp in prog.layers:
        bind_synthetic_jax(ex, lp, seed=lp.index)
    weights = {i: tuple(None if a is None else np.asarray(a)
                        for a in (w.w_lut, w.s_lut, w.w_dsp, w.s_dsp))
               for i, w in ex._weights.items()}
    lp0 = prog.layers[0]
    image = np.random.default_rng(0).integers(
        -8, 8, lp0.geometry.in_shape).astype(np.int8)
    layers = {}
    logits = np.asarray(chain_jax(prog.layers,
                                  _recording(ex.run_layer, layers), image,
                                  tail_factory=ex._elementwise_tail))
    assert np.array_equal(logits, np.asarray(ex.run(image)))
    return prog, weights, image, logits, layers


def _port(prog_jax, weights, **kw):
    prog = compile_network("mobilenet_v2", **REDUCED)
    assert prog.fingerprint() == prog_jax.fingerprint()
    ex = CudaExecutor(prog, device="cpu", **kw)
    bind_numpy_weights(ex, weights)
    return ex


def test_reduced_network_covers_the_depthwise_cases(reference):
    """What the chain below exercises: 17 depthwise layers, the first
    all-DSP, the rest split; inverted residuals 3 layers back; relu6."""
    prog = reference[0]
    dw = [lp for lp in prog.layers if lp.depthwise]
    assert len(prog.layers) == 53 and len(dw) == 17
    assert dw[0].n_lut == 0 and all(0 < lp.n_lut < lp.dims.n
                                    for lp in dw[1:])
    adds = [op for lp in prog.layers for op in lp.elementwise
            if op.kind == "add"]
    assert len(adds) == 10 and {op.src_offset for op in adds} == {3}
    assert {op.kind for lp in dw for op in lp.elementwise} == {"relu6",
                                                              "requant"}


@pytest.mark.parametrize("kw", [{}, {"fused": False}, {"mode": "ref"}],
                         ids=["fused", "per-partition", "plain"])
def test_every_layer_and_code_bitwise_equal_reference(reference, kw):
    """Logits, every layer's GEMM output and every stored requant code
    (each layer's input is its producer's codes) on each path."""
    prog_jax, weights, image, logits, layers = reference
    ex = _port(prog_jax, weights, **kw)
    got_layers = {}
    got = chain_layers(ex.program.layers,
                       _recording(ex.run_layer, got_layers),
                       ex._as_codes(image))
    assert got.dtype == torch.float32 and got.shape == (1, 1000)
    assert np.isfinite(got.numpy()).all()
    assert np.array_equal(_bits(got.numpy()), _bits(logits))
    assert sorted(got_layers) == sorted(layers) == list(range(53))
    for i in layers:
        x_ref, out_ref = layers[i]
        x_got, out_got = got_layers[i]
        assert np.array_equal(x_got, x_ref), f"layer {i} input codes"
        assert np.array_equal(_bits(out_got), _bits(out_ref)), \
            f"layer {i} GEMM output"
    assert torch.equal(ex.run(image), got)


def test_staged_depthwise_inputs_take_the_same_bits(reference):
    """Every layer handed its pre-staged input — [m, k, n] for depthwise
    layers, [m, k] for dense ones — gives the spatial input's bits on the
    fused and per-partition paths."""
    prog_jax, weights, _, _, layers = reference
    fused = _port(prog_jax, weights)
    split = _port(prog_jax, weights, fused=False)
    for lp in fused.program.layers:
        x_sp, out = layers[lp.index]
        staged = im2col_patches(torch.tensor(x_sp), lp.geometry)
        if not lp.depthwise:
            staged = staged.reshape(lp.dims.m, lp.dims.k)
        for ex in (fused, split):
            assert _same(ex.run_layer(lp.index, staged), out), lp.name


def test_cli_checksum_matches_reference_cli(reference, capsys):
    """``python -m repro_torch.compiler mobilenet_v2 --execute`` on the
    CPU prints the JAX CLI's ``|out| sum`` line."""
    from repro_torch.compiler.cli import main
    prog_jax, _, _, logits, _ = reference
    want = execute_report_jax(prog_jax, backend="pallas")
    checksum = re.search(r"\|out\| sum \S+\)", want).group(0)
    assert checksum == f"|out| sum {float(np.abs(logits).sum()):.6e})"
    assert main(["mobilenet_v2", "--in-hw", "32", "--width", "0.25",
                 "--execute", "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "executed  53/53 layers end to end via cuda backend" in out
    assert checksum in out
    line = execute_report(compile_network("mobilenet_v2", **REDUCED),
                          device="cpu")
    assert checksum in line


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("lut_share", [0, 3, 1], ids=["dsp", "split", "lut"])
@pytest.mark.parametrize("case", DW_CASES, ids=lambda c: f"{c[0]}n{c[-1]}")
def test_kernel_matches_plain_on_card(cuda, case, lut_share, bits):
    """Both entry points at the reference's specs, odd N and one-sided
    splits, against the plain version on the same card tensors."""
    name, c, kernel, stride, in_hw, n = case
    n_lut = {0: 0, 3: n // 3, 1: n}[lut_share]
    rng = np.random.default_rng(bits + n)
    x_sp, x_col, geom = _stack(rng, c, kernel, stride, in_hw, n)
    w = [_t(a) for a in _split(rng, kernel * kernel, n, n_lut, bits)]
    sw = ops.prepare_split(kernel * kernel, w[0], w[1], bits, w[2], w[3],
                           cuda)
    xs, xc = _t(x_sp).to(cuda), _t(x_col).to(cuda)
    args = (sw.planes, sw.packed, sw.scale, bits, sw.n_lut, sw.n_dsp)
    assert torch.equal(grouped_gemm(xc, *args), grouped_gemm_plain(xc, *args))
    assert torch.equal(depthwise_conv_gemm(xs, *args, *geom),
                       depthwise_conv_gemm_plain(xs, *args, *geom))
