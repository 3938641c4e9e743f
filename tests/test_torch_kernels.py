"""The port's split-GEMM kernels and their plain versions.

On the CPU the kernel wrappers compute their plain PyTorch versions,
which must equal the reference's oracles (``repro.kernels.ref``) and
the Pallas kernel bodies in interpret mode **bitwise**: every path
accumulates exactly in int32 and applies the same fp32 dequant
multiply, so the tolerance is zero. The CUDA kernels themselves run
only on a card (marker ``cuda``); ``chip_smoke.py`` drives them there
at resnet18's full-width shapes.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitserial_gemm import bitserial_gemm, \
    bitserial_gemm_plain
from repro_torch.kernels import fused_hetero_gemm as fhg
from repro_torch.kernels.fused_hetero_gemm import fused_conv_gemm, \
    fused_conv_gemm_plain, fused_hetero_gemm, fused_hetero_gemm_plain
from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain

# (bits, n_lut, n_dsp): the reference's fused-kernel corners — mixed
# ratios, ragged extents and one-sided splits
SPLIT_CORNERS = [
    (2, 24, 40), (4, 16, 48), (6, 40, 24), (8, 62, 2),
    (4, 0, 64), (4, 64, 0), (3, 2, 62),
]
# (kernel, stride, pad): the reference's conv geometries plus resnet18's
# 7x7/2 stem
CONV_GEOMS = [(3, 1, 1), (3, 2, 0), (1, 1, 0), (5, 2, 2), (7, 2, 3)]


def _same(a, b) -> bool:
    """Bitwise equality of a torch tensor and a JAX/numpy array."""
    a = a.numpy()
    b = np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _split_weights(rng, k, n_lut, n_dsp, bits):
    """numpy (w_lut, s_lut, w_dsp, s_dsp), None for an absent side."""
    w_lut = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1),
                         (k, n_lut)).astype(np.int32) if n_lut else None
    w_dsp = rng.integers(-8, 8, (k, n_dsp)).astype(np.int32) \
        if n_dsp else None
    s_lut = rng.uniform(0.5, 2.0, n_lut).astype(np.float32) \
        if n_lut else None
    s_dsp = rng.uniform(0.5, 2.0, n_dsp).astype(np.float32) \
        if n_dsp else None
    return w_lut, s_lut, w_dsp, s_dsp


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# Representation helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", range(2, 9))
def test_bitplanes_match_reference(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), (17, 9))
    planes = ref.bitplane_decompose(torch.from_numpy(q), bits)
    assert _same(planes, jref.bitplane_decompose(jnp.asarray(q), bits))
    assert ref.plane_scales(bits) == \
        np.asarray(jref.plane_scales(bits)).tolist()
    back = ref.bitplane_reconstruct(planes)
    assert _same(back, jref.bitplane_reconstruct(jnp.asarray(planes.numpy())))
    assert np.array_equal(back.numpy(), q)


KMAJOR_KS = [1, 31, 32, 33, 147, 4608]


@pytest.mark.parametrize("k", KMAJOR_KS)
@pytest.mark.parametrize("bits", range(1, 9))
def test_kmajor_words_round_trip(bits, k):
    """The single-path kernels' K-major words: codes -> words -> codes
    exactly, every row a multiple of 16 bytes whose padding is zero."""
    rng = np.random.default_rng(bits * 10_000 + k)
    n = 5
    q = torch.from_numpy(rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1),
                                      (k, n)))
    planes = ref.bitplane_decompose(q, bits)
    words = ref.pack_bits_kmajor(planes)
    kw = ref.kmajor_row_words(k, ref.LUT_PER_WORD)
    assert words.shape == (bits, n, kw) and words.dtype == torch.int32
    assert kw % 4 == 0 and 32 * kw >= k > 32 * kw - 128
    assert torch.equal(ref.unpack_bits_kmajor(words, k), planes)
    # bit k % 32 of word k // 32 of row (b, n), and zero past K
    bit = (words.numpy().view(np.uint32)[..., None]
           >> np.arange(32, dtype=np.uint32)) & 1
    bit = bit.reshape(bits, n, 32 * kw)
    assert np.array_equal(bit[..., :k], planes.numpy().transpose(0, 2, 1))
    assert not bit[..., k:].any()

    codes = torch.from_numpy(rng.integers(-8, 8, (k, n)))
    dwords = ref.pack_int4_kmajor(codes)
    kn = ref.kmajor_row_words(k, ref.DSP_PER_WORD)
    assert dwords.shape == (n, kn) and dwords.dtype == torch.int32
    assert kn % 4 == 0 and 8 * kn >= k > 8 * kn - 32
    assert torch.equal(ref.unpack_int4_kmajor(dwords, k),
                       codes.to(torch.int8))
    nib = (dwords.numpy().view(np.uint32)[..., None]
           >> (4 * np.arange(8, dtype=np.uint32))) & 0xF
    nib = nib.reshape(n, 8 * kn)
    assert np.array_equal(nib[:, :k], codes.numpy().T & 0xF)
    assert not nib[:, k:].any()


def test_int4_packing_matches_reference():
    q = np.arange(-8, 8).repeat(3).reshape(4, 12)
    packed = ref.pack_int4(torch.from_numpy(q))
    assert _same(packed, jref.pack_int4(jnp.asarray(q)))
    assert _same(ref.unpack_int4(packed),
                 jref.unpack_int4(jnp.asarray(packed.numpy())))
    assert np.array_equal(ref.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError):
        ref.pack_int4(torch.zeros((2, 3), dtype=torch.int32))


# ---------------------------------------------------------------------------
# Oracles and wrappers vs the reference, at the split corners
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,n_lut,n_dsp", SPLIT_CORNERS)
def test_fused_split_matches_reference(bits, n_lut, n_dsp):
    rng = np.random.default_rng(bits * 100 + n_lut)
    m, k = 13, 72                               # ragged: no block multiples
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = _split_weights(rng, k, n_lut, n_dsp, bits)
    want = jref.fused_hetero_gemm_ref(jnp.asarray(x), _j(w[0]), _j(w[1]),
                                      bits, _j(w[2]), _j(w[3]))
    tw = [_t(a) for a in w]
    xt = torch.from_numpy(x)
    assert _same(ref.fused_hetero_gemm_ref(xt, tw[0], tw[1], bits, tw[2],
                                           tw[3]), want)
    # the wrapper on CPU tensors: prepared weights, plain version
    assert _same(ops.fused_matmul(xt, tw[0], tw[1], bits, tw[2], tw[3]),
                 want)
    assert _same(ops.fused_matmul(xt, tw[0], tw[1], bits, tw[2], tw[3],
                                  mode="ref"), want)


@pytest.mark.parametrize("bits,n_lut,n_dsp", SPLIT_CORNERS)
def test_single_path_gemms_match_reference(bits, n_lut, n_dsp):
    rng = np.random.default_rng(bits * 10 + n_dsp)
    m, k = 9, 40
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w_lut, s_lut, w_dsp, s_dsp = _split_weights(rng, k, n_lut, n_dsp, bits)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if n_lut:
        want = jref.bitserial_gemm_ref(xj, jnp.asarray(w_lut),
                                       jnp.asarray(s_lut), bits)
        assert _same(ref.bitserial_gemm_ref(xt, _t(w_lut), _t(s_lut), bits),
                     want)
        assert _same(ops.bitserial_matmul(xt, _t(w_lut), _t(s_lut), bits),
                     want)
    if n_dsp and n_dsp % 2 == 0:
        packed = jref.pack_int4(jnp.asarray(w_dsp))
        want = jref.int4_gemm_ref(xj, packed, jnp.asarray(s_dsp))
        assert _same(ref.int4_gemm_ref(xt, ref.pack_int4(_t(w_dsp)),
                                       _t(s_dsp)), want)
    if n_dsp:
        want = jops.int4_matmul(xj, jnp.asarray(w_dsp), jnp.asarray(s_dsp),
                                mode="ref")
        for mode in ops.MODES:
            assert _same(ops.int4_matmul(xt, _t(w_dsp), _t(s_dsp),
                                         mode=mode), want)
    if n_lut and n_dsp:
        want = jops.hetero_matmul(xj, jnp.asarray(w_lut), jnp.asarray(s_lut),
                                  bits, jnp.asarray(w_dsp),
                                  jnp.asarray(s_dsp), mode="ref")
        assert _same(ops.hetero_matmul(xt, _t(w_lut), _t(s_lut), bits,
                                       _t(w_dsp), _t(s_dsp)), want)


@pytest.mark.parametrize("kernel,stride,pad", CONV_GEOMS)
def test_conv_split_matches_reference(kernel, stride, pad):
    """Implicit-im2col conv from the unpadded block, C=3 (K not a
    multiple of 4), against the reference's staged oracle."""
    bits, n_lut, n_dsp, in_hw, c_in = 5, 16, 23, 11, 3
    out_hw = (in_hw + 2 * pad - kernel) // stride + 1
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.integers(-128, 128, (in_hw, in_hw, c_in)).astype(np.int8)
    k = kernel * kernel * c_in
    w = _split_weights(rng, k, n_lut, n_dsp, bits)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    assert _same(ref.conv_patches_ref(xt, kernel, stride, pad, out_hw),
                 jref.conv_patches_ref(xj, kernel, stride, pad, out_hw))
    want = jops.fused_conv_matmul(xj, kernel, stride, pad, out_hw, _j(w[0]),
                                  _j(w[1]), bits, _j(w[2]), _j(w[3]),
                                  mode="ref")
    tw = [_t(a) for a in w]
    for mode in ops.MODES:
        got = ops.fused_conv_matmul(xt, kernel, stride, pad, out_hw, tw[0],
                                    tw[1], bits, tw[2], tw[3], mode=mode)
        assert _same(got, want)


@pytest.mark.parametrize("bits,n_lut,n_dsp", [(4, 16, 48), (3, 2, 62)])
def test_dense_wrapper_matches_pallas_interpret(bits, n_lut, n_dsp):
    """The reference's Pallas kernel body (interpret mode) on a ragged
    shape: the same bits as the port's wrapper."""
    rng = np.random.default_rng(bits * 7 + n_lut)
    m, k = 13, 72
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = _split_weights(rng, k, n_lut, n_dsp, bits)
    want = jops.fused_matmul(jnp.asarray(x), *[_j(a) for a in w[:2]], bits,
                             *[_j(a) for a in w[2:]], mode="kernel",
                             block=(8, 32, 16))
    tw = [_t(a) for a in w]
    assert _same(ops.fused_matmul(torch.from_numpy(x), tw[0], tw[1], bits,
                                  tw[2], tw[3]), want)


# (bits, n_lut, n_dsp, m, k): every LUT bit width, one-sided splits, odd
# n_dsp, ragged M and K (a word boundary, K not a multiple of 4)
SINGLE_PATH_CASES = [
    (1, 9, 0, 13, 72), (2, 24, 40, 5, 147), (3, 2, 61, 9, 33),
    (4, 16, 47, 13, 72), (5, 0, 33, 1, 31), (6, 40, 1, 7, 96),
    (7, 31, 0, 13, 33), (8, 62, 3, 3, 147),
]


@pytest.mark.parametrize("bits,n_lut,n_dsp,m,k", SINGLE_PATH_CASES)
def test_single_path_kmajor_matches_pallas_interpret(bits, n_lut, n_dsp, m,
                                                     k):
    """``lut_matmul`` / ``dsp_matmul`` on the K-major words (CPU tensors:
    the plain versions) are bitwise the reference's Pallas kernel bodies
    in interpret mode and its oracles."""
    rng = np.random.default_rng(bits * 1000 + m * 10 + k)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w_lut, s_lut, w_dsp, s_dsp = _split_weights(rng, k, n_lut, n_dsp, bits)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    sw = ops.prepare_split(k, _t(w_lut), _t(s_lut), bits, _t(w_dsp),
                           _t(s_dsp), torch.device("cpu"))
    if n_lut:
        for mode in ("kernel", "ref"):
            want = jops.bitserial_matmul(xj, jnp.asarray(w_lut),
                                         jnp.asarray(s_lut), bits,
                                         block=(16, 32, 32), mode=mode)
            assert _same(ops.lut_matmul(xt, sw), want)
            assert _same(ops.lut_matmul(xt, sw, mode="ref"), want)
    if n_dsp:
        for mode in ("kernel", "ref"):
            want = jops.int4_matmul(xj, jnp.asarray(w_dsp),
                                    jnp.asarray(s_dsp), block=(16, 32, 32),
                                    mode=mode)
            assert _same(ops.dsp_matmul(xt, sw), want)
            assert _same(ops.dsp_matmul(xt, sw, mode="ref"), want)
    if not (n_lut and n_dsp):
        want = jops.fused_matmul(xj, _j(w_lut), _j(s_lut), bits, _j(w_dsp),
                                 _j(s_dsp), mode="ref")
        assert _same(ops.split_matmul(xt, sw), want)


@pytest.mark.parametrize("kernel,stride,pad", [(3, 1, 1), (1, 1, 0)])
def test_conv_wrapper_matches_pallas_interpret(kernel, stride, pad):
    bits, n_lut, n_dsp, in_hw, c_in = 4, 8, 8, 6, 4
    out_hw = (in_hw + 2 * pad - kernel) // stride + 1
    rng = np.random.default_rng(kernel)
    x = rng.integers(-128, 128, (in_hw, in_hw, c_in)).astype(np.int8)
    w = _split_weights(rng, kernel * kernel * c_in, n_lut, n_dsp, bits)
    want = jops.fused_conv_matmul(jnp.asarray(x), kernel, stride, pad,
                                  out_hw, *[_j(a) for a in w[:2]], bits,
                                  *[_j(a) for a in w[2:]], mode="kernel",
                                  block=(8, 8, 8))
    tw = [_t(a) for a in w]
    assert _same(ops.fused_conv_matmul(torch.from_numpy(x), kernel, stride,
                                       pad, out_hw, tw[0], tw[1], bits,
                                       tw[2], tw[3]), want)


# ---------------------------------------------------------------------------
# Wrapper contract
# ---------------------------------------------------------------------------


def _prepared(k=24, n_lut=10, n_dsp=7, bits=4, seed=0):
    w = _split_weights(np.random.default_rng(seed), k, n_lut, n_dsp, bits)
    return ops.prepare_split(k, *[_t(a) for a in w[:2]], bits,
                             *[_t(a) for a in w[2:]], torch.device("cpu"))


def test_prepared_weights_layout():
    sw = _prepared()
    assert sw.planes.shape == (4, 24, 10) and sw.planes.dtype == torch.int8
    assert sw.packed.shape == (24, 4) and sw.packed.dtype == torch.int8
    # K-major words: 24 bits -> one 16-byte row of 4 words; 24 nibbles ->
    # 3 words padded to 4
    assert sw.lut_words.shape == (4, 10, 4)
    assert sw.lut_words.dtype == torch.int32
    assert sw.dsp_words.shape == (7, 4)
    assert sw.dsp_words.dtype == torch.int32
    assert all(t.is_contiguous() for t in (sw.planes, sw.packed,
                                           sw.lut_words, sw.dsp_words))
    assert torch.equal(ref.unpack_bits_kmajor(sw.lut_words, 24), sw.planes)
    codes = ref.unpack_int4_kmajor(sw.dsp_words, 24).to(torch.int32)
    assert torch.equal(ref.pack_int4(torch.nn.functional.pad(codes, (0, 1))),
                       sw.packed)
    assert sw.scale.shape == (17,) and sw.scale.dtype == torch.float32
    assert sw.s_lut.shape == (10,) and sw.s_dsp.shape == (7,)
    with pytest.raises(ValueError):
        ops.prepare_split(24, None, None, 4, None, None, torch.device("cpu"))


def test_wrappers_reject_bad_operands():
    sw = _prepared()
    x = torch.zeros((5, 24), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        fused_hetero_gemm(x.to(torch.int32), sw.lut_words, sw.dsp_words,
                          sw.scale, 4, 10, 7)
    with pytest.raises(ValueError, match="shape"):   # K = 200: longer rows
        fused_hetero_gemm(torch.zeros((5, 200), dtype=torch.int8),
                          sw.lut_words, sw.dsp_words, sw.scale, 4, 10, 7)
    # the fused kernels take the K-major words, not the planes / packed
    with pytest.raises(ValueError, match="int32"):
        fused_hetero_gemm(x, sw.planes, sw.dsp_words, sw.scale, 4, 10, 7)
    with pytest.raises(ValueError, match="int32"):
        fused_hetero_gemm(x, sw.lut_words, sw.packed, sw.scale, 4, 10, 7)
    with pytest.raises(ValueError, match="shape"):      # bits 3 of 4 planes
        fused_hetero_gemm(x, sw.lut_words, sw.dsp_words, sw.scale, 3, 10, 7)
    with pytest.raises(ValueError, match="shape"):      # words of K = 200
        fused_hetero_gemm(x, sw.lut_words,
                          torch.zeros((7, 28), dtype=torch.int32), sw.scale,
                          4, 10, 7)
    with pytest.raises(ValueError, match="contiguous"):
        fused_hetero_gemm(x, sw.lut_words.transpose(1, 2).contiguous()
                          .transpose(1, 2), sw.dsp_words, sw.scale, 4, 10, 7)
    with pytest.raises(ValueError, match="contiguous"):
        bitserial_gemm(x, sw.lut_words.transpose(1, 2).contiguous()
                       .transpose(1, 2), sw.s_lut, 4, 10)
    with pytest.raises(ValueError, match="int32"):
        bitserial_gemm(x, sw.planes, sw.s_lut, 4, 10)
    with pytest.raises(ValueError, match="shape"):
        int4_gemm(x, sw.dsp_words, sw.s_dsp, 9)
    with pytest.raises(ValueError, match="shape"):      # words of K = 200
        int4_gemm(x, torch.zeros((7, 28), dtype=torch.int32), sw.s_dsp, 7)
    with pytest.raises(ValueError, match="int32"):
        int4_gemm(x, sw.packed, sw.s_dsp, 7)
    # every bit width 1-8 takes its own plane count and nothing else
    for bits in range(1, 9):
        swb = _prepared(bits=bits)
        assert swb.lut_words.shape == (bits, 10, 4)
        assert bitserial_gemm(x, swb.lut_words, swb.s_lut, bits,
                              10).shape == (5, 10)
        for wrong in (bits - 1, bits + 1):
            with pytest.raises(ValueError):
                bitserial_gemm(x, swb.lut_words, swb.s_lut, wrong, 10)
    with pytest.raises(ValueError, match="does not give"):
        fused_conv_gemm(torch.zeros((4, 4, 1), dtype=torch.int8),
                        sw.lut_words, sw.dsp_words, sw.scale, 4, 10, 7,
                        3, 1, 1, 5)
    with pytest.raises(ValueError, match="mode"):
        ops.split_matmul(x, sw, mode="kernel")


def test_cpu_tensors_launch_nothing():
    from repro_torch.kernels.build import LAUNCHES
    before = dict(LAUNCHES)
    sw = _prepared()
    x = torch.ones((5, 24), dtype=torch.int8)
    ops.split_matmul(x, sw)
    ops.lut_matmul(x, sw)
    ops.dsp_matmul(x, sw)
    assert dict(LAUNCHES) == before


# ---------------------------------------------------------------------------
# The fused kernels' tile and K-split chooser
# ---------------------------------------------------------------------------


def _dense_layer_shapes(network):
    """(name, m, k, n_lut, n_dsp) of every dense (not depthwise) layer of
    the full-width network, its classifier included."""
    from repro_torch.compiler import compile_network
    return [(lp.name, lp.dims.m, lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut)
            for lp in compile_network(network).layers if not lp.depthwise]


@pytest.mark.parametrize("network", ["resnet18", "mobilenet_v2"])
def test_split_plan_covers_k_and_fills_the_card(network):
    """Every layer's plan is a compiled tile and cluster size, its K
    slices cover K exactly with none empty, and its grid holds
    MIN_BLOCKS..MAX_BLOCKS blocks, unless no compiled tile and split can
    (then it is the closest)."""
    shapes = _dense_layer_shapes(network)
    assert shapes[-1][0] == "fc"
    for name, m, k, n_lut, n_dsp in shapes:
        plan = fhg.split_plan(m, k, n_lut, n_dsp)
        steps = -(-k // fhg.BK)
        assert (plan.bm, plan.bn) in fhg.TILES and plan.split in fhg.SPLITS
        assert plan.split <= steps, name
        assert plan.blocks == plan.split * fhg._blocks(m, n_lut, n_dsp,
                                                       plan.bm, plan.bn)
        slices = fhg.k_slices(k, plan.split)
        assert slices[0][0] == 0 and slices[-1][1] == k, name
        for (b0, e0), (b1, _) in zip(slices, slices[1:]):
            assert e0 == b1, name
        assert all(b < e and b % fhg.BK == 0 for b, e in slices), name
        if not fhg.MIN_BLOCKS <= plan.blocks <= fhg.MAX_BLOCKS:
            reachable = [s * fhg._blocks(m, n_lut, n_dsp, bm, bn)
                         for bm, bn in fhg.TILES for s in fhg.SPLITS
                         if s <= steps]
            assert not any(fhg.MIN_BLOCKS <= b <= fhg.MAX_BLOCKS
                           for b in reachable), (name, plan)


def test_split_plan_on_resnet18_extremes():
    """conv17 (M=49, K=4608) splits K eight ways over 64x32 tiles; the
    fc layer (M=1) takes 16-row tiles; conv1 (M=12544) needs no split."""
    assert fhg.split_plan(49, 4608, 432, 80) == (64, 32, 8, 136)
    assert fhg.split_plan(1, 512, 680, 320).bm == 16
    assert fhg.split_plan(12544, 147, 48, 16).split == 1
    assert fhg.k_slices(147, 2) == [(0, 64), (64, 147)]
    assert fhg.k_slices(4608, 8)[-1] == (4032, 4608)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(13, 72), (49, 4608)])
@pytest.mark.parametrize("bits,n_lut,n_dsp", SPLIT_CORNERS)
def test_dense_kernels_match_plain_on_card(cuda, bits, n_lut, n_dsp, m, k):
    """Ragged 13x72, and conv17's M=49, K=4608, which splits K over a
    cluster of eight blocks."""
    rng = np.random.default_rng(bits)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = _split_weights(rng, k, n_lut, n_dsp, bits)
    sw = ops.prepare_split(k, *[_t(a) for a in w[:2]], bits,
                           *[_t(a) for a in w[2:]], cuda)
    xc = x.to(cuda)
    if n_lut and n_dsp:
        args = (sw.lut_words, sw.dsp_words, sw.scale, bits, n_lut, n_dsp)
        assert torch.equal(fused_hetero_gemm(xc, *args),
                           fused_hetero_gemm_plain(xc, *args))
    if n_lut:
        args = (sw.lut_words, sw.s_lut, bits, n_lut)
        assert torch.equal(bitserial_gemm(xc, *args),
                           bitserial_gemm_plain(xc, *args))
    if n_dsp:
        args = (sw.dsp_words, sw.s_dsp, n_dsp)
        assert torch.equal(int4_gemm(xc, *args), int4_gemm_plain(xc, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 31), (13, 147), (49, 4608)])
@pytest.mark.parametrize("bits", range(1, 9))
def test_single_path_kernels_every_bits_on_card(cuda, bits, m, k):
    """Every LUT bit width, and an odd DSP column count, on the K-major
    words: a word boundary, the byte-gathered A of K = 147, conv17's
    split-K."""
    rng = np.random.default_rng(bits * 100 + m)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    w = _split_weights(rng, k, 37, 19, bits)
    sw = ops.prepare_split(k, *[_t(a) for a in w[:2]], bits,
                           *[_t(a) for a in w[2:]], cuda)
    xc = x.to(cuda)
    args = (sw.lut_words, sw.s_lut, bits, 37)
    assert torch.equal(bitserial_gemm(xc, *args),
                       bitserial_gemm_plain(xc, *args))
    args = (sw.dsp_words, sw.s_dsp, 19)
    assert torch.equal(int4_gemm(xc, *args), int4_gemm_plain(xc, *args))


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [3, 48, 64])
@pytest.mark.parametrize("kernel,stride,pad", CONV_GEOMS)
def test_conv_kernel_matches_plain_on_card(cuda, kernel, stride, pad, c_in):
    """C=3 takes the kernel's byte gather; C=48 and C=64 (C % 16 == 0)
    its 16-byte cp.async gather with zero fill at the padding."""
    in_hw, bits = 11, 5
    out_hw = (in_hw + 2 * pad - kernel) // stride + 1
    rng = np.random.default_rng(kernel)
    x = torch.from_numpy(rng.integers(-128, 128, (in_hw, in_hw, c_in))
                         .astype(np.int8)).to(cuda)
    w = _split_weights(rng, kernel * kernel * c_in, 16, 23, bits)
    sw = ops.prepare_split(kernel * kernel * c_in, *[_t(a) for a in w[:2]],
                           bits, *[_t(a) for a in w[2:]], cuda)
    args = (sw.lut_words, sw.dsp_words, sw.scale, bits, 16, 23, kernel,
            stride, pad, out_hw)
    assert torch.equal(fused_conv_gemm(x, *args),
                       fused_conv_gemm_plain(x, *args))
