"""The fused split-GEMM kernels' launch plan and register arithmetic.

``fused_hetero_gemm.fused_plan`` picks each launch's token tile (wgmma's
N), the warpgroups' arrangement, the K split and the ring's depth from
the shape alone; these tests hold it, at every shape the port sends, to
what ``csrc/fused_split_gemm.cu`` takes: K covered once, shared memory
within the card's, a legal ``.s8`` wgmma N, the block count the grid
launches. The kernel builds its A fragments in registers from the
K-major words; numpy mirrors of that arithmetic (the LUT planes folded
byte-wise into the int8 codes, the DSP nibbles sign-extended) are held
to the codes here, since the kernel itself runs only on a card.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.compiler import compile_network
from repro_torch.compiler.networks import decode_step_layers
from repro_torch.kernels import fused_hetero_gemm as fhg

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fused_split_gemm.cu"

# llama3.2-1b's decode layers at batch 8: (K, N)
DECODE_KN = {(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)}
# the co-design loop's HeteroLinear shapes (chip_smoke.HETERO): (M, K,
# n_lut, n_dsp) at ratio 0.4, 0.5 and the solved 0.1992
HETERO_SHAPES = [(16, 256, 77, 115), (4096, 2048, 4096, 4096),
                 (4096, 2048, 1632, 6560)]
# the widths the PTX ISA allows for wgmma .m64nNk32 with .s8 operands
WGMMA_S8_N = (8, 16, 24, 32, *range(48, 257, 16))


def _dense(layers):
    return [(lp.name, lp.dims.m, lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut,
             lp.bits_w_lut) for lp in layers if not lp.depthwise]


def _network_shapes():
    """(where, M, K, n_lut, n_dsp, bits) of every fused launch the port
    sends: resnet18's 21 layers and mobilenet_v2's dense ones (conv1 and
    fc included), the 2- and 3-shard widths of chip_smoke.CNN_BUNDLES'
    filter bundles, llama3.2-1b's decode layers at M = 8 at a few
    splits, and the HeteroLinear shapes."""
    out = []
    for net in ("resnet18", "mobilenet_v2"):
        out += [(net, *row[1:]) for row in _dense(compile_network(net).layers)]
    for net, n_dev in (("resnet18", 2), ("resnet18", 3), ("mobilenet_v2", 2)):
        bundle = compile_network(net, devices=n_dev, partition="filter")
        for d, dev in enumerate(bundle.devices):
            out += [(f"{net} x{n_dev} dev{d}", *row[1:])
                    for row in _dense(dev.layers)]
    layers, _ = decode_step_layers("llama3.2-1b", batch=8, smoke=False)
    for lp in layers:
        n = lp.dims.n
        for n_lut in (0, n // 2 + 1, n):
            out.append((f"llama3.2-1b {lp.name}", lp.dims.m, lp.dims.k,
                        n_lut, n - n_lut, 4))
    out += [("hetero", m, k, a, b, 4) for m, k, a, b in HETERO_SHAPES]
    return out


@pytest.fixture(scope="module")
def shapes():
    return _network_shapes()


def test_the_shapes_are_the_ports(shapes):
    """The list holds resnet18's 21 layers (conv1's C = 3 and fc's
    M = 1 among them), the shard widths that are not multiples of 4,
    and llama3.2-1b's decode layers as _lm_layers gives them."""
    res = [s for s in shapes if s[0] == "resnet18"]
    assert len(res) == 21
    assert (12544, 147) in {(m, k) for _, m, k, *_ in res}
    assert any(m == 1 for _, m, *_ in res)
    mob = [s for s in shapes if s[0] == "mobilenet_v2"]
    assert any(k == 27 for _, _, k, *_ in mob)      # the stem, C = 3
    widths = {a + b for where, _, _, a, b, _ in shapes if " x3 " in where}
    assert {21, 22, 171} <= widths
    dec = {(k, a + b) for where, m, k, a, b, _ in shapes
           if where.startswith("llama")}
    assert DECODE_KN < dec
    layers, _ = decode_step_layers("llama3.2-1b", batch=8, smoke=False)
    head = layers[-1]
    assert head.name == "lm_head" and (head.dims.k, head.dims.n) in dec
    assert {lp.dims.m for lp in layers} == {8}


def test_fused_plan_at_every_shape(shapes):
    """At each shape: K covered once by the split's slices, the token
    tile a compiled one and a legal .s8 wgmma N, the ring 2..8 stages
    and within the shared memory one block (two at t <= 16) may take,
    and the block count what the grid launches."""
    for where, m, k, n_lut, n_dsp, bits in shapes:
        plan = fhg.fused_plan(m, k, n_lut, n_dsp, bits)
        tag = (where, m, k, n_lut, n_dsp, plan)
        assert plan.t in fhg.TOKEN_TILES and plan.t in WGMMA_S8_N, tag
        assert plan.wc in (1, 2) and plan.split in fhg.SPLITS, tag
        steps = -(-k // fhg.FUSED_BK)
        assert plan.split <= steps, tag
        slices = fhg.k_slices(k, plan.split, fhg.FUSED_BK)
        assert slices[0][0] == 0 and slices[-1][1] == k, tag
        assert all(e == b for (_, e), (b, _) in zip(slices, slices[1:]))
        assert all(b < e and b % fhg.FUSED_BK == 0 for b, e in slices), tag
        assert 2 <= plan.stages <= fhg.MAX_STAGES, tag
        assert plan.stages <= max(2, -(-steps // plan.split)), tag
        cap = fhg.SMEM_TWO if plan.t <= fhg.TWO_PER_SM else fhg.SMEM_ONE
        assert plan.smem <= cap <= 232448, tag
        assert plan.smem == fhg.fused_layout(plan.t, plan.wc, bits, n_lut,
                                             n_dsp, plan.stages)[1], tag
        cc, tt = 64 * plan.wc, plan.t * (2 // plan.wc)
        tiles = -(-n_lut // cc) + -(-n_dsp // cc)
        assert plan.blocks == plan.split * tiles * -(-m // tt), tag
        assert plan == fhg.fused_plan(m, k, n_lut, n_dsp, bits)


def test_fused_plan_regimes():
    """Decode's 8 tokens fill N = 8 exactly; the co-design loop's
    M = 4096 takes the widest tile without a K split; conv17's M = 49
    splits its 36 K steps over a cluster of 8; every candidate the
    chooser weighs is one the kernel compiles."""
    assert fhg.fused_plan(8, 2048, 1024, 1024).t == 8
    assert fhg.fused_plan(1, 512, 680, 320).t == 8
    big = fhg.fused_plan(4096, 2048, 4096, 4096)
    assert (big.t, big.wc, big.split) == (256, 2, 1)
    assert fhg.fused_plan(49, 4608, 432, 80).split == 8
    for m, k in ((1, 31), (8, 8192), (49, 4608), (12544, 147), (4096, 2048)):
        cands = fhg.fused_candidates(m, k)
        assert cands and all(t in fhg.TOKEN_TILES and split in fhg.SPLITS
                             for t, _, split in cands)


def test_source_constants_match_the_plan():
    """The layout fused_layout computes is the source's layout_of: the
    same step, warpgroup columns, word strides, ring depth and limits."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("BK") == fhg.FUSED_BK
    assert const("WCOLS") == fhg.WG_COLS
    assert const("NWG") == fhg.CONSUMERS
    assert const("LUT_CB") == 16 and const("DSP_LD") == 80
    assert const("MAX_STAGES") == fhg.MAX_STAGES
    assert const("MAX_SMEM") == fhg.SMEM_ONE
    assert f"T <= {fhg.TWO_PER_SM} ? 2 : 1" in text
    for t in (64, 128, 256):
        assert f"struct Wgmma<{t}>" in text
        assert f"m64n{t}k32.s32.s8.s8" in text
    for t in fhg.TOKEN_TILES:
        assert f"case {t}: return launch_tile<{t}, CONV>" in text


# ---------------------------------------------------------------------------
# The kernel's fragment arithmetic, mirrored in numpy
# ---------------------------------------------------------------------------


def _vadd4(a, b):
    """__vadd4: four byte-wise adds mod 256, no carry between bytes."""
    a, b = np.uint32(a), np.uint32(b)
    out = np.uint32(0)
    for i in range(4):
        s = ((a >> np.uint32(8 * i)) + (b >> np.uint32(8 * i))) & 0xFF
        out |= np.uint32(s) << np.uint32(8 * i)
    return out


def _spread_bits(w):
    """The kernel's spread_bits: a nibble to four 0/1 bytes."""
    return np.uint32((np.uint64(w & 0xF) * 0x00204081) & 0x01010101)


def _bytes_as_int8(word):
    return np.frombuffer(np.uint32(word).tobytes(), dtype=np.int8)


def _lut_words(codes, bits):
    """The planes' K-major words of 32 codes: word b holds bit b of code
    k at bit k (ref.pack_bits_kmajor's layout for one word)."""
    u = codes.astype(np.int64) & ((1 << bits) - 1)
    return [int(sum(((int(u[k]) >> b) & 1) << k for k in range(32)))
            for b in range(bits)]


@pytest.mark.parametrize("bits", range(1, 9))
def test_plane_fold_is_the_int8_code(bits):
    """Per lane quad q, the kernel adds each plane's spread nibble times
    its weight (2^b, the MSB's 256 - 2^(bits-1) as a byte) into one
    register: byte-wise (__vadd4) that is the int8 codes 4q..4q+3 (and
    16 + 4q..), and the 32-bit add the kernel does equals __vadd4 (no
    byte carries), over random codes, every code -1 (all planes set) and
    every code -2^(bits-1) (the MSB plane alone)."""
    rng = np.random.default_rng(bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    patterns = [rng.integers(lo, hi, 32) for _ in range(64)]
    patterns += [np.full(32, -1), np.full(32, lo), np.full(32, hi - 1),
                 np.zeros(32, dtype=np.int64)]
    scales = [1 << b for b in range(bits - 1)] + [256 - (1 << (bits - 1))]
    for codes in patterns:
        words = _lut_words(codes, bits)
        for q in range(4):
            for shift, k0 in ((4 * q, 4 * q), (16 + 4 * q, 16 + 4 * q)):
                byte_sum, plain_sum = np.uint32(0), 0
                for w, sc in zip(words, scales):
                    term = np.uint32((int(_spread_bits(w >> shift)) * sc)
                                     & 0xFFFFFFFF)
                    byte_sum = _vadd4(byte_sum, term)
                    plain_sum = (plain_sum + int(term)) & 0xFFFFFFFF
                assert plain_sum == int(byte_sum)
                assert np.array_equal(_bytes_as_int8(byte_sum),
                                      codes[k0:k0 + 4].astype(np.int8))


def _byte_perm(x, y, sel):
    src = np.frombuffer(np.array([x, y], dtype=np.uint32).tobytes(),
                        dtype=np.uint8)
    return int.from_bytes(bytes(src[(sel >> (4 * i)) & 7] for i in range(4)),
                          "little")


def test_int4_spread_is_the_int8_code():
    """The kernel's spread_int4: 16 bits of a DSP word (four codes, the
    low half for even q, the high for odd) to four sign-extended int8,
    over random words and the all -8, all 7 and all -1 patterns."""
    rng = np.random.default_rng(0)
    patterns = [rng.integers(-8, 8, 8) for _ in range(64)]
    patterns += [np.full(8, -8), np.full(8, 7), np.full(8, -1)]
    for codes in patterns:
        word = sum((int(c) & 0xF) << (4 * i) for i, c in enumerate(codes))
        for half, sel in ((0, 0x4140), (1, 0x4342)):
            t = _byte_perm(word, 0, sel)
            t = (t | (t << 4)) & 0x0F0F0F0F
            t = t | (((t & 0x08080808) * 0x1E) & 0xFFFFFFFF)
            assert np.array_equal(_bytes_as_int8(t),
                                  codes[4 * half:4 * half + 4]
                                  .astype(np.int8))


# ---------------------------------------------------------------------------
# kernel_parts.py's variants of the source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "no_mma", "copies_only",
                                     "empty", "plane_passes"])
def test_kernel_parts_fused_variants_edit_the_source(variant):
    """Each statement a ``kernel_parts.py`` fused variant edits is in
    ``fused_split_gemm.cu`` as many times as the edit says, and each
    variant reaches what it says: no_mma leaves no wgmma or mma.sync,
    copies_only no products (the consumers inactive), empty no copies
    either, plane_passes one tensor pass per LUT plane."""
    spec = importlib.util.spec_from_file_location("kernel_parts",
                                                  ROOT / "kernel_parts.py")
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = SOURCE.read_text()
    assert set(parts.VARIANTS) == {"full", "no_mma", "copies_only", "empty",
                                   "plane_passes"}
    for old, new, *n in parts.VARIANTS[variant]:
        assert src.count(old) == (n[0] if n else 1), (variant, old)
        assert old != new
        src = src.replace(old, new)
    if variant == "no_mma":
        assert '"wgmma.mma_async' not in src and '"mma.sync' not in src
    if variant in ("copies_only", "empty"):
        assert "  const bool active = false;\n" in src
    if variant == "empty":
        assert "blk.load_stage(" not in src
    if variant == "plane_passes":
        assert "(blk.lut ? p.bits : 1); ++b) products(cur, xs);" in src
