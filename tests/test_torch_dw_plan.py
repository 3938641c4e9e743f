"""The depthwise kernel's launch plan and its folded weights, on the CPU.

``csrc/depthwise_gemm.cu`` chooses, per launch, the channels a thread
owns (a vector of V, of one output pixel), the block and the grid; ``depthwise_gemm.depthwise_plan`` mirrors that
choice. Held here: every (pixel, channel) of the output is computed by
exactly one thread, a vector wider than one channel is taken only where
C and both pointers' alignment allow it, full-width mobilenet_v2's 17
layers each get a grid of at least one block an SM, and the plan's
constants are the source's. The kernel folds a LUT channel's planes
into its signed taps and sums K products on both sides
(``depthwise_gemm.folded_taps``); that sum is held bitwise to the plain
version's plane-by-plane sum. The kernel itself runs on the card only
(``chip_smoke.py`` phase 4, ``test_torch_depthwise.py``'s ``cuda``
tests).
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import depthwise_gemm as dw
from repro_torch.models.cnn import CNNConfig, reduced_config, specs_for

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/depthwise_gemm.cu"


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _layers(cfg) -> list[tuple]:
    """(in_hw, C, kernel, stride, pad, out_hw) of each depthwise layer."""
    out = []
    for s in specs_for(cfg):
        if s.depthwise:
            pad = s.kernel // 2
            out.append((s.in_hw, s.c_out, s.kernel, s.stride, pad,
                        (s.in_hw + 2 * pad - s.kernel) // s.stride + 1))
    return out


FULL = _layers(CNNConfig(arch="mobilenet_v2"))
REDUCED = _layers(reduced_config("mobilenet_v2"))
CORNERS = [(hw, c, ks, st, pad, (hw + 2 * pad - ks) // st + 1)
           for hw, c, ks, st, pad, *_ in SMOKE.DW_CORNERS + SMOKE.DW_NEW_CORNERS]
#: (form, geometry, x address, out address): every layer and corner in
#: both forms with aligned pointers, and a few with an input or output
#: off 16 bytes
CASES = ([(form, g, 0, 0) for g in FULL + REDUCED + CORNERS
          for form in ("spatial", "staged")] +
         [("spatial", FULL[0], 8, 0), ("spatial", FULL[1], 4, 0),
          ("staged", FULL[2], 0, 4), ("spatial", REDUCED[0], 1, 0)])


def _plan(form, geom, x_ptr=0, out_ptr=0):
    hw, c, ks, st, pad, out_hw = geom
    if form == "spatial":
        return dw.depthwise_plan(out_hw * out_hw, ks * ks, c, True, ks, st,
                                 out_hw, x_ptr, out_ptr)
    return dw.depthwise_plan(out_hw * out_hw, ks * ks, c, False,
                             x_ptr=x_ptr, out_ptr=out_ptr)


def _outputs(plan, m, n, spatial, out_hw):
    """Every (pixel, channel) each thread of ``plan`` writes, as the
    kernel maps block (bx, by, bz) and thread (x, y, z) to a channel
    vector and a run of pixels: an [outputs] array of m * n + c
    indices."""
    idx = np.meshgrid(*(np.arange(g) for g in plan.grid),
                      *(np.arange(b) for b in plan.block), indexing="ij")
    bx, by, bz, x, y, z = (a.ravel() for a in idx)
    tv, tw, th = plan.block
    v = bx * tv + x
    nv = n // plan.v
    if spatial:
        ow, oh = by * tw + y, bz * th + z
        live = (v < nv) & (ow < out_hw) & (oh < out_hw)
        pix, vv = (oh * out_hw + ow)[live], v[live]
    else:
        pix = by * tw + y
        live = (v < nv) & (pix < m)
        pix, vv = pix[live], v[live]
    chans = vv[:, None] * plan.v + np.arange(plan.v)[None, :]
    return (pix[:, None] * n + chans).ravel()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{c[2]}-{c[3]}")
def test_plan_covers_every_output_once(case):
    """Each (pixel, channel) is one thread's, exactly once: no output
    lost at a ragged channel or pixel tile, none written twice."""
    form, geom, x_ptr, out_ptr = case
    out_hw, n = geom[5], geom[1]
    plan = _plan(form, geom, x_ptr, out_ptr)
    got = _outputs(plan, out_hw * out_hw, n, form == "spatial", out_hw)
    counts = np.bincount(got, minlength=out_hw * out_hw * n)
    assert counts.shape == (out_hw * out_hw * n,) and (counts == 1).all()
    assert np.prod(plan.block) <= dw.DW_MAX_THREADS
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-"
                         f"{c[2]}-{c[3]}")
def test_vector_width_only_where_allowed(case):
    """V = 4 only where C is a multiple of 4, the input 4-byte and the
    output 16-byte aligned and the map has 4 pixels or more; V = 1 in the
    staged instance that reads K at run time; the shared weights fit the
    48 KB a block takes without opting in."""
    form, geom, x_ptr, out_ptr = case
    hw, c, ks, st, pad, out_hw = geom
    plan = _plan(form, geom, x_ptr, out_ptr)
    assert plan.v in (1, dw.DW_VEC)
    if plan.v > 1:
        assert c % plan.v == 0 and x_ptr % plan.v == 0 and out_ptr % 16 == 0
        assert plan.v <= out_hw * out_hw
    if plan.instance[1] == 0 and form == "staged":
        assert plan.v == 1
    assert plan.smem <= 48 * 1024


def test_full_width_layers_fill_the_card():
    """Every full-width layer's grid has a block an SM (132), in both
    forms, and 4 channels a thread everywhere."""
    for geom in FULL:
        for form in ("spatial", "staged"):
            plan = _plan(form, geom)
            assert np.prod(plan.grid) >= dw.DW_SLOTS, (form, geom)
    assert {_plan(form, g).v for g in FULL for form in ("spatial", "staged")} \
        == {dw.DW_VEC}


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    return eval(m.group(1))  # a product of integer literals


def test_plan_mirrors_the_source():
    """The plan's constants are the C source's."""
    assert (_constant("MAX_K"), _constant("MAX_KS"), _constant("VEC"),
            _constant("MAX_THREADS"), _constant("SLOTS"),
            _constant("TILE_PIX")) == (
        dw.MAX_TAPS, dw.DW_MAX_KSIZE, dw.DW_VEC, dw.DW_MAX_THREADS,
        dw.DW_SLOTS, dw.DW_TILE_PIX)


@pytest.mark.parametrize("bits", range(1, 9))
def test_folded_taps_equal_the_codes(bits):
    """A LUT channel's planes fold back to its codes, MSB plane negative,
    and the DSP channels' nibbles sign-extend to theirs, an odd count of
    them included."""
    rng = np.random.default_rng(bits)
    k, n_lut, n_dsp = 9, 7, 5
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    w_lut = torch.from_numpy(rng.integers(lo, hi, (k, n_lut)).astype(np.int32))
    w_dsp = torch.from_numpy(rng.integers(-8, 8, (k, n_dsp)).astype(np.int32))
    w_lut[0, 0], w_lut[1, 0] = lo, hi - 1
    sw = ops.prepare_split(k, w_lut, torch.ones(n_lut), bits, w_dsp,
                           torch.ones(n_dsp), torch.device("cpu"))
    got = dw.folded_taps(sw.planes, sw.packed, bits, n_lut, n_dsp)
    assert torch.equal(got, torch.cat([w_lut, w_dsp], dim=1))


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_folded_sum_is_the_plain_sum(bits):
    """One sum of K products over the folded taps, as the kernel takes
    it, then its one conversion and multiply: bitwise the plain
    version's plane-by-plane sums at the extremes (|x| = 128, the most
    negative tap, 32 taps)."""
    rng = np.random.default_rng(10 + bits)
    m, k, n_lut, n_dsp = 6, 32, 9, 4
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    w_lut = torch.from_numpy(rng.integers(lo, hi, (k, n_lut)).astype(np.int32))
    w_lut[:, 0] = lo
    w_dsp = torch.from_numpy(rng.integers(-8, 8, (k, n_dsp)).astype(np.int32))
    x = torch.from_numpy(rng.integers(-128, 128, (m, k, n_lut + n_dsp))
                         .astype(np.int8))
    x[0] = -128
    scale = torch.from_numpy(rng.uniform(0.5, 2, n_lut + n_dsp)
                             .astype(np.float32))
    sw = ops.prepare_split(k, w_lut, scale[:n_lut], bits, w_dsp,
                           scale[n_lut:], torch.device("cpu"))
    taps = dw.folded_taps(sw.planes, sw.packed, bits, n_lut, n_dsp)
    acc = (x.to(torch.int64) * taps[None].to(torch.int64)).sum(1)
    assert acc.abs().max() < 2 ** 31
    got = acc.to(torch.int32).to(torch.float32) * sw.scale[None, :]
    want = dw.grouped_gemm_plain(x, sw.planes, sw.packed, sw.scale, bits,
                                 n_lut, n_dsp)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(acc.to(torch.int32), ref.fused_hetero_grouped_gemm_ref(
        x, w_lut, torch.ones(n_lut), bits, w_dsp, torch.ones(n_dsp))
        .to(torch.int32))


@pytest.mark.parametrize("variant", ["full", "empty", "loads_only", "scalar",
                                     "no_decode", "no_x", "no_store",
                                     "no_reuse"])
def test_kernel_parts_depthwise_variants_edit_the_source(variant):
    """Each statement a ``kernel_parts.py --only depthwise`` variant edits
    is in ``depthwise_gemm.cu`` once, and each variant reaches what it
    says: empty returns before any load, loads_only has no __dp4a,
    scalar plans one channel a thread, no_decode folds no plane, no_x
    loads no input, no_store stores nothing, no_reuse loads the input
    past L1 (and only the input)."""
    spec = importlib.util.spec_from_file_location("kernel_parts",
                                                  ROOT / "kernel_parts.py")
    parts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parts)
    src = SOURCE.read_text()
    assert set(parts.DW_VARIANTS) == {"full", "empty", "loads_only",
                                      "scalar", "no_decode", "no_x",
                                      "no_store", "no_reuse"}
    for old, new, *n in parts.DW_VARIANTS[variant]:
        assert src.count(old) == (n[0] if n else 1)
        src = src.replace(old, new)
    body = src[src.index("depthwise_kernel(const Params p) {"):]
    if variant == "empty":
        assert body.index("  return;\n") < body.index("load_vec<V>(")
    if variant == "loads_only":
        assert "__dp4a(" not in src
    if variant == "scalar":
        assert "  pl.v = 1;\n" in src
    if variant == "no_decode":
        assert "tap4(p, k," not in src
        assert "wb[k * CB + q] = false ? (uint8_t)tap1(" in src
    if variant == "no_x":
        assert src.count("const bool ok = false && (KT") == 2
    if variant == "no_reuse":
        assert src.count("__ldcg(") == 2 and "__ldg(p)" not in src
        assert "__ldg(reinterpret_cast<const unsigned*>(q + b * plane))" \
            in src
    if variant == "no_store":
        assert "  if (acc[0] != 0x7654321) return;\n" in src


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm (default mode)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def _group_word(planes, packed, bits, k, tap, c, n_lut):
    """The kernel's tap4 before its transpose: tap ``tap`` of the 4
    channels c..c+3 as the bytes of one word, by the source's SIMD fold
    (a LUT group) or nibble spread (a DSP group)."""
    if c + 4 <= n_lut:
        msb, word = (0xFF << (bits - 1)) & 0xFF, 0
        for b in range(bits):
            off = (b * k + tap) * n_lut + c
            w = int.from_bytes(bytes(planes[off:off + 4]), "little")
            w &= 0x01010101
            word |= w * msb if b == bits - 1 else w << b
        return word
    row = packed[tap]
    j = c - n_lut
    x = _byte_perm(int(row[j // 2]), int(row[j // 2 + 1]), 0x4400)
    y = (x & 0x000F000F) | ((x >> 4) & 0x0F000F00)
    return (y | (y & 0x08080808) * 0x1E) & 0xFFFFFFFF


@pytest.mark.parametrize("bits", range(1, 9))
def test_simd_decode_is_the_fold(bits):
    """The kernel's 4-channel decode of a tap (``tap4``: one 32-bit load
    of a plane row's 4 bytes a bit, the planes ORed shifted, the MSB
    plane times its byte's two's-complement weight; two packed bytes
    spread into 4 sign-extended nibbles), mirrored bit for bit, gives the
    folded taps of every LUT and DSP group, the extremes included."""
    rng = np.random.default_rng(20 + bits)
    k, n_lut, n_dsp = 9, 8, 12
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
    w_lut = rng.integers(lo, hi, (k, n_lut)).astype(np.int32)
    w_lut[0, :2] = lo, hi - 1
    w_dsp = rng.integers(-8, 8, (k, n_dsp)).astype(np.int32)
    w_dsp[0, :2] = -8, 7
    sw = ops.prepare_split(k, torch.from_numpy(w_lut), torch.ones(n_lut),
                           bits, torch.from_numpy(w_dsp), torch.ones(n_dsp),
                           torch.device("cpu"))
    planes = sw.planes.numpy().astype(np.uint8).reshape(-1)
    packed = sw.packed.numpy().astype(np.uint8)
    want = np.concatenate([w_lut, w_dsp], axis=1)
    for tap in range(k):
        for c in range(0, n_lut + n_dsp, 4):
            word = _group_word(planes, packed, bits, k, tap, c, n_lut)
            got = np.frombuffer(word.to_bytes(4, "little"), dtype=np.int8)
            assert list(got) == list(want[tap, c:c + 4]), (tap, c)
    src = SOURCE.read_text()
    assert "__byte_perm(__ldg(r), __ldg(r + 1), 0x4400)" in src
    assert "return y | (y & 0x08080808u) * 0x1Eu;" in src
    assert "w |= b == p.bits - 1 ? pl * msb : pl << b;" in src
