"""The flash-attention backward's wrapper and its plain versions.

``flash_attention_bwd`` launches the two entry points of
``csrc/flash_attention_bwd.cu``, dq then dkdv, with the arguments
``entry_args`` lays out for the signatures in ``build.SOURCES``, and
refuses what the kernels do not take before any launch. Those are held
here; the kernel itself runs on the card only (the tests marked ``cuda``
skip here, ``chip_smoke.py`` runs the same checks at the training
shapes). The JAX parity of the plain backward is in
``test_torch_train.py``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, \
    f32_pair, flash_attention
from repro_torch.kernels.flash_attention_bwd import ENTRY_POINTS, \
    F32_ENTRY_POINTS, bwd_prep_plain, entry_args, entry_points, \
    flash_attention_bwd, flash_attention_bwd_plain

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    """A script at the repository root, imported by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (b, sq, skv, hq, hkv, d, causal, kv_offset): chip_smoke's BWD_SHAPES and
# others, GQA groups of 1 to 8 heads, ragged and offset
SHAPES = [
    (8, 256, 256, 16, 16, 64, False, 0),
    (8, 256, 256, 16, 16, 64, True, 0),
    (8, 200, 320, 16, 16, 64, False, 0),
    (2, 2048, 2048, 32, 8, 64, True, 0),
    (2, 1000, 1000, 32, 8, 64, True, 0),
    (2, 300, 1000, 8, 8, 64, True, 700),
    (2, 512, 512, 12, 2, 128, True, 0),
    (2, 1000, 1000, 32, 8, 128, True, 0),
    (1, 64, 64, 64, 4, 128, True, 0),
    (1, 4096, 4096, 32, 8, 64, True, 0),
    (1, 17, 33, 7, 7, 64, False, 0),
    (3, 129, 129, 56, 8, 128, True, 5),
    (8, 256, 256, 8, 8, 64, False, 0),
    (8, 256, 256, 8, 8, 64, True, 0),
    (8, 200, 320, 8, 8, 64, False, 0),
]
# (b, sq, skv, hq, hkv, d, dv, causal, kv_offset, dtype): chip_smoke's
# BWD_SHAPES at key sizes other than the value's or past 128 (MLA's and
# gemma-7b's training, each also with tiles across the diagonal, and MLA's
# with a dq block's second warpgroup past the last row) and its
# fp32 rows (F32_SHAPES with a backward: the smoke configs' pairs, GQA,
# ragged causal tiles, kv_offset > 0, non-causal)
PAIR_SHAPES = [
    (2, 1024, 1024, 128, 128, 192, 128, True, 0, "bf16"),
    (2, 1000, 1000, 16, 16, 192, 128, True, 0, "bf16"),
    (2, 130, 130, 4, 4, 192, 128, True, 0, "bf16"),
    (1, 8448, 8448, 16, 16, 256, 256, True, 0, "bf16"),
    (2, 1000, 1000, 16, 16, 256, 256, True, 0, "bf16"),
    (8, 128, 128, 4, 2, 12, 12, False, 0, "fp32"),
    (8, 128, 128, 4, 2, 12, 12, True, 0, "fp32"),
    (8, 128, 128, 4, 4, 24, 16, True, 0, "fp32"),
    (2, 100, 100, 4, 4, 24, 16, True, 0, "fp32"),
    (8, 64, 64, 4, 4, 32, 32, True, 0, "fp32"),
    (8, 64, 64, 7, 1, 8, 8, True, 0, "fp32"),
    (2, 130, 200, 4, 1, 32, 32, True, 70, "fp32"),
    (1, 8448, 8448, 4, 2, 16, 16, True, 0, "fp32"),
]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _operands(b, sq, skv, hq, hkv, d, dtype=torch.bfloat16):
    """q, k, v, out, dout as the training path gives them: q, k and v
    views into one projection's output (so their strides are not their
    shapes'), out and dout contiguous; lse and delta fp32 [B, Hq, Sq]."""
    qkv = torch.empty(b, max(sq, skv), hq + 2 * hkv, d, dtype=dtype)
    q = qkv[:, :sq, :hq]
    k = qkv[:, :skv, hq:hq + hkv]
    v = qkv[:, :skv, hq + hkv:]
    out, dout = (torch.empty(b, sq, hq, d, dtype=dtype) for _ in range(2))
    lse = torch.empty(b, hq, sq)
    return q, k, v, out, dout, lse


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_entry_args_place_every_operand(shape):
    """Each entry point gets its signature's arguments (the stream comes
    last): its tensors' pointers in order, the shape, each operand's
    (batch, sequence, head) strides and scale, causal, kv_offset; dq
    reads out and dout for delta, dkdv reads the delta dq wrote."""
    b, sq, skv, hq, hkv, d, causal, off = shape
    q, k, v, out, dout, lse = _operands(b, sq, skv, hq, hkv, d)
    delta = torch.empty_like(lse)
    dq = torch.empty_like(out)
    dk, dv = (torch.empty(b, skv, hkv, d, dtype=q.dtype) for _ in range(2))
    args = entry_args(q, k, v, out, dout, lse, delta, dq, dk, dv, 0.125,
                      causal, off)
    assert tuple(args) == ENTRY_POINTS
    assert ENTRY_POINTS[0] == "flash_attention_bwd_dq"
    sig = build.SOURCES["flash_attention_bwd"]
    for name, a in args.items():
        assert len(a) == len(sig[name]) - 1
    ptr = lambda *ts: tuple(t.data_ptr() for t in ts)  # noqa: E731
    st = lambda *ts: tuple(x for t in ts for x in t.stride()[:3])  # noqa
    dims = (b, sq, skv, hq, hkv, d, d)
    tail = (0.125, int(causal), off)
    assert args["flash_attention_bwd_dq"] == (
        *ptr(q, k, v, out, dout, lse, delta, dq), *dims,
        *st(q, k, v, out, dout), *tail)
    assert args["flash_attention_bwd_dkdv"] == (
        *ptr(q, k, v, dout, lse, delta, dk, dv), *dims,
        *st(q, k, v, dout), *tail)
    assert q.stride()[1] == (hq + 2 * hkv) * d != hq * d


@pytest.mark.parametrize("dims", [(64, 128, "bf16"), (128, 64, "bf16"),
                                  (192, 192, "bf16"), (96, 96, "fp32")])
def test_wrapper_refuses_pairs_without_a_backward(dims):
    """A (key, value) pair outside BWD_HEAD_DIMS in bf16, or past the fp32
    kernel's 64, raises before any launch (the forward's ``kernel_route``
    refuses it earlier still)."""
    d, dv, name = dims
    dtype = DTYPES[name]
    assert (d, dv) not in BWD_HEAD_DIMS and not f32_pair(d, dv)
    q, k, _, _, _, lse = _operands(1, 64, 64, 4, 2, d, dtype)
    v = torch.empty(1, 64, 2, dv, dtype=q.dtype)
    out = torch.empty(1, 64, 4, dv, dtype=q.dtype)
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError, match="not instantiated"):
        flash_attention_bwd(q, k, v, out, out, lse, 0.1, True, 0)
    assert dict(build.LAUNCHES) == before


@pytest.mark.parametrize("shape", PAIR_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_entry_args_at_every_pair(shape):
    """The bf16 wide pairs and the fp32 kernel: each entry point of q's
    dtype gets its signature's arguments, with the value head size after
    the key's and v's, out's and dout's strides at DV."""
    b, sq, skv, hq, hkv, d, dv, causal, off, name = shape
    dtype = DTYPES[name]
    q, k, _, _, _, lse = _operands(b, sq, skv, hq, hkv, d, dtype)
    v = torch.empty(b, skv, hkv, dv, dtype=dtype)
    out, dout, dq = (torch.empty(b, sq, hq, n, dtype=dtype)
                     for n in (dv, dv, d))
    dk, dvv = (torch.empty(b, skv, hkv, n, dtype=dtype) for n in (d, dv))
    delta = torch.empty_like(lse)
    args = entry_args(q, k, v, out, dout, lse, delta, dq, dk, dvv, 0.125,
                      causal, off)
    names = entry_points(dtype)
    assert tuple(args) == names == (
        F32_ENTRY_POINTS if name == "fp32" else ENTRY_POINTS)
    source = build.SOURCE_OF[names[0]]
    assert source == ("flash_attention_f32" if name == "fp32"
                      else "flash_attention_bwd")
    for e, a in args.items():
        assert len(a) == len(build.SOURCES[source][e]) - 1
        assert a[8:15] == (b, sq, skv, hq, hkv, d, dv)
        assert a[-3:] == (0.125, int(causal), off)
    assert args[names[0]][24:27] == out.stride()[:3]
    assert args[names[1]][15:24] == (*q.stride()[:3], *k.stride()[:3],
                                     *v.stride()[:3])
    if name == "bf16":
        assert (d, dv) in BWD_HEAD_DIMS
    else:
        assert f32_pair(d, dv)


@pytest.mark.parametrize("bad", ["fp32_q", "bf16_lse", "odd_stride",
                                 "strided_d"])
def test_wrapper_refuses_operands_the_kernels_do_not_take(bad):
    """Other dtypes, strides that are not multiples of 8 elements and a
    head dimension that is not contiguous raise before any launch; the
    tensor maps need what the checks ask."""
    q, k, v, out, dout, lse = _operands(2, 64, 64, 4, 2, 64)
    if bad == "fp32_q":
        q = q.float()
    elif bad == "bf16_lse":
        lse = lse.to(torch.bfloat16)
    elif bad == "odd_stride":
        k = torch.empty(2, 64, 2, 68, dtype=q.dtype)[..., :64]
    else:
        v = torch.empty(2, 64, 2, 64, 2, dtype=q.dtype)[..., 0]
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, out, dout, lse, 0.1, True, 0)
    assert dict(build.LAUNCHES) == before


def test_smoke_shapes_are_held_here_and_one_crosses_the_diagonal():
    """chip_smoke.py's BWD_SHAPES and its fp32 rows with a backward are
    among the ones above, each with a pair its kernel has; one D=128 GQA
    shape, one MLA (192, 128) and one (256, 256) shape have causal tiles
    that cross the diagonal (Sq not a multiple of the 64-row tiles), and
    the fp32 rows hold every smoke pair, GQA, a ragged causal shape,
    kv_offset > 0 and a non-causal one."""
    smoke = _load("chip_smoke")
    bf16 = [(*s[1:7], s.v_dim, *s[7:9], "bf16") for s in smoke.BWD_SHAPES]
    assert {s[:6] + s[7:9] for s in bf16 if s[5] == s[6] <= 128} <= \
        set(SHAPES)
    assert {s for s in bf16 if not s[5] == s[6] <= 128} <= set(PAIR_SHAPES)
    assert all((s.d, s.v_dim) in BWD_HEAD_DIMS for s in smoke.BWD_SHAPES)
    crossing = {(s.d, s.v_dim) for s in smoke.BWD_SHAPES
                if s.causal and s.sq % 64}
    assert {(128, 128), (192, 128), (256, 256)} <= crossing
    assert [s.name for s in smoke.BWD_SHAPES if s.d == 128 and s.causal
            and s.hq > s.hkv and s.sq % 64]
    f32 = [s for s in smoke.F32_SHAPES if s.backward]
    assert {(*s[1:7], s.v_dim, *s[7:9], "fp32") for s in f32} <= \
        set(PAIR_SHAPES)
    assert all(f32_pair(s.d, s.v_dim) for s in smoke.F32_SHAPES)
    assert {(12, 12), (16, 16), (24, 16), (8, 8), (32, 32)} <= \
        {(s.d, s.v_dim) for s in f32}
    assert any(s.hq > s.hkv for s in f32)
    assert any(s.causal and s.sq % 32 and s.sq > 64 for s in f32)
    assert any(s.kv_offset > 0 for s in f32)
    assert any(not s.causal for s in f32)


def test_delta_plain_is_the_rowsum_in_fp32():
    """What the dq launch writes beside dq: rowsum(dout * out) over D,
    [B, Hq, Sq], from bf16 operands widened to fp32."""
    rng = np.random.default_rng(5)
    o, do = (rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
             for _ in range(2))
    ot, dt = (torch.from_numpy(a).to(torch.bfloat16) for a in (o, do))
    want = np.einsum("bshd,bshd->bhs", ot.float().numpy(),
                     dt.float().numpy())
    got = bwd_prep_plain(ot, dt)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["full", "no_mma", "copies_only",
                                     "empty", "no_pdl", "no_stagger"])
def test_kernel_parts_bwd_variants_edit_the_source(variant):
    """Each statement a ``kernel_parts.py`` backward variant edits is in
    ``flash_attention_bwd.cu`` as many times as the edit says (the card's
    compiler is the first to see the variants, so this is checked here),
    and the variants reach the wide pairs' instance: copies_only skips
    every tile function of both instances, no_pdl makes every dkdv launch
    an ordinary one, no_stagger takes out the wide dkdv's S_DONE barrier
    (WG-K's dp no longer waits for WG-V's s)."""
    parts = _load("kernel_parts")
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
           ).read_text()
    assert set(parts.BWD_VARIANTS) == {"full", "no_mma", "copies_only",
                                       "empty", "no_pdl", "no_stagger"}
    assert set(parts.WIDE_VARIANTS) <= set(parts.BWD_VARIANTS)
    for old, new, *n in parts.BWD_VARIANTS[variant]:
        assert src.count(old) == (n[0] if n else 1)
        src = src.replace(old, new)
    if variant == "no_mma":
        assert "wgmma.mma_async" not in src.replace("// wgmma", "")
    if variant in ("copies_only", "empty"):
        for call in ("dq_tile<D>(", "dkdv_tile<D>(", "dq_wide_tile<D, DV>(",
                     "dv_tile<D, DV>(", "dk_tile<D, DV>("):
            assert src.count(call) == src.count(f"if (false) {call}") > 0
    if variant == "no_stagger":
        assert "BAR_S_DONE, 2 * WG" not in src
    if variant == "empty":
        assert '"cp.async.bulk.tensor' not in src
    if variant == "no_pdl":
        assert "m, a, true);" not in src
        assert src.count("m, a, false);") == 8  # every launch, dq's too


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the backward "
                    "there at the training shapes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 130, 12, 2, 128, True, 0),
                                   (1, 200, 330, 8, 8, 64, True, 130),
                                   (2, 100, 70, 4, 4, 64, False, 0),
                                   (2, 130, 130, 4, 4, 192, True, 0, 128),
                                   (1, 200, 330, 4, 2, 256, True, 130,
                                    256)])
def test_kernel_backward_matches_plain_on_card(cuda, shape):
    """Through the autograd Function: one launch of each entry point, the
    gradients within chip_smoke's tolerances of the plain version, and a
    second backward bitwise equal to the first; at the plan's pairs and
    at the wide instance's (192, 128) and (256, 256), with GQA, causal
    tiles across the diagonal and kv_offset > 0 among them."""
    smoke = _load("chip_smoke")
    b, sq, skv, hq, hkv, d, causal, off, *dv = shape
    dv = dv[0] if dv else d
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=gen, device=cuda,
                                 dtype=torch.bfloat16)
                     for s in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, dv), (b, sq, hq, dv)))

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(build.LAUNCHES)
        out = flash_attention(*leaves, causal=causal, kv_offset=off)
        got = torch.autograd.grad(out, leaves, dout)
        for e in ENTRY_POINTS:
            assert build.LAUNCHES[e] == before.get(e, 0) + 1
        return got
    got, again = grads(), grads()
    want = flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                     kv_offset=off)
    for g, h, w in zip(got, again, want):
        assert torch.equal(g, h)
        err = float((g.float() - w.float()).abs().max())
        assert err <= smoke.BWD_TOL * float(w.float().abs().max())
        assert smoke.bwd_row_err(g, w) <= smoke.BWD_ROW_TOL
