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
    flash_attention
from repro_torch.kernels.flash_attention_bwd import ENTRY_POINTS, \
    bwd_prep_plain, entry_args, flash_attention_bwd, \
    flash_attention_bwd_plain

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
    dims = (b, sq, skv, hq, hkv, d)
    tail = (0.125, int(causal), off)
    assert args["flash_attention_bwd_dq"] == (
        *ptr(q, k, v, out, dout, lse, delta, dq), *dims,
        *st(q, k, v, out, dout), *tail)
    assert args["flash_attention_bwd_dkdv"] == (
        *ptr(q, k, v, dout, lse, delta, dk, dv), *dims,
        *st(q, k, v, dout), *tail)
    assert q.stride()[1] == (hq + 2 * hkv) * d != hq * d


@pytest.mark.parametrize("dims", [(64, 128), (128, 64), (192, 128),
                                  (256, 256)])
def test_wrapper_refuses_pairs_without_a_backward(dims):
    """A (key, value) pair outside BWD_HEAD_DIMS raises before any launch
    (the forward's ``kernel_route`` refuses it earlier still)."""
    assert dims not in BWD_HEAD_DIMS
    d, dv = dims
    q, k, _, _, _, lse = _operands(1, 64, 64, 4, 2, d)
    v = torch.empty(1, 64, 2, dv, dtype=q.dtype)
    out = torch.empty(1, 64, 4, dv, dtype=q.dtype)
    before = dict(build.LAUNCHES)
    with pytest.raises(NotImplementedError, match="not instantiated"):
        flash_attention_bwd(q, k, v, out, out, lse, 0.1, True, 0)
    assert dict(build.LAUNCHES) == before


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
    """chip_smoke.py's BWD_SHAPES are among the ones above, each with a
    pair the kernel has, and one D=128 GQA shape has causal tiles that
    cross the diagonal (Sq not a multiple of the 64-row tiles)."""
    smoke = _load("chip_smoke")
    shapes = [tuple(s[1:9]) for s in smoke.BWD_SHAPES]
    assert set(shapes) <= set(SHAPES)
    assert all((s.d, s.d) in BWD_HEAD_DIMS for s in smoke.BWD_SHAPES)
    assert [s.name for s in smoke.BWD_SHAPES if s.d == 128 and s.causal
            and s.hq > s.hkv and s.sq % 64]


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
                                     "empty", "no_pdl"])
def test_kernel_parts_bwd_variants_edit_the_source(variant):
    """Each statement a ``kernel_parts.py`` backward variant edits is in
    ``flash_attention_bwd.cu`` as many times as the edit says (the card's
    compiler is the first to see the variants, so this is checked here)."""
    parts = _load("kernel_parts")
    src = (ROOT / "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
           ).read_text()
    assert set(parts.BWD_VARIANTS) == {"full", "no_mma", "copies_only",
                                       "empty", "no_pdl"}
    for old, new, *n in parts.BWD_VARIANTS[variant]:
        assert src.count(old) == (n[0] if n else 1)
        src = src.replace(old, new)
    if variant == "no_mma":
        assert "wgmma.mma_async" not in src.replace("// wgmma", "")
    if variant == "empty":
        assert '"cp.async.bulk.tensor' not in src


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the backward "
                    "there at the training shapes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 130, 12, 2, 128, True, 0),
                                   (1, 200, 330, 8, 8, 64, True, 130),
                                   (2, 100, 70, 4, 4, 64, False, 0)])
def test_kernel_backward_matches_plain_on_card(cuda, shape):
    """Through the autograd Function: one launch of each entry point, the
    gradients within chip_smoke's tolerances of the plain version, and a
    second backward bitwise equal to the first."""
    smoke = _load("chip_smoke")
    b, sq, skv, hq, hkv, d, causal, off = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=gen, device=cuda,
                                 dtype=torch.bfloat16)
                     for s in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, d), (b, sq, hq, d)))

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
