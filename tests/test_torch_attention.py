"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs go through the reference's Pallas flash kernel
(interpret mode), its softmax oracle and its three attention forms
(``blockwise_attention``, ``dense_attention``, ``decode_attention``),
and through the port's counterparts. On CPU tensors the port's flash
wrapper computes its plain version, so these tests hold that plain
version, and the wrappers around it, to the reference.

Tolerance: 3e-5 absolute and relative in fp32, the one
``tests/test_kernels.py`` holds the Pallas kernel to against its
oracle. Both sides compute the same fp32 online softmax; they differ
only in summation order and in the chunk at which each running max is
taken. The CUDA kernel itself runs only on a card (marker ``cuda``);
``chip_smoke.py`` holds it to its plain version there in bf16. Its
launch plan (``flash_plan``: form, grid, shared memory) and the
arguments the wrapper passes are checked here on the CPU.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as jlayers
from jax.scipy.special import logsumexp
from repro_torch.kernels import ops, ref
from repro_torch.kernels import build
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention import KERNEL_HEAD_DIMS, \
    flash_attention, flash_attention_plain, flash_plan, kernel_args, \
    wide_prefill, wide_stages
from repro_torch.kernels.flash_attention import stages as flash_stages
from repro_torch.models import layers

TOL = dict(rtol=3e-5, atol=3e-5)
ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    """A script at the repository root, imported by path."""
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(seed, b, hq, hkv, sq, skv, d, dv=None):
    """q [B, Hq, Sq, D], k [B, Hkv, Skv, D], v [B, Hkv, Skv, DV] (DV = D
    unless given) fp32 numpy."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, hq, sq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, hkv, skv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dv or d)).astype(np.float32)
    return q, k, v


def _bshd(a):
    """numpy [B, H, S, D] -> torch [B, S, H, D] (contiguous)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# The kernel's plain version and ops.attention vs the Pallas kernel
# ---------------------------------------------------------------------------


# (b, h, s, d) of tests/test_kernels.py's sweep, plus a ragged s
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 32), (2, 3, 192, 64),
                                     (2, 2, 100, 16)])
def test_plain_matches_pallas_and_oracle(b, h, s, d, causal):
    q, k, v = _qkv(s + d, b, h, h, s, s, d)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    got = flash_attention_plain(_bshd(q), _bshd(k), _bshd(v), causal=causal,
                                q_chunk=64, kv_chunk=64)
    _close(got.permute(0, 2, 1, 3), want)
    if s % 64 == 0:
        pallas = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, bq=64, bkv=64, interpret=True)
        _close(got.permute(0, 2, 1, 3), pallas)
    # the port's oracle and the ops wrapper agree with the reference too
    _close(ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal), want)
    _close(ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal), want)


def test_plain_matches_pallas_decode_offset():
    b, h, s, d = 2, 2, 128, 32
    q, k, v = _qkv(5, b, h, h, 1, s, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, kv_offset=s - 1, bq=1, bkv=64, interpret=True)
    got = flash_attention_plain(_bshd(q), _bshd(k), _bshd(v), causal=True,
                                kv_offset=s - 1, kv_chunk=64)
    _close(got.permute(0, 2, 1, 3), want)
    _close(ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), kv_offset=s - 1), want)


# (b, sq, skv, hq, hkv, d, dv, causal, kv_offset, kv dtype): the smoke
# configs' pairs as the fp32 kernel takes them (seamless's 12 at GQA 4/2,
# the LMs' 16, MLA's 24 over 16, gemma's 32, yi's 8 at 7/1), ragged,
# offset, and seamless's decode step: fp32 queries over its bf16 cross
# cache
SMOKE_PAIRS = [
    (2, 40, 40, 4, 2, 12, 12, False, 0, "fp32"),
    (2, 37, 37, 4, 2, 16, 16, True, 0, "fp32"),
    (2, 24, 24, 4, 4, 24, 16, True, 0, "fp32"),
    (1, 9, 50, 4, 4, 32, 32, True, 41, "fp32"),
    (2, 33, 33, 7, 1, 8, 8, True, 0, "fp32"),
    (2, 1, 30, 4, 2, 12, 12, False, 0, "bf16"),
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,off,kv", SMOKE_PAIRS)
def test_plain_fp32_matches_jax_at_smoke_pairs(b, sq, skv, hq, hkv, d, dv,
                                               causal, off, kv):
    """What the fp32 kernel computes, in its plain version, against the
    reference's ``blockwise_attention`` on the same fp32 inputs (numpy,
    seeded), at chunks that split the keys; over a bf16 cache both round
    p and the output to bf16, which flips an occasional last bit."""
    rng = np.random.default_rng(d + sq)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    jkv = jnp.bfloat16 if kv == "bf16" else jnp.float32
    tkv = torch.bfloat16 if kv == "bf16" else torch.float32
    want = jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k).astype(jkv), jnp.asarray(v).astype(jkv),
        causal=causal, kv_offset=off, q_chunk=16, kv_chunk=16)
    got = flash_attention_plain(torch.from_numpy(q),
                                torch.from_numpy(k).to(tkv),
                                torch.from_numpy(v).to(tkv), causal=causal,
                                kv_offset=off, q_chunk=16, kv_chunk=16)
    assert got.dtype == tkv and got.shape == (b, sq, hq, dv)
    want = np.asarray(want.astype(jnp.float32))
    tol = 2 * 2 ** -8 * np.abs(v).max() if kv == "bf16" else \
        1e-5 * np.abs(v).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("mode", ["auto", "ref"])
@pytest.mark.parametrize("s", [96, 75])
def test_attention_wrapper_gqa(s, mode):
    b, hq, hkv, d = 2, 8, 2, 32
    q, k, v = _qkv(s, b, hq, hkv, s, s, d)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=True, mode=mode)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True)
    _close(got, want)
    # the kernel maps query head h to KV head h // rep: the same as the
    # reference's repeat, with no repeat
    kr = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    vr = jnp.repeat(jnp.asarray(v), hq // hkv, axis=1)
    _close(got, jref.flash_attention_ref(jnp.asarray(q), kr, vr))


def test_wrapper_on_cpu_launches_nothing_and_checks():
    q, k, v = (_bshd(a) for a in _qkv(0, 1, 4, 2, 16, 16, 16))
    before = dict(LAUNCHES)
    flash_attention(q, k, v)
    flash_attention(q, k, v, mode="ref")
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="mode"):
        flash_attention(q, k, v, mode="pallas")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="kv_offset"):
        flash_attention(q, k, v, kv_offset=-1)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q, k.double(), v)


# ---------------------------------------------------------------------------
# models/layers.py attention forms vs the reference's
# ---------------------------------------------------------------------------


# (sq, skv, q_chunk, kv_chunk, kv_offset, causal)
BLOCKWISE = [
    (64, 64, 512, 1024, 0, True),       # the serving prefill: one chunk
    (96, 96, 32, 48, 0, True),          # chunks smaller than S
    (70, 70, 32, 16, 0, True),          # ragged against both chunks
    (24, 88, 16, 32, 64, True),         # queries at the end of the keys
    (1, 80, 8, 32, 79, True),           # the decode form
    (50, 50, 16, 32, 0, False),
]


@pytest.mark.parametrize("sq,skv,qc,kc,off,causal", BLOCKWISE)
def test_blockwise_attention_matches_reference(sq, skv, qc, kc, off, causal):
    q, k, v = _qkv(sq + skv, 2, 4, 2, sq, skv, 16)
    want = jlayers.blockwise_attention(
        jnp.asarray(q.transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), causal=causal, q_chunk=qc,
        kv_chunk=kc, kv_offset=off)
    got = layers.blockwise_attention(_bshd(q), _bshd(k), _bshd(v),
                                     causal=causal, q_chunk=qc, kv_chunk=kc,
                                     kv_offset=off)
    _close(got, want)
    # ... and the wrapper through [B, H, S, D] strided views
    got_t = flash_attention(torch.from_numpy(q).transpose(1, 2),
                            torch.from_numpy(k).transpose(1, 2),
                            torch.from_numpy(v).transpose(1, 2),
                            causal=causal, q_chunk=qc, kv_chunk=kc,
                            kv_offset=off)
    _close(got_t, want)


@pytest.mark.parametrize("sq,skv,off,causal", [(40, 40, 0, True),
                                               (12, 40, 28, True),
                                               (33, 33, 0, False)])
def test_dense_attention_matches_reference(sq, skv, off, causal):
    q, k, v = _qkv(sq, 2, 4, 2, sq, skv, 16)
    args = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    want = jlayers.dense_attention(*map(jnp.asarray, args), causal=causal,
                                   kv_offset=off)
    got = layers.dense_attention(*map(_bshd, (q, k, v)), causal=causal,
                                 kv_offset=off)
    _close(got, want)


@pytest.mark.parametrize("kv_len", [1, 17, 48])
def test_decode_attention_matches_reference(kv_len):
    q, k, v = _qkv(kv_len, 3, 8, 2, 1, 48, 16)
    args = [a.transpose(0, 2, 1, 3) for a in (q, k, v)]
    want = jlayers.decode_attention(*map(jnp.asarray, args), kv_len=kv_len)
    got = layers.decode_attention(*map(_bshd, (q, k, v)), kv_len=kv_len)
    _close(got, want)


@pytest.mark.parametrize("s_new,idx", [(20, 0), (8, 0), (1, 5)])
def test_cache_write_matches_reference(s_new, idx):
    rng = np.random.default_rng(s_new)
    cache = rng.standard_normal((2, 20, 3, 4)).astype(np.float32)
    if s_new > 1:
        cache[:] = 0.0          # prefill writes into an empty cache
    new = rng.standard_normal((2, s_new, 3, 4)).astype(np.float32)
    want = jlayers.cache_write(jnp.asarray(cache), jnp.asarray(new), idx)
    got = torch.from_numpy(cache.copy())
    out = layers.cache_write(got, torch.from_numpy(new), idx)
    assert out is got           # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (b, sq, skv, hq, hkv, d, dv, kv_offset): both wide pairs over 150
# queries (past one 128-row tile of the wgmma instance) at offset 50 into
# 200 keys (tiles across the causal diagonal), with GQA at (256, 256)
WIDE_PLAIN = [(1, 150, 200, 2, 1, 256, 256, 50),
              (1, 150, 200, 2, 2, 192, 128, 50)]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,off", WIDE_PLAIN)
def test_plain_with_lse_matches_jax_at_wide_pairs(b, sq, skv, hq, hkv, d,
                                                  dv, off):
    """What the wide pairs' kernels compute, in the plain version with
    its log-sum-exp, against the reference: the output against
    ``blockwise_attention`` and the lse against ``logsumexp`` of the
    reference's masked fp32 scores, on the same numpy inputs, in fp32
    (tolerance 3e-5, as above), the queries split into 64-row chunks as
    the kernel's warpgroups split them and the keys into 64-key tiles."""
    rng = np.random.default_rng(sq + d)
    q = (rng.standard_normal((b, sq, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    scale = d ** -0.5
    want = jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=64, kv_chunk=64, kv_offset=off, softmax_scale=scale)
    kr = jnp.repeat(jnp.asarray(k), hq // hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), kr) * scale
    masked = jnp.arange(skv)[None, :] > jnp.arange(sq)[:, None] + off
    want_lse = logsumexp(jnp.where(masked, -1e30, s), axis=-1)
    got, lse = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_offset=off, scale=scale, q_chunk=64, kv_chunk=64,
        return_lse=True)
    assert got.shape == (b, sq, hq, dv) and lse.shape == (b, hq, sq)
    _close(got, want)
    _close(lse, want_lse)


# ---------------------------------------------------------------------------
# The kernel's launch plan
# ---------------------------------------------------------------------------


# (Sq, Hq, Hkv) -> form: decode when Sq * Hq / Hkv fills at most 16 rows
@pytest.mark.parametrize("sq,hq,hkv,form", [
    (1, 32, 8, "decode"), (4, 32, 8, "decode"), (5, 32, 8, "prefill"),
    (16, 4, 4, "decode"), (17, 4, 4, "prefill"), (1, 16, 1, "decode"),
    (2, 16, 1, "prefill"), (1, 32, 1, "prefill"), (64, 32, 8, "prefill"),
])
def test_flash_plan_picks_the_form(sq, hq, hkv, form):
    plan = flash_plan(3, sq, 100, hq, hkv, 64)
    assert plan.form == form
    if form == "decode":
        assert plan.grid == (hkv, 3, 1)
    else:
        assert plan.grid == (hq, 3, -(-sq // 64))


# chip_smoke.py's flash shapes: (name, form, grid); the wide pairs'
# prefill form (but (192, 128) over at most 64 queries) on the wgmma
# instance's one-dimensional grid of ceil(Sq / 128) * Hq * B blocks
CHIP_PLANS = [
    ("prefill", "prefill", (32, 8, 1)),
    ("s2048", "prefill", (32, 1, 32)),
    ("ragged", "prefill", (32, 2, 16)),
    ("noncausal", "prefill", (32, 2, 6)),
    ("offset", "prefill", (32, 8, 1)),
    ("decode", "decode", (8, 8, 1)),
    ("d128_mha", "prefill", (16, 2, 8)),
    ("decode4", "decode", (8, 8, 1)),
    ("d256_prefill", "prefill", (128, 1, 1)),
    ("d256_ragged", "prefill", (256, 1, 1)),
    ("d256_decode4", "decode", (16, 8, 1)),
    ("gqa7", "prefill", (56, 8, 1)),
    ("qwen3_prefill", "prefill", (32, 8, 1)),
    ("moe_prefill", "prefill", (64, 8, 1)),
    ("mla_prefill", "prefill", (128, 8, 1)),
    ("mla_ragged", "prefill", (256, 1, 1)),
    ("mla_decode4", "decode", (4, 8, 1)),
    ("d256_offset", "prefill", (96, 1, 1)),
    ("mla_offset", "prefill", (96, 1, 1)),
    ("cross_prefill", "prefill", (16, 8, 1)),
    ("cross_decode", "decode", (16, 8, 1)),
    ("tp_prefill", "prefill", (16, 8, 1)),
    ("tp_seamless_enc", "prefill", (8, 8, 4)),
    ("tp_seamless_dec", "prefill", (8, 8, 4)),
    ("tp_cross", "prefill", (8, 8, 4)),
]


def _chip_shapes() -> dict:
    """``chip_smoke.FLASH_SHAPES`` by name."""
    return {row.name: row for row in _load("chip_smoke").FLASH_SHAPES}


@pytest.mark.parametrize("name,form,grid", CHIP_PLANS)
def test_flash_plan_at_chip_shapes(name, form, grid):
    shapes = _chip_shapes()
    assert list(shapes) == [row[0] for row in CHIP_PLANS]
    row = shapes[name]
    plan = flash_plan(row.b, row.sq, row.skv, row.hq, row.hkv, row.d,
                      row.v_dim)
    assert (plan.form, plan.grid) == (form, grid)
    assert (row.d, row.v_dim) in KERNEL_HEAD_DIMS
    wide = form == "prefill" and wide_prefill(row.sq, row.d, row.v_dim)
    assert plan.threads == (384 if wide else 128)
    if wide:
        assert grid[0] == -(-row.sq // 128) * row.hq * row.b


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("sq,hq,hkv", [(1, 32, 8), (4, 32, 8), (64, 32, 8),
                                       (2048, 32, 32)])
def test_flash_plan_shared_memory_fits(sq, hq, hkv, d):
    plan = flash_plan(2, sq, 4096, hq, hkv, d)
    # the decode form's 4 stages at D=256 would take 264 KiB: it has 3
    stages = {"prefill": 2, "decode": 3 if d == 256 else 4}[plan.form]
    assert stages == flash_stages(plan.form, d) == \
        flash_stages(plan.form, d, d)
    if plan.form == "prefill" and d == 256:
        # the wgmma instance: two 64-row Q tiles, 2 stages of [K, V] (3
        # would not fit), 8 bytes a barrier (Q's, a full and an empty
        # one a stage) and 1 KiB to align the tiles to 1024 bytes
        assert wide_stages(d, d) == 2
        assert plan.smem == 2 * d * (128 + 2 * 2 * 64) + 8 * 5 + 1024
        assert plan.threads == 384
    else:
        # the bf16 Q tile and the ring of [K, V] 64-key tile stages
        rows = 16 if plan.form == "decode" else 64
        assert plan.smem == 2 * d * (rows + stages * 2 * 64)
        assert plan.threads == 128
    # within the 227 KB of dynamic shared memory an H100 block may take
    assert plan.smem <= 227 * 1024
    assert plan == flash_plan(2, sq, 4096, hq, hkv, d, d)


def test_flash_plan_rejects_what_it_cannot_launch():
    with pytest.raises(ValueError, match="no launch"):
        flash_plan(1, 4, 0, 8, 2, 64)
    with pytest.raises(ValueError, match="no launch"):
        flash_plan(1, 4, 16, 6, 4, 64)


@pytest.mark.parametrize("name", ["prefill", "decode4", "mla_prefill"])
def test_kernel_args_match_the_entry_point(name):
    """The wrapper's arguments fill the C entry point's signature in
    ``build.SOURCES`` (the stream comes last): the key head size D, then
    the value head size DV, then the strides; and they carry the plan's
    form (the entry point works out the grid and shared memory from
    it)."""
    row = _chip_shapes()[name]
    b, sq, skv, hq, hkv, d, causal, off = row[1:9]
    dv = row.v_dim
    q = torch.zeros((b, hq, sq, d)).transpose(1, 2)
    k = torch.zeros((b, skv, hkv, d))
    v = torch.zeros((b, skv, hkv, dv))
    out = torch.empty((b, sq, hq, dv))
    plan = flash_plan(b, sq, skv, hq, hkv, d, dv)
    args = kernel_args(q, k, v, out, d ** -0.5, causal, off, plan)
    argtypes = build.SOURCES["flash_attention"]["flash_attention"]
    assert len(args) == len(argtypes) - 1
    assert args[4:11] == (b, sq, skv, hq, hkv, d, dv)
    assert args[11:14] == (hq * sq * d, d, sq * d)      # [B, H, S, D] view
    assert args[17:20] == (skv * hkv * dv, hkv * dv, dv)
    assert args[-4:] == (d ** -0.5, int(causal), off,
                         ("prefill", "decode").index(plan.form))


def test_kernel_parts_flash_variants_edit_the_source():
    """Each statement a ``kernel_parts.py`` flash variant edits is in the
    source as many times as the edit says (the script fails loudly
    otherwise), and the variants of both kernels reach the wgmma
    instance: no_mma takes out every wgmma, copies_only every tile's
    products, empty its TMA loads too (but not the output's store), and
    mma_sync (chip_smoke.py's parent launch) leaves no launch of it."""
    parts = _load("kernel_parts")
    text = (parts.CSRC / "flash_attention.cu").read_text()
    assert set(parts.FLASH_VARIANTS) == {
        "full", "no_mma", "copies_only", "empty", "mma_sync", "head_major",
        "no_store", "q_smem", "wgmma_short"}
    assert set(parts.FLASH_WIDE_VARIANTS) < set(parts.FLASH_VARIANTS)
    assert parts.FLASH_VARIANTS["mma_sync"] == \
        _load("chip_smoke").PARENT_FLASH_EDITS
    for name, edits in parts.FLASH_VARIANTS.items():
        src = text
        for old, new, *n in edits:
            assert src.count(old) == (n[0] if n else 1), (name, old)
            assert old != new
            src = src.replace(old, new)
        if name == "no_mma":
            assert "wgmma.mma_async" not in src.replace("// wgmma", "")
        if name in ("copies_only", "empty"):
            assert "      if (false) {\n" in src
        if name == "empty":
            assert '"cp.async.bulk.tensor.4d.shared' not in src
            assert '"cp.async.bulk.tensor.4d.global' in src
        if name == "mma_sync":  # both launches of the instance dead
            assert src.count("return launch_wide") == 2
            assert "  if constexpr (false) {\n    return launch_wide" in src
            assert "if (false) return launch_wide" in src


@pytest.mark.parametrize("name", ["offset", "decode", "decode4",
                                  "d256_decode4"])
def test_flash_row_check_sees_a_dropped_key(name):
    """``chip_smoke.py``'s per-row check passes a schedule that rounds p
    at other running maxima (64-key chunks, as the kernel's tiles) and
    fails one whose causal limit is one key short, at shapes where each
    row sees ~1000 keys."""
    smoke = _load("chip_smoke")
    b, sq, skv, hq, hkv, d, causal, off = {
        r.name: r[1:9] for r in smoke.FLASH_SHAPES}[name]
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((b, s, h, d), generator=gen).to(torch.bfloat16)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    want = flash_attention_plain(q, k, v, causal=causal, kv_offset=off)
    tiled = flash_attention_plain(q, k, v, causal=causal, kv_offset=off,
                                  q_chunk=64, kv_chunk=64)
    assert smoke.flash_row_err(tiled, want) <= smoke.FLASH_ROW_TOL
    short = flash_attention_plain(q, k, v, causal=causal, kv_offset=off - 1)
    assert smoke.flash_row_err(short, want) > smoke.FLASH_ROW_TOL


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the kernel "
                    "there at the serving shapes")
    return torch.device("cuda")


# (form, D, (b, hq, hkv, sq, skv), kv_offset[, DV])
ON_CARD = [
    ("prefill", 64, (2, 8, 2, 100, 100), 0),
    ("prefill", 128, (1, 4, 4, 130, 130), 0),
    ("decode", 64, (2, 8, 2, 4, 100), 96),
    ("decode", 128, (2, 8, 2, 1, 77), 76),
    ("prefill", 256, (1, 4, 4, 130, 130), 0),
    ("decode", 256, (2, 4, 4, 3, 150), 147),
    ("prefill", 192, (1, 4, 4, 130, 130), 0, 128),
    ("decode", 192, (2, 4, 4, 3, 150), 147, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("form,d,dims,off,dv",
                         [(*c, None)[:5] for c in ON_CARD])
def test_kernel_matches_plain_on_card(cuda, form, d, dims, off, dv):
    b, hq, hkv, sq, skv = dims
    assert flash_plan(b, sq, skv, hq, hkv, d, dv).form == form
    q, k, v = (_bshd(a).to(cuda, torch.bfloat16)
               for a in _qkv(1, b, hq, hkv, sq, skv, d, dv))
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=True, kv_offset=off)
    assert LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v, causal=True, kv_offset=off)
    # two steps of bf16's 2^-8 on max|v|: p and the output are rounded
    # to bf16 at running maxima taken over other tiles
    tol = 2 * 2 ** -8 * float(v.abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        flash_attention(q.half(), k.half(), v.half())
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted.view(q.shape), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 96])
def test_kernel_refuses_head_sizes_it_lacks(cuda, d):
    """The smoke configs' head sizes (8-32) and any other size outside
    ``KERNEL_HEAD_DIMS`` raise on the card, naming the (key, value)
    pairs the kernel has; they never fall back to the plain version."""
    assert (d, d) not in KERNEL_HEAD_DIMS == ((64, 64), (128, 128),
                                              (256, 256), (192, 128))
    q = torch.zeros((1, 4, 2, d), device=cuda, dtype=torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(NotImplementedError,
                       match=r"head sizes \(key, value\) \(%d, %d\) are "
                             r"not instantiated \(\(64, 64\), " % (d, d)):
        flash_attention(q, q, q)
    assert LAUNCHES["flash_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(192, 64), (128, 192), (64, 128),
                                  (192, 192)])
def test_kernel_refuses_pairs_it_lacks(cuda, d, dv):
    """A key head size the kernel has, under a value head size it is not
    paired with (or MLA's 192 with equal values), raises on the card; no
    fallback, no launch."""
    assert (d, dv) not in KERNEL_HEAD_DIMS
    q = torch.zeros((1, 4, 2, d), device=cuda, dtype=torch.bfloat16)
    v = torch.zeros((1, 4, 2, dv), device=cuda, dtype=torch.bfloat16)
    before = LAUNCHES["flash_attention"]
    with pytest.raises(NotImplementedError,
                       match=r"\(%d, %d\) are not instantiated" % (d, dv)):
        flash_attention(q, q, v)
    assert LAUNCHES["flash_attention"] == before
