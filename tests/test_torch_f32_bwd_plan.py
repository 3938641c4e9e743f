"""The fp32 flash backward's launch plan and its rank-ordered sums.

``flash_attention_f32.cu``'s dkdv splits each 64-key tile's row tiles
over the S blocks of a thread-block cluster and adds the ranks' partial
sums in rank order; ``flash_attention_bwd.f32_bwd_plan`` mirrors the C
entry points' choice. Held here, on the CPU: the plan covers every (key
tile, visible row tile) pair exactly once, S is a cluster size the
launch takes, shared memory fits an H100 block, the plan's constants and
compiled pairs are the source's, and dk, dv summed by the plan's ranks
(``f32_dkdv_ranked_plain``) match the plain backward and JAX's gradient
of the reference's ``blockwise_attention`` in fp32. The kernel itself
runs on the card only (``chip_smoke.py`` phase 15).
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import SMEM_BLOCK, f32_pair

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/csrc/flash_attention_f32.cu"


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()
# (b, sq, skv, hq, hkv, d, dv, causal, kv_offset): chip_smoke's fp32 rows
# with a backward, and others: a longer key range than query range, a key
# tile no row sees, one row tile, many heads
PLAN_SHAPES = [(*s[1:7], s.v_dim, *s[7:9]) for s in SMOKE.F32_SHAPES
               if s.backward] + [
    (2, 30, 500, 4, 2, 16, 16, True, 100),
    (1, 70, 300, 2, 2, 8, 8, True, 0),
    (3, 17, 17, 5, 5, 12, 12, True, 0),
    (8, 1024, 1024, 16, 16, 16, 16, False, 0),
]


def _visible(sq, skv, hq, hkv, causal, off):
    """Per key tile, the row tiles with a row that sees one of its keys,
    from the rows themselves."""
    rep = hq // hkv
    nrows = sq * rep
    out = []
    for k0 in range(0, skv, fab.F32_KEYS):
        tiles = set()
        for r in range(nrows):
            if not causal or k0 <= r // rep + off:
                tiles.add(r // fab.F32_ROWS)
        out.append(tiles)
    return out


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_visible_row_tile_once(shape):
    """Each key tile's ranks take contiguous, disjoint, ascending shares
    of its row tiles, and together exactly the row tiles that see it;
    S is a cluster size of the launch; dkdv's blocks are the clusters
    times S, dq's the row tiles times heads and batch."""
    b, sq, skv, hq, hkv, d, dv, causal, off = shape
    plan = fab.f32_bwd_plan(*shape)
    assert plan.split in (1, 2, 4, 8)
    nkt = -(-skv // fab.F32_KEYS)
    nrt = -(-sq * (hq // hkv) // fab.F32_ROWS)
    assert len(plan.ranges) == nkt
    assert plan.dkdv_blocks == nkt * hkv * b * plan.split
    assert plan.dq_blocks == nrt * hkv * b
    for shares, seen in zip(plan.ranges, _visible(sq, skv, hq, hkv, causal,
                                                  off)):
        assert len(shares) == plan.split
        assert all(first <= end for first, end in shares)
        assert all(shares[r][1] == shares[r + 1][0]
                   for r in range(plan.split - 1))
        covered = [t for first, end in shares for t in range(first, end)]
        assert covered == sorted(seen)


def test_plan_reaches_the_cluster_cases_on_the_card():
    """chip_smoke's rows hold S 8, a rank with an empty share, a rank
    whose share is one partial row tile, a causal first row inside a row
    tile at S > 1, and the run-time instance."""
    shapes = [(s, fab.f32_bwd_plan(*s[1:7], s.v_dim, *s[7:9]))
              for s in SMOKE.F32_SHAPES if s.backward]
    assert any(p.split == 8 for _, p in shapes)
    assert any(first == end for _, p in shapes for shares in p.ranges
               for first, end in shares)
    rows = {s.name: s.sq * (s.hq // s.hkv) for s, _ in shapes}
    assert any(end - first == 1 and end * 32 > rows[s.name] > first * 32
               for s, p in shapes if rows[s.name] % 32
               for shares in p.ranges for first, end in shares)
    assert any((k0 - s.kv_offset) * (s.hq // s.hkv) % 32
               for s, p in shapes if s.causal and p.split > 1
               for k0 in range(0, s.skv, 64)
               if s.kv_offset < k0 < s.kv_offset + s.sq)
    assert any(p.instance == (0, 0) for _, p in shapes)
    assert {p.instance for _, p in shapes} >= set(fab.F32_BWD_PAIRS)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE.read_text())
    return eval(m.group(1))  # a product of integer literals


def test_plan_mirrors_the_source():
    """The plan's tile sizes, ring, split limits and compiled pairs are
    the C source's."""
    assert (_constant("THREADS"), _constant("BR"), _constant("BK"),
            _constant("NST"), _constant("MAX_SPLIT"), _constant("SLOTS")) \
        == (fab.F32_THREADS, fab.F32_ROWS, fab.F32_KEYS, fab.F32_STAGES,
            fab.F32_MAX_SPLIT, fab.F32_SLOTS)
    pairs = re.findall(r"if \(D == (\d+) && DV == (\d+)\) return f\(Pair<",
                       SOURCE.read_text())
    assert tuple((int(d), int(dv)) for d, dv in pairs) == fab.F32_BWD_PAIRS


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 8), sq=st.integers(1, 9000),
       skv=st.integers(1, 9000), hkv=st.integers(1, 8),
       rep=st.integers(1, 8), d4=st.integers(1, 16), dv4=st.integers(1, 16),
       causal=st.booleans(), off=st.integers(0, 200))
def test_plan_shared_memory_fits_at_every_pair(b, sq, skv, hkv, rep, d4,
                                               dv4, causal, off):
    """Both launches' shared memory stays under an H100 block's 227 KB at
    any fp32 pair (multiples of 4 up to 64) and shape, and S is a cluster
    size; every chip_smoke row too."""
    d, dv = 4 * d4, 4 * dv4
    assert f32_pair(d, dv)
    plan = fab.f32_bwd_plan(b, sq, skv, hkv * rep, hkv, d, dv, causal, off)
    assert plan.split in (1, 2, 4, 8)
    assert max(plan.dq_smem, plan.dkdv_smem) <= SMEM_BLOCK
    for s in SMOKE.F32_SHAPES:
        p = fab.f32_bwd_plan(*s[1:7], s.v_dim, *s[7:9])
        assert max(p.dq_smem, p.dkdv_smem) <= SMEM_BLOCK


# (b, sq, skv, hq, hkv, d, dv, causal, kv_offset): GQA with empty ranks,
# a causal first row inside a tile over a longer key range, MLA's pair
# non-causal, and a partial last row tile
RANKED = [(1, 40, 40, 2, 1, 16, 16, True, 0),
          (2, 50, 100, 4, 2, 8, 8, True, 30),
          (2, 33, 70, 3, 3, 24, 16, False, 0)]


@pytest.mark.parametrize("shape", RANKED, ids=lambda s: "x".join(map(str, s)))
def test_ranked_plain_matches_plain_and_jax(shape):
    """dk and dv summed by the plan's ranks, merged in rank order, against
    the plain backward (autograd through the plain forward) and JAX's
    gradient of blockwise_attention, all fp32 on the same numpy inputs:
    within 2e-5 of the largest |gradient| (the three sum the rows in
    different orders; fp32 roundings of sums over at most 100 rows are
    ~1e-6 of it)."""
    b, sq, skv, hq, hkv, d, dv, causal, off = shape
    plan = fab.f32_bwd_plan(*shape)
    assert plan.split > 1
    rng = np.random.default_rng(sq + d)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, sq, hq, d), (b, skv, hkv, d),
                               (b, skv, hkv, dv), (b, sq, hq, dv)))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    dk, dvv = fab.f32_dkdv_ranked_plain(tq, tk, tv, tdo, causal=causal,
                                        kv_offset=off)
    _, pk, pv = fab.flash_attention_bwd_plain(tq, tk, tv, tdo,
                                              causal=causal, kv_offset=off)

    def loss(k_, v_):
        out = jlayers.blockwise_attention(jnp.asarray(q), k_, v_,
                                          causal=causal, kv_offset=off,
                                          q_chunk=32, kv_chunk=64)
        return jnp.sum(out * jnp.asarray(dout))
    jk, jv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    for got, plain, want in ((dk, pk, jk), (dvv, pv, jv)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        tol = 2e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# The forward's launch (``flash_attention_f32``): the same constants, one
# block per (row tile, KV head, batch), the compiled pairs
# ---------------------------------------------------------------------------

FWD_SHAPES = [(*s[1:7], s.v_dim, *s[7:9], s.kv_bf16) for s in SMOKE.F32_SHAPES] \
    + [(2, 30, 500, 4, 2, 16, 16, True, 100, False),
       (3, 17, 17, 5, 5, 12, 12, True, 0, True),
       (1, 64, 64, 1, 1, 64, 64, False, 0, False)]


@pytest.mark.parametrize("shape", FWD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fwd_plan_takes_the_heaviest_row_tiles_first(shape):
    """Each row tile is launched once (for every KV head and batch), and
    under a causal mask in order of the key tiles its rows see, the most
    first; without one in row order, all seeing every key tile."""
    b, sq, skv, hq, hkv, d, dv, causal, off, kv_bf16 = shape
    plan = fab.f32_fwd_plan(*shape)
    nrt = -(-sq * (hq // hkv) // fab.F32_ROWS)
    assert plan.blocks == nrt * hkv * b
    assert sorted(plan.row_tiles) == list(range(nrt))
    if causal:
        assert list(plan.key_tiles) == sorted(plan.key_tiles, reverse=True)
        assert plan.row_tiles[0] == nrt - 1
    else:
        assert plan.row_tiles == tuple(range(nrt))
        assert set(plan.key_tiles) == {-(-skv // fab.F32_KEYS)}


def _arch_heads():
    """(arch id, how, (key, value) head sizes) of every flash launch the
    smoke configs make: served (``flash_heads``) and trained at 8448
    tokens (``train_flash_heads``, above every dense_attn_max)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.launch.serve import flash_heads
    from repro_torch.launch.train import train_flash_heads
    out = []
    for arch_id in registry.list_archs():
        arch = registry.get(arch_id)
        if arch.smoke is None:
            continue
        smoke = dataclasses.replace(arch, model=arch.smoke)
        for how, heads in (("serve", flash_heads(smoke)),
                           ("train", train_flash_heads(smoke, 8448))):
            if heads is not None:
                out.append((arch_id, how, tuple(heads)))
    return out


def test_compiled_pairs_cover_every_smoke_config():
    """Every attention arch's smoke config, served or trained, runs a
    compiled (D, DV) instance of the fp32 forward and backward, not the
    one that reads its head sizes at run time."""
    heads = _arch_heads()
    assert {a for a, _, _ in heads} >= {"llama3.2-1b", "seamless-m4t-large-v2",
                                        "deepseek-v2-236b", "gemma-7b",
                                        "yi-34b", "jamba-v0.1-52b"}
    for arch_id, how, pair in heads:
        assert pair in fab.F32_BWD_PAIRS, (arch_id, how, pair)
        plan = fab.f32_fwd_plan(2, 64, 64, 4, 2, *pair, True, 0)
        assert plan.instance == pair


def test_fwd_plan_mirrors_the_source():
    """The forward's key slices are the source's fwd_slices, over its 16
    lanes, and the forward launches the backward's compiled pairs."""
    text = SOURCE.read_text()
    assert "int ks = TX;\n  while (ks > 1 && nq * ks > TX) ks /= 2;" in text
    assert re.search(r"constexpr int TX = (\d+);", text).group(1) == "16"
    assert [fab.f32_fwd_slices(4 * nq) for nq in (1, 2, 3, 4, 5, 6, 8, 16)] \
        == [16, 8, 4, 4, 2, 2, 2, 1]
    fwd = text[text.index("int flash_attention_f32("):]
    assert "return with_pair(D, DV, [&](auto p) {" in \
        fwd[:fwd.index("int flash_attention_f32_bwd_dq(")]


@settings(max_examples=40, deadline=None)
@given(d4=st.integers(1, 16), dv4=st.integers(1, 16), kv_bf16=st.booleans())
def test_fwd_shared_memory_fits(d4, dv4, kv_bf16):
    """The forward's shared memory fits an H100 block at every fp32 pair,
    and four blocks an SM (its launch bounds) at the compiled pairs."""
    d, dv = 4 * d4, 4 * dv4
    plan = fab.f32_fwd_plan(1, 100, 100, 2, 1, d, dv, True, 0, kv_bf16)
    assert plan.smem <= SMEM_BLOCK
    for pair in fab.F32_BWD_PAIRS:
        p = fab.f32_fwd_plan(1, 100, 100, 2, 1, *pair, True, 0, kv_bf16)
        assert 4 * p.smem <= SMEM_BLOCK
