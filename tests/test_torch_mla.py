"""DeepSeek-V2's multi-head latent attention and dense prefix in the port
(``repro_torch.models.lm`` with ``mla`` and ``n_dense_prefix`` set)
against the JAX package, on the CPU.

Weights are the reference's own ``lm.init``, carried across with
``params_from_jax``; tokens and activations are made with numpy from a
seed. Everything runs in fp32.

Tolerances:
- logits, the compressed cache (``c``, ``k_rope``) and the aux loss
  across packages: 1e-4 absolute and relative, as
  ``tests/test_torch_lm.py`` (the same fp32 arithmetic in another
  order; the largest logit error seen was 2e-6). It holds only while
  both packages route every token to the same experts in the same
  slots, which the tests check first: each MoE layer's dispatch is
  recorded in both packages (the reference's, inside jit and scan, by
  an ordered ``jax.debug.callback``) and must be equal;
- the flash kernel's plain version at key size != value size against
  ``blockwise_attention``: 3e-5, as ``tests/test_torch_attention.py``;
- decode against forward in one package: 2e-2, as
  ``tests/test_models.py::test_mla_decode_matches_forward``.
Greedy tokens must be equal; parameter counts equal.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention import flash_attention_plain, \
    flash_plan, stages, wide_stages
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.serve import engine
from test_torch_ssm import _jax_launcher
from test_torch_lm import serve_on_a_fake_card

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek-v2-236b"
BATCH, PROMPT, NEW = 2, 12, 6
_jinit = jax.jit(jlm.init, static_argnums=0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@contextlib.contextmanager
def _recorded(mod):
    """While the block runs (and in what it traces), each call of
    ``mod._top_k_dispatch`` appends to the yielded list, per MoE layer,
    the capacity slot each (token, expert) pair took, -1 where it was
    not kept. The reference's dispatch runs inside jit and scan, so its
    record is taken by an ordered ``jax.debug.callback``."""
    original, calls = mod._top_k_dispatch, []

    def keep(d):
        d = np.asarray(d)
        calls.append(np.where(d.sum(-1) > 0, d.argmax(-1), -1))

    def recording(probs, top_k, capacity):
        d, c = original(probs, top_k, capacity)
        if mod is jlayers:
            jax.debug.callback(keep, d, ordered=True)
        else:
            keep(d)
        return d, c

    mod._top_k_dispatch = recording
    try:
        yield calls
    finally:
        mod._top_k_dispatch = original


def _same_routing(got: list, want: list):
    """Equal routing in every MoE layer; the lists are emptied."""
    jax.effects_barrier()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got.clear()
    want.clear()


# ---------------------------------------------------------------------------
# Config, sizes
# ---------------------------------------------------------------------------


def test_config_transcribes_the_reference():
    arch, want = registry.get(ARCH), jregistry.get(ARCH)
    assert (arch.family, arch.module, arch.notes, arch.frontend) == \
        (want.family, want.module, want.notes, want.frontend)
    assert arch.model_module() is lm
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            elif f.name in ("moe", "mla"):
                assert dataclasses.asdict(got) == dataclasses.asdict(exp)
            else:
                assert got == exp, f.name
        assert (cfg.qk_dim, cfg.v_head_dim) == (ref_cfg.qk_dim,
                                                ref_cfg.v_head_dim)
    assert (arch.model.qk_dim, arch.model.v_head_dim) == (192, 128)


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_equal_reference(which):
    """``param_count`` and ``active_param_count`` equal to the
    reference's; the published config within 10% of its 236 B total and
    21 B active parameters."""
    cfg, ref = (getattr(r.get(ARCH), which) for r in (registry, jregistry))
    assert lm.param_count(cfg) == jlm.param_count(ref)
    assert lm.active_param_count(cfg) == jlm.active_param_count(ref)
    if which == "model":
        assert abs(lm.param_count(cfg) - 236e9) / 236e9 < 0.10
        assert abs(lm.active_param_count(cfg) - 21e9) / 21e9 < 0.10


@pytest.mark.parametrize("n_dense", [0, 1, 2])
def test_active_param_count_leaves_the_dense_prefix_whole(n_dense):
    """The unused experts are subtracted over the ``n_layers -
    n_dense_prefix`` MoE layers only, as in the reference: the dense
    layers have none."""
    kw = dict(name="t", n_layers=3, d_model=32, n_heads=2, n_kv_heads=2,
              head_dim=16, d_ff=48, vocab=100, vocab_pad_multiple=16,
              n_dense_prefix=n_dense, d_ff_dense=64)
    moe = dict(n_experts=6, top_k=2, d_ff=24, n_shared=1)
    cfg = lm.LMConfig(moe=layers.MoEConfig(**moe), **kw)
    ref = jlm.LMConfig(moe=jlayers.MoEConfig(**moe), **kw)
    assert lm.param_count(cfg) == jlm.param_count(ref)
    got = lm.active_param_count(cfg)
    assert got == jlm.active_param_count(ref)
    unused = (6 - 2) * 3 * 32 * 24
    assert got == lm.param_count(cfg) - (3 - n_dense) * unused


# ---------------------------------------------------------------------------
# The flash kernel's plain version at key size != value size
# ---------------------------------------------------------------------------


# (b, sq, skv, hq, hkv, d, dv, q_chunk, kv_chunk, causal, kv_offset)
UNEQUAL = [
    (2, 12, 12, 4, 4, 24, 16, 512, 1024, True, 0),      # the smoke prefill
    (2, 70, 70, 4, 2, 24, 16, 32, 16, True, 0),         # ragged chunks, GQA
    (1, 3, 40, 4, 4, 48, 32, 8, 16, True, 37),          # the decode form
    (2, 33, 50, 2, 1, 24, 8, 16, 32, False, 0),         # non-causal
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,qc,kc,causal,off", UNEQUAL)
def test_plain_flash_at_unequal_head_sizes(b, sq, skv, hq, hkv, d, dv, qc,
                                           kc, causal, off):
    """``flash_attention_plain`` with 192-wide keys over 128-wide values
    in miniature: [B, Sq, Hq, DV] out, equal within 3e-5 to the
    reference's ``blockwise_attention`` at MLA's ``softmax_scale``."""
    rng = np.random.default_rng(sq + d)
    q = (rng.standard_normal((b, sq, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    scale = (d * 1.5) ** -0.5
    want = jlayers.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_chunk=qc, kv_chunk=kc, kv_offset=off, softmax_scale=scale)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                kv_offset=off, scale=scale, q_chunk=qc,
                                kv_chunk=kc)
    assert got.shape == (b, sq, hq, dv)
    _close(got, want, rtol=3e-5, atol=3e-5)
    wrapped = layers.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_chunk=qc, kv_chunk=kc, kv_offset=off,
        softmax_scale=scale)
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("sq,form,smem", [(64, "prefill", 106_496),
                                          (1, "decode", 169_984),
                                          (65, "prefill", 214_088)])
def test_flash_plan_shared_memory_at_mla(sq, form, smem):
    """At (192, 128): over at most 64 queries the mma.sync kernel, its
    bf16 Q tile [rows, 192] and the ring of [K [64, 192], V [64, 128]]
    stages, 2 in the prefill form (two blocks fit an SM's 228 KB) and 4
    in the decode form; past 64 queries the wgmma instance, two 64-row Q
    tiles, 4 stages, 8 bytes a barrier and 1 KiB of alignment, one block
    an SM; each within the 227 KB a block may take."""
    plan = flash_plan(8, sq, 64, 128, 128, 192, 128)
    assert (plan.form, plan.smem) == (form, smem)
    if sq > 64:
        assert wide_stages(192, 128) == 4
        assert plan.smem == 2 * (128 * 192 + 4 * 64 * 320) + 8 * 9 + 1024
        assert (plan.grid, plan.threads) == ((128 * 8, 1, 1), 384)
    else:
        rows = {"prefill": 64, "decode": 16}[form]
        assert stages(form, 192, 128) == {"prefill": 2, "decode": 4}[form]
        assert plan.smem == 2 * (rows * 192 +
                                 stages(form, 192, 128) * 64 * 320)
        assert plan.threads == 128
    if form == "prefill" and sq <= 64:
        assert 2 * plan.smem <= 228 * 1024
    assert plan.smem <= 227 * 1024


# ---------------------------------------------------------------------------
# The smoke config against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params) of deepseek's smoke
    config (1 dense + 1 MoE layer, d_model 64, 4 heads, MLA kv_lora 32,
    keys 16 + 8 rotary over values 16, 8 experts top 2 + 1 shared)."""
    jarch, tarch = (dataclasses.replace(r.get(ARCH), model=r.get(ARCH).smoke)
                    for r in (jregistry, registry))
    jp = _jinit(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, lm.params_from_jax(jax.tree.map(np.asarray, jp),
                                                CPU)


def test_smoke_params_carry_the_reference_tree(smoke):
    jarch, tarch, jp, tp = smoke
    shapes = layers.tree_map(lambda t: tuple(t.shape), tp)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert layers.tree_map(lambda s: s.shape, lm.param_specs(tarch.model)) \
        == shapes
    assert len(tp["dense_prefix"]) == 1
    assert tp["dense_prefix"][0]["mlp"]["gate"].shape == (64, 128)
    assert tp["layers"]["moe"]["gate"].shape == (1, 8, 64, 96)
    assert tp["layers"]["attn"]["wkv_b"].shape == (1, 32, 4 * (16 + 16))


def test_smoke_forward_matches_reference(smoke):
    """Routing of every MoE layer, then the logits and aux loss of
    ``forward`` (the full MLA form, through ``blockwise_attention``)."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((2, 24))
    before = dict(LAUNCHES)
    with _recorded(jlayers) as jroutes, _recorded(layers) as routes:
        want, want_aux = jlm.forward(jp, jnp.asarray(toks), jarch.model)
        got, aux = lm.forward(tp, torch.from_numpy(toks), tarch.model)
        _same_routing(routes, jroutes)
    assert dict(LAUNCHES) == before        # plain versions on the CPU
    assert got.shape == (2, 24, 512) and float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


def test_smoke_prefill_and_decode_match_reference(smoke):
    """Through the engines: routing, prefill logits and the compressed
    cache (dense prefix and stack), then six absorbed decode steps'
    routing and logits, and the cache after them."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((BATCH, PROMPT + 6))
    max_seq = PROMPT + 6
    jcache = jengine.make_cache(jarch, BATCH, max_seq, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU)
    with _recorded(jlayers) as jroutes, _recorded(layers) as routes:
        want, jcache = jax.jit(jengine.make_prefill_fn(jarch))(
            jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, jcache)
        got, tcache = engine.make_prefill_fn(tarch)(
            tp, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, tcache)
        _same_routing(routes, jroutes)
        _close(got, want)
        assert set(tcache) == {"layers", "dense_prefix"}
        assert tcache["layers"]["c"].shape == (1, BATCH, max_seq, 32)
        assert tcache["dense_prefix"][0]["k_rope"].shape == \
            (BATCH, max_seq, 8)
        jdecode = jax.jit(jengine.make_decode_fn(jarch))
        tdecode = engine.make_decode_fn(tarch)
        for i in range(PROMPT, PROMPT + 6):
            want, jcache = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jcache,
                                   jnp.int32(i))
            got, tcache = tdecode(tp, torch.from_numpy(toks[:, i:i + 1]),
                                  tcache, i)
            _same_routing(routes, jroutes)
            _close(got, want)
    for name in ("c", "k_rope"):
        _close(tcache["layers"][name], jcache["layers"][name])
        _close(tcache["dense_prefix"][0][name],
               jcache["dense_prefix"][0][name])


@pytest.mark.parametrize("side", ["port", "reference"])
def test_mla_decode_matches_forward(side):
    """``tests/test_models.py::test_mla_decode_matches_forward`` in each
    package, on the reference's weights and tokens."""
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
              head_dim=16, d_ff=128, vocab=300, vocab_pad_multiple=16)
    mla = dict(kv_lora=32, q_lora=48, qk_nope_dim=16, qk_rope_dim=8,
               v_dim=16)
    jcfg = jlm.LMConfig(mla=jlm.MLAConfig(**mla), param_dtype=jnp.float32,
                        **kw)
    p = _jinit(jcfg, jax.random.key(0))
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 12), 0, 300))
    if side == "port":
        cfg = lm.LMConfig(mla=lm.MLAConfig(**mla), param_dtype=torch.float32,
                          **kw)
        p = lm.params_from_jax(jax.tree.map(np.asarray, p), CPU)
        toks = torch.from_numpy(toks)
        cache = lm.init_cache(cfg, 2, 16, torch.float32, CPU)
        mod, stack = lm, torch.stack
    else:
        cfg, mod, stack = jcfg, jlm, jnp.stack
        toks = jnp.asarray(toks)
        cache = jlm.init_cache(cfg, 2, 16, jnp.float32)
    logits, _ = mod.forward(p, toks, cfg)
    dec = []
    for t in range(6):
        lg, cache = mod.decode_step(p, toks[:, t:t + 1], cache, t, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :6])).max())
    assert err < 2e-2, err


def test_smoke_greedy_tokens_equal_reference(smoke):
    jarch, tarch, jp, tp = smoke
    prompts = _tokens((BATCH, PROMPT), seed=2)
    want = jengine.greedy_generate(jarch, jp, jnp.asarray(prompts), NEW)
    got = engine.greedy_generate(tarch, tp, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantized_projections_cover_mla(smoke):
    """``hetero_quant`` fake-quantizes MLA's projections through ``_proj``
    as in the reference (``wkv_b``'s product stays plain there too):
    prefill logits within ``TOL``, and unlike the plain run's."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((BATCH, PROMPT), seed=3)
    q = dict(w_bits_lut=4, a_bits=8, ratio=0.5)
    jcfg = dataclasses.replace(jarch.model,
                               hetero_quant=jlm.HeteroQuantConfig(**q))
    tcfg = dataclasses.replace(tarch.model,
                               hetero_quant=lm.HeteroQuantConfig(**q))
    want, _ = jax.jit(jlm.forward, static_argnums=2)(jp, jnp.asarray(toks),
                                                     jcfg)
    got, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
    _close(got, want)
    plain, _ = lm.forward(tp, torch.from_numpy(toks), tarch.model)
    assert not torch.allclose(plain, got, **TOL)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_on_cpu_matches_reference(capsys):
    """``launch.serve --arch deepseek-v2-236b --smoke --device cpu``: the
    prompts and tokens of the reference's launcher on the same weights
    (made by ``lm.init`` from ``--seed`` on the CPU's generator and
    handed to JAX as numpy)."""
    before = dict(LAUNCHES)
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4"])
    assert dict(LAUNCHES) == before
    assert "# arch=deepseek-v2-smoke layers=2" in capsys.readouterr().out
    params = lm.init(registry.get(ARCH).smoke,
                     torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    prompts, tokens = _jax_launcher(ARCH, jparams, 2, 8, 4)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)


@pytest.mark.parametrize("n,code", [(1, 2), (0, 1), (3, 1)])
def test_serve_layers_keeps_the_dense_prefix(capsys, n, code):
    """``--layers N`` keeps the dense first layer and cuts the MoE stack:
    N = 1 would leave no MoE layer and exits 2; N outside [1, 2] is the
    range error of every LM."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--layers", str(n)])
    if code == 2:
        assert exc.value.code == 2
        assert "dense prefix" in capsys.readouterr().err
    else:
        assert "--layers must be in [1, 2]" in str(exc.value.code)


def test_serve_layers_cuts_the_moe_stack(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--layers", "2", "--batch", "1", "--prompt-len", "4",
                      "--new-tokens", "2"])
    assert "# arch=deepseek-v2-smoke layers=2" in capsys.readouterr().out
    assert out["tokens"].shape == (1, 2)


def test_serve_smoke_takes_the_card(monkeypatch):
    """deepseek's smoke config (keys 24 wide over values 16, fp32) is
    served on a CUDA device: MLA's attention routes to the fp32 flash
    kernel at both sizes and the launcher goes on to build the model on
    the card."""
    routed, reached = serve_on_a_fake_card(monkeypatch,
                                           ["--arch", ARCH, "--smoke"])
    assert routed == [(24, 16, torch.float32, False)] and reached == "cuda"
