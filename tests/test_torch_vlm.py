"""Qwen2-VL's multimodal RoPE and frontend embeddings in the port
(``repro_torch.models.layers.apply_mrope``, ``repro_torch.models.lm``
with ``mrope_sections`` and ``extra_embed``) against the JAX package,
on the CPU; and the port's registry of all ten archs.

Weights are the reference's own ``lm.init``, carried across with
``params_from_jax``; tokens, positions and patch embeddings are made
with numpy from a seed. Everything runs in fp32.

Tolerances:
- ``apply_mrope`` and ``layernorm`` across packages: 1e-5 absolute and
  relative (the same fp32 products; sin/cos implementations differ in
  the last bits);
- M-RoPE with three equal components against RoPE: 1e-5, as
  ``tests/test_models.py::test_mrope_reduces_to_rope_for_text``;
- logits across packages: 1e-4 absolute and relative, as
  ``tests/test_torch_lm.py``.
Greedy tokens must be equal; parameter counts equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.serve import engine
from test_torch_ssm import _jax_launcher
from test_torch_lm import serve_on_a_fake_card

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
FINE = dict(rtol=1e-5, atol=1e-5)
ARCH = "qwen2-vl-2b"
BATCH, PROMPT, NEW = 2, 12, 6
_jinit = jax.jit(jlm.init, static_argnums=0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# M-RoPE and LayerNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,d,theta", [((16, 24, 24), 128, 1e6),
                                              ((4, 2, 2), 16, 1e4)],
                         ids=["published", "smoke"])
def test_apply_mrope_matches_reference(sections, d, theta):
    """Three different position components (as a vision token's t, h, w
    would be), at qwen2-vl-2b's sections and at its smoke config's."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 9, 3, d)).astype(np.float32)
    pos = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                             sections, theta)
    _close(got, want, **FINE)
    # each band follows its own component: a band of the t section moves
    # with t alone
    moved = pos.copy()
    moved[1:] += 7
    again = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved),
                               sections, theta)
    t_cols = np.r_[0:sections[0], d // 2:d // 2 + sections[0]]
    np.testing.assert_array_equal(again[..., t_cols].numpy(),
                                  got[..., t_cols].numpy())
    assert not torch.equal(again, got)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_mrope_reduces_to_rope_for_text(side):
    """``tests/test_models.py::test_mrope_reduces_to_rope_for_text`` in
    each package."""
    x = np.random.default_rng(0).standard_normal((2, 10, 4, 64)).astype(
        np.float32)
    pos = np.repeat(np.arange(10, dtype=np.int32)[None], 2, 0)
    if side == "port":
        x, pos, mod, stack = (torch.from_numpy(x), torch.from_numpy(pos),
                              layers, torch.stack)
    else:
        x, pos, mod, stack = jnp.asarray(x), jnp.asarray(pos), jlayers, \
            jnp.stack
    a = mod.apply_rope(x, pos)
    b = mod.apply_mrope(x, stack([pos] * 3), (16, 8, 8))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_mrope_sections_must_cover_half_the_head():
    x = np.zeros((1, 2, 1, 16), np.float32)
    pos = np.zeros((3, 1, 2), np.int32)
    for mod, conv in ((layers, torch.from_numpy), (jlayers, jnp.asarray)):
        with pytest.raises(ValueError, match="must sum to head_dim/2=8"):
            mod.apply_mrope(conv(x), conv(pos), (4, 2, 1))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 5, 32)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    want = jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias))
    got = layers.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias))
    _close(got, want, **FINE)


# ---------------------------------------------------------------------------
# qwen2-vl-2b
# ---------------------------------------------------------------------------


def test_config_transcribes_the_reference():
    arch, want = registry.get(ARCH), jregistry.get(ARCH)
    assert (arch.family, arch.module, arch.notes, arch.frontend) == \
        (want.family, want.module, want.notes, "vision")
    assert arch.model_module() is lm
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            else:
                assert got == exp, f.name


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params) of qwen2-vl's smoke
    config (2 layers, d_model 48, GQA 3 over 1 head of 16, sections
    (4, 2, 2), fp32)."""
    jarch, tarch = (dataclasses.replace(r.get(ARCH), model=r.get(ARCH).smoke)
                    for r in (jregistry, registry))
    jp = _jinit(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, lm.params_from_jax(jax.tree.map(np.asarray, jp),
                                                CPU)


@pytest.mark.parametrize("with_embed", [False, True],
                         ids=["text", "extra_embed"])
def test_smoke_forward_matches_reference(smoke, with_embed):
    """Logits of ``forward``, text only and with precomputed patch
    embeddings added to the token embeddings."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((2, 24))
    extra = (np.random.default_rng(5).standard_normal((2, 24, 48))
             .astype(np.float32) if with_embed else None)
    want, _ = jlm.forward(jp, jnp.asarray(toks), jarch.model,
                          extra_embed=None if extra is None
                          else jnp.asarray(extra))
    before = dict(LAUNCHES)
    got, _ = lm.forward(tp, torch.from_numpy(toks), tarch.model,
                        extra_embed=None if extra is None
                        else torch.from_numpy(extra))
    assert dict(LAUNCHES) == before
    assert got.shape == (2, 24, 512) and torch.isfinite(got).all()
    _close(got, want)
    if with_embed:
        text, _ = lm.forward(tp, torch.from_numpy(toks), tarch.model)
        assert not torch.allclose(text, got, **TOL)


@pytest.mark.parametrize("with_embed", [False, True],
                         ids=["text", "extra_embed"])
def test_smoke_prefill_and_decode_match_reference(smoke, with_embed):
    """Through the engines (the prefill takes ``batch["extra_embed"]``):
    prefill logits and K/V cache, then decode steps (each given a patch
    embedding too where the prefill was)."""
    jarch, tarch, jp, tp = smoke
    rng = np.random.default_rng(6)
    toks = _tokens((BATCH, PROMPT + 4))
    extra = rng.standard_normal((BATCH, PROMPT + 4, 48)).astype(np.float32)
    batch = {"tokens": toks[:, :PROMPT]}
    if with_embed:
        batch["extra_embed"] = extra[:, :PROMPT]
    max_seq = PROMPT + 4
    jcache = jengine.make_cache(jarch, BATCH, max_seq, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU)
    want, jcache = jengine.make_prefill_fn(jarch)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    got, tcache = engine.make_prefill_fn(tarch)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
    _close(got, want)
    for i in range(PROMPT, max_seq):
        e = extra[:, i:i + 1] if with_embed else None
        want, jcache = jlm.decode_step(
            jp, jnp.asarray(toks[:, i:i + 1]), jcache, i, jarch.model,
            extra_embed=None if e is None else jnp.asarray(e))
        got, tcache = lm.decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1]), tcache, i, tarch.model,
            extra_embed=None if e is None else torch.from_numpy(e))
        _close(got, want)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])


def test_smoke_greedy_tokens_equal_reference(smoke):
    jarch, tarch, jp, tp = smoke
    prompts = _tokens((BATCH, PROMPT), seed=2)
    want = jengine.greedy_generate(jarch, jp, jnp.asarray(prompts), NEW)
    got = engine.greedy_generate(tarch, tp, torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_on_cpu_matches_reference(capsys):
    """``launch.serve --arch qwen2-vl-2b --smoke --device cpu``: text
    only, as the reference's launcher serves it; its prompts and tokens
    on the same weights."""
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4"])
    assert "# arch=qwen2-vl-smoke layers=2" in capsys.readouterr().out
    params = lm.init(registry.get(ARCH).smoke,
                     torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    prompts, tokens = _jax_launcher(ARCH, jparams, 2, 8, 4)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)


def test_serve_smoke_takes_the_card(monkeypatch):
    """qwen2-vl's smoke config (head_dim 16, fp32) is served on a CUDA
    device: its attention routes to the fp32 flash kernel and the
    launcher goes on to build the model on the card."""
    routed, reached = serve_on_a_fake_card(monkeypatch,
                                           ["--arch", ARCH, "--smoke"])
    assert routed == [(16, 16, torch.float32, False)] and reached == "cuda"


# ---------------------------------------------------------------------------
# The registry: tests/test_smoke_archs.py's checks on the port
# ---------------------------------------------------------------------------


def test_all_ten_archs_registered():
    assert len(registry.list_archs()) == 10
    assert registry.list_archs() == jconfigs.list_archs()
    assert set(registry.list_archs()) == {
        "jamba-v0.1-52b", "seamless-m4t-large-v2", "yi-34b", "gemma-7b",
        "llama3.2-1b", "qwen3-8b", "mamba2-780m", "qwen3-moe-235b-a22b",
        "deepseek-v2-236b", "qwen2-vl-2b"}
    for arch_id in registry.list_archs():
        arch, want = registry.get(arch_id), jregistry.get(arch_id)
        assert (arch.family, arch.module, arch.frontend) == \
            (want.family, want.module, want.frontend)


#: the published sizes ``tests/test_smoke_archs.py`` holds the configs to
PUBLISHED = {
    "deepseek-v2-236b": 236e9, "qwen3-moe-235b-a22b": 235e9,
    "jamba-v0.1-52b": 52e9, "yi-34b": 34.4e9, "gemma-7b": 8.5e9,
    "qwen3-8b": 8.2e9, "llama3.2-1b": 1.24e9, "mamba2-780m": 0.78e9,
    "qwen2-vl-2b": 1.5e9, "seamless-m4t-large-v2": 2.0e9,
}


@pytest.mark.parametrize("arch_id", sorted(PUBLISHED))
def test_published_param_counts(arch_id):
    """Equal to the reference's count for every arch, and so within its
    10% of the published size."""
    arch, want = registry.get(arch_id), jregistry.get(arch_id)
    n = arch.model_module().param_count(arch.model)
    assert n == want.model_module().param_count(want.model)
    assert abs(n - PUBLISHED[arch_id]) / PUBLISHED[arch_id] < 0.10
