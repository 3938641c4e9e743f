"""The dense LM's features of qwen3-8b, gemma-7b and yi-34b in the port
against the JAX package, on the CPU: qk-norm, the tanh-approximate
gelu of gemma's GeGLU, the int8 KV cache, the three archs' smoke
configs, and the published configs' parameter counts.

Weights are the reference's own ``lm.init``, carried across with
``params_from_jax``; tokens and activations are made with numpy from a
seed. Everything runs in fp32.

Tolerances:
- logits, K/V caches and activations across packages: 1e-4 absolute
  and relative, as ``tests/test_torch_lm.py`` (the same fp32 arithmetic
  in another order: matmul blocking, the online softmax's chunks,
  exp/rsqrt/tanh/sin; the largest logit error seen was 2e-6);
- the int8 KV cache's codes and scales on the same K/V: equal (the
  scales are max|x|/127 in fp32, the codes round x / scale half to
  even in both packages). Through the model the K/V themselves differ
  in the last fp32 bits, so there the scales are held within 1e-6
  relative (1-2 ulps) and the codes equal;
- decode against forward in one package: 2e-3 (``tests/test_models.py
  ::test_lm_decode_matches_forward``), and the int8 cache within 6% of
  max |logit| (``::test_int8_kv_cache_decode_close_to_fp``).
Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import layers, lm, ssm
from repro_torch.serve import engine

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen3-8b", "gemma-7b", "yi-34b"]
BATCH, PROMPT, NEW = 2, 12, 6


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _dense(mod, **kw):
    """``tests/test_models.py::_dense_cfg`` in either package."""
    base = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab=300, vocab_pad_multiple=16,
                param_dtype=jnp.float32 if mod is jlm else torch.float32)
    base.update(kw)
    return mod.LMConfig(**base)


def _pair(**kw):
    """(JAX cfg, port cfg, JAX params, port params) of a small dense LM."""
    jcfg, tcfg = _dense(jlm, **kw), _dense(lm, **kw)
    jp = jlm.init(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, lm.params_from_jax(jax.tree.map(np.asarray, jp),
                                              CPU)


def _tokens(shape, vocab=300, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# Registry and configs
# ---------------------------------------------------------------------------


def test_registry_lists_the_six_archs():
    """The registry lists the reference's archs, all ten of them now,
    the dense ones among them; an unknown id raises naming them."""
    assert registry.list_archs() == jregistry.list_archs()
    assert set(ARCHS) < set(registry.list_archs())
    assert registry.get("deepseek-v2-236b").module == "lm"
    with pytest.raises(KeyError, match="unknown arch 'yi-35b'"):
        registry.get("yi-35b")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_config_transcribes_the_reference(arch_id):
    arch, want = registry.get(arch_id), jregistry.get(arch_id)
    assert (arch.family, arch.module, arch.notes) == \
        (want.family, want.module, want.notes)
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            else:
                assert got == exp, f.name
        assert cfg.padded_vocab == ref_cfg.padded_vocab
    assert arch.model_module() is lm


@pytest.mark.parametrize("arch_id", ARCHS + ["llama3.2-1b", "mamba2-780m"])
def test_published_param_counts(arch_id):
    """``tests/test_smoke_archs.py::test_published_param_counts`` for the
    five archs the port serves: equal to the reference's count, and so
    within its 10% of the published size."""
    published = {"yi-34b": 34.4e9, "gemma-7b": 8.5e9, "qwen3-8b": 8.2e9,
                 "llama3.2-1b": 1.24e9, "mamba2-780m": 0.78e9}
    arch, want = registry.get(arch_id), jregistry.get(arch_id)
    n = arch.model_module().param_count(arch.model)
    assert n == want.model_module().param_count(want.model)
    assert abs(n - published[arch_id]) / published[arch_id] < 0.10


# ---------------------------------------------------------------------------
# qk-norm, gelu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("side", ["port", "reference"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_lm_decode_matches_forward(qk_norm, side):
    """``tests/test_models.py::test_lm_decode_matches_forward`` in each
    package, on the reference's weights."""
    jcfg, tcfg, jp, tp = _pair(qk_norm=qk_norm)
    toks = _tokens((2, 16))
    if side == "port":
        cfg, p, t, mod, stack = tcfg, tp, torch.from_numpy(toks), lm, \
            torch.stack
        cache = lm.init_cache(cfg, 2, 24, torch.float32, CPU)
        assert ("q_norm" in p["layers"]["attn"]) == qk_norm
    else:
        cfg, p, t, mod, stack = jcfg, jp, jnp.asarray(toks), jlm, jnp.stack
        cache = jlm.init_cache(cfg, 2, 24, jnp.float32)
    logits, _ = mod.forward(p, t, cfg)
    dec = []
    for i in range(8):
        lg, cache = mod.decode_step(p, t[:, i:i + 1], cache, i, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :8])).max())
    assert err < 2e-3, err


@pytest.mark.parametrize("kw", [{"qk_norm": True}, {"act": "gelu"},
                                {"qk_norm": True, "act": "gelu",
                                 "tie_embeddings": True}],
                         ids=["qk_norm", "gelu", "both-tied"])
def test_prefill_and_decode_match_reference(kw):
    """Prefill logits and K/V cache (qk-norm is applied before RoPE and
    the cache write), then each decode step's logits, against the
    reference's."""
    jcfg, tcfg, jp, tp = _pair(**kw)
    toks = _tokens((BATCH, PROMPT + 4))
    jcache = jlm.init_cache(jcfg, BATCH, PROMPT + 4, jnp.float32)
    tcache = lm.init_cache(tcfg, BATCH, PROMPT + 4, torch.float32, CPU)
    want, jcache = jlm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jcache,
                               jcfg)
    got, tcache = lm.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), tcache,
                             tcfg)
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache["layers"][name], jcache["layers"][name])
    for i in range(PROMPT, PROMPT + 4):
        want, jcache = jlm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                       jcache, i, jcfg)
        got, tcache = lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                     tcache, i, tcfg)
        _close(got, want)


def test_gelu_is_the_references_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = layers.ACTIVATIONS["gelu"](torch.from_numpy(x))
    _close(got, jlayers.ACTIVATIONS["gelu"](jnp.asarray(x)), rtol=1e-6,
           atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((got - exact).abs().max()) > 1e-5     # not the erf form


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        lm.param_specs(_dense(lm, act="swish"))


# ---------------------------------------------------------------------------
# The int8 KV cache
# ---------------------------------------------------------------------------


def test_kv_quantizer_equals_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 9, 3, 16)) *
         rng.uniform(0.1, 4.0, (1, 1, 3, 1))).astype(np.float32)
    want_s = jlayers.kv_scale_from(jnp.asarray(x))
    got_s = layers.kv_scale_from(torch.from_numpy(x))
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # decode clips into the calibrated scales: values beyond them too
    for scale in (np.asarray(want_s), np.asarray(want_s) * 0.5):
        want = jlayers.quantize_kv(jnp.asarray(x), jnp.asarray(scale))
        got = layers.quantize_kv(torch.from_numpy(x),
                                 torch.from_numpy(scale.copy()))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_len", [1, 5, 12])
def test_int8_decode_attention_matches_reference(kv_len):
    rng = np.random.default_rng(kv_len)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    k = rng.integers(-127, 128, (2, 12, 2, 16)).astype(np.int8)
    v = rng.integers(-127, 128, (2, 12, 2, 16)).astype(np.int8)
    ks, vs = (rng.uniform(0.001, 0.05, (2, 2)).astype(np.float32)
              for _ in range(2))
    want = jlayers.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = layers.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    _close(got, want)


def test_int8_kv_cache_codes_and_scales_equal_reference():
    """Prefill calibrates per-(batch, head) scales and stores int8 codes;
    each decode step clips into those scales. The port's cache, every
    layer, equals the reference's after the prefill and after each step
    (codes equal, scales within 1-2 ulps), and the logits are within
    ``TOL``."""
    jcfg, tcfg, jp, tp = _pair(kv_cache_quant=True, qk_norm=True)
    toks = _tokens((BATCH, PROMPT + 4))
    jcache = jlm.init_cache(jcfg, BATCH, PROMPT + 4, jnp.float32)
    tcache = lm.init_cache(tcfg, BATCH, PROMPT + 4, torch.float32, CPU)
    assert tcache["layers"]["k"].dtype == torch.int8
    assert torch.equal(tcache["layers"]["k_scale"],
                       torch.ones((2, BATCH, 2)))
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), jcache) == \
        layers.tree_map(lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1]), tcache)

    def same_cache():
        for name in ("k", "v"):
            np.testing.assert_array_equal(tcache["layers"][name].numpy(),
                                          np.asarray(jcache["layers"][name]))
        for name in ("k_scale", "v_scale"):
            _close(tcache["layers"][name], jcache["layers"][name],
                   rtol=1e-6, atol=0)

    want, jcache = jlm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jcache,
                               jcfg)
    got, tcache = lm.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), tcache,
                             tcfg)
    _close(got, want)
    same_cache()
    for i in range(PROMPT, PROMPT + 4):
        want, jcache = jlm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                       jcache, i, jcfg)
        got, tcache = lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                     tcache, i, tcfg)
        _close(got, want)
        same_cache()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_int8_kv_cache_decode_close_to_fp(side):
    """``tests/test_models.py::test_int8_kv_cache_decode_close_to_fp`` in
    each package, on the reference's weights."""
    jcfg, tcfg, jp, tp = _pair(kv_cache_quant=True)
    toks = _tokens((2, 24))
    if side == "port":
        cfg, p, t, mod, stack = tcfg, tp, torch.from_numpy(toks), lm, \
            torch.stack
        cache = lm.init_cache(cfg, 2, 32, torch.float32, CPU)
        assert cache["layers"]["k"].dtype == torch.int8
    else:
        cfg, p, t, mod, stack = jcfg, jp, jnp.asarray(toks), jlm, jnp.stack
        cache = jlm.init_cache(cfg, 2, 32, jnp.float32)
    logits, _ = mod.forward(p, t, cfg)
    _, cache = mod.prefill(p, t[:, :8], cache, cfg)
    dec = []
    for i in range(8, 12):
        lg, cache = mod.decode_step(p, t[:, i:i + 1], cache, i, cfg)
        dec.append(lg)
    want = np.asarray(logits[:, 8:12])
    rel = float(np.abs(np.asarray(stack(dec, 1)) - want).max()) / \
        float(np.abs(want).max())
    assert rel < 0.06, rel


# ---------------------------------------------------------------------------
# The three archs' smoke configs
# ---------------------------------------------------------------------------


def _smoke(arch_id):
    jarch, tarch = (dataclasses.replace(r.get(arch_id),
                                        model=r.get(arch_id).smoke)
                    for r in (jregistry, registry))
    jp = jlm.init(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, lm.params_from_jax(jax.tree.map(np.asarray, jp),
                                                CPU)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_smoke_forward(arch_id):
    """``tests/test_smoke_archs.py::test_smoke_forward``: shape, finite,
    and the reference's logits on its weights."""
    jarch, tarch, jp, tp = _smoke(arch_id)
    toks = _tokens((2, 24), jarch.model.vocab)
    want, _ = jlm.forward(jp, jnp.asarray(toks), jarch.model)
    got, aux = lm.forward(tp, torch.from_numpy(toks), tarch.model)
    assert got.shape == (2, 24, tarch.model.vocab)
    assert torch.isfinite(got).all() and torch.isfinite(aux)
    _close(got, want)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_smoke_decode_step(arch_id):
    """``tests/test_smoke_archs.py::test_smoke_decode_step`` against the
    reference's logits and cache."""
    jarch, tarch, jp, tp = _smoke(arch_id)
    jcache = jlm.init_cache(jarch.model, 2, 16, jnp.float32)
    tcache = lm.init_cache(tarch.model, 2, 16, torch.float32, CPU)
    want, jcache = jlm.decode_step(jp, jnp.zeros((2, 1), jnp.int32), jcache,
                                   0, jarch.model)
    got, tcache = lm.decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                                 tcache, 0, tarch.model)
    assert got.shape == (2, tarch.model.vocab) and torch.isfinite(got).all()
    _close(got, want)
    _close(tcache["layers"]["k"], jcache["layers"]["k"])


@pytest.mark.parametrize("arch_id", ARCHS)
def test_smoke_greedy_tokens_equal_reference(arch_id):
    jarch, tarch, jp, tp = _smoke(arch_id)
    prompts = _tokens((BATCH, PROMPT), jarch.model.vocab, seed=2)
    want = jengine.greedy_generate(jarch, jp, jnp.asarray(prompts), NEW)
    before = dict(LAUNCHES)
    got = engine.greedy_generate(tarch, tp, torch.from_numpy(prompts), NEW)
    assert dict(LAUNCHES) == before        # plain versions on the CPU
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ssm_configs_are_the_references():
    arch, want = registry.get("mamba2-780m"), jregistry.get("mamba2-780m")
    assert arch.model_module() is ssm
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(ref_cfg.ssm)
        assert ssm.param_count(cfg) == jssm.param_count(ref_cfg)
