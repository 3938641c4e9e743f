"""The port's encoder-decoder (``repro_torch.models.encdec``,
seamless-m4t-large-v2) against the JAX package, on the CPU.

Weights are the reference's own ``encdec.init``, carried across with
``params_from_jax``; frames and tokens are made with numpy from a seed
and handed to both packages (the launcher's frames come from a torch
generator and go to the reference as numpy). Everything runs in fp32,
except the cross cache, which ``build_cross_cache`` makes in bf16 by
default in both packages (the engine's prefill takes the default).

Tolerances:
- memory, logits and fp32 caches across packages: 1e-4 absolute and
  relative, as ``tests/test_torch_lm.py`` (the same fp32 arithmetic in
  another order; the largest logit error seen was 2e-6). Over the bf16
  cross cache both packages round p and the attention output to bf16 at
  the same places, so the logits keep that bound;
- the bf16 cross cache itself: one bf16 step (2^-8 relative) besides
  1e-4: the memory differs in its last fp32 bits, which moves the
  rounding of an element that lies next to a bf16 boundary;
- decode against forward in one package: 2e-3, as
  ``tests/test_models.py::test_encdec_decode_matches_forward``.
Greedy tokens must be equal; parameter counts equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import encdec, layers
from repro_torch.serve import engine
from test_torch_lm import serve_on_a_fake_card

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"
BATCH, SRC, PROMPT = 2, 20, 12
_jinit = jax.jit(jencdec.init, static_argnums=0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(shape=(BATCH, SRC, 48), seed=2):
    return (0.5 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params) of seamless's smoke
    config (2 + 2 layers, d_model 48, GQA 4 over 2 heads of 12)."""
    jarch, tarch = (dataclasses.replace(r.get(ARCH), model=r.get(ARCH).smoke)
                    for r in (jregistry, registry))
    jp = _jinit(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, encdec.params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


# ---------------------------------------------------------------------------
# Config, sizes, parameters
# ---------------------------------------------------------------------------


def test_config_transcribes_the_reference():
    arch, want = registry.get(ARCH), jregistry.get(ARCH)
    assert (arch.family, arch.module, arch.notes, arch.frontend) == \
        (want.family, want.module, want.notes, want.frontend)
    assert arch.model_module() is encdec
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            else:
                assert got == exp, f.name
        assert cfg.padded_vocab == ref_cfg.padded_vocab


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_equal_reference(which):
    """Equal to the reference's; the published config within 10% of its
    2.0 B parameters."""
    cfg, ref = (getattr(r.get(ARCH), which) for r in (registry, jregistry))
    assert encdec.param_count(cfg) == jencdec.param_count(ref)
    if which == "model":
        assert abs(encdec.param_count(cfg) - 2.0e9) / 2.0e9 < 0.10


def test_params_carry_the_reference_tree(smoke):
    jarch, tarch, jp, tp = smoke
    shapes = layers.tree_map(lambda t: tuple(t.shape), tp)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert layers.tree_map(lambda s: s.shape,
                           encdec.param_specs(tarch.model)) == shapes
    mine = encdec.init(tarch.model, torch.Generator().manual_seed(0))
    assert layers.tree_map(lambda t: tuple(t.shape), mine) == shapes
    assert torch.equal(mine["ln_enc"], torch.ones(48))


def test_relu_is_the_references():
    x = np.linspace(-3, 3, 101, dtype=np.float32)
    _close(layers.ACTIVATIONS["relu"](torch.from_numpy(x)),
           jlayers.ACTIVATIONS["relu"](jnp.asarray(x)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# encode / forward / cross cache / decode against the reference
# ---------------------------------------------------------------------------


def test_encode_matches_reference(smoke):
    jarch, tarch, jp, tp = smoke
    frames = _frames()
    want = jencdec.encode(jp, jnp.asarray(frames), jarch.model)
    before = dict(LAUNCHES)
    got = encdec.encode(tp, torch.from_numpy(frames), tarch.model)
    assert dict(LAUNCHES) == before        # plain versions on the CPU
    assert got.shape == (BATCH, SRC, 48)
    _close(got, want)


def test_forward_matches_reference(smoke):
    """Teacher-forced logits (and aux 0) with a target shorter than the
    source: the cross-attention is non-causal at Sq != Skv."""
    jarch, tarch, jp, tp = smoke
    frames, toks = _frames(), _tokens((BATCH, PROMPT))
    want, want_aux = jencdec.forward(jp, jnp.asarray(frames),
                                     jnp.asarray(toks), jarch.model)
    got, aux = encdec.forward(tp, torch.from_numpy(frames),
                              torch.from_numpy(toks), tarch.model)
    assert got.shape == (BATCH, PROMPT, 512) and torch.isfinite(got).all()
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_build_cross_cache_matches_reference(smoke, dtype):
    """Every decoder layer's cross K/V from the memory, in ``dtype``:
    [n_dec, B, S_src, Hkv, D], replacing the cache's max_seq-long zeros;
    the self K/V are left as they were."""
    jarch, tarch, jp, tp = smoke
    frames = _frames()
    jmem = jencdec.encode(jp, jnp.asarray(frames), jarch.model)
    tmem = encdec.encode(tp, torch.from_numpy(frames), tarch.model)
    jcache = jencdec.init_cache(jarch.model, BATCH, 16, 32, jnp.float32)
    tcache = encdec.init_cache(tarch.model, BATCH, 16, 32, torch.float32, CPU)
    want = jencdec.build_cross_cache(jp, jmem, jarch.model, jcache,
                                     getattr(jnp, dtype))
    got = encdec.build_cross_cache(tp, tmem, tarch.model, tcache,
                                   getattr(torch, dtype))
    assert got["layers"]["self"] is tcache["layers"]["self"]
    tol = dict(rtol=2 ** -8, atol=1e-4) if dtype == "bfloat16" else TOL
    for name in ("k", "v"):
        cross = got["layers"]["cross"][name]
        assert cross.shape == (2, BATCH, SRC, 2, 12)
        assert cross.dtype == getattr(torch, dtype)
        _close(cross, want["layers"]["cross"][name], **tol)


def test_decode_steps_match_reference(smoke):
    """The engine's decode after its prefill's bf16 cross cache: each
    step's logits over the reference's greedy tokens (fp32 queries over
    the bf16 cross K/V in both packages), then the self cache."""
    jarch, tarch, jp, tp = smoke
    frames, toks = _frames(), _tokens((BATCH, PROMPT))
    max_seq = PROMPT + 6
    batch = {"frames": frames, "tokens": toks}
    jcache = jengine.make_cache(jarch, BATCH, max_seq, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, max_seq, torch.float32, CPU)
    want, jcache = jax.jit(jengine.make_prefill_fn(jarch))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    got, tcache = engine.make_prefill_fn(tarch)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcache)
    _close(got, want)
    assert tcache["layers"]["cross"]["k"].dtype == torch.bfloat16
    jdecode = jax.jit(jengine.make_decode_fn(jarch))
    tdecode = engine.make_decode_fn(tarch)
    tok = np.array(jnp.argmax(want[:, -1], axis=-1))[:, None]
    for pos in range(PROMPT, max_seq - 1):
        want, jcache = jdecode(jp, jnp.asarray(tok, jnp.int32), jcache,
                               jnp.int32(pos))
        got, tcache = tdecode(tp, torch.from_numpy(tok).int(), tcache, pos)
        assert got.dtype == torch.float32
        _close(got, want)
        tok = np.array(jnp.argmax(want, axis=-1))[:, None]
    for name in ("k", "v"):
        _close(tcache["layers"]["self"][name],
               jcache["layers"]["self"][name])


@pytest.mark.parametrize("side", ["port", "reference"])
def test_encdec_decode_matches_forward(side):
    """``tests/test_models.py::test_encdec_decode_matches_forward`` in
    each package, on the reference's weights, frames and tokens."""
    kw = dict(n_enc_layers=2, n_dec_layers=2, d_model=48, n_heads=4,
              n_kv_heads=2, head_dim=12, d_ff=96, vocab=130,
              vocab_pad_multiple=8)
    jcfg = jencdec.EncDecConfig("t", param_dtype=jnp.float32, **kw)
    p = _jinit(jcfg, jax.random.key(0))
    frames = np.array(0.5 * jax.random.normal(jax.random.key(1), (2, 20, 48)))
    toks = np.array(jax.random.randint(jax.random.key(2), (2, 12), 0, 130))
    if side == "port":
        cfg = encdec.EncDecConfig("t", param_dtype=torch.float32, **kw)
        p = encdec.params_from_jax(jax.tree.map(np.asarray, p), CPU)
        frames, toks = torch.from_numpy(frames), torch.from_numpy(toks)
        mod, stack, f32 = encdec, torch.stack, torch.float32
        cache = encdec.init_cache(cfg, 2, 16, 20, f32, CPU)
    else:
        cfg, mod, stack, f32 = jcfg, jencdec, jnp.stack, jnp.float32
        frames, toks = jnp.asarray(frames), jnp.asarray(toks)
        cache = jencdec.init_cache(cfg, 2, 16, 20, f32)
    logits, _ = mod.forward(p, frames, toks, cfg)
    memory = mod.encode(p, frames, cfg)
    cache = mod.build_cross_cache(p, memory, cfg, cache, f32)
    dec = []
    for t in range(6):
        lg, cache = mod.decode_step(p, toks[:, t:t + 1], cache, t, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :6])).max())
    assert err < 2e-3, err


def test_greedy_generate_raises(smoke):
    """As in the reference, ``greedy_generate`` serves no
    encoder-decoder: it has no frames to encode."""
    jarch, tarch, jp, tp = smoke
    prompts = _tokens((BATCH, 4))
    with pytest.raises(NotImplementedError):
        jengine.greedy_generate(jarch, jp, jnp.asarray(prompts), 2)
    with pytest.raises(NotImplementedError, match="make_prefill_fn"):
        engine.greedy_generate(tarch, tp, torch.from_numpy(prompts), 2)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _jax_encdec_launcher(params, frames, batch, prompt_len, new_tokens,
                         seed=0):
    """What ``repro.launch.serve.main --smoke`` computes for the
    encoder-decoder on ``params`` and ``frames`` (the reference draws
    its own frames from ``jax.random.key(1)``; these are the port's),
    without its host mesh: prompts, prefill and greedy decode, the cache
    in the params' dtype. Returns (prompts, tokens [B, new])."""
    arch = jregistry.get(ARCH)
    arch = dataclasses.replace(arch, model=arch.smoke)
    prompts = JSyntheticTokens(arch.model.vocab, batch, prompt_len,
                               seed=seed).next_batch()["tokens"]
    cache = jengine.make_cache(arch, batch, prompt_len + new_tokens,
                               dtype=arch.model.param_dtype)
    logits, cache = jax.jit(jengine.make_prefill_fn(arch))(
        params, {"tokens": prompts, "frames": jnp.asarray(frames)}, cache)
    decode = jax.jit(jengine.make_decode_fn(arch))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(new_tokens - 1):
        logits, cache = decode(params, tok, cache, jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(prompts), np.asarray(jnp.concatenate(out, axis=1))


def test_frames_are_the_launchers_seeded_draw():
    a = serve.encdec_frames(2, 8, 48, CPU)
    gen = torch.Generator().manual_seed(serve.FRAMES_SEED)
    assert a.dtype == torch.float32 and a.shape == (2, 8, 48)
    assert torch.equal(a, 0.1 * torch.randn((2, 8, 48), generator=gen))


def test_serve_launcher_on_cpu_matches_reference(capsys):
    """``launch.serve --arch seamless-m4t-large-v2 --smoke --device
    cpu``: the prompts and tokens of the reference's launcher on the
    same weights and frames."""
    before = dict(LAUNCHES)
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4"])
    assert dict(LAUNCHES) == before
    text = capsys.readouterr().out
    assert "# arch=seamless-smoke layers=2+2" in text
    assert "sample tokens:" in text
    params = encdec.init(registry.get(ARCH).smoke,
                         torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    frames = serve.encdec_frames(2, 8, 48, CPU).numpy()
    prompts, tokens = _jax_encdec_launcher(jparams, frames, 2, 8, 4)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)


def test_serve_layers_refuses_the_encoder_decoder(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--layers", "1"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("error: --layers") and "encoder-decoder" in err


def test_serve_smoke_takes_the_card(monkeypatch):
    """seamless's smoke config (head_dim 12, fp32; its decode over the
    bf16 cross cache) is served on a CUDA device: its attentions route to
    the fp32 flash kernel and the launcher goes on to build the model on
    the card."""
    routed, reached = serve_on_a_fake_card(monkeypatch,
                                           ["--arch", ARCH, "--smoke"])
    assert routed == [(12, 12, torch.float32, False)] and reached == "cuda"
