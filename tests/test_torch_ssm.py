"""The port's Mamba2 (``repro_torch.models.ssm``) and its serving path
against the JAX package, on the CPU.

The inputs are made with numpy from a seed and handed to both
packages; the models' weights are the reference's own ``ssm.init``,
carried across with ``params_from_jax``, so both compute the same
function on the same numbers. Everything runs in fp32.

Tolerances:
- the SSD functions (``ssd_chunked``, ``ssd_step``, ``_causal_conv``,
  ``block_apply``) and the LM's logits: 1e-5 absolute and relative.
  The two sides run the same fp32 arithmetic in another order (einsum
  contraction order, exp, softplus, rsqrt): a few fp32 ulps per op on
  values of magnitude ~1-5 (the largest logit error seen was 1.4e-6);
- the chunked form against the step-by-step recurrence in one package:
  1e-4, as ``tests/test_models.py::test_ssd_chunked_equals_stepwise``;
- decode logits against the forward's in one package: 1e-3, as
  ``tests/test_models.py::test_ssm_lm_decode_matches_forward``.
Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import layers, ssm
from repro_torch.serve import engine

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH, PROMPT, NEW = 2, 10, 6


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ssd_inputs(seed=0, b=2, s=40, h=4, p=8, g=2, n=16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    bb = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, bb, c


def _ssd_cfgs(h=4, p=8, g=2, n=16, chunk=16):
    kw = dict(d_model=32, d_inner=h * p, head_dim=p, d_state=n, n_groups=g,
              chunk=chunk)
    return jssm.SSMConfig(**kw), ssm.SSMConfig(**kw)


@pytest.mark.parametrize("s,chunk", [(40, 16), (32, 32), (7, 16)],
                         ids=["ragged", "one-chunk", "short"])
def test_ssd_chunked_matches_reference(s, chunk):
    x, dt, a, b, c = _ssd_inputs(s=s)
    jcfg, tcfg = _ssd_cfgs(chunk=chunk)
    init = np.random.default_rng(9).standard_normal(
        (2, 4, 8, 16)).astype(np.float32)
    for st in (None, init):
        want_y, want_fin = jssm.ssd_chunked(
            *map(jnp.asarray, (x, dt, a, b, c)), jcfg,
            initial_state=None if st is None else jnp.asarray(st))
        got_y, got_fin = ssm.ssd_chunked(
            *map(_t, (x, dt, a, b, c)), tcfg,
            initial_state=None if st is None else _t(st))
        _close(got_y, want_y)
        _close(got_fin, want_fin)


def test_ssd_step_matches_reference():
    x, dt, a, b, c = _ssd_inputs(s=1)
    state = np.random.default_rng(4).standard_normal(
        (2, 4, 8, 16)).astype(np.float32)
    want_y, want_st = jssm.ssd_step(jnp.asarray(x[:, 0]),
                                    jnp.asarray(dt[:, 0]), jnp.asarray(a),
                                    jnp.asarray(b[:, 0]),
                                    jnp.asarray(c[:, 0]), jnp.asarray(state))
    got_y, got_st = ssm.ssd_step(_t(x[:, 0]), _t(dt[:, 0]), _t(a),
                                 _t(b[:, 0]), _t(c[:, 0]), _t(state))
    _close(got_y, want_y)
    _close(got_st, want_st)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_ssd_chunked_equals_stepwise(side):
    """``tests/test_models.py::test_ssd_chunked_equals_stepwise`` in each
    package."""
    x, dt, a, b, c = _ssd_inputs()
    jcfg, tcfg = _ssd_cfgs()
    if side == "port":
        mod, cfg, conv, stack = ssm, tcfg, _t, torch.stack
        st = torch.zeros((2, 4, 8, 16))
    else:
        mod, cfg, conv, stack = jssm, jcfg, jnp.asarray, jnp.stack
        st = jnp.zeros((2, 4, 8, 16))
    x, dt, a, b, c = map(conv, (x, dt, a, b, c))
    y, fin = mod.ssd_chunked(x, dt, a, b, c, cfg)
    ys = []
    for t in range(x.shape[1]):
        yt, st = mod.ssd_step(x[:, t], dt[:, t], a, b[:, t], c[:, t], st)
        ys.append(yt)
    np.testing.assert_allclose(np.asarray(y), np.asarray(stack(ys, 1)),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(fin), np.asarray(st), atol=1e-4)


@pytest.mark.parametrize("with_window", [False, True])
def test_causal_conv_matches_reference(with_window):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    win = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_window else None
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if win is None else jnp.asarray(win))
    got = ssm._causal_conv(_t(x), _t(w), None if win is None else _t(win))
    _close(got, want)


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params, prompts numpy) of
    mamba2-780m's smoke config (2 layers, d_model 64, 8 heads of 16,
    d_state 32, chunk 32, fp32)."""
    jarch, tarch = (dataclasses.replace(r.get("mamba2-780m"),
                                        model=r.get("mamba2-780m").smoke)
                    for r in (jregistry, registry))
    jparams = jssm.init(jarch.model, jax.random.key(0))
    tparams = ssm.params_from_jax(jax.tree.map(np.asarray, jparams), CPU)
    prompts = np.array(JSyntheticTokens(jarch.model.vocab, BATCH, 40,
                                        seed=0).next_batch()["tokens"])
    return jarch, tarch, jparams, tparams, prompts


def test_block_apply_matches_reference(smoke):
    """One Mamba2 block, scan form and one decode step from a non-zero
    state and window (both updated in place in the port)."""
    jarch, tarch, jparams, tparams, _ = smoke
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["ssm"])
    tp = {k: v[0] for k, v in tparams["layers"]["ssm"].items()}
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 12, 64)).astype(np.float32)
    want, _ = jssm.block_apply(jp, jnp.asarray(u), jarch.model.ssm)
    got, none = ssm.block_apply(tp, _t(u), tarch.model.ssm)
    assert none is None
    _close(got, want)
    specs = ssm.block_cache_specs(tarch.model.ssm, 2, torch.float32)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.3
             for k, s in specs.items()}
    want, want_cache = jssm.block_apply(
        jp, jnp.asarray(u[:, :1]), jarch.model.ssm,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: _t(v.copy()) for k, v in cache.items()}
    got, got_cache = ssm.block_apply(tp, _t(u[:, :1]), tarch.model.ssm,
                                     cache=tcache)
    assert got_cache is tcache
    _close(got, want)
    for k in ("state", "conv"):
        _close(tcache[k], want_cache[k])


def test_param_specs_and_init_follow_the_reference(smoke):
    jarch, tarch, jparams, _, _ = smoke
    params = ssm.init(tarch.model, torch.Generator().manual_seed(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert layers.tree_map(lambda t: tuple(t.shape), params) == shapes
    # the a_log / dt_bias law: the same values up to the fp32 ulps of
    # two linspace / exp / expm1 / log implementations
    for name in ("a_log", "dt_bias"):
        _close(params["layers"]["ssm"][name],
               jparams["layers"]["ssm"][name], rtol=1e-5, atol=1e-6)
    assert torch.equal(params["layers"]["ssm"]["d_skip"],
                       torch.ones_like(params["layers"]["ssm"]["d_skip"]))
    assert params["layers"]["ssm"]["a_log"].dtype == torch.float32
    wz = params["layers"]["ssm"]["wz"]
    assert abs(float(wz.std()) * tarch.model.d_model ** 0.5 - 1.0) < 0.05
    for name in ("mamba2-780m",):
        assert ssm.param_count(registry.get(name).model) == \
            jssm.param_count(jregistry.get(name).model)


def test_forward_matches_reference(smoke):
    jarch, tarch, jparams, tparams, prompts = smoke
    want, _ = jssm.forward(jparams, jnp.asarray(prompts), jarch.model)
    before = dict(LAUNCHES)
    got, aux = ssm.forward(tparams, torch.from_numpy(prompts), tarch.model)
    assert dict(LAUNCHES) == before
    assert got.shape == (BATCH, 40, 512) and float(aux) == 0.0
    _close(got, want)


def test_decode_steps_match_reference(smoke):
    """Each decode step's logits and the recurrent cache, from the empty
    state, against the reference's on the same tokens."""
    jarch, tarch, jparams, tparams, prompts = smoke
    jcache = jengine.make_cache(jarch, BATCH, 0, jnp.float32)
    tcache = engine.make_cache(tarch, BATCH, 0, torch.float32, CPU)
    jdecode = jax.jit(jengine.make_decode_fn(jarch))
    tdecode = engine.make_decode_fn(tarch)
    for t in range(6):
        tok = prompts[:, t:t + 1]
        want, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                               jnp.int32(t))
        got, tcache = tdecode(tparams, torch.from_numpy(tok), tcache, t)
        _close(got, want)
    for k in ("state", "conv"):
        _close(tcache["layers"][k], jcache["layers"][k])


@pytest.mark.parametrize("side", ["port", "reference"])
def test_ssm_lm_decode_matches_forward(side):
    """``tests/test_models.py::test_ssm_lm_decode_matches_forward`` in
    each package, on the reference's weights and tokens."""
    kw = dict(n_layers=2, d_model=32, vocab=120, vocab_pad_multiple=8)
    scfg = dict(d_model=32, d_inner=64, head_dim=16, d_state=16, chunk=16)
    jcfg = jssm.SSMLMConfig("t", ssm=jssm.SSMConfig(**scfg),
                            param_dtype=jnp.float32, **kw)
    p = jssm.init(jcfg, jax.random.key(0))
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 12), 0, 120))
    if side == "port":
        cfg = ssm.SSMLMConfig("t", ssm=ssm.SSMConfig(**scfg),
                              param_dtype=torch.float32, **kw)
        p = ssm.params_from_jax(jax.tree.map(np.asarray, p), CPU)
        toks = torch.from_numpy(toks)
        logits, _ = ssm.forward(p, toks, cfg)
        cache = ssm.init_cache(cfg, 2, dtype=torch.float32, device=CPU)
        mod, stack = ssm, torch.stack
    else:
        cfg, mod, stack = jcfg, jssm, jnp.stack
        logits, _ = jssm.forward(p, jnp.asarray(toks), cfg)
        cache = jssm.init_cache(cfg, 2, dtype=jnp.float32)
    dec = []
    for t in range(8):
        lg, cache = mod.decode_step(p, toks[:, t:t + 1], cache, t, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :8])).max())
    assert err < 1e-3, err


def test_greedy_tokens_equal_reference(smoke):
    """``engine.greedy_generate`` builds the state token by token through
    decode, as the reference's does for the recurrent family."""
    jarch, tarch, jparams, tparams, prompts = smoke
    p = prompts[:, :PROMPT]
    want = jengine.greedy_generate(jarch, jparams, jnp.asarray(p), NEW)
    got = engine.greedy_generate(tarch, tparams, torch.from_numpy(p), NEW)
    assert got.dtype == torch.int32 and got.shape == (BATCH, PROMPT + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_scores_the_prompt_and_keeps_the_cache(smoke):
    jarch, tarch, jparams, tparams, prompts = smoke
    tcache = engine.make_cache(tarch, BATCH, 99, torch.float32, CPU)
    zeros = {k: torch.zeros_like(v) for k, v in tcache["layers"].items()}
    logits, same = engine.make_prefill_fn(tarch)(
        tparams, {"tokens": torch.from_numpy(prompts)}, tcache)
    assert same is tcache
    for k, v in zeros.items():
        assert torch.equal(tcache["layers"][k], v)
    want, _ = jengine.make_prefill_fn(jarch)(
        jparams, {"tokens": jnp.asarray(prompts)},
        jengine.make_cache(jarch, BATCH, 99, jnp.float32))
    _close(logits, want)


def _jax_launcher(arch_id, params, batch, prompt_len, new_tokens, seed=0):
    """What ``repro.launch.serve.main --smoke`` computes on ``params``,
    without its host mesh (whose sharding constraints this JAX version
    refuses on the CPU): the reference's prompts, prefill and greedy
    decode, the cache in the params' dtype. Returns (prompts, tokens
    [B, new])."""
    arch = jregistry.get(arch_id)
    arch = dataclasses.replace(arch, model=arch.smoke)
    prompts = JSyntheticTokens(arch.model.vocab, batch, prompt_len,
                               seed=seed).next_batch()["tokens"]
    cache = jengine.make_cache(arch, batch, prompt_len + new_tokens,
                               dtype=arch.model.param_dtype)
    logits, cache = jax.jit(jengine.make_prefill_fn(arch))(
        params, {"tokens": prompts}, cache)
    decode = jax.jit(jengine.make_decode_fn(arch))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(new_tokens - 1):
        logits, cache = decode(params, tok, cache,
                               jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(prompts), np.asarray(jnp.concatenate(out, axis=1))


def test_serve_launcher_on_cpu_matches_reference(capsys):
    """``launch.serve --arch mamba2-780m --smoke --device cpu``: the
    prompts and tokens of the reference's launcher on the same weights
    (the launcher's, made by ``ssm.init`` from ``--seed`` on the CPU's
    generator and handed to JAX as numpy). As in the reference, prefill
    scores the prompt and leaves the state empty, so decode starts from
    the zero state (ROADMAP queue 3, entry 7, open in the reference)."""
    before = dict(LAUNCHES)
    out = serve.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "5"])
    assert dict(LAUNCHES) == before
    text = capsys.readouterr().out
    for line in ("# arch=mamba2-780m-smoke", "prefill:", "decode:",
                 "sample tokens:"):
        assert line in text
    params = ssm.init(registry.get("mamba2-780m").smoke,
                      torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    prompts, tokens = _jax_launcher("mamba2-780m", jparams, 2, 8, 5)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)
    # the zero-state quirk: the first generated token is the prompt's
    # last logits' argmax, the second is decoded from the empty state
    empty = engine.make_cache(
        dataclasses.replace(registry.get("mamba2-780m"),
                            model=registry.get("mamba2-780m").smoke),
        2, 0, torch.float32, CPU)
    step, _ = ssm.decode_step(params, out["tokens"][:, :1], empty, 8,
                              registry.get("mamba2-780m").smoke)
    np.testing.assert_array_equal(
        torch.argmax(step, -1).numpy(), out["tokens"][:, 1].numpy())


def test_serve_smoke_takes_the_card_without_flash(monkeypatch):
    """mamba2-780m reaches no flash kernel, so ``--smoke`` is not refused
    on a CUDA device: the launcher goes on to the CUDA check (here, with
    no card, its error)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "mamba2-780m", "--smoke"])
    assert str(exc.value.code).startswith("error: CUDA is not available")
