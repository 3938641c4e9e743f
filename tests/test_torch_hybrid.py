"""The port's Jamba hybrid (``repro_torch.models.hybrid``) and its serving
path against the JAX package, on the CPU.

jamba-v0.1-52b's smoke config (one period of 8 layers: 7 Mamba, 1
attention, 4 MoE and 4 dense FFNs; d_model 64, fp32) is built with the
reference's ``hybrid.init`` and carried across with ``params_from_jax``,
so both packages compute the same function on the same weights; tokens
are made with numpy from a seed. Everything runs in fp32.

Tolerances:
- logits, aux loss and caches across packages: 1e-4 absolute and
  relative, as ``tests/test_torch_dense_archs.py`` (the same fp32
  arithmetic in another order: einsum order, exp, softplus, rsqrt),
  with every MoE sublayer routing alike in both (a routing difference
  would show as an error far above it);
- decode against forward in one package: 2e-3, as
  ``tests/test_models.py::test_hybrid_decode_matches_forward``.
Greedy tokens must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import hybrid, layers, ssm
from repro_torch.serve import engine
from test_torch_ssm import _jax_launcher

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "jamba-v0.1-52b"
BATCH, PROMPT, NEW = 2, 10, 6
#: the reference's ``hybrid.init``, compiled once per config (eager, it
#: compiles a draw per leaf shape: 9 s at the smoke config)
_jinit = jax.jit(jhybrid.init, static_argnums=0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params)."""
    jarch, tarch = (dataclasses.replace(r.get(ARCH), model=r.get(ARCH).smoke)
                    for r in (jregistry, registry))
    jp = _jinit(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, hybrid.params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


def test_config_transcribes_the_reference():
    arch, want = registry.get(ARCH), jregistry.get(ARCH)
    assert (arch.family, arch.module, arch.notes) == \
        (want.family, want.module, want.notes)
    assert arch.model_module() is hybrid and ARCH in registry.list_archs()
    assert (hybrid.PERIOD, hybrid.ATTN_POS, hybrid.MOE_POS) == \
        (jhybrid.PERIOD, jhybrid.ATTN_POS, jhybrid.MOE_POS)
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            elif f.name in ("ssm", "moe"):
                assert dataclasses.asdict(got) == dataclasses.asdict(exp)
            else:
                assert got == exp, f.name


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_equal_reference(which):
    """``param_count`` and ``active_param_count`` from the specs alone,
    equal to the reference's; the published config within 10% of
    Jamba's 52 B total and 12 B active parameters."""
    cfg, ref = (getattr(r.get(ARCH), which) for r in (registry, jregistry))
    assert hybrid.param_count(cfg) == jhybrid.param_count(ref)
    assert hybrid.active_param_count(cfg) == jhybrid.active_param_count(ref)
    if which == "model":
        assert abs(hybrid.param_count(cfg) - 52e9) / 52e9 < 0.10
        assert abs(hybrid.active_param_count(cfg) - 12e9) / 12e9 < 0.10


def test_params_carry_the_reference_tree(smoke):
    """``init`` and ``params_from_jax`` give the reference's tree: periods
    stacked, then the Mamba / MoE / MLP sublayers, the same shapes, the
    reference's init laws (``a_log`` / ``dt_bias`` zeros, ``d_skip`` ones,
    the router fp32)."""
    jarch, tarch, jp, tp = smoke
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert layers.tree_map(lambda t: tuple(t.shape), tp) == shapes
    params = hybrid.init(tarch.model, torch.Generator().manual_seed(0))
    assert layers.tree_map(lambda t: tuple(t.shape), params) == shapes
    period = params["periods"]
    assert period["mamba"]["ssm"]["wz"].shape == (1, 7, 64, 128)
    assert period["moe"]["ffn"]["gate"].shape == (1, 4, 4, 64, 96)
    assert period["mlp"]["ffn"]["gate"].shape == (1, 4, 64, 128)
    assert period["moe"]["ffn"]["router"].dtype == torch.float32
    for name, fill in (("a_log", 0), ("dt_bias", 0), ("d_skip", 1)):
        assert torch.equal(period["mamba"]["ssm"][name],
                           torch.full_like(period["mamba"]["ssm"][name],
                                           fill))


@pytest.mark.parametrize("side", ["port", "reference"])
def test_hybrid_decode_matches_forward(side):
    """``tests/test_models.py::test_hybrid_decode_matches_forward`` in each
    package, on the reference's weights and tokens."""
    kw = dict(n_layers=8, d_model=48, n_heads=4, n_kv_heads=2, head_dim=12,
              d_ff=96, vocab=130, vocab_pad_multiple=8)
    scfg = dict(d_model=48, d_inner=96, head_dim=16, d_state=16, chunk=16)
    moe = dict(n_experts=4, top_k=2, d_ff=64, group_size=32,
               capacity_factor=8.0)
    jcfg = jhybrid.HybridConfig(
        "t", ssm=jssm.SSMConfig(**scfg), moe=jlayers.MoEConfig(**moe),
        param_dtype=jnp.float32, **kw)
    p = _jinit(jcfg, jax.random.key(0))
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 12), 0, 130))
    if side == "port":
        cfg = hybrid.HybridConfig(
            "t", ssm=ssm.SSMConfig(**scfg), moe=layers.MoEConfig(**moe),
            param_dtype=torch.float32, **kw)
        p = hybrid.params_from_jax(jax.tree.map(np.asarray, p), CPU)
        toks = torch.from_numpy(toks)
        cache = hybrid.init_cache(cfg, 2, 16, torch.float32, CPU)
        mod, stack, step = hybrid, torch.stack, hybrid.decode_step
    else:
        cfg, mod, stack = jcfg, jhybrid, jnp.stack
        toks = jnp.asarray(toks)
        cache = jhybrid.init_cache(cfg, 2, 16, jnp.float32)
        step = jax.jit(jhybrid.decode_step, static_argnums=4)
    logits, _ = mod.forward(p, toks, cfg)
    dec = []
    for t in range(6):
        lg, cache = step(p, toks[:, t:t + 1], cache, t, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :6])).max())
    assert err < 2e-3, err


def test_forward_matches_reference(smoke):
    """Logits and the four MoE sublayers' summed aux loss; no kernel
    launches (the prompt's attention is ``dense_attention``)."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((2, 24))
    want, want_aux = jhybrid.forward(jp, jnp.asarray(toks), jarch.model)
    before = dict(LAUNCHES)
    got, aux = hybrid.forward(tp, torch.from_numpy(toks), tarch.model)
    assert dict(LAUNCHES) == before
    assert got.shape == (2, 24, 512) and torch.isfinite(got).all()
    assert float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


def test_decode_steps_match_reference(smoke):
    """Six decode steps from the empty cache: each step's logits, then
    every period's SSM states, conv windows and KV cache (the port's
    written in place)."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((BATCH, 6), seed=4)
    jcache = jhybrid.init_cache(jarch.model, BATCH, 8, jnp.float32)
    tcache = hybrid.init_cache(tarch.model, BATCH, 8, torch.float32, CPU)
    assert layers.tree_map(lambda t: tuple(t.shape), tcache) == \
        jax.tree.map(lambda a: tuple(a.shape), jcache)
    jdecode = jax.jit(jengine.make_decode_fn(jarch))
    tdecode = engine.make_decode_fn(tarch)
    for t in range(6):
        want, jcache = jdecode(jp, jnp.asarray(toks[:, t:t + 1]), jcache,
                               jnp.int32(t))
        got, same = tdecode(tp, torch.from_numpy(toks[:, t:t + 1]), tcache,
                            t)
        assert same is tcache
        _close(got, want)
    period, jperiod = tcache["periods"], jcache["periods"]
    for k in ("state", "conv"):
        _close(period["mamba"][k], jperiod["mamba"][k])
    for k in ("k", "v"):
        _close(period["attn"][k], jperiod["attn"][k])
    assert float(period["attn"]["k"][:, :, 6:].abs().max()) == 0


def test_greedy_tokens_equal_reference(smoke):
    """``engine.greedy_generate`` builds the state and the KV cache token
    by token through decode, as the reference's does for the hybrid."""
    jarch, tarch, jp, tp = smoke
    prompts = _tokens((BATCH, PROMPT), seed=2)
    want = jengine.greedy_generate(jarch, jp, jnp.asarray(prompts), NEW)
    got = engine.greedy_generate(tarch, tp, torch.from_numpy(prompts), NEW)
    assert got.dtype == torch.int32 and got.shape == (BATCH, PROMPT + NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_scores_the_prompt_and_keeps_the_cache(smoke):
    jarch, tarch, jp, tp = smoke
    prompts = _tokens((BATCH, PROMPT), seed=3)
    tcache = engine.make_cache(tarch, BATCH, 16, torch.float32, CPU)
    assert tcache["periods"]["attn"]["k"].shape == (1, BATCH, 16, 2, 16)
    logits, same = engine.make_prefill_fn(tarch)(
        tp, {"tokens": torch.from_numpy(prompts)}, tcache)
    assert same is tcache
    assert all(float(t.abs().max()) == 0 for t in
               (tcache["periods"]["mamba"]["state"],
                tcache["periods"]["attn"]["k"]))
    want, _ = jengine.make_prefill_fn(jarch)(
        jp, {"tokens": jnp.asarray(prompts)},
        jengine.make_cache(jarch, BATCH, 16, jnp.float32))
    _close(logits, want)


def test_serve_launcher_on_cpu_matches_reference(capsys):
    """``launch.serve --arch jamba-v0.1-52b --smoke --device cpu``: the
    prompts and tokens of the reference's launcher on the same weights
    (made by ``hybrid.init`` from ``--seed`` on the CPU's generator and
    handed to JAX as numpy). As in the reference, prefill scores the
    prompt and leaves the states and the KV cache empty, so decode
    starts from them (ROADMAP queue 3, entry 7)."""
    before = dict(LAUNCHES)
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "5"])
    assert dict(LAUNCHES) == before
    assert "# arch=jamba-smoke layers=8" in capsys.readouterr().out
    smoke_cfg = registry.get(ARCH).smoke
    params = hybrid.init(smoke_cfg, torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    prompts, tokens = _jax_launcher(ARCH, jparams, 2, 8, 5)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)
    # the empty-state quirk: the second token is decoded at position 8
    # from empty states and an empty KV cache
    empty = hybrid.init_cache(smoke_cfg, 2, 13, torch.float32, CPU)
    step, _ = hybrid.decode_step(params, out["tokens"][:, :1], empty, 8,
                                 smoke_cfg)
    np.testing.assert_array_equal(torch.argmax(step, -1).numpy(),
                                  out["tokens"][:, 1].numpy())


@pytest.mark.parametrize("argv", [["--layers", "7"],
                                  ["--smoke", "--layers", "4"]],
                         ids=["published", "smoke"])
def test_serve_layers_must_be_whole_periods(capsys, argv):
    """A hybrid's ``--layers`` not a multiple of its 8-layer period exits
    2 with an ``error:`` line before anything is built, card or no
    card."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, *argv])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert err.startswith("error: --layers") and "periods of 8" in err


def test_serve_smoke_takes_the_card(monkeypatch):
    """jamba's smoke config reaches no flash kernel (its attention is
    ``dense_attention``), so ``--smoke`` is not refused on a CUDA device:
    the launcher goes on to the CUDA check (here, with no card, its
    error)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", ARCH, "--smoke", "--layers", "8"])
    assert str(exc.value.code).startswith("error: CUDA is not available")
