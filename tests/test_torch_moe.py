"""The port's MoE layer (``repro_torch.models.layers.moe_apply``) and the
MoE LM (qwen3-moe-235b-a22b) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
model weights are the reference's own ``init``, carried across with
``params_from_jax`` / ``tree_from_numpy``. Everything runs in fp32.

Tolerances:
- ``_top_k_dispatch`` on the same probabilities: bitwise equal (ties,
  padded rows and dropped tokens included);
- ``moe_apply`` outputs and aux loss, and the LM's logits and K/V
  caches across packages: 1e-4 absolute and relative, as
  ``tests/test_torch_dense_archs.py`` (the same fp32 arithmetic in
  another order). It holds only while both packages route every token
  to the same experts in the same slots, which the tests check first:
  the routing is discontinuous, and a router logit that differs in its
  last bit next to a tie would move a token (none does on these
  inputs);
- decode against forward in one package: 2e-2, as
  ``tests/test_models.py::test_moe_decode_matches_forward_high_capacity``.
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
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import layers, lm
from repro_torch.models.layers import MoEConfig, _top_k_dispatch
from repro_torch.serve import engine
from test_torch_ssm import _jax_launcher
from test_torch_lm import serve_on_a_fake_card

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-moe-235b-a22b"
BATCH, PROMPT, NEW = 2, 12, 6
#: the reference's ``lm.init``, compiled once per config (eager, it
#: compiles a draw per leaf shape)
_jinit = jax.jit(jlm.init, static_argnums=0)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _probs(g=2, s=32, e=8, seed=0):
    """Router probabilities [G, S, E] in fp32, softmax of normal logits."""
    logits = np.random.default_rng(seed).standard_normal((g, s, e))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def _moe(d=16, seed=0, **kw):
    """(JAX params, port params) of one MoE layer, the reference's init."""
    cfg = MoEConfig(**kw)
    jp = jlayers.init_params(
        jlayers.moe_specs(d, jlayers.MoEConfig(**kw), jnp.float32),
        jax.random.key(seed))
    return cfg, jp, layers.tree_from_numpy(jax.tree.map(np.asarray, jp), CPU)


# ---------------------------------------------------------------------------
# tests/test_moe.py, mirrored on the port
# ---------------------------------------------------------------------------


def test_dispatch_capacity_respected():
    dispatch, _ = _top_k_dispatch(torch.from_numpy(_probs()), top_k=2,
                                  capacity=4)
    per_expert = dispatch.sum(dim=(1, 3))                   # [G, E]
    assert bool((per_expert <= 4 + 1e-6).all())


def test_dispatch_one_position_per_assignment():
    dispatch, _ = _top_k_dispatch(torch.from_numpy(_probs()), top_k=2,
                                  capacity=64)
    # with ample capacity every token is dispatched exactly top_k times
    _close(dispatch.sum(dim=(2, 3)), np.full((2, 32), 2.0), atol=1e-6)
    # each (expert, slot) holds at most one token
    assert bool((dispatch.sum(dim=1) <= 1 + 1e-6).all())


def test_combine_weights_match_router_probs():
    probs = _probs()
    _, combine = _top_k_dispatch(torch.from_numpy(probs), top_k=2,
                                 capacity=64)
    got = combine.sum(dim=3).numpy()                        # [G, S, E]
    top = np.argsort(-probs, axis=-1, kind="stable")[..., :2]
    want = np.zeros_like(got)
    g, s, _ = probs.shape
    for gi in range(g):
        for si in range(s):
            for j in top[gi, si]:
                want[gi, si, j] += probs[gi, si, j]
    np.testing.assert_allclose(got, want, atol=1e-5)


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_moe_apply_zero_capacity_drops_gracefully():
    cfg = MoEConfig(n_experts=4, top_k=1, d_ff=16, group_size=8,
                    capacity_factor=0.25)
    p = layers.init_params(layers.moe_specs(16, cfg, torch.float32),
                           torch.Generator().manual_seed(0))
    x = _x((2, 16, 16))
    y, aux = layers.moe_apply(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))


def test_moe_tail_tokens_preserved():
    """Token count not divisible by group_size still returns all rows."""
    cfg = MoEConfig(n_experts=4, top_k=2, d_ff=16, group_size=10,
                    capacity_factor=8.0)
    p = layers.init_params(layers.moe_specs(16, cfg, torch.float32),
                           torch.Generator().manual_seed(0))
    y, _ = layers.moe_apply(p, _x((3, 9, 16)), cfg)            # 27 tokens
    assert y.shape == (3, 9, 16)
    assert bool(torch.isfinite(y).all())


def test_shared_expert_always_active():
    cfg = MoEConfig(n_experts=4, top_k=1, d_ff=16, n_shared=1,
                    group_size=8, capacity_factor=0.01)
    p = layers.init_params(layers.moe_specs(16, cfg, torch.float32),
                           torch.Generator().manual_seed(0))
    y, _ = layers.moe_apply(p, _x((2, 8, 16)), cfg)
    # with capacity ~0 every routed expert drops; shared path remains
    assert float(y.abs().sum()) > 0


@pytest.mark.parametrize("side", ["port", "reference"])
def test_moe_decode_matches_forward_high_capacity(side):
    """``tests/test_models.py::test_moe_decode_matches_forward_high_capacity``
    in each package, on the reference's weights and tokens."""
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128, vocab=300, vocab_pad_multiple=16)
    moe = dict(n_experts=8, top_k=2, d_ff=96, n_shared=1, group_size=64,
               capacity_factor=8.0)
    jcfg = jlm.LMConfig(moe=jlayers.MoEConfig(**moe),
                        param_dtype=jnp.float32, **kw)
    p = _jinit(jcfg, jax.random.key(0))
    toks = np.array(jax.random.randint(jax.random.key(1), (2, 12), 0, 300))
    if side == "port":
        cfg = lm.LMConfig(moe=MoEConfig(**moe), param_dtype=torch.float32,
                          **kw)
        p = lm.params_from_jax(jax.tree.map(np.asarray, p), CPU)
        toks = torch.from_numpy(toks)
        cache = lm.init_cache(cfg, 2, 16, torch.float32, CPU)
        mod, stack = lm, torch.stack
    else:
        cfg, mod, stack = jcfg, jlm, jnp.stack
        toks = jnp.asarray(toks)
        cache = jlm.init_cache(cfg, 2, 16, jnp.float32)
    logits, aux = mod.forward(p, toks, cfg)
    assert float(aux) > 0.0                      # balance loss is live
    dec = []
    for t in range(6):
        lg, cache = mod.decode_step(p, toks[:, t:t + 1], cache, t, cfg)
        dec.append(lg)
    err = float(np.abs(np.asarray(stack(dec, 1)) -
                       np.asarray(logits[:, :6])).max())
    assert err < 2e-2, err


# ---------------------------------------------------------------------------
# Against the reference's functions
# ---------------------------------------------------------------------------


def _tied_probs():
    """[2, 12, 6]: group 0 holds exact ties (probabilities from a few
    repeated logits, so equal values at several experts); group 1 is a
    padded tail group's shape: 5 real rows, then zero rows whose
    probabilities are uniform."""
    rng = np.random.default_rng(3)
    ties = rng.integers(0, 3, (12, 6)).astype(np.float32)
    tail = np.zeros((12, 6), np.float32)
    tail[:5] = rng.standard_normal((5, 6))
    logits = np.stack([ties, tail])
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("case,top_k,capacity", [
    ("random", 2, 64), ("random", 2, 4), ("random", 3, 5),
    ("ties", 2, 3), ("ties", 3, 8), ("ties", 1, 1)])
def test_top_k_dispatch_bitwise_equal_reference(case, top_k, capacity):
    """The same probabilities through both ``_top_k_dispatch``: equal
    dispatch and combine tensors, bit for bit. The tie cases would
    differ under ``torch.topk``'s unspecified tie order: the padded
    rows pick experts 0..k-1 and take capacity slots there."""
    probs = _probs(e=8, seed=5) if case == "random" else _tied_probs()
    if case == "ties":
        assert (probs[1, 5:] == probs[1, 5, 0]).all()     # uniform rows
        assert any(len(set(r)) < len(r) for r in probs[0].tolist())
    want_d, want_c = jlayers._top_k_dispatch(jnp.asarray(probs), top_k,
                                             capacity)
    got_d, got_c = _top_k_dispatch(torch.from_numpy(probs), top_k,
                                   capacity)
    assert got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    kept = got_d.sum().item()
    assert kept <= probs.shape[0] * probs.shape[1] * top_k
    if capacity * probs.shape[2] < probs.shape[1] * top_k:
        assert kept < probs.shape[0] * probs.shape[1] * top_k   # drops


def _routing(p: dict, x: np.ndarray, cfg: MoEConfig, side: str):
    """The (token, expert, slot) dispatch of ``moe_apply`` on ``x``:
    its router, softmax and ``_top_k_dispatch``, in one package."""
    b, s, m = x.shape
    gs = min(cfg.group_size, b * s)
    g = -(-b * s // gs)
    xt = np.zeros((g * gs, m), np.float32)
    xt[:b * s] = x.reshape(b * s, m)
    cap = max(1, int(np.ceil(gs * cfg.top_k * cfg.capacity_factor
                             / cfg.n_experts)))
    if side == "port":
        logits = torch.from_numpy(xt.reshape(g, gs, m)) @ p["router"]
        d, _ = _top_k_dispatch(torch.softmax(logits, -1), cfg.top_k, cap)
        return d.numpy()
    logits = jnp.asarray(xt.reshape(g, gs, m)) @ p["router"]
    d, _ = jlayers._top_k_dispatch(jax.nn.softmax(logits, -1), cfg.top_k,
                                   cap)
    return np.asarray(d)


@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_moe_apply_matches_reference(n_shared, capacity_factor):
    """``moe_apply`` on the reference's weights, 3 x 9 tokens in groups
    of 10 (a padded tail group), at a capacity that drops tokens (0.5,
    and 1.25 with top 2 of 4), and one that keeps them all: the same
    routing, then the output and the aux loss within ``TOL``."""
    kw = dict(n_experts=4, top_k=2, d_ff=24, n_shared=n_shared,
              group_size=10, capacity_factor=capacity_factor)
    cfg, jp, tp = _moe(d=16, **kw)
    x = np.random.default_rng(7).standard_normal((3, 9, 16)).astype(
        np.float32)
    d_port, d_ref = (_routing(p, x, cfg, side)
                     for p, side in ((tp, "port"), (jp, "reference")))
    np.testing.assert_array_equal(d_port, d_ref)
    # 3 groups of 10 rows (3 of them padding), 2 assignments a row
    assert (d_port.sum() < 60) == (capacity_factor < 8)    # tokens dropped
    want, want_aux = jlayers.moe_apply(jp, jnp.asarray(x),
                                       jlayers.MoEConfig(**kw))
    got, aux = layers.moe_apply(tp, torch.from_numpy(x), cfg)
    assert got.shape == (3, 9, 16) and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)


def test_router_runs_in_ieee_fp32():
    """The router product is fp32 whatever the process's matmul
    precision, which is restored after."""
    cfg, _, tp = _moe(d=16, n_experts=4, top_k=2, d_ff=8, group_size=8)
    x = _x((2, 4, 16))
    want, _ = layers.moe_apply(tp, x, cfg)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        got, _ = layers.moe_apply(tp, x, cfg)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# qwen3-moe-235b-a22b
# ---------------------------------------------------------------------------


def test_config_transcribes_the_reference():
    arch, want = registry.get(ARCH), jregistry.get(ARCH)
    assert (arch.family, arch.module, arch.notes) == \
        (want.family, want.module, want.notes)
    assert arch.model_module() is lm
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        for f in dataclasses.fields(ref_cfg):
            got, exp = getattr(cfg, f.name), getattr(ref_cfg, f.name)
            if f.name == "param_dtype":
                assert str(got).split(".")[-1] == jnp.dtype(exp).name
            elif f.name == "moe":
                assert dataclasses.asdict(got) == dataclasses.asdict(exp)
            else:
                assert got == exp, f.name


@pytest.mark.parametrize("which", ["model", "smoke"])
def test_param_counts_equal_reference(which):
    """``param_count`` and ``active_param_count`` from the specs alone,
    equal to the reference's; the published config within 10% of its
    235 B total and 22 B active parameters."""
    cfg, ref = (getattr(r.get(ARCH), which) for r in (registry, jregistry))
    assert lm.param_count(cfg) == jlm.param_count(ref)
    assert lm.active_param_count(cfg) == jlm.active_param_count(ref)
    if which == "model":
        assert abs(lm.param_count(cfg) - 235e9) / 235e9 < 0.10
        assert abs(lm.active_param_count(cfg) - 22e9) / 22e9 < 0.10


@pytest.fixture(scope="module")
def smoke():
    """(JAX arch, port arch, JAX params, port params) of qwen3-moe's
    smoke config (2 layers, d_model 64, 8 experts top 2, fp32)."""
    jarch, tarch = (dataclasses.replace(r.get(ARCH), model=r.get(ARCH).smoke)
                    for r in (jregistry, registry))
    jp = _jinit(jarch.model, jax.random.key(0))
    return jarch, tarch, jp, lm.params_from_jax(jax.tree.map(np.asarray, jp),
                                                CPU)


def _tokens(shape, vocab=512, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_smoke_params_carry_the_moe_tree(smoke):
    jarch, tarch, jp, tp = smoke
    shapes = layers.tree_map(lambda t: tuple(t.shape), tp)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert layers.tree_map(lambda s: s.shape, lm.param_specs(tarch.model)) \
        == shapes
    assert "mlp" not in tp["layers"] and tp["layers"]["moe"]["gate"].shape \
        == (2, 8, 64, 96)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32


def test_smoke_forward_matches_reference(smoke):
    """Logits and the summed aux loss of ``forward``."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((2, 24))
    want, want_aux = jlm.forward(jp, jnp.asarray(toks), jarch.model)
    before = dict(LAUNCHES)
    got, aux = lm.forward(tp, torch.from_numpy(toks), tarch.model)
    assert dict(LAUNCHES) == before        # plain versions on the CPU
    assert got.shape == (2, 24, 512) and torch.isfinite(got).all()
    assert float(aux) > 0
    _close(got, want)
    _close(aux, want_aux)


def test_smoke_prefill_and_decode_match_reference(smoke):
    """Prefill logits and K/V cache, then six decode steps' logits and
    the cache, against the reference's."""
    jarch, tarch, jp, tp = smoke
    toks = _tokens((BATCH, PROMPT + 6))
    jcache = jlm.init_cache(jarch.model, BATCH, PROMPT + 6, jnp.float32)
    tcache = lm.init_cache(tarch.model, BATCH, PROMPT + 6, torch.float32,
                           CPU)
    want, jcache = jlm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jcache,
                               jarch.model)
    got, tcache = lm.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), tcache,
                             tarch.model)
    _close(got, want)
    for i in range(PROMPT, PROMPT + 6):
        want, jcache = jlm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                       jcache, i, jarch.model)
        got, tcache = lm.decode_step(tp, torch.from_numpy(toks[:, i:i + 1]),
                                     tcache, i, tarch.model)
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
    """``launch.serve --arch qwen3-moe-235b-a22b --smoke --device cpu``:
    the prompts and tokens of the reference's launcher on the same
    weights (made by ``lm.init`` from ``--seed`` on the CPU's generator
    and handed to JAX as numpy)."""
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4"])
    assert "# arch=qwen3-moe-smoke layers=2" in capsys.readouterr().out
    params = lm.init(registry.get(ARCH).smoke,
                     torch.Generator().manual_seed(0))
    jparams = jax.tree.map(jnp.asarray,
                           layers.tree_map(lambda t: t.numpy(), params))
    prompts, tokens = _jax_launcher(ARCH, jparams, 2, 8, 4)
    np.testing.assert_array_equal(out["prompts"].numpy(), prompts)
    np.testing.assert_array_equal(out["tokens"].numpy(), tokens)


def test_serve_smoke_takes_the_card(monkeypatch):
    """qwen3-moe's smoke config (head_dim 16, fp32) is served on a CUDA
    device: its attention routes to the fp32 flash kernel and the
    launcher goes on to build the model on the card, as for the dense
    LMs."""
    routed, reached = serve_on_a_fake_card(monkeypatch,
                                           ["--arch", ARCH, "--smoke"])
    assert routed == [(16, 16, torch.float32, False)] and reached == "cuda"
