"""Training in the port (``repro_torch.train``, ``parallel.compress``,
``launch.train``, the models' ``remat``, the flash kernel's gradient
route) against the JAX package, on the CPU. One train step of every
arch's smoke config is in ``tests/test_torch_train_archs.py``.

Weights are the reference's own ``init``, carried across with the
models' ``params_from_jax`` (or the port's, carried the other way as
numpy); batches, gradients and trees are made with numpy from a seed
and handed to both packages. Every smoke config is fp32.

Tolerances:
- the optimizer, clipping and schedule on the same trees: 1e-6
  relative (the same fp32 formulas; JAX and torch may round a power or
  a cosine one ulp apart);
- ``compress_int8``: codes bitwise equal, scales bitwise equal (a max, a
  division by 127 and a round half to even, each exact or correctly
  rounded in both);
- gradients of the hetero-quant LM and of the plain attention against
  ``jax.grad``: 1e-4 of the gradient's max |.| (the same fp32 products
  summed in another order; the straight-through forms pass the same
  cotangents);
- ``remat`` "none" / "full" / "dots": equal gradients, bitwise (the
  recomputed forward repeats the same CPU arithmetic);
- the launcher's logged losses, |g| and lr against the reference loop's
  on the same weights: 1e-3 absolute on the printed values (printed to
  4 and 3 decimals).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.parallel import compress as jcompress
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.data.synthetic import make_host_batch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, lm
from repro_torch.parallel import compress
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from test_torch_attention import _load

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# optimizer, clipping, schedule (tests/test_train_infra.py:30-51)
# ---------------------------------------------------------------------------


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"layers": {"w": rng.standard_normal((3, 4, 5)).astype(
        np.float32), "b": rng.standard_normal((5,)).astype(np.float32)},
        "embed": rng.standard_normal((7, 4)).astype(np.float32)}
    grads = jax.tree.map(
        lambda p: (3 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    return params, grads


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = opt.adamw_init(w)
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=100)
    l0 = float(torch.sum(w["w"] ** 2))
    for _ in range(50):
        g = {"w": 2 * w["w"]}
        w, state, _ = opt.adamw_update(w, g, state, cfg)
    assert float(torch.sum(w["w"] ** 2)) < 0.05 * l0


def test_adamw_steps_match_reference():
    """Five AdamW steps on the same trees (matrix and vector leaves, so
    the decay applies to some only), past warm-up and clipping."""
    params, grads = _trees()
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jp, js = params, jopt.adamw_init(params)
    tp = layers.tree_from_numpy(params, CPU)
    ts = opt.adamw_init(tp)
    for i in range(5):
        g = jax.tree.map(lambda x: x * (1.0 + 0.3 * i), grads)
        jp, js, jm = jopt.adamw_update(jp, g, js, jopt.AdamWConfig(**cfg))
        tp, ts, tm = opt.adamw_update(tp, layers.tree_from_numpy(g, CPU), ts,
                                      opt.AdamWConfig(**cfg))
        _rel(tm["grad_norm"], jm["grad_norm"], 1e-6)
        _rel(tm["lr"], jm["lr"], 1e-6)
    assert int(ts.count) == int(js.count) == 5
    for a, b in zip(layers.tree_leaves(tp), jax.tree.leaves(jp)):
        _rel(a, b, 1e-6)
    for a, b in zip(layers.tree_leaves(ts.m) + layers.tree_leaves(ts.v),
                    jax.tree.leaves(js.m) + jax.tree.leaves(js.v)):
        assert a.dtype == torch.float32
        _rel(a, b, 1e-6)


def test_adamw_keeps_bf16_params_and_fp32_moments():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
         "s": torch.ones((4,), dtype=torch.bfloat16)}
    st = opt.adamw_init(p)
    new, st, _ = opt.adamw_update(p, {k: torch.full_like(v, 0.5)
                                      for k, v in p.items()}, st,
                                  opt.AdamWConfig(lr=0.1, warmup_steps=0))
    assert new["w"].dtype == torch.bfloat16 and st.m["w"].dtype == \
        torch.float32 and st.count.dtype == torch.int32
    # decoupled decay on the matrix only
    assert float(new["w"][0, 0]) < float(new["s"][0])


def test_grad_clip():
    g = {"a": torch.full((4,), 10.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(torch.sqrt(torch.sum(clipped["a"] ** 2))) == \
        pytest.approx(1.0, rel=1e-5)
    params, grads = _trees(1)
    jc, jn = jopt.clip_by_global_norm(grads, 1.0)
    tc, tn = opt.clip_by_global_norm(layers.tree_from_numpy(grads, CPU), 1.0)
    _rel(tn, jn, 1e-6)
    for a, b in zip(layers.tree_leaves(tc), jax.tree.leaves(jc)):
        _rel(a, b, 1e-6)


def test_cosine_schedule_shape():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    jcfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    steps = (0, 5, 10, 55, 100, 150)
    lrs = [float(opt.cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)
    want = [float(jopt.cosine_schedule(jcfg, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# gradient compression (tests/test_train_infra.py:59-76)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 3e4)])
def test_compress_int8_codes_bitwise(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(1000) * scale).astype(np.float32)
    g[:4] = [0.5, 1.5, -2.5, 0.0]          # ties of the rounding, scaled
    codes, s = compress.compress_int8(torch.from_numpy(g))
    jcodes, js = jcompress.compress_int8(jnp.asarray(g))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    err = (compress.decompress_int8(codes, s) - torch.from_numpy(g)).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-7 * scale


def test_error_feedback_accumulates_to_zero_bias():
    """EF property: sum of (decompressed) over steps -> sum of true
    grads (the residual carries what was lost); and each step's output
    and residual equal the reference's."""
    rng = np.random.default_rng(1)
    grads = [(rng.standard_normal(64) * 1e-3).astype(np.float32)
             for _ in range(32)]
    state = compress.init_compression_state({"g": torch.from_numpy(grads[0])})
    jstate = jcompress.init_compression_state({"g": jnp.asarray(grads[0])})
    sent_total = torch.zeros(64)
    true_total = torch.zeros(64)
    for g in grads:
        out, state = compress.compressed_grad_allreduce(
            {"g": torch.from_numpy(g)}, state)
        jout, jstate = jcompress.compressed_grad_allreduce(
            {"g": jnp.asarray(g)}, jstate)
        np.testing.assert_array_equal(out["g"].numpy(), np.asarray(jout["g"]))
        np.testing.assert_array_equal(state.residual["g"].numpy(),
                                      np.asarray(jstate.residual["g"]))
        sent_total += out["g"]
        true_total += torch.from_numpy(g)
    np.testing.assert_allclose((sent_total + state.residual["g"]).numpy(),
                               true_total.numpy(), atol=1e-5)


def test_compressed_allreduce_over_an_axis_waits_for_the_parallel_layer():
    """An all-reduce over a named axis needs a mesh: without one it
    raises, never running locally in its place (the all-reduce itself is
    held on 4 ranks in tests/test_torch_parallel_compress.py)."""
    state = compress.init_compression_state({"g": torch.zeros(3)})
    with pytest.raises(ValueError, match="needs a mesh"):
        compress.compressed_grad_allreduce({"g": torch.zeros(3)}, state,
                                           axis_name="pod")


def test_compression_ratio():
    g = {"a": torch.zeros(100), "b": torch.zeros(10, dtype=torch.bfloat16)}
    want = jcompress.compression_ratio({"a": jnp.zeros(100),
                                        "b": jnp.zeros(10, jnp.bfloat16)})
    assert compress.compression_ratio(g) == pytest.approx(want)


def test_hetero_quant_lm_trains():
    """tests/test_models.py::test_hetero_quant_lm_trains mirrored: the
    port's gradients of the fake-quantized LM against ``jax.grad``."""
    kw = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              head_dim=16, d_ff=128, vocab=300, vocab_pad_multiple=16)
    jcfg = jlm.LMConfig(**kw, param_dtype=jnp.float32,
                        hetero_quant=jlm.HeteroQuantConfig(
                            w_bits_lut=8, a_bits=8, ratio=0.5))
    tcfg = lm.LMConfig(**kw, param_dtype=torch.float32,
                       hetero_quant=lm.HeteroQuantConfig(
                           w_bits_lut=8, a_bits=8, ratio=0.5))
    jp = jlm.init(jcfg, jax.random.key(0))
    toks = np.random.default_rng(1).integers(0, 300, (2, 16)).astype(
        np.int32)

    def jloss(p):
        lg, _ = jlm.forward(p, jnp.asarray(toks), jcfg)
        return jnp.mean((lg[:, :-1] - jax.nn.one_hot(toks[:, 1:], 300)) ** 2)

    jg = jax.grad(jloss)(jp)
    tp = lm.params_from_jax(_np_tree(jp), CPU)
    leaves = [p.requires_grad_() for p in layers.tree_leaves(tp)]
    lg, _ = lm.forward(tp, torch.from_numpy(toks), tcfg)
    loss = torch.mean((lg[:, :-1] - torch.nn.functional.one_hot(
        torch.from_numpy(toks[:, 1:]).long(), 300).float()) ** 2)
    tg = torch.autograd.grad(loss, leaves)
    norms = [float(g.abs().sum()) for g in tg]
    assert all(np.isfinite(norms)) and sum(norms) > 0
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("arch_id", ["llama3.2-1b", "seamless-m4t-large-v2",
                                     "mamba2-780m", "jamba-v0.1-52b"])
def test_remat_policies_give_equal_grads(arch_id):
    """``remat`` "none", "full" and (the LM's) "dots" checkpoint each
    layer differently and give the same gradients, bitwise."""
    arch = registry.get(arch_id)
    batch = make_host_batch(arch, batch=2, seq=24)
    policies = ("none", "full", "dots") if arch.module == "lm" \
        else ("none", "full")
    grads = []
    for policy in policies:
        a = dataclasses.replace(arch, model=dataclasses.replace(
            arch.smoke, remat=policy))
        params = a.model_module().init(a.model,
                                       torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_() for p in layers.tree_leaves(params)]
        loss, _ = tstep.make_loss_fn(a)(params, batch)
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)


def test_remat_saves_fewer_tensors():
    """"full" keeps each layer's input only: the autograd graph of a
    forward holds fewer saved activations than with "none"."""
    arch = registry.get("llama3.2-1b")
    batch = make_host_batch(arch, batch=2, seq=24)
    saved = {}
    for policy in ("none", "full"):
        a = dataclasses.replace(arch, model=dataclasses.replace(
            arch.smoke, remat=policy))
        params = lm.init(a.model, torch.Generator().manual_seed(0))
        for p in layers.tree_leaves(params):
            p.requires_grad_()
        n = [0]

        def pack(t, n=n):
            n[0] += t.numel()
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tstep.make_loss_fn(a)(params, batch)
        saved[policy] = n[0]
    assert saved["full"] < saved["none"]


# ---------------------------------------------------------------------------
# attention gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv,causal,off,qc,kc", [
    (2, 40, 40, 4, 4, 16, 16, True, 0, 16, 16),     # causal, chunks
    (2, 33, 21, 4, 2, 16, 16, False, 0, 16, 8),     # non-causal, ragged
    (1, 37, 37, 6, 2, 8, 8, True, 0, 512, 16),      # GQA, ragged
    (2, 9, 50, 4, 2, 16, 16, True, 41, 8, 16),      # kv_offset > 0
    (1, 24, 24, 2, 2, 24, 16, True, 0, 8, 8),       # keys 24 over values 16
    (1, 20, 20, 2, 2, 192, 128, True, 0, 8, 16),    # MLA's (192, 128)
    (1, 19, 19, 2, 2, 256, 256, True, 0, 8, 16),    # gemma's (256, 256)
    (2, 30, 30, 4, 2, 12, 12, False, 0, 16, 8),     # seamless smoke's 12
    (1, 26, 40, 4, 4, 32, 32, True, 14, 8, 16),     # gemma smoke's 32
])
def test_plain_attention_grads_match_jax(b, sq, skv, hq, hkv, d, dv, causal,
                                         off, qc, kc):
    """Autograd through the plain version against ``jax.grad`` of the
    reference's ``blockwise_attention`` (fp32)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dv)).astype(np.float32)
    w = rng.standard_normal((b, sq, hq, dv)).astype(np.float32)

    def jloss(q, k, v):
        out = jlayers.blockwise_attention(q, k, v, causal=causal,
                                          q_chunk=qc, kv_chunk=kc,
                                          kv_offset=off)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    got = flash_attention_bwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(w), causal=causal, kv_offset=off, q_chunk=qc,
        kv_chunk=kc)
    for a, bb in zip(got, want):
        bb = np.asarray(bb)
        np.testing.assert_allclose(a.numpy(), bb, rtol=0,
                                   atol=1e-4 * np.abs(bb).max())


def test_plain_lse_is_the_logsumexp():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 30, 4, 16), (2, 30, 2, 16), (2, 30, 2, 16)))
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, q_chunk=8,
                                        kv_chunk=8, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 4.0
    s = s.masked_fill(torch.ones(30, 30).triu(1).bool(), -1e30)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, causal=True,
                                                     q_chunk=8, kv_chunk=8))


@pytest.mark.parametrize("sq,skv,off", [(100, 400, 300), (256, 257, 1)])
def test_bwd_row_check_sees_a_key_one_short(sq, skv, off):
    """``chip_smoke.py``'s per-row check of the backward kernel passes the
    bf16 plain version against fp32 (another rounding of every product)
    and fails a causal limit one key short."""
    smoke = _load("chip_smoke")
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in
        ((2, sq, 4, 64), (2, skv, 2, 64), (2, skv, 2, 64), (2, sq, 4, 64)))
    good = flash_attention_bwd_plain(q, k, v, do, causal=True, kv_offset=off,
                                     q_chunk=64, kv_chunk=64)
    exact = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      do.float(), causal=True, kv_offset=off)
    short = flash_attention_bwd_plain(q, k, v, do, causal=True,
                                      kv_offset=off - 1)
    for g, e, s in zip(good, exact, short):
        assert smoke.bwd_row_err(g, e) <= smoke.BWD_ROW_TOL
        assert smoke.bwd_row_err(s, g) > smoke.BWD_ROW_TOL


def test_bwd_entry_args_fill_the_signatures():
    """The wrapper's arguments fill each C entry point's signature in
    ``build.SOURCES`` (the stream comes last)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention_bwd import ENTRY_POINTS, \
        entry_args
    q, out, dout, dq = (torch.zeros(2, 40, 8, 64, dtype=torch.bfloat16)
                        for _ in range(4))
    k, v, dk, dv = (torch.zeros(2, 50, 2, 64, dtype=torch.bfloat16)
                    for _ in range(4))
    lse, delta = torch.zeros(2, 8, 40), torch.zeros(2, 8, 40)
    args = entry_args(q, k, v, out, dout, lse, delta, dq, dk, dv, 0.125,
                      True, 10)
    assert set(args) == set(ENTRY_POINTS)
    for name, a in args.items():
        assert len(a) == len(build.SOURCES["flash_attention_bwd"][name]) - 1
    assert args["flash_attention_bwd_dkdv"][8:15] == (2, 40, 50, 8, 2, 64,
                                                      64)
    assert args["flash_attention_bwd_dq"][8:15] == (2, 40, 50, 8, 2, 64, 64)
    assert args["flash_attention_bwd_dq"][3] == out.data_ptr()
    assert args["flash_attention_bwd_dq"][-3:] == (0.125, 1, 10)
    assert args["flash_attention_bwd_dkdv"][-3:] == (0.125, 1, 10)


@pytest.mark.parametrize("d,dv,dtype,kv", [
    (64, 128, torch.bfloat16, None),
    (96, 96, torch.float32, None),
    (16, 16, torch.float32, torch.bfloat16),
])
def test_kernel_route_raises_where_a_gradient_has_no_kernel(d, dv, dtype,
                                                            kv):
    """On CUDA inputs that need a gradient, a (key, value) pair with no
    backward instantiation (bf16 outside the four pairs, fp32 past 64),
    or fp32 queries over a bf16 cache, raises at forward time: the
    gradient is never dropped and never falls back to the plain version.
    Serving keeps the forward where one exists (fp32 over a bf16 cache)."""
    with pytest.raises(NotImplementedError):
        fa.kernel_route(d, dv, dtype, needs_grad=True, kv_dtype=kv)
    if kv is not None:
        assert fa.kernel_route(d, dv, dtype, False, kv_dtype=kv) == "forward"
    else:
        with pytest.raises(NotImplementedError):
            fa.kernel_route(d, dv, dtype, needs_grad=False)


@pytest.mark.parametrize("d", [64, 128])
def test_kernel_route_takes_the_autograd_function(d):
    assert fa.kernel_route(d, d, torch.bfloat16, needs_grad=True) == \
        "autograd"
    assert fa.kernel_route(d, d, torch.bfloat16, needs_grad=False) == \
        "forward"
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fa.kernel_route(d, d, torch.float16, needs_grad=True)
    # fp32 goes to the fp32 kernel up to head size 64
    if d <= fa.F32_MAX_HEAD:
        assert fa.kernel_route(d, d, torch.float32, True) == "autograd"
    else:
        with pytest.raises(NotImplementedError, match="fp32"):
            fa.kernel_route(d, d, torch.float32, needs_grad=True)


def _registry_pairs():
    """(arch id, config, path, (key, value) head sizes, dtype) for every
    flash launch a published or smoke config of the registry makes:
    serving, and training at 8193 tokens (where the dense LMs and the
    hybrid reach the kernels too)."""
    from repro_torch.launch import serve
    out = []
    for arch_id in registry.list_archs():
        arch = registry.get(arch_id)
        for which in ("published", "smoke"):
            cfg = arch.model if which == "published" else arch.smoke
            a = dataclasses.replace(arch, model=cfg)
            for path, heads in (("serve", serve.flash_heads(a)),
                                ("train", launch_train.train_flash_heads(
                                    a, 8193))):
                if heads is not None:
                    out.append((arch_id, which, path, heads,
                                cfg.param_dtype))
    return out


def test_kernel_route_takes_every_registry_pair():
    """Every (key, value) pair and dtype the registry's configs send,
    served or trained, has a kernel: bf16 at the published pairs, the
    fp32 kernel at the smoke ones; none is refused, and the list covers
    the pairs the launchers used to refuse."""
    pairs = _registry_pairs()
    seen = set()
    for arch_id, which, path, (d, dv), dtype in pairs:
        route = fa.kernel_route(d, dv, dtype, needs_grad=path == "train")
        assert route == ("autograd" if path == "train" else "forward")
        assert dtype == (torch.bfloat16 if which == "published"
                         else torch.float32), (arch_id, which)
        seen.add((d, dv, dtype))
    assert {(192, 128, torch.bfloat16), (256, 256, torch.bfloat16),
            (12, 12, torch.float32), (24, 16, torch.float32),
            (16, 16, torch.float32), (32, 32, torch.float32),
            (8, 8, torch.float32)} <= seen
    assert {p[3] for p in pairs if p[1] == "published"} <= \
        set(fa.BWD_HEAD_DIMS)


def test_cpu_attention_keeps_its_gradient():
    """On CPU tensors the call is the plain version, whose autograd is
    the gradient (no kernel launch)."""
    q, k, v = (torch.randn(1, 20, 2, 16, requires_grad=True)
               for _ in range(3))
    before = dict(LAUNCHES)
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert dict(LAUNCHES) == before


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

_LINE = re.compile(r"step\s+(\d+)\s+loss (\S+)\s+\|g\| (\S+)\s+lr (\S+)")


def _logged(text):
    return {int(m[0]): tuple(map(float, m[1:])) for m in _LINE.findall(text)}


def _reference_loop(arch_id, params, steps, batch, seq, seed=0, lr=3e-4):
    """What ``repro.launch.train.main --smoke`` computes on ``params``,
    without its host mesh: the same data stream, optimizer and step.
    Returns {step: (loss, |g|, lr)} at every step."""
    arch = jregistry.get(arch_id)
    arch = dataclasses.replace(arch, model=arch.smoke)
    step_fn = jax.jit(jstep.make_train_step(
        arch, jopt.AdamWConfig(lr=lr, total_steps=steps)))
    data = JSyntheticTokens(arch.model.vocab, batch, seq, seed=seed)
    state = jstep.init_train_state(params)
    out = {}
    for i in range(steps):
        state, m = step_fn(state, data.next_batch())
        out[i + 1] = (float(m["loss"]), float(m["grad_norm"]),
                      float(m["lr"]))
    return out


def test_train_launcher_on_cpu_matches_reference(capsys, tmp_path):
    """``--device cpu --smoke``: the logged losses, |g| and lr of every
    step equal the reference loop's on the same weights (the launcher's
    own, made from ``--seed``), and a second run with more steps resumes
    from the checkpoint."""
    args = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--log-every",
            "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    res = launch_train.main(args)
    text = capsys.readouterr().out
    got = _logged(text)
    assert sorted(got) == [1, 2, 3, 4] and int(res["state"].step) == 4
    cfg = registry.get("llama3.2-1b").smoke
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    want = _reference_loop("llama3.2-1b", jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), params), 4, 2, 16)
    for s in got:
        np.testing.assert_allclose(got[s], want[s], atol=1e-3, rtol=0)
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")
                  ) == [2, 4]
    assert (tmp_path / "heartbeat.json").exists()
    res2 = launch_train.main(args[:-4] + ["--steps", "6", "--ckpt-dir",
                                          str(tmp_path)])
    text = capsys.readouterr().out
    assert "# resumed from checkpoint step 4" in text
    assert sorted(_logged(text)) == [5, 6] and res2["start"] == 4
    assert int(res2["state"].step) == 6


def test_train_launcher_encdec_on_cpu():
    res = launch_train.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                             "--device", "cpu", "--steps", "2", "--batch",
                             "2", "--seq", "12", "--log-every", "1"])
    assert int(res["state"].step) == 2
    assert all(np.isfinite(float(m["loss"])) for m in res["metrics"])


@pytest.mark.parametrize("arch_id,heads", [
    ("seamless-m4t-large-v2", (12, 12)),
    ("deepseek-v2-236b", (24, 16)),
])
def test_train_smoke_takes_the_card(monkeypatch, arch_id, heads):
    """A smoke config whose attentions reach the flash kernels (fp32, head
    sizes 12 / (24, 16)) trains on a CUDA device: the launcher routes its
    heads to the fp32 kernels and goes on to train, card or no card here
    (the training itself is stubbed)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    routed, trained = [], []

    def route(*a, **k):
        routed.append((a, k))
        return fa.kernel_route(*a, **k)
    monkeypatch.setattr(launch_train, "kernel_route", route)
    monkeypatch.setattr(launch_train, "_train",
                        lambda args, arch, device, dist: trained.append(
                            (arch.model.name, device.type, dist)) or {})
    assert launch_train.main(["--arch", arch_id, "--smoke"]) == {}
    assert routed == [((*heads, torch.float32), {"needs_grad": True})]
    assert trained == [(registry.get(arch_id).smoke.name, "cuda", False)]


def test_train_refuses_a_pair_without_a_kernel(monkeypatch):
    """A config whose head size no kernel takes (fp32 at 96) raises in
    the launcher before anything is built; no launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    base = registry.get("seamless-m4t-large-v2")
    odd = dataclasses.replace(base, smoke=dataclasses.replace(
        base.smoke, head_dim=96))
    monkeypatch.setattr(launch_train.registry, "get", lambda _: odd)
    monkeypatch.setattr(launch_train, "_train", lambda *a: pytest.fail(
        "the launcher trained a config no kernel takes"))
    before = dict(LAUNCHES)
    with pytest.raises(NotImplementedError, match=r"\(96, 96\)"):
        launch_train.main(["--arch", "seamless-m4t-large-v2", "--smoke"])
    assert dict(LAUNCHES) == before


def test_train_flash_heads():
    get = registry.get
    assert launch_train.train_flash_heads(get("seamless-m4t-large-v2"),
                                          256) == (64, 64)
    assert launch_train.train_flash_heads(get("llama3.2-1b"), 2048) is None
    assert launch_train.train_flash_heads(get("llama3.2-1b"), 8193) == \
        (64, 64)
    assert launch_train.train_flash_heads(get("deepseek-v2-236b"), 16) == \
        (192, 128)
    assert launch_train.train_flash_heads(get("mamba2-780m"), 10 ** 6) is None


def test_train_production_mesh_exits_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as exc:
        launch_train.main(["--arch", "llama3.2-1b", "--production-mesh"])
    assert exc.value.code == 2
    assert "needs 256 devices" in capsys.readouterr().err


def test_train_launcher_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--arch", "llama3.2-1b", "--smoke"])
