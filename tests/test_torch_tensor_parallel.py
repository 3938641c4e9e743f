"""Tensor parallelism over the mesh's "model" axis: every model module's
smoke config on gloo CPU ranks, against the one-process port and the
JAX package's single-device functions.

Archs: llama3.2-1b (dense GQA), deepseek-v2-236b (MLA and MoE with a
dense first layer and shared experts), qwen2-vl-2b (M-RoPE, precomputed
patch embeddings, and its rule overrides: the query split by rows over
"model", not by heads), mamba2-780m (ssm), jamba-v0.1-52b (hybrid:
attention, Mamba and MoE sublayers) and seamless-m4t-large-v2
(encoder-decoder). Meshes: (1, 2) on 2 ranks and (2, 2) on 4, over
("data", "model"); and llama3.2-1b on (1, 4), where the smoke config's
2 KV heads of 16 do not divide over "model" while the K / V weights'
32 columns do: the projections come out split inside a head and are
gathered whole before the attention (``layers.head_layout``). The
weights are the reference's ``init``, carried across by
``params_from_jax`` and sharded by ``shard_params_tree``; the batch is
the reference's ``make_host_batch`` (2 x 24), handed to both
packages. The ranks run (``tests/_torch_ranks.py::tp_body``): the
forward, the serving path (``serve_steps``), the loss and its gradients
gathered, and one ``make_train_step`` step.

Tolerances (every smoke config is fp32): against the one-process port,
logits within 1e-5 of their max |logit| (the sums over split heads and
columns are taken in another order), the loss within 1e-6 relative,
each gradient, first moment and updated parameter within 1e-4 of its
leaf's max (gradients and moments) or 1e-6 (parameters: a step of lr
3e-6); the encoder-decoder's decode logits within 2^-6 of their max (its
cross cache is bf16, and a K / V entry computed in another order can
round to the neighbouring bf16 value). Against JAX: the tolerances the
one-process port meets in the families' own test files (logits and
metrics 1e-4 relative and absolute; params 1e-5 absolute; moments 1e-4
of the leaf's max; the bf16 cross cache as above).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import registry as jregistry
from repro.data.synthetic import make_host_batch as jmake_host_batch
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.train import step as tstep
from repro_torch.train.optimizer import AdamWConfig

ARCHS = ["llama3.2-1b", "deepseek-v2-236b", "qwen2-vl-2b", "mamba2-780m",
         "jamba-v0.1-52b", "seamless-m4t-large-v2"]
MESHES = {"1x2": ((1, 2), 2), "2x2": ((2, 2), 4)}
#: the split-head case: llama3.2-1b's smoke config (4 query heads, 2 KV
#: heads of 16) on a "model" axis of 4
SPLIT_HEAD = ("llama3.2-1b", (1, 4))
B, S = 2, 24
LOGIT_TOL = 1e-5
BF16_CROSS_TOL = 2 ** -6
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def _arch(arch_id, reg=registry):
    a = reg.get(arch_id)
    return dataclasses.replace(a, model=a.smoke)


@functools.lru_cache(maxsize=None)
def _inputs(arch_id):
    """The reference's initial params and host batch, as numpy."""
    jarch = _arch(arch_id, jregistry)
    jp = jax.jit(jarch.model_module().init, static_argnums=0)(
        jarch.model, jax.random.key(0))
    batch = jmake_host_batch(jregistry.get(arch_id), batch=B, seq=S)
    return (jax.tree.map(np.asarray, jp),
            {k: np.asarray(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def split_head(tmp_path_factory):
    arch_id, shape = SPLIT_HEAD
    tmp = tmp_path_factory.mktemp("tp1x4")
    _torch_ranks.run_ranks(_torch_ranks.tp_body, 4, tmp, shape,
                           [(arch_id, *_inputs(arch_id))], timeout=300)
    return "1x4", _torch_ranks.load(tmp / "tp_1x4.pt")


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, tmp_path_factory):
    shape, world = MESHES[request.param]
    tmp = tmp_path_factory.mktemp(f"tp{request.param}")
    cases = [(a, *_inputs(a)) for a in ARCHS]
    _torch_ranks.run_ranks(_torch_ranks.tp_body, world, tmp, shape, cases,
                           timeout=300)
    return request.param, _torch_ranks.load(tmp / f"tp_{request.param}.pt")


@functools.lru_cache(maxsize=None)
def _port(arch_id):
    """The one-process port on the same inputs."""
    arch = _arch(arch_id)
    mod, cfg = arch.model_module(), arch.model
    np_params, np_batch = _inputs(arch_id)
    params = mod.params_from_jax(np_params, "cpu")
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    if arch.module == "encdec":
        logits, aux = mod.forward(params, batch["frames"], batch["tokens"],
                                  cfg)
    elif arch.module == "lm":
        logits, aux = mod.forward(params, batch["tokens"], cfg,
                                  extra_embed=batch.get("extra_embed"))
    else:
        logits, aux = mod.forward(params, batch["tokens"], cfg)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = tstep.make_loss_fn(arch)(tree_unflatten(params, leaves),
                                       batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    new, metrics = tstep.make_train_step(
        arch, AdamWConfig(lr=3e-4, total_steps=1))(
            tstep.init_train_state(params), batch)
    return {"logits": logits, "aux": aux,
            "serve": _torch_ranks.serve_steps(arch, params, batch),
            "loss": loss.detach(),
            "grads": [torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, grads)],
            "metrics": metrics, "params": tree_leaves(new.params),
            "moments": tree_leaves(new.opt.m)}


@functools.lru_cache(maxsize=None)
def _jax(arch_id):
    """The JAX package's single-device functions on the same inputs:
    the forward, the same serving steps, one jitted train step."""
    jarch = _arch(arch_id, jregistry)
    mod, cfg = jarch.model_module(), jarch.model
    np_params, np_batch = _inputs(arch_id)
    p = jax.tree.map(jnp.asarray, np_params)
    tok = jnp.asarray(np_batch["tokens"])
    serve = {}
    if jarch.module == "encdec":
        frames = jnp.asarray(np_batch["frames"])
        logits, aux = jax.jit(lambda p: mod.forward(p, frames, tok, cfg))(p)
        cache = mod.init_cache(cfg, B, S + 2, S, jnp.float32)

        def decode(p, cache):
            cache = mod.build_cross_cache(p, mod.encode(p, frames, cfg),
                                          cfg, cache)
            return mod.decode_step(p, tok[:, :1], cache, 0, cfg)[0]
        serve["decode"] = jax.jit(decode)(p, cache)
    elif jarch.module == "lm":
        ee = np_batch.get("extra_embed")
        ee = None if ee is None else jnp.asarray(ee)
        logits, aux = jax.jit(lambda p: mod.forward(
            p, tok, cfg, extra_embed=ee))(p)
        cache = mod.init_cache(cfg, B, S + 2, jnp.float32)
        pre, cache = jax.jit(lambda p, c: mod.prefill(
            p, tok, c, cfg, extra_embed=ee, last_only=True))(p, cache)
        serve["prefill"] = pre
        serve["decode"], _ = jax.jit(lambda p, c: mod.decode_step(
            p, tok[:, :1], c, S, cfg))(p, cache)
    else:
        logits, aux = jax.jit(lambda p: mod.forward(p, tok, cfg))(p)
        kw = {} if jarch.module == "ssm" else {"max_seq": S + 2}
        cache = mod.init_cache(cfg, B, dtype=jnp.float32, **kw)
        step = jax.jit(lambda p, t, c, pos: mod.decode_step(p, t, c, pos,
                                                            cfg))
        serve["decode0"], cache = step(p, tok[:, :1], cache, 0)
        serve["decode1"], _ = step(p, tok[:, 1:2], cache, 1)
    step = jax.jit(jstep.make_train_step(
        jarch, jopt.AdamWConfig(lr=3e-4, total_steps=1)))
    state, metrics = step(jstep.init_train_state(p),
                          {k: jnp.asarray(v) for k, v in np_batch.items()})
    return {"logits": np.asarray(logits), "aux": float(aux),
            "serve": {k: np.asarray(v) for k, v in serve.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": [np.asarray(x) for x in jax.tree.leaves(state.params)],
            "moments": [np.asarray(x) for x in
                        jax.tree.leaves(state.opt.m)]}


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = want.detach().float().numpy() if torch.is_tensor(want) \
        else np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max() + 1e-9,
                               err_msg=what)


def _serve_tol(arch_id, key):
    return BF16_CROSS_TOL if (arch_id.startswith("seamless")
                              and key == "decode") else None


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_and_serving_match(ranks, arch_id):
    _hold_forward(*ranks, arch_id)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_gradients_and_train_step_match(ranks, arch_id):
    _hold_train(*ranks, arch_id)


def test_heads_split_inside_a_head(split_head):
    """llama3.2-1b on (1, 4): the forward, the serving steps, the
    gradients and one train step as on the other meshes."""
    _hold_forward(*split_head, SPLIT_HEAD[0])
    _hold_train(*split_head, SPLIT_HEAD[0])


def _hold_forward(mesh, runs, arch_id):
    got, port, ref = runs[arch_id], _port(arch_id), _jax(arch_id)
    _close(got["logits"], port["logits"], LOGIT_TOL, f"{mesh} logits")
    np.testing.assert_allclose(got["logits"].numpy(), ref["logits"],
                               **JAX_TOL, err_msg=f"{mesh} logits (JAX)")
    np.testing.assert_allclose(float(got["aux"]), float(port["aux"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got["aux"]), ref["aux"], **JAX_TOL)
    assert sorted(got["serve"]) == sorted(ref["serve"])
    for key, value in got["serve"].items():
        tol = _serve_tol(arch_id, key)
        _close(value, port["serve"][key], tol or LOGIT_TOL,
               f"{mesh} {key}")
        want = ref["serve"][key]
        if tol is None:
            np.testing.assert_allclose(value.reshape(want.shape).numpy(),
                                       want, **JAX_TOL,
                                       err_msg=f"{mesh} {key} (JAX)")
        else:
            _close(value.reshape(want.shape), want, tol, f"{mesh} {key} "
                   "(JAX)")


def _hold_train(mesh, runs, arch_id):
    got, port, ref = runs[arch_id], _port(arch_id), _jax(arch_id)
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(port["loss"]), rtol=1e-6, atol=0)
    assert len(got["grads"]) == len(port["grads"])
    for g, w in zip(got["grads"], port["grads"]):
        _close(g, w, 1e-4, f"{mesh} gradient")
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got["metrics"][k]),
                                   float(port["metrics"][k]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{mesh} {k}")
        np.testing.assert_allclose(float(got["metrics"][k]),
                                   ref["metrics"][k], **JAX_TOL,
                                   err_msg=f"{mesh} {k} (JAX)")
    for a, b, j in zip(got["params"], port["params"], ref["params"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), j, rtol=0, atol=1e-5)
    for a, b, j in zip(got["moments"], port["moments"], ref["moments"]):
        _close(a, b, 1e-4, f"{mesh} moment")
        _close(a, j, 1e-4, f"{mesh} moment (JAX)")
