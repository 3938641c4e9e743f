"""One train step of every arch's smoke config in the port
(``repro_torch.train.step.make_train_step``) against
``jax.jit(repro.train.step.make_train_step)``, on the CPU, mirroring
``tests/test_smoke_archs.py::test_smoke_train_step``; and the smoke
tests' host batch.

Weights are the reference's own ``init``, carried across with the
models' ``params_from_jax``; the batch is the reference's
``make_host_batch`` as numpy, handed to both packages. Every smoke
config is fp32.

Tolerances: loss, ce, aux and grad_norm within 1e-4 relative and
absolute; every updated parameter within 1e-5 absolute (the step moves
a parameter by lr = 3e-6 times the sign of its gradient at step 1, plus
the decay, so an update is wrong by at most 2 lr where a near-zero
gradient's sign differs); every first moment within 1e-4 of its leaf's
max |m| plus 1e-9 (m is 0.1 times the clipped gradient: this holds the
gradients themselves); the compressed step's residual within 1e-3 of
its leaf's max. The MoE archs route every token to the same experts
first, or the rest cannot hold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data.synthetic import make_host_batch as jmake_host_batch
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.data.synthetic import make_host_batch
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import layers, lm
from repro_torch.train import step as tstep
from test_torch_mla import _recorded, _same_routing
from test_torch_train import CPU, _np_tree, _rel, _t

ARCHS = registry.list_archs()
MOE_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "jamba-v0.1-52b")




def _smoke_archs(arch_id):
    return (dataclasses.replace(r.get(arch_id), model=r.get(arch_id).smoke)
            for r in (jregistry, registry))


def test_make_host_batch_tokens_are_the_reference_draws():
    for arch_id in ("llama3.2-1b", "seamless-m4t-large-v2", "qwen2-vl-2b"):
        jb = jmake_host_batch(jregistry.get(arch_id), batch=2, seq=24)
        tb = make_host_batch(registry.get(arch_id), batch=2, seq=24)
        assert set(tb) == set(jb)
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        for name in set(tb) - {"tokens"}:
            assert tb[name].shape == jb[name].shape
            assert tb[name].dtype == torch.float32
            assert 0.05 < float(tb[name].std()) < 0.15


@pytest.mark.parametrize("arch_id", ARCHS)
def test_smoke_train_step_matches_reference(arch_id):
    jarch, tarch = _smoke_archs(arch_id)
    jmod, tmod = jarch.model_module(), tarch.model_module()
    jp = jax.jit(jmod.init, static_argnums=0)(jarch.model, jax.random.key(0))
    tp = tmod.params_from_jax(_np_tree(jp), CPU)
    jbatch = _np_tree(jmake_host_batch(jregistry.get(arch_id), batch=2,
                                       seq=24))
    tbatch = {k: _t(v) for k, v in jbatch.items()}
    if arch_id in MOE_ARCHS:
        # the same routing in every MoE layer first
        with _recorded(jlayers) as jroutes, _recorded(layers) as routes:
            jmod.forward(jp, jnp.asarray(jbatch["tokens"]), jarch.model)
            tmod.forward(tp, tbatch["tokens"], tarch.model)
            _same_routing(routes, jroutes)
    jstate, jm = jax.jit(jstep.make_train_step(jarch))(
        jstep.init_train_state(jp), jbatch)
    before = dict(LAUNCHES)
    tstate, tm = tstep.make_train_step(tarch)(
        tstep.init_train_state(tp), tbatch)
    assert dict(LAUNCHES) == before        # plain versions on the CPU
    assert int(tstate.step) == int(jstate.step) == 1
    for name in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert np.isfinite(float(tm[name]))
        _rel(tm[name], jm[name], 1e-4)
    got, want = layers.tree_leaves(tstate.params), \
        jax.tree.leaves(jstate.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    for a, b in zip(layers.tree_leaves(tstate.opt.m),
                    jax.tree.leaves(jstate.opt.m)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max() + 1e-9)


def test_carried_params_start_at_zero_moments_and_step():
    jarch, tarch = _smoke_archs("llama3.2-1b")
    jp = jax.jit(jlm.init, static_argnums=0)(jarch.model, jax.random.key(0))
    state = tstep.init_train_state(lm.params_from_jax(_np_tree(jp), CPU))
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    assert int(state.opt.count) == 0
    assert all(float(m.abs().max()) == 0 and m.dtype == torch.float32
               for m in layers.tree_leaves(state.opt.m)
               + layers.tree_leaves(state.opt.v))
    assert state.compress is None
    assert tstep.init_train_state(state.params, compress_grads=True
                                  ).compress is not None


def test_compressed_train_step_matches_reference():
    jarch, tarch = _smoke_archs("llama3.2-1b")
    jp = jax.jit(jlm.init, static_argnums=0)(jarch.model, jax.random.key(0))
    tp = lm.params_from_jax(_np_tree(jp), CPU)
    jbatch = _np_tree(jmake_host_batch(jregistry.get("llama3.2-1b"), 2, 24))
    jstate, jm = jax.jit(jstep.make_train_step(jarch, compress_grads=True))(
        jstep.init_train_state(jp, compress_grads=True), jbatch)
    tstate, tm = tstep.make_train_step(tarch, compress_grads=True)(
        tstep.init_train_state(tp, compress_grads=True),
        {k: _t(v) for k, v in jbatch.items()})
    _rel(tm["grad_norm"], jm["grad_norm"], 1e-4)
    for a, b in zip(layers.tree_leaves(tstate.compress.residual),
                    jax.tree.leaves(jstate.compress.residual)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-3 * np.abs(b).max() + 1e-9)
