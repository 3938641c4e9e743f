"""The int8 error-feedback all-reduce over a mesh axis: 4 gloo ranks
against the JAX function under ``jax.vmap(..., axis_name="data")``.

Each rank holds its own gradients (a tree with fp32 leaves and a bf16
leaf) and residuals. Local quantities are bitwise equal to JAX's: the
codes (whose int32 sum over the ranks is bitwise too) and the new
residuals (the error against the local dequantized value). The reduced
gradient is ``summed * (scale_sum / n) / n``; the scale sum is an fp32
sum of 4 terms in another order than XLA's, so it may differ by up to 3
roundings, and the reduced fp32 leaves are held to 8 x 2^-24 relative
(those roundings and the two products'); a bf16 leaf is rounded after
that, so it may land one bf16 step (2^-8 relative) away.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.parallel import compress as jcompress
from repro_torch.parallel import compress

WORLD = 4
N_REPLICAS = 3
FP32_RTOL = 8 * 2.0 ** -24
BF16_RTOL = 2.0 ** -8


def _grads(rng):
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": (rng.standard_normal(12) * 3).astype(ml_dtypes.bfloat16),
            "c": [(rng.standard_normal(4) * 1e-3).astype(np.float32)]}


def _residuals(rng, grads):
    return jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-3)
                        .astype(np.float32), grads)


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    rng = np.random.default_rng(0)
    grads = [_grads(rng) for _ in range(WORLD)]
    res = [_residuals(rng, g) for g in grads]
    tmp = tmp_path_factory.mktemp("compress")
    _torch_ranks.run_ranks(_torch_ranks.compress_body, WORLD, tmp, grads,
                           res, N_REPLICAS)
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *trees)

    def ref(n_replicas):
        return jax.vmap(lambda g, r: jcompress.compressed_grad_allreduce(
            g, jcompress.CompressionState(r), axis_name="data",
            n_replicas=n_replicas), axis_name="data")(stack(grads),
                                                      stack(res))

    def code_sums(g, r):
        return jax.tree.map(lambda gl, rl: jax.lax.psum(
            jcompress.compress_int8(gl.astype(jnp.float32) + rl)[0]
            .astype(jnp.int32), "data"), g, r)

    sums = jax.vmap(code_sums, axis_name="data")(stack(grads), stack(res))
    return {"ref": ref(None), "ref_n": ref(N_REPLICAS), "sums": sums,
            "ranks": [_torch_ranks.load(tmp / f"compress_{r}.pt")
                      for r in range(WORLD)]}


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def _leaves(tree):
    return [tree["a"], tree["b"], tree["c"][0]]


@pytest.mark.parametrize("which", ["axis_size", "n_replicas"])
def test_reduced_gradients_match_jax_vmap(reduced, which):
    out_key, ref_key = ("out", "ref") if which == "axis_size" \
        else ("out_n", "ref_n")
    jout, _ = reduced[ref_key]
    for r, got in enumerate(reduced["ranks"]):
        for name, g, j in zip("abc", _leaves(got[out_key]), _leaves(jout)):
            want = np.asarray(j[r]).astype(np.float32)
            rtol = BF16_RTOL if g.dtype == torch.bfloat16 else FP32_RTOL
            assert g.dtype == (torch.bfloat16 if name == "b"
                               else torch.float32)
            np.testing.assert_allclose(_np(g), want, rtol=rtol, atol=0,
                                       err_msg=f"rank {r} leaf {name}")


@pytest.mark.parametrize("which", ["axis_size", "n_replicas"])
def test_residuals_match_jax_bitwise(reduced, which):
    res_key, ref_key = ("residual", "ref") if which == "axis_size" \
        else ("residual_n", "ref_n")
    _, jstate = reduced[ref_key]
    for r, got in enumerate(reduced["ranks"]):
        for g, j in zip(_leaves(got[res_key]), _leaves(jstate.residual)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j[r]))


def test_code_sums_match_jax_bitwise(reduced):
    for got in reduced["ranks"]:
        for g, j in zip(_leaves(got["code_sums"]),
                        _leaves(reduced["sums"])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j[0]))


def test_allreduce_over_an_axis_refuses_without_a_mesh():
    g = {"g": torch.ones(3)}
    state = compress.init_compression_state(g)
    with pytest.raises(ValueError, match="needs a mesh"):
        compress.compressed_grad_allreduce(g, state, axis_name="data",
                                           n_replicas=2)
