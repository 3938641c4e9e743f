"""The port's GPipe schedule on 4 gloo ranks against the JAX serial
chain (tests/test_pipeline.py's case: L 8, D 16, B 12, n_micro 6).

Each rank runs one stage of ``repro_torch.parallel.gpipe`` over a
("pod",) mesh, with its stage's rows from the full stack and again from
a DTensor sharded ``Shard(0)`` on the stage axis; every rank's output
must be within 2e-5 of ``tanh(x @ w)`` chained over the 8 layers in JAX
(the reference test's tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.parallel.pipeline import stage_params_from_stack as jstage
from repro_torch.parallel import pipeline

L, D, B, N_MICRO, STAGES = 8, 16, 12, 6, 4


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((L, D, D)) * 0.5).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    tmp = tmp_path_factory.mktemp("pipe")
    _torch_ranks.run_ranks(_torch_ranks.pipeline_body, STAGES, tmp, ws, x,
                           N_MICRO)
    y = jnp.asarray(x)
    for i in range(L):
        y = jnp.tanh(y @ ws[i])
    return np.asarray(y), [_torch_ranks.load(tmp / f"pipe_{r}.pt")
                           for r in range(STAGES)]


@pytest.mark.parametrize("form", ["full", "dtensor"])
def test_gpipe_matches_jax_serial_chain(piped, form):
    y_ref, ranks = piped
    for out in ranks:
        np.testing.assert_allclose(out[form].numpy(), y_ref, rtol=2e-5,
                                   atol=2e-5)


def test_stage_params_from_stack_matches_jax_and_its_error():
    ws = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = pipeline.stage_params_from_stack({"w": torch.from_numpy(ws)}, 4)
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.asarray(jstage({"w": ws}, 4)["w"]))
    with pytest.raises(ValueError) as err:
        pipeline.stage_params_from_stack(torch.zeros(6, 2), 4)
    with pytest.raises(ValueError) as jerr:
        jstage(jnp.zeros((6, 2)), 4)
    assert str(err.value) == str(jerr.value) == "layers 6 % stages 4 != 0"
