"""Data-parallel training through the launcher: ``launch.train.main`` on
2 gloo ranks against the one-process launcher and against the JAX
package's train step on the same global batches.

The ranks (tests/_torch_ranks.py) share one process group and run, in
turn: llama3.2-1b's smoke config (fp32) for 3 steps at batch 4 (each
rank 2 rows), the encoder-decoder's smoke config the same way (the
frames sliced like the tokens), llama at batch 3 (which the data axis
does not divide: replicated, each rank computes it whole), and the
three MoE archs for one step at batch 4 (64 tokens: one dispatch group
of 64, which the ranks' rows split, so every rank routes the gathered
group) and at batch 8 (two groups, one a rank: each routes its own and
the load-balance means are all-reduced). Two more ranks run the llama
case as ``torchrun``'s children do, with no group made for them.

Tolerances, against the one-process launcher: each step's loss, ce,
aux, |g| and lr within 1e-6 relative (the global loss is the mean of
the two ranks' half-batch means, an fp32 sum in another order).
Against both it and ``jax.jit(repro.train.step.make_train_step)``:
every first moment within 1e-4 of its leaf's max |m| plus 1e-9 (m
sums 0.1 x each step's clipped gradient, so this holds the gradients
leaf by leaf); the update ``params - params0`` within ``UPDATE_RTOL``
relative L2 over all leaves (a zero or reversed update is 1 or 2);
every final parameter within ``PARAM_ATOL`` (see there). The two
ranks' parameters are bitwise equal to each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from repro.configs import registry as jregistry
from repro.data.synthetic import SyntheticTokens as JSyntheticTokens
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import registry
from repro_torch.launch import ranks, train
from repro_torch.models.layers import tree_leaves

STEPS = 3
LLAMA = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--steps",
         str(STEPS), "--seq", "16", "--seed", "0", "--log-every", "1"]
ENCDEC = ["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
          "--steps", str(STEPS), "--batch", "4", "--seq", "16", "--seed",
          "1", "--log-every", "1"]
MOE = ["qwen3-moe-235b-a22b", "deepseek-v2-236b", "jamba-v0.1-52b"]
RUNS = [("llama", LLAMA + ["--batch", "4"]), ("encdec", ENCDEC),
        ("odd", LLAMA + ["--batch", "3"])] + [
    (f"moe{b}:{a}", ["--arch", a, "--smoke", "--device", "cpu", "--steps",
                     "1", "--batch", str(b), "--seq", "16", "--seed", "0"])
    for a in MOE for b in (4, 8)]
DENSE = ["llama", "encdec", "odd"]
#: per parameter, |2-rank - reference|: step 1 moves a parameter by
#: lr x sign(g) (lr 3e-6), and a gradient element near 0 can take the
#: other sign when the sum over the batch is taken in another order (2 lr
#: = 6e-6); later steps' updates are continuous in the moments, which
#: MOMENT_RTOL holds
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-6
MOMENT_RTOL = 1e-4
#: relative L2 of the 3 steps' update (params - params0) over all leaves
UPDATE_RTOL = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    _torch_ranks.run_ranks(_torch_ranks.launcher_body, 2, tmp, RUNS,
                           timeout=240)
    return [_torch_ranks.load(tmp / f"launch_{r}.pt") for r in range(2)]


def _arg(argv, flag):
    return int(argv[argv.index(flag) + 1])


def _initial_params(argv):
    """The launcher's initial parameters for ``argv`` (the model's init
    from ``--seed`` on the CPU)."""
    arch = registry.get(argv[argv.index("--arch") + 1])
    return arch.model_module().init(
        arch.smoke, torch.Generator(device="cpu").manual_seed(
            _arg(argv, "--seed")))


def _jax_run(argv):
    """``jax.jit(repro.train.step.make_train_step)`` for the launcher's
    steps from its initial parameters, on its global batches: the
    reference's token stream and, for the encoder-decoder, the
    launcher's frames. Returns the final params and first moments as
    leaf lists, and each step's metrics."""
    arch_id = argv[argv.index("--arch") + 1]
    jarch = jregistry.get(arch_id)
    jarch = dataclasses.replace(jarch, model=jarch.smoke)
    steps, b, s, seed = (_arg(argv, f) for f in
                         ("--steps", "--batch", "--seq", "--seed"))
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          _initial_params(argv))
    step = jax.jit(jstep.make_train_step(
        jarch, jopt.AdamWConfig(lr=3e-4, total_steps=steps)))
    state = jstep.init_train_state(params)
    data = JSyntheticTokens(jarch.model.vocab, b, s, seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    metrics = []
    for _ in range(steps):
        batch = data.next_batch()
        if jarch.module == "encdec":
            batch["frames"] = jnp.asarray(train.step_frames(
                gen, b, s, jarch.model.d_model, "cpu").numpy())
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return ([np.asarray(x) for x in jax.tree.leaves(state.params)],
            [np.asarray(x) for x in jax.tree.leaves(state.opt.m)], metrics)


def _hold(params, moments, params_ref, moments_ref, params0):
    """One run's final params and first moments (leaf lists, numpy)
    against a reference's, to the module's tolerances."""
    assert len(params) == len(params_ref) == len(params0)
    assert len(moments) == len(moments_ref)
    for a, b in zip(moments, moments_ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=MOMENT_RTOL *
                                   np.abs(b).max() + 1e-9)
    num = den = 0.0
    for a, b, p0 in zip(params, params_ref, params0):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
        num += float(np.sum(np.square((a - p0) - (b - p0))))
        den += float(np.sum(np.square(b - p0)))
    assert den > 0 and np.sqrt(num / den) <= UPDATE_RTOL


def _np(leaves):
    return [t.numpy() for t in leaves]


@pytest.mark.parametrize("name", DENSE)
def test_two_ranks_match_one_process(runs, name):
    argv = dict(RUNS)[name]
    ref = train.main(argv)
    params0 = _np(tree_leaves(_initial_params(argv)))
    batch = _arg(argv, "--batch")
    half = batch // 2 if batch % 2 == 0 else None
    for r, out in enumerate(runs):
        got = out[name]
        assert got["mesh"] == (("data", "model"), (2, 1))
        assert got["rows"] == (slice(r * half, (r + 1) * half) if half
                               else slice(0, batch))
        for m, mr in zip(got["metrics"], ref["metrics"]):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[k]), float(mr[k]),
                                           rtol=LOSS_RTOL, atol=0,
                                           err_msg=f"{name} {k}")
        _hold(_np(tree_leaves(got["params"])),
              _np(tree_leaves(got["moments"])),
              _np(tree_leaves(ref["state"].params)),
              _np(tree_leaves(ref["state"].opt.m)), params0)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(runs[0][name]["params"]),
        tree_leaves(runs[1][name]["params"])))


@pytest.mark.parametrize("name", DENSE)
def test_two_ranks_match_the_reference(runs, name):
    """The 2-rank run against the JAX package's train step on the same
    global batches from the same initial parameters."""
    argv = dict(RUNS)[name]
    params, moments, metrics = _jax_run(argv)
    params0 = _np(tree_leaves(_initial_params(argv)))
    got = runs[0][name]
    for m, mj in zip(got["metrics"], metrics):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), mj[k], rtol=1e-4,
                                       atol=1e-4, err_msg=f"{name} {k}")
    _hold(_np(tree_leaves(got["params"])), _np(tree_leaves(got["moments"])),
          params, moments, params0)


def test_launcher_makes_its_group_under_torchrun(runs, tmp_path):
    """Two ranks with torchrun's environment and no group: the launcher
    makes a gloo group on the CPU, trains as under a given group (its
    parameters bitwise equal to that run's), logs on rank 0 only and
    leaves no group behind."""
    argv = dict(RUNS)["llama"]
    _torch_ranks.run_ranks(_torch_ranks.torchrun_body, 2, tmp_path,
                           ranks.free_port(), argv, backend=None)
    for r in range(2):
        got = _torch_ranks.load(tmp_path / f"torchrun_{r}.pt")
        assert got["group_left"] is False
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got["params"]),
            tree_leaves(runs[r]["llama"]["params"])))
        if r == 0:
            assert got["log"][0] == ("# data parallel: world 2 over gloo, "
                                     "mesh ('data', 'model') (2, 1)")
            assert [ln.split()[0] for ln in got["log"][1:]] == \
                ["step"] * STEPS + ["#"]
        else:
            assert got["log"] == []


@pytest.mark.parametrize("arch_id", MOE)
def test_moe_archs_exit_2_at_two_ranks(runs, arch_id):
    """The MoE archs no longer exit 2 at two data ranks: their step at
    batch 4 (the ranks route the gathered global group) and at batch 8
    (each rank its own group, the load-balance means all-reduced) holds,
    on both ranks, to the one-process launcher (loss, ce, aux, |g| and
    lr within ``LOSS_RTOL``; moments and params by ``_hold``) and to
    ``jax.jit(repro.train.step.make_train_step)`` (the metrics within
    1e-4; ``_hold``)."""
    for b in (4, 8):
        name = f"moe{b}:{arch_id}"
        argv = dict(RUNS)[name]
        ref = train.main(argv)
        params0 = _np(tree_leaves(_initial_params(argv)))
        params_j, moments_j, metrics_j = _jax_run(argv)
        for r, out in enumerate(runs):
            got = out[name]
            assert "exit" not in got, got.get("stderr")
            assert got["rows"] == slice(r * b // 2, (r + 1) * b // 2)
            for m, mr, mj in zip(got["metrics"], ref["metrics"],
                                 metrics_j):
                for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                    np.testing.assert_allclose(
                        float(m[k]), float(mr[k]), rtol=LOSS_RTOL, atol=0,
                        err_msg=f"{name} {k}")
                    np.testing.assert_allclose(
                        float(m[k]), mj[k], rtol=1e-4, atol=1e-4,
                        err_msg=f"{name} {k} (JAX)")
            for pr, mr in ((ref["state"].params, ref["state"].opt.m),):
                _hold(_np(tree_leaves(got["params"])),
                      _np(tree_leaves(got["moments"])),
                      _np(tree_leaves(pr)), _np(tree_leaves(mr)), params0)
            _hold(_np(tree_leaves(got["params"])),
                  _np(tree_leaves(got["moments"])), params_j, moments_j,
                  params0)


def test_rank_rows_follow_the_batch_rule():
    """``batch_rows`` on a device-free stand-in of a (2, 2) ("pod",
    "data") mesh: row-major over the two axes, replicated where the
    batch does not divide."""
    from repro_torch.parallel.sharding import DEFAULT_RULES

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 1)

        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return self.coord

    rows = [train.batch_rows(Mesh([p, d, 0]), DEFAULT_RULES, 8, 4)
            for p in range(2) for d in range(2)]
    assert rows == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert train.batch_rows(Mesh([1, 1, 0]), DEFAULT_RULES, 6, 4) == \
        slice(3, 6)                      # 6 % 4: the pod axis alone
    assert train.batch_rows(Mesh([1, 1, 0]), DEFAULT_RULES, 3, 4) == \
        slice(0, 3)
