"""The port's accuracy harness against the reference's.

What must be bitwise equal: the synthetic images (the same numpy
draws), the folded weights' quantized codes and scales, the compiled
logits on the same folded weights and images (the port runs the chain
one image at a time, the reference ``vmap``s it; every requant reduces
over one sample in both), and so the agreement counts on the same
reference predictions. What agrees within a stated tolerance: the fp32
forward and its frozen norms (convolutions summed in another order),
and ``quant_snr_db`` (a float32 sum and a log). The reference draws its
weights with ``jax.random`` and trains with XLA, so the port cannot
reproduce its bits there: torch-native training only has to reach
:data:`AGREEMENT_FLOOR` on both reduced networks.
"""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import PallasExecutor
from repro.data.synthetic import SyntheticImages as SyntheticImagesJax
from repro.eval import accuracy as acc_jax
from repro.models import cnn as cnn_jax
from repro.core.workloads import ConvSpec as ConvSpecJax
from repro.quant.uniform import fit_scale as fit_scale_jax
from repro.quant.uniform import qrange
from repro.quant.uniform import quant_snr_db as snr_jax
from repro_torch.compiler import CudaExecutor, GoldenExecutor
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.eval import accuracy as acc
from repro_torch.eval.accuracy import AGREEMENT_FLOOR, measure
from repro_torch.models import cnn
from repro_torch.quant import quant_snr_db

ARCHS = ["resnet18", "mobilenet_v2"]
#: Smallest useful operating point — plumbing tests only.
TINY = dict(n_samples=32, batch=16, train_steps=30, simulate=False,
            torch_device="cpu")
#: The reference's CI-smoke point for the floor checks: reduced eval
#: stream, full 200-step training (the floor is calibrated for a
#: converged reference).
SMOKE = dict(n_samples=64, batch=32, train_steps=200, torch_device="cpu")
#: fp32 forward of the same params and norms, port vs reference: max
#: |diff| within this fraction of max |logit|. The two sum each
#: convolution in another order; the difference grows with depth, to
#: 1.2e-6 on reduced resnet18 and 1.1e-4 on reduced mobilenet_v2 (53
#: layers) at random init.
FORWARD_TOL = 1e-3
#: frozen norms, port vs reference: relative error per channel. Largest
#: (3.2e-4 on reduced mobilenet_v2) at channels whose conv output is ~0,
#: where the RMS is ~sqrt(1e-6) and every rounding counts.
NORM_RTOL = 1e-3
#: the reference's jitted runner vs its own per-image chain: max |diff|
#: within this fraction of max |logit| (FMA contraction moves an fp32
#: sum by an ulp; a requant scale or code may follow it)
RUNNER_TOL = 1e-4
#: one training step's gradients, port vs reference, as a fraction of
#: the largest gradient of the same parameter
GRAD_TOL = 1e-4


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


#: torch's intra-op threads for the floor checks. Which network a CPU
#: training run ends in depends on the thread count (reduced
#: mobilenet_v2, seed 0, 64 samples: agreement 0.8594 on 1 thread,
#: 0.9844 on 2, 1.0 on 4 and on 8), so the checks pin it rather than
#: take a thread per core of whatever machine runs them. The reference's
#: agreement spreads over seeds as the port's does
#: (``tests/accuracy_seed_spread.py``): some trained networks lose more
#: to quantization than others, in both packages.
FLOOR_THREADS = 4


@contextlib.contextmanager
def torch_threads(n: int):
    """torch on ``n`` intra-op threads for the duration. Test workers
    share the cores, and torch's default of a thread per core then slows
    each of them many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _threads(request):
    """The floor checks train on :data:`FLOOR_THREADS` threads, every
    other test runs on one."""
    floor = request.node.originalname == "test_agreement_meets_documented_floor"
    with torch_threads(FLOOR_THREADS if floor else 1):
        yield


@pytest.fixture(scope="module")
def tiny_cuda():
    with torch_threads(1):
        return measure("resnet18", backend="cuda", **TINY)


# ---------------------------------------------------------------------------
# Data, quantizer, fp32 network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_classes=10, batch=16, hw=32),
                                dict(n_classes=7, batch=5, hw=9, seed=3,
                                     snr=1.5, sample_seed=11)])
def test_synthetic_images_bitwise_equal_reference(kw):
    ds, ds_jax = SyntheticImages(**kw), SyntheticImagesJax(**kw)
    for _ in range(3):
        b, b_jax = ds.next_batch(), ds_jax.next_batch()
        assert b["images"].dtype == torch.float32
        assert b["labels"].dtype == torch.int32
        assert tuple(b["images"].shape) == (kw["batch"], kw["hw"], kw["hw"], 3)
        assert np.array_equal(_bits(b["images"].numpy()),
                              _bits(b_jax["images"]))
        assert np.array_equal(b["labels"].numpy(), np.asarray(b_jax["labels"]))


def test_quant_snr_db_matches_reference():
    rng = np.random.default_rng(0)
    for shape, noise in [((64,), 0.1), ((16, 33), 1e-3), ((3, 3, 8, 5), 2.0)]:
        x = rng.standard_normal(shape).astype(np.float32)
        x_hat = (x + noise * rng.standard_normal(shape)).astype(np.float32)
        got = float(quant_snr_db(torch.from_numpy(x), torch.from_numpy(x_hat)))
        want = float(snr_jax(jnp.asarray(x), jnp.asarray(x_hat)))
        assert abs(got - want) <= 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """The reference's harness at ``train_steps=0`` on a reduced net —
    ``build_reference``'s random-init params, norms frozen on its
    calibration batch and fp32 forward (each step jitted here, which
    gives the same bits as its eager steps and compiles in a fraction
    of the time), the folded weights, and a ``PallasExecutor`` they are
    bound to — and the same params carried into the port, with the
    port's norms frozen on the same batch."""
    arch = request.param
    cfg_jax = cnn_jax.reduced_config(arch)
    params_jax = jax.jit(cnn_jax.init, static_argnums=0)(
        cfg_jax, jax.random.PRNGKey(0))
    x = SyntheticImagesJax(10, 64, 32, seed=0,
                           sample_seed=0).next_batch()["images"]
    norms_jax = jax.jit(lambda p, x: cnn_jax.calibrate_norms(
        p, x, cfg_jax))(params_jax, x)
    ref_jax = jax.jit(lambda x: cnn_jax.forward(params_jax, x, cfg_jax,
                                                norms=norms_jax))
    folded_jax = cnn_jax.fold_inference_weights(params_jax, cfg_jax,
                                                norms_jax)
    prog_jax, specs_jax = acc_jax.compile_quantized_cnn(cfg_jax)
    ex_jax = PallasExecutor(prog_jax)
    acc_jax.bind_folded_weights(ex_jax, prog_jax, folded_jax, specs_jax)
    cfg = cnn.reduced_config(arch)
    params = cnn.params_from_numpy(params_jax, "cpu")
    with torch_threads(1):
        norms = cnn.calibrate_norms(params, torch.from_numpy(np.array(x)),
                                    cfg)
    return dict(arch=arch, cfg=cfg, cfg_jax=cfg_jax, params=params,
                params_jax=params_jax, norms=norms, norms_jax=norms_jax,
                ref_jax=ref_jax, x=x, folded_jax=folded_jax, ex_jax=ex_jax)


def test_params_from_numpy_keeps_layout_and_bits(reference):
    cfg, params = reference["cfg"], reference["params"]
    assert sorted(params) == sorted(s.name for s in cnn.specs_for(cfg))
    mine = cnn.init(cfg, torch.Generator().manual_seed(0))
    for name, p in params.items():
        for k, t in p.items():
            assert t.dtype == torch.float32
            assert tuple(t.shape) == tuple(mine[name][k].shape)
            assert np.array_equal(_bits(t.numpy()),
                                  _bits(reference["params_jax"][name][k]))


def test_forward_and_norms_match_reference(reference):
    cfg, params, norms = reference["cfg"], reference["params"], \
        reference["norms"]
    norms_jax = reference["norms_jax"]
    assert sorted(norms) == sorted(norms_jax)
    for name, rms in norms.items():
        want = np.asarray(norms_jax[name])
        assert np.all(np.abs(rms.numpy() - want) <= NORM_RTOL * want), name
    x = np.asarray(reference["x"])[:16]
    want = np.asarray(reference["ref_jax"](x))
    got = cnn.forward(params, torch.from_numpy(x.copy()), cfg,
                      norms=norms).numpy()
    assert got.shape == want.shape == (16, 10)
    assert np.abs(got - want).max() <= FORWARD_TOL * np.abs(want).max()
    labels = np.arange(16, dtype=np.int32) % 10
    ce = float(cnn.cross_entropy(torch.from_numpy(want),
                                 torch.from_numpy(labels)))
    assert abs(ce - float(cnn_jax.cross_entropy(jnp.asarray(want),
                                                jnp.asarray(labels)))) <= 1e-6


def test_fold_and_quantize_match_reference(reference):
    """The same params and frozen norms fold to the same bits, and the
    folded weights quantize and bind to the reference's codes and
    scales, layer by layer."""
    folded_jax = reference["folded_jax"]
    folded = cnn.fold_inference_weights(
        reference["params"], reference["cfg"],
        cnn.params_from_numpy(reference["norms_jax"], "cpu"))
    prog, specs = acc.compile_quantized_cnn(reference["cfg"])
    ex = CudaExecutor(prog, device="cpu")
    acc.bind_folded_weights(ex, prog, folded, specs)
    for lp, spec in zip(prog.layers, specs):
        assert np.array_equal(_bits(folded[spec.name].numpy()),
                              _bits(folded_jax[spec.name])), spec.name
        assert acc.fold_to_matrix(folded[spec.name], spec).shape \
            == (lp.dims.k, lp.dims.n)
        got = dataclasses.astuple(ex._weights[lp.index])
        want = dataclasses.astuple(reference["ex_jax"]._weights[lp.index])
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(_bits(a.numpy()), _bits(b)), spec.name


def test_relu6_gradient_matches_reference():
    """A depthwise layer's relu6 passes no gradient at exactly 0 or 6, as
    ``jax.nn.relu6``; a 3x3 window over relu zeros lands exactly on 0."""
    spec = ConvSpecJax("dw", 4, 4, 3, 1, 6, depthwise=True)
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((2, 6, 6, 4)), 0).astype(np.float32)
    x[:, :3] = 0.0                                   # exact-zero windows
    w = rng.standard_normal((3, 3, 1, 4)).astype(np.float32)
    norm = np.full(4, 0.25, np.float32)
    bias = np.array([0.0, 6.0, 0.0, 6.0], np.float32)   # 0 and 6 exactly

    def loss_jax(b):
        p = {"w": jnp.asarray(w), "scale": jnp.ones(4), "bias": b}
        return jnp.sum(cnn_jax.conv_layer(p, jnp.asarray(x), spec, None,
                                          norm=jnp.asarray(norm)))
    want = np.asarray(jax.grad(loss_jax)(jnp.asarray(bias)))
    b = torch.from_numpy(bias.copy()).requires_grad_()
    p = {"w": torch.from_numpy(w), "scale": torch.ones(4), "bias": b}
    torch.sum(cnn.conv_layer(p, torch.from_numpy(x), spec,
                             norm=torch.from_numpy(norm))).backward()
    assert np.array_equal(b.grad.numpy(), want)
    assert want[0] < 2 * 6 * 6                       # zeros passed none


def test_one_training_step_matches_reference():
    """Reduced resnet18, the reference's init and first batch: the loss
    and every gradient agree within :data:`GRAD_TOL` of the layer's
    largest (both are within 5e-6 of a float64 gradient)."""
    cfg_jax = cnn_jax.reduced_config("resnet18")
    params_jax = jax.jit(cnn_jax.init, static_argnums=0)(
        cfg_jax, jax.random.PRNGKey(0))
    b = SyntheticImagesJax(10, 64, 32, seed=0, sample_seed=0).next_batch()
    x, y = b["images"], b["labels"]
    loss_jax, grads_jax = jax.jit(jax.value_and_grad(
        lambda p: cnn_jax.cross_entropy(cnn_jax.forward(p, x, cfg_jax), y)))(
        params_jax)
    params = cnn.params_from_numpy(params_jax, "cpu")
    leaves = [t.requires_grad_() for p in params.values() for t in p.values()]
    loss = cnn.cross_entropy(
        cnn.forward(params, torch.from_numpy(np.array(x)),
                    cnn.reduced_config("resnet18")),
        torch.from_numpy(np.array(y)))
    grads = iter(torch.autograd.grad(loss, leaves))
    assert abs(float(loss) - float(loss_jax)) <= 1e-5 * float(loss_jax)
    for name, p in params.items():
        for k in p:
            got, want = next(grads).numpy(), np.asarray(grads_jax[name][k])
            assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), \
                (name, k)


def test_fold_refuses_nonzero_bias_and_quant_cfgs():
    cfg = cnn.reduced_config("resnet18")
    params = cnn.init(cfg, torch.Generator().manual_seed(0))
    x = torch.zeros((2, 32, 32, 3))
    norms = cnn.calibrate_norms(params, x, cfg)
    params["conv3"]["bias"][1] = 0.5
    with pytest.raises(ValueError, match="conv3 has a nonzero norm bias"):
        cnn.fold_inference_weights(params, cfg, norms)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        cnn.forward(params, x, cfg, quant_cfgs=[object()] * 21)
    with pytest.raises(ValueError, match="unknown CNN arch"):
        cnn.forward(params, x, dataclasses.replace(cfg, arch="vgg"))


def test_forward_leaves_cudnn_flags_as_they_were():
    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
              cudnn.allow_tf32)
    with cnn.fp32_convs():
        assert not cudnn.allow_tf32 and cudnn.deterministic
        assert (cudnn.enabled, cudnn.benchmark) == before[:2]
    cfg = cnn.reduced_config("mobilenet_v2")
    cnn.forward(cnn.init(cfg, torch.Generator().manual_seed(0)),
                torch.zeros((1, 32, 32, 3)), cfg)
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
            cudnn.allow_tf32) == before


def test_max_pool_pads_like_reduce_window():
    """The stem's SAME max pool is asymmetric on even maps."""
    from repro_torch.models.cnn import _max_pool_same
    rng = np.random.default_rng(1)
    for hw in (7, 8, 16):
        x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32)
        want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                     (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
        got = _max_pool_same(torch.from_numpy(x)).numpy()
        assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# Compiled chain on the reference's folded weights and images
# ---------------------------------------------------------------------------


def test_compiled_chain_bitwise_equal_reference(reference, monkeypatch):
    """The reference's folded weights bound to both packages' compiled
    programs. The port's per-image chain (fused path and golden) gives
    the reference executor's own chain, ``ex.run`` on each image after
    ``_batched_runner``'s quantization, bit for bit. The reference's
    ``_batched_runner`` jits that chain, and XLA then contracts the
    dequant multiply and the residual add into one FMA: its logits are
    within :data:`RUNNER_TOL` of the chain's, and the agreement counts,
    on the reference's predictions, are equal."""
    cfg, cfg_jax = reference["cfg"], reference["cfg_jax"]
    ex_jax = reference["ex_jax"]
    prog, specs = acc.compile_quantized_cnn(cfg)
    assert prog.fingerprint() == ex_jax.program.fingerprint()
    folded = cnn.params_from_numpy(reference["folded_jax"], "cpu")
    exs = {"cuda": CudaExecutor(prog, device="cpu"),
           "golden": GoldenExecutor(prog, device="cpu")}
    for ex in exs.values():
        acc.bind_folded_weights(ex, prog, folded, specs)

    # the reference's counts, keeping its jitted runner's logits
    runner_logits = []
    runner = acc_jax._batched_runner

    def recording(ex):
        run = runner(ex)
        return lambda x: runner_logits.append(run(x)) or runner_logits[-1]
    monkeypatch.setattr(acc_jax, "_batched_runner", recording)
    want_counts = acc_jax.evaluate_agreement(ex_jax, reference["ref_jax"],
                                             cfg_jax, 24, batch=16)

    ref_jax = reference["ref_jax"]

    def ref_bridge(x):
        return torch.from_numpy(np.asarray(ref_jax(jnp.asarray(x.numpy()))))
    assert acc.evaluate_agreement(exs["cuda"], ref_bridge, cfg, 24,
                                  batch=16) == want_counts
    assert want_counts["total"] == 24

    images = SyntheticImagesJax(10, 16, 32, seed=0,
                                sample_seed=10_000).next_batch()["images"]
    images = np.asarray(images)[:3]
    lo, hi = qrange(8)
    chain = []
    for img in images:
        s = fit_scale_jax(jnp.asarray(img), 8)
        x_q = jnp.clip(jnp.round(img / s), lo, hi).astype(jnp.int8)
        chain.append(np.asarray(ex_jax.run(x_q, x_scale=s)).reshape(-1))
    chain = np.stack(chain)
    for name, ex in exs.items():
        got = acc._batched_runner(ex)(torch.from_numpy(images.copy()))
        assert got.shape == (3, 10)
        assert np.array_equal(_bits(got.numpy()), _bits(chain)), name
    jitted = np.asarray(runner_logits[0])[:3]
    assert np.abs(jitted - chain).max() <= RUNNER_TOL * np.abs(chain).max()


# ---------------------------------------------------------------------------
# measure: determinism, backend equivalence, the floor, the CLI
# ---------------------------------------------------------------------------


def test_measure_is_deterministic(tiny_cuda):
    assert measure("resnet18", backend="cuda", **TINY) == tiny_cuda
    assert tiny_cuda.train_s > 0 and tiny_cuda.eval_ms_per_image > 0


def test_golden_measures_same_agreement(tiny_cuda):
    gold = measure("resnet18", backend="golden", **TINY)
    assert gold.backend == "golden"
    assert dataclasses.replace(gold, backend="cuda") == tiny_cuda


def test_bench_row_schema(tiny_cuda):
    row = tiny_cuda.bench_row()
    assert row["BENCH"] == "accuracy.eval"
    assert row["network"] == "resnet18"
    assert row["backend"] == "cuda"
    assert row["n_samples"] == TINY["n_samples"]
    assert row["agreement_floor"] == AGREEMENT_FLOOR == 0.95
    assert row["meets_floor"] == (row["agreement"] >= AGREEMENT_FLOOR)
    assert row["latency_ms"] is None        # simulate=False
    assert row["train_s"] == tiny_cuda.train_s
    json.dumps(row)


def test_accuracy_fn_scores_a_program_as_measure(tiny_cuda):
    cfg = cnn.reduced_config("resnet18")
    fn = acc.make_accuracy_fn(cfg, n_samples=32, batch=16, train_steps=30,
                              torch_device="cpu")
    prog, _ = acc.compile_quantized_cnn(cfg)
    assert fn(prog) == 100.0 * tiny_cuda.agreement


@pytest.mark.parametrize("arch", ARCHS)
def test_agreement_meets_documented_floor(arch):
    rep = measure(arch, backend="cuda", simulate=(arch == "resnet18"),
                  **SMOKE)
    assert rep.agreement >= AGREEMENT_FLOOR, rep
    # the trained reference actually separates the synthetic task
    assert rep.top1_ref >= 0.9
    if arch == "resnet18":
        assert rep.sim_cycles and rep.sim_cycles > 0
        assert rep.latency_ms and rep.latency_ms > 0


def test_cli_prints_one_row_per_arch_and_backend(capsys):
    argv = ["--arch", "resnet18", "--backend", "cuda", "--backend",
            "golden", "--samples", "16", "--batch", "16", "--train-steps",
            "0", "--torch-device", "cpu"]
    rc = acc.main(argv)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [(r["network"], r["backend"]) for r in rows] \
        == [("resnet18", "cuda"), ("resnet18", "golden")]
    assert rows[0]["sim_cycles"] > 0 and rows[0]["n_samples"] == 16
    assert rows[0]["agreement"] == rows[1]["agreement"]
    assert rc == (0 if all(r["meets_floor"] for r in rows) else 1)
    assert acc.main(argv[:4] + argv[6:] + ["--no-gate"]) == 0
    capsys.readouterr()
    acc.main(argv[:4] + argv[6:] + ["--no-gate", "--seed", "3"])
    seeded = json.loads(capsys.readouterr().out)
    want = measure("resnet18", n_samples=16, batch=16, train_steps=0,
                   seed=3, torch_device="cpu").bench_row()
    for row in (seeded, want):
        del row["train_s"], row["eval_ms_per_image"]
    assert seeded == want


def test_harness_refuses_to_fall_back_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure("resnet18", n_samples=1, train_steps=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        acc.build_reference(cnn.reduced_config("resnet18"), train_steps=0)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the harness "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_chain_equals_cpu_on_the_same_folded_weights(cuda, arch):
    cfg = cnn.reduced_config(arch)
    params, norms, _ = acc.build_reference(cfg, train_steps=0,
                                           torch_device="cpu")
    folded = cnn.fold_inference_weights(params, cfg, norms)
    prog, specs = acc.compile_quantized_cnn(cfg)
    images = SyntheticImages(10, 4, 32, sample_seed=10_000).next_batch()
    logits = []
    for dev in (cuda, torch.device("cpu")):
        ex = CudaExecutor(prog, device=dev)
        acc.bind_folded_weights(
            ex, prog, {k: w.to(dev) for k, w in folded.items()}, specs)
        logits.append(acc._batched_runner(ex)(images["images"]).cpu())
    assert torch.equal(logits[0], logits[1])
