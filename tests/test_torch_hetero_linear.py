"""The port's deployable HeteroLinear, hybrid quantization and chip cost
record against the reference's.

The same seed-made inputs go through both packages (the reference on
the CPU, as its own tests run it; the port's kernel wrappers compute
their plain versions on CPU tensors). What must be bitwise equal: the
fake quantizers' forward and gradient masks, the hybrid codes, scales
and allocation permutations, ``deploy`` on carried weights,
``apply_deploy`` against the reference's ``mode="ref"``, the cost model
with one chip record given to both, and ``bind_deployed`` layer outputs.
What agrees within a stated tolerance: the KL values behind the
allocation (``torch.log`` and ``jnp.log`` differ in the last bit on
~14% of inputs, and the 64-bin sums run in another order), ``apply_qat``
and the QAT CNN logits (fp32 matmuls and convolutions summed in another
order). Tests marked ``cuda`` hold the kernels behind ``apply_deploy``
and ``bind_deployed`` to their plain versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import PallasExecutor
from repro.compiler.lower import lower_network as lower_jax
from repro.compiler.program import GemmLayer as GemmLayerJax
from repro.core import hetero_linear as hl_jax
from repro.core import tpu_cost as tc_jax
from repro.core.scheduler import GemmDims as GemmDimsJax
from repro.kernels import hetero_matmul as hetero_matmul_jax
from repro.models import cnn as cnn_jax
from repro.quant import hybrid as hy_jax
from repro.quant import uniform as un_jax
from repro_torch import kernels
from repro_torch.compiler import CudaExecutor, GoldenExecutor
from repro_torch.compiler.lower import lower_network
from repro_torch.compiler.program import GemmLayer
from repro_torch.core import hetero_linear as hl
from repro_torch.core import tpu_cost as tc
from repro_torch.core.scheduler import XC7Z020, DspCoreConfig, GemmDims, \
    LutCoreConfig
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import cnn
from repro_torch.quant import hybrid as hy
from repro_torch.quant import uniform as un

CPU = torch.device("cpu")
#: KL values behind the allocation, port vs reference: max |diff|
#: (largest seen over 240 seeded weight sets: 3.8e-6, at 2-bit probes)
KL_TOL = 1e-5
#: apply_qat, port vs reference on the same params and input: max |diff|
#: within this fraction of max |y| (fp32 matmul summed in another order)
QAT_TOL = 1e-5
#: the QAT CNN forward, port vs reference on the same params and
#: images: max |diff| within this fraction of max |logit| (8-bit
#: activations, the whole reduced network; 6.3e-7 on resnet18, 3.8e-7
#: on mobilenet_v2) or of the layer's max |output| (4-bit activations,
#: one layer on the same input; up to 7.3e-7). The two packages sum
#: each convolution in another order; at 4-bit activations such an ulp
#: moves an activation across a rounding boundary of the next layer's
#: quantizer now and then, a whole step of 1/7 of its range, and over
#: 21 layers those steps reach the logits (seed 0: 1.49x max |logit|),
#: so at 4 bits the layers are compared on one input each.
CNN_QAT_TOL = 1e-5
#: the rel-MSE allocation metric, port vs reference: max |diff| (the
#: sums of squares run in another order)
MSE_TOL = 1e-6


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cfg_pair(in_f=64, out_f=48, ratio=0.4, bits=8, a_bits=8, **kw):
    q = dict(w_bits_lut=bits, a_bits=a_bits, ratio=ratio)
    return (hl.HeteroLinearConfig(in_f, out_f, hy.LayerQuantConfig(**q),
                                  **kw),
            hl_jax.HeteroLinearConfig(in_f, out_f,
                                      hy_jax.LayerQuantConfig(**q), **kw))


def _params(cfg_jax, seed):
    """The reference's params for ``seed``, and the same bits in the
    port."""
    pj = hl_jax.init_hetero_linear(jax.random.key(seed), cfg_jax)
    return hl.params_from_numpy(pj, device=CPU), pj


def _x(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


JAX_H100 = tc_jax.TPUChip(**dataclasses.asdict(tc.H100_SXM))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and the suite's
    workers each run a file at once, so a thread per core oversubscribes
    the machine (this file took 7x as long that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The straight-through fake quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fake_quant_forward_and_gradient_mask_exact(bits):
    rng = np.random.default_rng(bits)
    x = (2.0 * rng.standard_normal((37, 19))).astype(np.float32)
    g = rng.standard_normal((37, 19)).astype(np.float32)
    s = np.float32(4.0 / 2 ** (bits - 1))     # |x / s| reaches past hi
    yj, vjp = jax.vjp(lambda v: un_jax.fake_quant(v, jnp.float32(s), bits),
                      jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    st = torch.tensor(s).requires_grad_(True)
    yt = un.fake_quant(xt, st, bits)
    yt.backward(_t(g))
    assert np.array_equal(_bits(yt.detach()), _bits(yj))
    assert np.array_equal(_bits(xt.grad), _bits(gj))
    # outside the code range the gradient is 0, inside it is g
    lo, hi = un.qrange(bits)
    inside = (x / s >= lo) & (x / s <= hi)
    assert (~inside).any() and inside.any()
    assert np.array_equal(xt.grad.numpy(), np.where(inside, g, 0.0))
    assert st.grad is None                  # the scale gets no gradient


@pytest.mark.parametrize("bits,axis", [(4, 0), (8, 1), (3, 3)])
def test_fake_quant_per_channel_forward_and_gradient_exact(bits, axis):
    rng = np.random.default_rng(10 + bits)
    x = rng.standard_normal((3, 5, 4, 6)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    yj, vjp = jax.vjp(
        lambda v: un_jax.fake_quant_per_channel(v, bits, axis=axis),
        jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    yt = un.fake_quant_per_channel(xt, bits, axis=axis)
    yt.backward(_t(g))
    assert np.array_equal(_bits(yt.detach()), _bits(yj))
    assert np.array_equal(_bits(xt.grad), _bits(gj))
    assert np.array_equal(xt.grad.numpy(), g)         # identity STE


# ---------------------------------------------------------------------------
# Hybrid quantization
# ---------------------------------------------------------------------------


WEIGHTS = [(48, 64, 0), (192, 256, 1), (64, 576, 2), (100, 27, 3)]


def _filters(c_out, fan_in, seed):
    """Filters of spread magnitudes (so that they quantize unevenly)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((c_out, fan_in))
            * rng.uniform(0.1, 2.0, (c_out, 1))).astype(np.float32)


@pytest.mark.parametrize("bits", [2, 3, 6])        # probes 2, 3 and 4
@pytest.mark.parametrize("c_out,fan_in,seed", WEIGHTS)
def test_kl_allocation_permutation_equal(c_out, fan_in, seed, bits):
    w = _filters(c_out, fan_in, seed)
    probe = min(bits, 4)
    kl_j = np.asarray(hy_jax._filter_kl_divergence(jnp.asarray(w), probe))
    kl_t = hy._filter_kl_divergence(_t(w), probe).numpy()
    assert np.abs(kl_t - kl_j).max() <= KL_TOL
    for ratio in (0.0, 0.4, 1.0):
        q = dict(w_bits_lut=bits, ratio=ratio)
        perm_j = np.asarray(hy_jax.kl_filter_allocation(
            jnp.asarray(w), hy_jax.LayerQuantConfig(**q)))
        perm_t = hy.kl_filter_allocation(_t(w), hy.LayerQuantConfig(**q))
        assert perm_t.dtype == torch.int64
        assert np.array_equal(perm_t.numpy(), perm_j)


@pytest.mark.parametrize("c_out,fan_in,seed", WEIGHTS)
def test_mse_allocation_permutation_equal(c_out, fan_in, seed):
    w = _filters(c_out, fan_in, seed)
    for bits in (2, 6):
        assert np.abs(hy._filter_rel_mse(_t(w), bits).numpy() - np.asarray(
            hy_jax._filter_rel_mse(jnp.asarray(w), bits))).max() <= MSE_TOL
        q = dict(w_bits_lut=bits, ratio=0.3, alloc_metric="mse")
        assert np.array_equal(
            hy.kl_filter_allocation(_t(w), hy.LayerQuantConfig(**q)).numpy(),
            np.asarray(hy_jax.kl_filter_allocation(
                jnp.asarray(w), hy_jax.LayerQuantConfig(**q))))


def test_kl_allocation_ties_keep_index_order():
    """Identical filters tie exactly in both packages; the stable sort
    keeps them in index order, as ``jnp.argsort`` does."""
    base = _filters(4, 32, 7)
    w = np.concatenate([base, base, base])               # 12 filters
    q = dict(w_bits_lut=6, ratio=0.5)
    perm_t = hy.kl_filter_allocation(_t(w), hy.LayerQuantConfig(**q))
    perm_j = np.asarray(hy_jax.kl_filter_allocation(
        jnp.asarray(w), hy_jax.LayerQuantConfig(**q)))
    assert np.array_equal(perm_t.numpy(), perm_j)
    order = perm_t.numpy()
    for f in range(4):                  # copies of filter f, in order
        pos = [list(order).index(f + 4 * c) for c in range(3)]
        assert pos == sorted(pos)


@pytest.mark.parametrize("bits,ratio", [(2, 0.5), (6, 0.25), (8, 1.0),
                                        (3, 0.0)])
def test_hybrid_quantize_weight_bitwise(bits, ratio):
    w = _filters(16, 3 * 3 * 8, 20 + bits).reshape(16, 3, 3, 8)
    q = dict(w_bits_lut=bits, ratio=ratio)
    hj = hy_jax.hybrid_quantize_weight(jnp.asarray(w),
                                       hy_jax.LayerQuantConfig(**q))
    ht = hy.hybrid_quantize_weight(_t(w), hy.LayerQuantConfig(**q))
    for name in ("q_lut", "q_dsp", "s_lut", "s_dsp", "perm"):
        assert np.array_equal(_bits(getattr(ht, name)),
                              _bits(getattr(hj, name))), name
    assert ht.n_lut == hj.n_lut == round(16 * ratio)
    assert np.array_equal(_bits(ht.dequantize()), _bits(hj.dequantize()))


@pytest.mark.parametrize("bits", [2, 5, 8])
def test_hybrid_fake_quant_weight_forward_and_gradient_exact(bits):
    w = _filters(24, 40, 30 + bits)
    g = np.random.default_rng(bits).standard_normal(w.shape).astype(
        np.float32)
    q = dict(w_bits_lut=bits, ratio=0.4)
    yj, vjp = jax.vjp(lambda v: hy_jax.hybrid_fake_quant_weight(
        v, hy_jax.LayerQuantConfig(**q)), jnp.asarray(w))
    (gj,) = vjp(jnp.asarray(g))
    wt = _t(w).requires_grad_(True)
    yt = hy.hybrid_fake_quant_weight(wt, hy.LayerQuantConfig(**q))
    yt.backward(_t(g))
    assert np.array_equal(_bits(yt.detach()), _bits(yj))
    assert np.array_equal(_bits(wt.grad), _bits(gj))


def test_model_size_bits_equal():
    shapes = [(64, 27), (128, 576), (10, 512)]
    for bits, ratio in ((2, 0.5), (8, 0.25), (5, 1.0)):
        q = dict(w_bits_lut=bits, ratio=ratio)
        assert hy.model_size_bits(shapes, [hy.LayerQuantConfig(**q)] * 3) \
            == hy_jax.model_size_bits(shapes,
                                      [hy_jax.LayerQuantConfig(**q)] * 3)


# ---------------------------------------------------------------------------
# The chip cost record
# ---------------------------------------------------------------------------


def test_h100_record_is_the_data_sheet():
    c = tc.H100_SXM
    assert (c.bf16_flops, c.int8_ops, c.hbm_bw) == (989.4e12, 1978.9e12,
                                                    3.35e12)
    assert c.ici_bw == 25e9                      # NVLink, per link and way
    assert hl.HeteroLinearConfig(8, 8).chip is c
    import inspect
    for fn in (tc.hetero_gemm_cost, tc.solve_tpu_split, tc.roofline_terms):
        assert inspect.signature(fn).parameters["chip"].default is c


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("m,k,n", [(4096, 2048, 8192), (16, 256, 192),
                                   (4096, 1024, 1024), (8, 512, 4097)])
def test_cost_model_equal_on_one_chip_record(m, k, n, spatial):
    for bits, a_bits, ser in ((2, 4, False), (6, 8, False), (4, 4, True)):
        rj, sj, cj = tc_jax.solve_tpu_split(m, k, n, bits, a_bits, JAX_H100,
                                            spatial=spatial,
                                            serialize_activations=ser)
        rt, st, ct = tc.solve_tpu_split(m, k, n, bits, a_bits,
                                        spatial=spatial,
                                        serialize_activations=ser)
        assert (rt, st) == (rj, sj)
        assert np.array_equal(ct, cj)
        ratios = np.linspace(0, 1, 9)
        a = tc.hetero_gemm_cost(m, k, n, ratios, bits, a_bits,
                                serialize_activations=ser)
        b = tc_jax.hetero_gemm_cost(m, k, n, ratios, bits, a_bits, JAX_H100,
                                    serialize_activations=ser)
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name))


def test_roofline_terms_equal():
    for dtype in ("bf16", "int8"):
        a = tc.roofline_terms(3e12, 4e10, 2e9, 4, flops_dtype=dtype)
        b = tc_jax.roofline_terms(3e12, 4e10, 2e9, 4, JAX_H100,
                                  flops_dtype=dtype)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.dominant == b.dominant and a.bound_s == b.bound_s


# ---------------------------------------------------------------------------
# HeteroLinear: deploy, apply_deploy, apply_qat
# ---------------------------------------------------------------------------


def test_init_is_seeded_and_in_range():
    cfg, _ = _cfg_pair()
    a = hl.init_hetero_linear(torch.Generator().manual_seed(3), cfg,
                              device=CPU)
    b = hl.init_hetero_linear(torch.Generator().manual_seed(3), cfg,
                              device=CPU)
    assert torch.equal(a["w"], b["w"]) and a["w"].shape == (64, 48)
    assert float(a["w"].abs().max()) <= 1 / 8
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hl.init_hetero_linear(torch.Generator().manual_seed(3), cfg)


@pytest.mark.parametrize("ratio,bits,a_bits", [(0.4, 8, 8), (0.0, 4, 4),
                                               (0.25, 2, 4), (0.75, 6, 3),
                                               (1.0, 8, 8)])
def test_deploy_codes_bitwise(ratio, bits, a_bits):
    cfg, cfg_j = _cfg_pair(ratio=ratio, bits=bits, a_bits=a_bits)
    p, pj = _params(cfg_j, 2)
    dj = hl_jax.deploy(pj, cfg_j)
    d = hl.deploy(p, cfg)
    for f in dataclasses.fields(d):
        assert np.array_equal(_bits(getattr(d, f.name)),
                              _bits(getattr(dj, f.name))), f.name
    carried = hl.deployed_from_numpy(dj, device=CPU)
    for f in dataclasses.fields(d):
        assert np.array_equal(_bits(getattr(carried, f.name)),
                              _bits(getattr(d, f.name))), f.name


@pytest.mark.parametrize("ratio,bits,a_bits", [(0.4, 8, 8), (0.0, 4, 4),
                                               (0.25, 2, 4), (0.75, 6, 3),
                                               (1.0, 8, 8)])
def test_apply_deploy_plain_bitwise_reference(ratio, bits, a_bits):
    """On CPU tensors ``"auto"`` is the kernels' plain versions and
    ``"ref"`` the oracles: both bitwise equal to the reference's
    ``mode="ref"``, batch dimensions included."""
    cfg, cfg_j = _cfg_pair(ratio=ratio, bits=bits, a_bits=a_bits)
    p, pj = _params(cfg_j, 2)
    dj = hl_jax.deploy(pj, cfg_j)
    d = hl.deployed_from_numpy(dj, device=CPU)
    x = _x(3, (2, 5, 64))
    want = _bits(hl_jax.apply_deploy(dj, jnp.asarray(x), mode="ref"))
    for mode in ("auto", "ref"):
        got = hl.apply_deploy(d, _t(x), mode=mode)
        assert got.shape == (2, 5, 48) and got.dtype == torch.float32
        assert np.array_equal(_bits(got), want), mode


def test_apply_qat_within_tolerance_and_gradients():
    cfg, cfg_j = _cfg_pair()
    p, pj = _params(cfg_j, 0)
    x = _x(1, (10, 64))
    yj, vjp = jax.vjp(lambda w: hl_jax.apply_qat({"w": w}, jnp.asarray(x),
                                                  cfg_j), pj["w"])
    (gj,) = vjp(jnp.ones_like(yj))
    w = p["w"].clone().requires_grad_(True)
    y = hl.apply_qat({"w": w}, _t(x), cfg)
    y.sum().backward()
    scale = float(np.abs(np.asarray(yj)).max())
    assert float((y.detach() - _t(yj)).abs().max()) <= QAT_TOL * scale
    # the STEs pass the gradient as identity: d sum(x_q @ w_q) / dw is
    # x_q summed over rows, the same up to the fp32 sum's order
    gscale = float(np.abs(np.asarray(gj)).max())
    assert float((w.grad - _t(gj)).abs().max()) <= QAT_TOL * gscale
    # disabled: the plain fp linear
    off = dataclasses.replace(cfg, enabled=False)
    assert torch.equal(hl.apply_qat(p, _t(x), off), hl.apply_fp(p, _t(x)))


def test_solved_ratio_matches_reference_on_the_same_chip():
    cfg, cfg_j = _cfg_pair(in_f=256, out_f=192, bits=2, a_bits=4,
                           solve_ratio=True, spatial=True)
    cfg_j = dataclasses.replace(cfg_j, chip=JAX_H100)
    assert cfg.resolved_ratio() == cfg_j.resolved_ratio()
    assert 0.0 < cfg.resolved_ratio() < 1.0
    p, pj = _params(cfg_j, 5)
    assert np.array_equal(hl.column_allocation(p["w"], cfg).numpy(),
                          np.asarray(hl_jax.column_allocation(pj["w"],
                                                              cfg_j)))


# -- mirrors of tests/test_hetero_linear.py ----------------------------------


def test_deploy_matches_qat_bit_exactly():
    cfg, cfg_j = _cfg_pair()
    p, _ = _params(cfg_j, 0)
    x = _t(_x(1, (10, 64)))
    y_qat = hl.apply_qat(p, x, cfg)
    y_dep = hl.apply_deploy(hl.deploy(p, cfg), x)
    rel = float((y_dep - y_qat).abs().max() / y_qat.abs().max())
    assert rel < 1e-4, rel


@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.75, 1.0])
def test_deploy_all_ratios(ratio):
    cfg, cfg_j = _cfg_pair(ratio=ratio)
    p, _ = _params(cfg_j, 2)
    y = hl.apply_deploy(hl.deploy(p, cfg), _t(_x(3, (6, 64))))
    assert y.shape == (6, 48)
    assert bool(torch.isfinite(y).all())


def test_higher_bits_closer_to_fp():
    errs = []
    for bits in (2, 4, 8):
        cfg, cfg_j = _cfg_pair(ratio=1.0, bits=bits)  # all on the flex path
        p, _ = _params(cfg_j, 4)
        x = _t(_x(5, (20, 64)))
        y = hl.apply_deploy(hl.deploy(p, cfg), x)
        errs.append(float((y - hl.apply_fp(p, x)).abs().mean()))
    assert errs[0] > errs[1] > errs[2]


def test_column_allocation_is_permutation():
    cfg, cfg_j = _cfg_pair()
    p, _ = _params(cfg_j, 6)
    perm = hl.column_allocation(p["w"], cfg).numpy()
    assert sorted(perm.tolist()) == list(range(48))


def test_qat_gradients_flow():
    cfg, cfg_j = _cfg_pair()
    p, _ = _params(cfg_j, 7)
    w = p["w"].clone().requires_grad_(True)
    hl.apply_qat({"w": w}, _t(_x(8, (4, 64), 1.0)), cfg).sum().backward()
    assert float(w.grad.abs().sum()) > 0
    assert bool(torch.isfinite(w.grad).all())


# ---------------------------------------------------------------------------
# bind_deployed: a program layer bound from deploy()
# ---------------------------------------------------------------------------


def _fc_program(lower, layer, dims, m, k, n, n_lut):
    lut = LutCoreConfig(m=8, n=16, k=128)
    dsp = DspCoreConfig(n_reg_row_a=DspCoreConfig.rows_for_device(XC7Z020))
    return lower("fc", [layer("fc", dims(m, k, n))], lut, dsp, XC7Z020,
                 bits_w_lut=4, bits_a=8, n_luts=[n_lut])


@pytest.mark.parametrize("ratio", [0.0, 0.4, 1.0])
def test_bind_deployed_layer_bitwise(ratio):
    """A one-layer FC program bound from ``deploy()``: the port's
    executors' layer output is bitwise the reference executor's and
    ``hetero_matmul``'s LUT-first output."""
    m, k, n = 12, 64, 48
    cfg, cfg_j = _cfg_pair(in_f=k, out_f=n, ratio=ratio, bits=4)
    _, pj = _params(cfg_j, 9)
    dj = hl_jax.deploy(pj, cfg_j)
    d = hl.deployed_from_numpy(dj, device=CPU)
    n_lut = d.wq_serial.shape[1]
    prog = _fc_program(lower_network, GemmLayer, GemmDims, m, k, n, n_lut)
    prog_j = _fc_program(lower_jax, GemmLayerJax, GemmDimsJax, m, k, n,
                         n_lut)
    assert prog.fingerprint() == prog_j.fingerprint()
    x_q = np.random.default_rng(1).integers(-128, 128, (m, k)).astype(
        np.int8)
    ex_j = PallasExecutor(prog_j)
    ex_j.bind_deployed(0, dj)
    want = _bits(ex_j.run_layer(0, x_q))
    assert np.array_equal(want, _bits(hetero_matmul_jax(
        jnp.asarray(x_q), dj.wq_serial, dj.s_serial, dj.bits_serial,
        dj.wq_parallel, dj.s_parallel, mode="ref")))
    ref = kernels.hetero_matmul(_t(x_q), d.wq_serial, d.s_serial,
                                d.bits_serial, d.wq_parallel, d.s_parallel)
    assert np.array_equal(_bits(ref), want)
    for ex in (CudaExecutor(prog, device=CPU),
               CudaExecutor(prog, device=CPU, fused=False),
               GoldenExecutor(prog, device=CPU)):
        ex.bind_deployed(0, d)
        assert np.array_equal(_bits(ex.run_layer(0, x_q)), want), ex.name


# ---------------------------------------------------------------------------
# CNN workloads under hybrid quantization
# ---------------------------------------------------------------------------


def _qcfgs(specs, q_mod, **q):
    return [q_mod.LayerQuantConfig(**q) for _ in specs]


def test_cnn_quantized_forward_matches_reference():
    """The QAT forward of reduced resnet18 (8-bit activations) on the
    reference's params and images: logits within :data:`CNN_QAT_TOL` of
    max |logit|; the reference jitted, as a training step runs it."""
    cfg, cfg_j = cnn.reduced_config("resnet18"), \
        cnn_jax.reduced_config("resnet18")
    pj = cnn_jax.init(cfg_j, jax.random.key(0))
    p = cnn.params_from_numpy(pj, device=CPU)
    specs = cnn.specs_for(cfg)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    q = dict(w_bits_lut=6, a_bits=8, ratio=0.5)
    qj = _qcfgs(specs, hy_jax, **q)
    yj = np.asarray(jax.jit(lambda p_, x_: cnn_jax.forward(
        p_, x_, cfg_j, qj))(pj, jnp.asarray(x)))
    y = cnn.forward(p, _t(x), cfg, _qcfgs(specs, hy, **q))
    assert y.shape == (2, 10) and not bool(torch.isnan(y).any())
    err = float(np.abs(y.detach().numpy() - yj).max())
    assert err <= CNN_QAT_TOL * float(np.abs(yj).max()), err


@pytest.mark.parametrize("arch,name", [
    ("resnet18", "conv1"), ("resnet18", "conv5"), ("resnet18", "conv8_ds"),
    ("resnet18", "fc"), ("mobilenet_v2", "b3_dw"),
    ("mobilenet_v2", "b3_exp")])
def test_cnn_quantized_layer_matches_reference(arch, name):
    """One QAT conv layer at 4-bit activations (8 at the first and
    last) on one input: within :data:`CNN_QAT_TOL` of max |output|."""
    s = {sp.name: sp for sp in cnn.specs_for(cnn.reduced_config(arch))}[name]
    rng = np.random.default_rng(5)
    c_in = 1 if s.depthwise else s.c_in
    layer = {"w": (rng.standard_normal((s.kernel, s.kernel, c_in, s.c_out))
                   * (2.0 / (s.kernel ** 2 * c_in)) ** 0.5).astype(np.float32),
             "scale": rng.uniform(0.5, 1.5, s.c_out).astype(np.float32),
             "bias": np.zeros(s.c_out, np.float32)}
    x = rng.standard_normal((2, s.in_hw, s.in_hw, s.c_in)).astype(np.float32)
    q = dict(w_bits_lut=6, a_bits=4, ratio=0.5)
    want = np.asarray(cnn_jax.conv_layer(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x), s,
        hy_jax.LayerQuantConfig(**q)))
    got = cnn.conv_layer(cnn.params_from_numpy(layer, device=CPU), _t(x), s,
                         hy.LayerQuantConfig(**q))
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= CNN_QAT_TOL * float(np.abs(want).max()), err


@pytest.mark.parametrize("arch", ["resnet18", "mobilenet_v2"])
def test_cnn_quantized_smoke(arch):
    cfg = cnn.reduced_config(arch)
    specs = cnn.specs_for(cfg)
    p = cnn.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    y = cnn.forward(p, x, cfg, _qcfgs(specs, hy, w_bits_lut=6, a_bits=4,
                                      ratio=0.5))
    assert y.shape == (2, 10)
    assert not bool(torch.isnan(y).any())


def test_cnn_qat_improves_on_synthetic():
    """A few QAT steps on separable synthetic data reduce the loss."""
    cfg = cnn.reduced_config("resnet18")
    specs = cnn.specs_for(cfg)
    qcfgs = _qcfgs(specs, hy, w_bits_lut=8, a_bits=8, ratio=0.5)
    p = cnn.init(cfg, torch.Generator().manual_seed(0))
    batch = SyntheticImages(10, 16, 32, seed=0).next_batch()
    losses = []
    for _ in range(6):
        for leaf in (v for layer in p.values() for v in layer.values()):
            leaf.requires_grad_(True)
        loss = cnn.cross_entropy(cnn.forward(p, batch["images"], cfg, qcfgs),
                                 batch["labels"])
        loss.backward()
        with torch.no_grad():
            p = {name: {k: v - 0.05 * v.grad for k, v in layer.items()}
                 for name, layer in p.items()}
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [0.0, 0.4, 1.0])
def test_apply_deploy_kernels_match_plain_on_card(cuda, ratio):
    from repro_torch.kernels.build import LAUNCHES
    cfg, cfg_j = _cfg_pair(in_f=256, out_f=192, ratio=ratio, bits=6)
    p = hl.init_hetero_linear(torch.Generator().manual_seed(0), cfg,
                              device=cuda)
    d = hl.deploy(p, cfg)
    x = torch.randn((64, 256), generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    LAUNCHES.clear()
    got = hl.apply_deploy(d, x)
    n_ser = d.wq_serial.shape[1]
    assert dict(LAUNCHES) == {k: 1 for k, n in (
        ("bitserial_gemm", n_ser), ("int4_gemm", 192 - n_ser)) if n}
    want = hl.apply_deploy(d, x, mode="ref")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    cpu = hl.apply_deploy(d.to(CPU), x.cpu())
    assert torch.equal(got.cpu().view(torch.int32), cpu.view(torch.int32))
