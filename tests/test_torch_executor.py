"""``CudaExecutor`` on the CPU against the reference's ``PallasExecutor``.

A reduced resnet18 (``in_hw=32, width=0.25``) runs through both
packages on the same weight codes — carried across from the reference
executor with ``bind_numpy_weights`` — and the same seed-made image.
The tolerance is zero: the logits, every layer's GEMM output and every
stored requant code must be bitwise equal. On the CPU the port's
kernel wrappers compute their plain versions; ``chip_smoke.py`` holds
the CUDA kernels to those on the card.
"""
import numpy as np
import pytest
import torch

from repro.compiler import PallasExecutor
from repro.compiler import bind_synthetic as bind_synthetic_jax
from repro.compiler import compile_network as compile_jax
from repro.compiler.runtime.base import chain_layers as chain_jax
from repro.compiler.runtime.base import synthetic_weights as synth_jax
from repro_torch.compiler import CudaExecutor, bind_numpy_weights, \
    bind_synthetic, compile_network, execute_report
from repro_torch.compiler.runtime.base import apply_pool, chain_layers, \
    im2col_patches, requantize, synthetic_weights

REDUCED = {"in_hw": 32, "width": 0.25}


def _recording(run_layer, store):
    """Wrap ``run_layer`` to keep each layer's input codes and output."""
    def run(index, x):
        out = run_layer(index, x)
        store[index] = (np.asarray(x), np.asarray(out))
        return out
    return run


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype != np.int8 else a


@pytest.fixture(scope="module")
def reference():
    """The reference run: program, bound weights, image, logits and the
    per-layer (input codes, GEMM output) of the chain."""
    prog = compile_jax("resnet18", **REDUCED)
    ex = PallasExecutor(prog)
    for lp in prog.layers:
        bind_synthetic_jax(ex, lp, seed=lp.index)
    weights = {i: tuple(None if a is None else np.asarray(a)
                        for a in (w.w_lut, w.s_lut, w.w_dsp, w.s_dsp))
               for i, w in ex._weights.items()}
    rng = np.random.default_rng(0)
    lp0 = prog.layers[0]
    image = rng.integers(-8, 8, lp0.geometry.in_shape).astype(np.int8)
    layers = {}
    logits = np.asarray(chain_jax(prog.layers,
                                  _recording(ex.run_layer, layers), image,
                                  tail_factory=ex._elementwise_tail))
    assert np.array_equal(logits, np.asarray(ex.run(image)))
    return prog, weights, image, logits, layers


def _port(prog_jax, weights, **kw):
    prog = compile_network("resnet18", **REDUCED)
    assert prog.fingerprint() == prog_jax.fingerprint()
    ex = CudaExecutor(prog, device="cpu", **kw)
    bind_numpy_weights(ex, weights)
    return ex


def test_logits_and_codes_bitwise_equal_reference(reference):
    prog_jax, weights, image, logits, layers = reference
    ex = _port(prog_jax, weights)
    got_layers = {}
    got = chain_layers(ex.program.layers, _recording(ex.run_layer,
                                                     got_layers),
                       ex._as_codes(image))
    assert got.dtype == torch.float32 and got.shape == (1, 1000)
    assert np.isfinite(got.numpy()).all()
    assert np.array_equal(_bits(got.numpy()), _bits(logits))
    assert sorted(got_layers) == sorted(layers) == list(range(21))
    for i in layers:
        x_ref, out_ref = layers[i]
        x_got, out_got = got_layers[i]
        # layer i's input is its producer's stored requant codes
        assert np.array_equal(x_got, x_ref), f"layer {i} input codes"
        assert np.array_equal(_bits(out_got), _bits(out_ref)), \
            f"layer {i} GEMM output"
    assert torch.equal(ex.run(image), got)


@pytest.mark.parametrize("kw", [{"fused": False}, {"mode": "ref"}],
                         ids=["per-partition", "plain"])
def test_other_paths_bitwise_equal_reference(reference, kw):
    prog_jax, weights, image, logits, _ = reference
    ex = _port(prog_jax, weights, **kw)
    assert np.array_equal(_bits(ex.run(image).numpy()), _bits(logits))


def test_staged_inputs_take_the_same_bits(reference):
    """A conv layer handed the pre-staged [m, k] matrix takes the dense
    fused entry (or, with fused=False, the per-partition path)."""
    prog_jax, weights, _, _, layers = reference
    fused = _port(prog_jax, weights)
    split = _port(prog_jax, weights, fused=False)
    for lp in fused.program.layers:
        x_sp, out = layers[lp.index]
        staged = im2col_patches(torch.tensor(x_sp), lp.geometry)
        staged = staged.reshape(lp.dims.m, lp.dims.k)
        for ex in (fused, split):
            got = ex.run_layer(lp.index, staged)
            assert np.array_equal(_bits(got.numpy()), _bits(out)), lp.name
            got = ex.run_layer(lp.index, x_sp)
            assert np.array_equal(_bits(got.numpy()), _bits(out)), lp.name


def test_execute_report_checksum_matches_reference(reference):
    """The CLI path binds the same synthetic codes and image as the
    reference's ``execute_report``, so the checksums agree."""
    _, _, _, logits, _ = reference
    line = execute_report(compile_network("resnet18", **REDUCED),
                          device="cpu")
    assert line.startswith("executed  21/21 layers end to end via cuda")
    assert f"|out| sum {float(np.abs(logits).sum()):.6e}" in line


def test_cli_execute_on_cpu(reference, capsys):
    from repro_torch.compiler.cli import main
    _, _, _, logits, _ = reference
    assert main(["resnet18", "--in-hw", "32", "--width", "0.25",
                 "--execute", "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "executed  21/21 layers end to end via cuda backend" in out
    assert f"|out| sum {float(np.abs(logits).sum()):.6e}" in out


def test_synthetic_weights_match_reference():
    for args in [(0, 147, 48, 16, 4), (3, 64, 0, 10, 8), (5, 9, 9, 0, 2)]:
        for a, b in zip(synthetic_weights(*args), synth_jax(*args)):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = compile_network("resnet18", **REDUCED)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaExecutor(prog)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_report(prog)


def test_tail_numerics_match_reference():
    """Max pool (SAME, -inf padding), global average pool (sequential
    float32 sum x float32(1/n)) and requant, against the reference's
    jnp ops on the same inputs."""
    import jax.numpy as jnp
    from repro.compiler.runtime.base import apply_pool as pool_jax
    from repro.compiler.runtime.base import requantize as requant_jax
    rng = np.random.default_rng(3)
    for hw in (7, 8, 15, 16):
        x = rng.standard_normal((hw, hw, 5)).astype(np.float32)
        got = apply_pool(torch.from_numpy(x), "max").numpy()
        assert np.array_equal(_bits(got), _bits(pool_jax(jnp.asarray(x),
                                                         "max")))
    for _ in range(20):
        x = rng.standard_normal((7, 7, 64)).astype(np.float32)
        got = apply_pool(torch.from_numpy(x), "gap").numpy()
        assert np.array_equal(_bits(got), _bits(pool_jax(jnp.asarray(x),
                                                         "gap")))
        for bits in (4, 8):
            assert np.array_equal(requantize(torch.from_numpy(x), bits),
                                  np.asarray(requant_jax(jnp.asarray(x),
                                                         bits)))


def test_unbound_and_malformed_inputs_raise(reference):
    from repro_torch.compiler import ExecutionError
    prog_jax, weights, image, _, _ = reference
    ex = CudaExecutor(compile_network("resnet18", **REDUCED), device="cpu")
    with pytest.raises(ExecutionError, match="no bound weights"):
        ex.run_layer(0, image)
    bind_numpy_weights(ex, weights)
    with pytest.raises(ExecutionError, match="activations must be"):
        ex.run_layer(0, image[:5])
    lp = ex.program.layers[0]
    w = list(weights[0])
    w[0] = w[0] * 100
    with pytest.raises(ValueError, match="exceed"):
        ex.bind_layer(0, *w)
    with pytest.raises(ValueError, match="mode"):
        CudaExecutor(ex.program, device="cpu", mode="kernel")
    assert lp.n_lut > 0


def test_bind_synthetic_equals_carried_weights(reference):
    prog_jax, weights, image, logits, _ = reference
    ex = CudaExecutor(compile_network("resnet18", **REDUCED), device="cpu")
    for lp in ex.program.layers:
        bind_synthetic(ex, lp, seed=lp.index)
    assert np.array_equal(_bits(ex.run(image).numpy()), _bits(logits))
