"""The port's compiler is the reference's compiler.

``repro_torch`` keeps its own copies of the reference's pure-Python
modules (it imports nothing of ``repro``). These tests hold the copies
to the originals: the copied files equal the originals with only their
imports rewritten, and the compiled programs have the same
fingerprints, splits, bit widths, geometries and elementwise tails. They
also guard the import boundary: nothing in ``src/repro_torch`` or
``chip_smoke.py`` imports JAX or the reference package.
"""
import ast
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.compiler import asm as jasm
from repro.compiler import cli as jcli
from repro.compiler import compile_decode_network as compile_decode_jax
from repro.compiler import compile_network as compile_jax
from repro.compiler import list_networks as jax_list_networks
from repro.compiler import network_layers as jax_network_layers
from repro.configs import registry as jregistry
from repro_torch.compiler import compile_decode_network as \
    compile_decode_torch
from repro_torch.compiler import compile_network as compile_torch
from repro_torch.compiler import asm, cli, list_networks, network_layers
from repro_torch.configs import registry
from repro_torch.core.workloads import WORKLOADS

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

#: modules copied verbatim from ``src/repro``, imports rewritten
COPIED = [
    "core/isa.py", "core/scheduler.py", "core/workloads.py",
    "core/latency_model.py", "core/split.py",
    "compiler/program.py", "compiler/lower.py", "compiler/passes.py",
    "compiler/networks.py", "compiler/asm.py", "compiler/partition.py",
    "obs/counters.py", "obs/trace.py", "obs/metrics.py", "obs/report.py",
    "serve/protocol.py", "core/cost_model.py", "dse/search.py",
    "checkpoint/watchdog.py", "configs/resnet18.py", "configs/mobilenet_v2.py",
]

#: modules copied from ``src/repro`` with their imports rewritten and then
#: exactly these (old, new) substitutions, each made once: the chip
#: record the environment defaults to (and the docstring that named
#: the reference's chip), and ``verify``'s second executor
#: (the reference compares golden with ``PallasExecutor``; the port with
#: ``CudaExecutor``, both on the torch device it is given)
SUBSTITUTED = {
    "dse/env.py": [
        ("from repro_torch.core.tpu_cost import TPUChip, V5E\n",
         "from repro_torch.core.tpu_cost import TPUChip, H100_SXM\n"),
        ("target_latency_ms: float, chip: TPUChip = V5E,",
         "target_latency_ms: float, chip: TPUChip = H100_SXM,"),
        ("    the split ratio is solved per layer against the v5e roofline (the\n",
         "    the split ratio is solved per layer against the chip's roofline (the\n"),
    ],
    "dse/evaluator.py": [
        ("""    def verify(self, info: dict, seed: int = 0) -> bool:
        \"\"\"Execute the config's compiled program functionally and check
        golden-vs-pallas bit-exactness layer by layer (the repo's
        standing cross-check for a program that "actually runs"):
        synthetic weights, synthetic quantized activations, exact
        integer comparison of every layer output.\"\"\"
        from repro_torch.compiler.runtime import (
            GoldenExecutor,
            PallasExecutor,
            bind_synthetic,
        )
""", """    def verify(self, info: dict, seed: int = 0,
               torch_device="cuda") -> bool:
        \"\"\"Execute the config's compiled program functionally and check
        golden-vs-cuda bit-exactness layer by layer (the repo's
        standing cross-check for a program that "actually runs"):
        synthetic weights, synthetic quantized activations, exact
        integer comparison of every layer output, both executors on
        ``torch_device``.\"\"\"
        from repro_torch.compiler.runtime import (
            CudaExecutor,
            GoldenExecutor,
            bind_synthetic,
        )
"""),
        ("        golden, pallas = GoldenExecutor(prog), PallasExecutor(prog)\n",
         "        golden = GoldenExecutor(prog, device=torch_device)\n"
         "        cuda = CudaExecutor(prog, device=torch_device)\n"),
        ("            bind_synthetic(pallas, lp, seed=seed + lp.index)\n",
         "            bind_synthetic(cuda, lp, seed=seed + lp.index)\n"),
        ("""            out_g = np.asarray(golden.run_layer(lp.index, x_q))
            out_p = np.asarray(pallas.run_layer(lp.index, x_q))
            if not (out_g == out_p).all():
""", """            out_g = golden.run_layer(lp.index, x_q).cpu().numpy()
            out_c = cuda.run_layer(lp.index, x_q).cpu().numpy()
            if not (out_g == out_c).all():
"""),
    ],
}

#: (network, keyword arguments); ``decode`` compiles the decode-step
#: program (``compile_decode_network``) instead of the fixed one, and
#: ``devices`` / ``partition`` a multi-device bundle
PROGRAMS = [
    ("resnet18", {}),
    ("resnet18", {"in_hw": 32, "width": 0.25}),
    ("mobilenet_v2", {}),
    ("llama3.2-1b", {"seq_len": 8}),
    ("llama3.2-1b", {"decode": True, "batch": 2, "max_seq": 16}),
    ("resnet18", {"in_hw": 32, "width": 0.25, "devices": 2,
                  "partition": "filter"}),
]


def _imports_rewritten(path: str) -> str:
    original = (ROOT / "src" / "repro" / path).read_text()
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  original, flags=re.M)


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_equals_original(path):
    assert (PORT / path).read_text() == _imports_rewritten(path)


@pytest.mark.parametrize("path", sorted(SUBSTITUTED))
def test_substituted_module_equals_original(path):
    want = _imports_rewritten(path)
    for old, new in SUBSTITUTED[path]:
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    assert (PORT / path).read_text() == want


def _layer_view(lp):
    geom = None if lp.geometry is None else dataclasses.astuple(lp.geometry)
    return (lp.index, lp.name, lp.dims.m, lp.dims.k, lp.dims.n, lp.n_lut,
            lp.bits_w_lut, lp.bits_a, lp.depthwise, geom,
            tuple(dataclasses.astuple(op) for op in lp.elementwise))


def _compile(fixed, decode, name, kw, opt_level):
    kw = dict(kw)
    fn = decode if kw.pop("decode", False) else fixed
    return fn(name, opt_level=opt_level, **kw)


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("name,kw", PROGRAMS,
                         ids=["resnet18", "resnet18-reduced", "mobilenet_v2",
                              "llama3.2-1b", "llama3.2-1b-decode",
                              "resnet18-reduced-filter2"])
def test_compiled_program_matches_reference(name, kw, opt_level):
    want = _compile(compile_jax, compile_decode_jax, name, kw, opt_level)
    got = _compile(compile_torch, compile_decode_torch, name, kw, opt_level)
    if hasattr(want, "devices"):
        # a bundle: the same image bytes, and each device program the
        # same as the reference's by the single-program checks below
        assert asm.to_bundle_binary(got) == jasm.to_bundle_binary(want)
        pairs = list(zip(got.devices, want.devices, strict=True))
    else:
        pairs = [(got, want)]
    for got, want in pairs:
        _same_program(got, want)


def _same_program(got, want):
    assert got.fingerprint() == want.fingerprint()
    assert (got.step and dataclasses.asdict(got.step)) == \
        (want.step and dataclasses.asdict(want.step))
    assert [_layer_view(lp) for lp in got.layers] == \
        [_layer_view(lp) for lp in want.layers]
    assert got.stats().n_instructions == want.stats().n_instructions


def test_resnet18_full_width_program_identity():
    prog = compile_torch("resnet18")
    assert len(prog.layers) == 21
    assert prog.fingerprint().startswith("7e19135d4d75")
    # every layer is split on both sides and carries a conv geometry
    assert all(0 < lp.n_lut < lp.dims.n and lp.geometry is not None
               for lp in prog.layers)


def _gemm_view(layers):
    return [(gl.name, dataclasses.astuple(gl.dims)) for gl in layers]


def test_networks_are_the_cnn_workloads():
    """The CNN workloads and the port's registry archs, each walked into
    the same GEMM layers as the JAX package's ``network_layers`` (LM
    archs at their smoke and their full configs)."""
    assert list_networks() == sorted(WORKLOADS) + registry.list_archs()
    assert list_networks() == jax_list_networks()
    assert len(network_layers("resnet18")) == 21
    for name in list_networks():
        assert _gemm_view(network_layers(name)) == \
            _gemm_view(jax_network_layers(name)), name
        if name not in WORKLOADS:
            assert _gemm_view(network_layers(name, smoke=False)) == \
                _gemm_view(jax_network_layers(name, smoke=False)), name
    with pytest.raises(KeyError, match="unknown arch"):
        network_layers("deepseek-v2-2360b")


def test_cli_summary_and_errors(capsys):
    assert cli.main(["resnet18", "--in-hw", "32", "--width", "0.25",
                     "--simulate"]) == 0
    out = capsys.readouterr().out
    assert "layers    21" in out and "simulated" in out
    # an LM arch compiles its smoke config: the JAX CLI's summary
    for argv in (["llama3.2-1b", "--seq-len", "8"],
                 ["mamba2-780m", "--decode", "--batch", "2"]):
        assert cli.main(argv) == 0
        got = capsys.readouterr().out
        assert jcli.main(argv) == 0
        assert got == capsys.readouterr().out
    assert "layers    9" in got and "decode    family=ssm batch=2" in got
    assert cli.main(["qwen3-8b"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["qwen3-8b"]) == 0
    assert got == capsys.readouterr().out
    # the MoE arch: its smoke config's 8 experts a layer walked as the
    # JAX CLI walks them
    assert cli.main(["qwen3-moe-235b-a22b"]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["qwen3-moe-235b-a22b"]) == 0
    assert got == capsys.readouterr().out
    # the last three archs ported: MLA with a dense prefix, M-RoPE and
    # the encoder-decoder, each walked as the JAX CLI walks it; MLA has
    # no decode program in either
    for arch in ("deepseek-v2-236b", "qwen2-vl-2b", "seamless-m4t-large-v2"):
        assert cli.main([arch]) == 0
        got = capsys.readouterr().out
        assert jcli.main([arch]) == 0
        assert got == capsys.readouterr().out
    assert cli.main(["deepseek-v2-236b", "--decode"]) == 2
    got = capsys.readouterr().err
    assert jcli.main(["deepseek-v2-236b", "--decode"]) == 2
    assert got == capsys.readouterr().err
    assert "MLA" in got
    assert cli.main(["resnet18", "--ratio", "2"]) == 2
    assert cli.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list_networks()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), mod) for f in files
           for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_executor_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.compiler.runtime.cuda, "
            "repro_torch.core, repro_torch.core.hetero_linear, "
            "repro_torch.dse, repro_torch.dse.__main__, "
            "repro_torch.models.cnn, repro_torch.quant; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
