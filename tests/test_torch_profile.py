"""The port's profile report (``repro_torch.obs.report``, a copy of the
reference's) and the compiler CLI's ``--trace PATH`` / ``--profile``
against the JAX package's, on the CPU.

Both packages simulate the same compiled program (the compiler and the
simulator are copies, held byte for byte by
``tests/test_torch_compiler.py``), so the report's text and the trace
file's events must be equal, not close: the cycle counts are integers.
"""
import json

import pytest

from repro.compiler import cli as jcli
from repro.compiler import compile_network as jcompile
from repro.core.scheduler import simulate_program as jsimulate
from repro.obs import Tracer as JTracer
from repro.obs import profile_report as jprofile_report
from repro_torch import obs
from repro_torch.compiler import cli, compile_network
from repro_torch.core.scheduler import simulate_program
from repro_torch.obs import NULL_TRACER, Tracer, profile_report

NET = "llama3.2-1b"
SEQ = 16


@pytest.fixture(scope="module")
def single_prog():
    return compile_network(NET, seq_len=SEQ)


def test_profile_report_renders(single_prog):
    """``tests/test_obs.py::test_profile_report_renders`` on the port."""
    tracer = Tracer()
    simulate_program(single_prog, tracer=tracer)
    text = profile_report(tracer)
    assert "cycle accounting: closed" in text
    assert "dev0 lut/execute" in text
    assert "top stall causes" in text
    assert profile_report(NULL_TRACER).startswith("profile: no trace data")
    assert obs.profile_report is profile_report
    assert "profile_report" in obs.__all__


@pytest.mark.parametrize("kw", [{}, {"opt_level": 1},
                                {"devices": 2, "partition": "pipeline"}],
                         ids=["O0", "O1", "pipeline2"])
def test_profile_report_equals_reference(kw):
    texts = []
    for compile_fn, simulate, tracer, report in (
            (compile_network, simulate_program, Tracer(), profile_report),
            (jcompile, jsimulate, JTracer(), jprofile_report)):
        simulate(compile_fn(NET, seq_len=SEQ, **kw), batches=4,
                 tracer=tracer)
        texts.append(report(tracer, max_layer_rows=8))
    assert texts[0] == texts[1]
    assert "cycle accounting: closed" in texts[0]


@pytest.mark.parametrize("argv", [
    [NET, "-O", "1", "--seq-len", str(SEQ)],
    ["resnet18", "--in-hw", "32", "--width", "0.25", "--devices", "2",
     "--partition", "filter"]], ids=["llama-O1", "resnet18-filter2"])
def test_cli_trace_and_profile_equal_reference(argv, tmp_path, capsys):
    """``--trace PATH --profile``: the port's stdout equals the JAX CLI's
    (summary, ``trace`` line, report ending in the closure verdict), and
    the trace files hold the same events."""
    outs, traces = [], []
    for main, name in ((cli.main, "torch"), (jcli.main, "jax")):
        path = tmp_path / f"{name}.trace.json"
        assert main(argv + ["--trace", str(path), "--profile"]) == 0
        outs.append(capsys.readouterr().out.replace(str(path), "TRACE"))
        traces.append(json.loads(path.read_text()))
    assert outs[0] == outs[1]
    assert "cycle accounting: closed" in outs[0]
    assert "trace     TRACE (" in outs[0]
    assert traces[0] == traces[1]
    assert obs.validate_chrome_trace(traces[0]) == []


def test_cli_profile_alone_writes_no_trace(capsys):
    assert cli.main([NET, "--seq-len", "8", "--profile"]) == 0
    out = capsys.readouterr().out
    assert "== profile: makespan" in out and "trace     " not in out
