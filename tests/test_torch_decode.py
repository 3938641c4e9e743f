"""The port's decode sessions against the JAX package, on the CPU.

One arch of each decode family (lm, ssm, hybrid) at its smoke config,
``batch=1``, ``max_seq=8``, ``-O 1`` — the operating point of the
reference's ``tests/test_decode_serving.py``:

  * the port's decode programs are the JAX compiler's (fingerprint,
    ``StepSpec``, layers, segment residency);
  * ``synthetic_decode_arrays`` draws the reference's bytes;
  * ``ExecutorSession`` (``cuda`` on CPU tensors, i.e. the kernels'
    plain versions, and ``golden``) is bitwise equal to the port's
    ``ReferenceSession`` at every step, per slot too;
  * against the JAX ``ReferenceSession``: every projection GEMM is
    bitwise equal on the int8 inputs the JAX session fed it, and the
    logits agree within :data:`LOGIT_TOL` (whether they came out
    bitwise is recorded as a test property);
  * steady-state weight elision, the simulator's warm-up/steady cycles,
    the refusals (message for message) and the CLI's decode report.

Tolerance for logits: 1e-5 of the largest |logit|. The glue's fp32
transcendentals (softmax, silu, sigmoid, tanh) and ``torch.mean`` /
``jnp.mean`` are separate implementations and may differ in the last
bit; every GEMM and every requant is exact, so the only way the logits
move is through such a bit, and at this operating point none has
moved them (they come out bitwise). A last-bit difference that flips a
requantized code moves the logits by far more than the tolerance: the
test is meant to fail then.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler import ExecutorSession as JExecutorSession
from repro.compiler import ReferenceSession as JReferenceSession
from repro.compiler import cli as jcli
from repro.compiler import compile_decode_network as jcompile_decode
from repro.compiler import steady_program as jsteady_program
from repro.compiler.runtime.base import ExecutionError as JExecutionError
from repro.compiler.runtime.session import \
    synthetic_decode_arrays as jsynthetic_decode_arrays
from repro.configs import registry as jregistry
from repro.core.scheduler import simulate_program as jsimulate_program
from repro_torch.compiler import ExecutionError, ExecutorSession, \
    ReferenceSession, cli, compile_decode_network, steady_program, \
    synthetic_decode_arrays
from repro_torch.compiler.runtime import base
from repro_torch.configs import registry
from repro_torch.core import isa
from repro_torch.core.scheduler import simulate_program
from repro_torch.kernels.build import LAUNCHES

CPU = torch.device("cpu")
FAMILIES = [("llama3.2-1b", "lm"), ("mamba2-780m", "ssm"),
            ("jamba-v0.1-52b", "hybrid")]
NAMES = [name for name, _ in FAMILIES]
TOKENS = [3, 5, 1]
LOGIT_TOL = 1e-5


def _kw(**kw):
    return {"batch": 1, "max_seq": 8, "opt_level": 1, **kw}


@pytest.fixture(scope="module")
def programs():
    """name -> (port program, JAX program), compiled once."""
    return {name: (compile_decode_network(name, **_kw()),
                   jcompile_decode(name, **_kw())) for name in NAMES}


def _weight_fetches(prog) -> int:
    """Stage-0 fetches that target a ``weights``-resident segment."""
    wbases = {s.base for s in prog.memory.segments
              if s.residency == "weights"}
    n = 0
    for lp in prog.layers:
        for cp in (lp.lut, lp.dsp):
            if cp is None:
                continue
            for op in cp.streams["fetch"]:
                if (isinstance(op.instr, isa.FetchInstr)
                        and op.instr.stage_ctrl == 0
                        and op.instr.ddr_base in wbases):
                    n += 1
    return n


def _residency(prog) -> dict:
    out: dict = {}
    for seg in prog.memory.segments:
        out[seg.residency] = out.get(seg.residency, 0) + 1
    return out


def _ref(prog, seed=0):
    sess = ReferenceSession(prog, device=CPU)
    sess.bind_synthetic_all(seed=seed)
    return sess


def _session(prog, backend, seed=0):
    sess = ExecutorSession(prog, backend=backend, device=CPU)
    sess.bind_synthetic_all(seed=seed)
    return sess


# ---------------------------------------------------------------------------
# programs, configs and synthetic weights are the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,family", FAMILIES, ids=NAMES)
def test_decode_program_matches_reference(programs, name, family):
    got, want = programs[name]
    assert got.step.family == family
    assert dataclasses.asdict(got.step) == dataclasses.asdict(want.step)
    assert got.fingerprint() == want.fingerprint()
    assert [(lp.index, lp.name, dataclasses.astuple(lp.dims), lp.n_lut,
             lp.bits_w_lut, lp.bits_a) for lp in got.layers] == \
        [(lp.index, lp.name, dataclasses.astuple(lp.dims), lp.n_lut,
          lp.bits_w_lut, lp.bits_a) for lp in want.layers]
    assert _residency(got) == _residency(want)
    assert {"weights", "io"} <= set(_residency(got))
    assert steady_program(got).fingerprint() == \
        jsteady_program(want).fingerprint()


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_decode_arch_configs_are_the_references(name):
    def view(cfg):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if f.name == "param_dtype":
                v = str(v).split(".")[-1]
            elif dataclasses.is_dataclass(v):
                v = dataclasses.asdict(v)
            out[f.name] = v
        return out

    arch, want = registry.get(name), jregistry.get(name)
    assert (arch.family, arch.module) == (want.family, want.module)
    for cfg, ref_cfg in ((arch.model, want.model), (arch.smoke, want.smoke)):
        got = view(cfg)
        exp = view(ref_cfg)
        exp["param_dtype"] = jnp.dtype(ref_cfg.param_dtype).name
        assert got == exp
        assert cfg.padded_vocab == ref_cfg.padded_vocab
        assert cfg.ssm.n_heads == ref_cfg.ssm.n_heads
        if name.startswith("jamba"):
            assert cfg.n_periods == ref_cfg.n_periods
            lm_view = view(ref_cfg.as_lm())
            lm_view["param_dtype"] = exp["param_dtype"]
            assert view(cfg.as_lm()) == lm_view


@pytest.mark.parametrize("seed", [None, 0], ids=["seed-none", "seed-0"])
def test_synthetic_decode_arrays_are_the_references(programs, seed):
    for name in NAMES:
        got_p, want_p = programs[name]
        got = synthetic_decode_arrays(got_p.layers, got_p.step, seed)
        want = jsynthetic_decode_arrays(want_p.layers, want_p.step, seed)
        assert sorted(got) == sorted(want)
        for key, arr in want.items():
            arr = np.asarray(arr)
            assert got[key].dtype == arr.dtype, key
            assert got[key].tobytes() == arr.tobytes(), key


def test_requantize_rows_is_requantize_at_batch1():
    """Bitwise ``requantize`` at batch 1, row by row above it, and the
    JAX package's ``requantize_rows`` codes on the same input."""
    from repro.compiler.runtime.base import requantize_rows as jrows
    rng = np.random.default_rng(0)
    for bits in (2, 4, 8):
        x = torch.from_numpy(rng.standard_normal((1, 300)).astype(np.float32)
                             * 7)
        assert torch.equal(base.requantize_rows(x, bits),
                           base.requantize(x, bits))
        xs = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
        rows = base.requantize_rows(xs, bits)
        for r in range(3):
            assert torch.equal(rows[r:r + 1], base.requantize(xs[r:r + 1],
                                                              bits))
        np.testing.assert_array_equal(rows.numpy(),
                                      np.asarray(jrows(xs.numpy(), bits)))


# ---------------------------------------------------------------------------
# the port's own executor/reference pair is bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "golden"])
@pytest.mark.parametrize("name,family", FAMILIES, ids=NAMES)
def test_session_step_matches_reference(programs, name, family, backend):
    prog, _ = programs[name]
    ref, sess = _ref(prog), _session(prog, backend)
    assert sess.session_name == backend and sess.device == CPU
    before = dict(LAUNCHES)
    for pos, t in enumerate(TOKENS):
        tok = np.array([t], np.int32)
        want, got = ref.step(tok, pos), sess.step(tok, pos)
        assert got.dtype == torch.float32 and got.device == CPU
        assert tuple(got.shape) == (1, prog.layers[-1].dims.n)
        assert torch.equal(got, want), (name, backend, pos)
    assert dict(LAUNCHES) == before         # plain versions on the CPU


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def _recording(sess, record, to_numpy):
    run = sess._run_layer

    def wrapped(index, x_q):
        out = run(index, x_q)
        record.append((index, to_numpy(x_q), to_numpy(out)))
        return out
    sess._run_layer = wrapped


@pytest.mark.parametrize("name,seed", [(n, 0) for n in NAMES]
                         + [("jamba-v0.1-52b", 7)],
                         ids=NAMES + ["jamba-v0.1-52b-seed7"])
def test_gemms_and_logits_match_jax(programs, record_property, name, seed):
    """Every projection GEMM of the port's sessions is bitwise equal to
    the JAX session's on the JAX session's own int8 inputs; the logits
    agree within LOGIT_TOL. (jamba at seed 0 saturates every SSM gate,
    1 + tanh(mean(bc)), to 0, so its logits are 0 on both sides; seed 7
    carries non-zero activations through the MoE and attention glue.)"""
    prog, jprog = programs[name]
    jref = JReferenceSession(jprog)
    jref.bind_synthetic_all(seed=seed)
    record: list = []
    _recording(jref, record, np.asarray)
    ref = _ref(prog, seed)
    cuda = _session(prog, "cuda", seed)
    bitwise, n_gemms, nonzero = True, 0, 0
    for pos, t in enumerate(TOKENS):
        tok = np.array([t], np.int32)
        record.clear()
        want = np.asarray(jref.step(tok, pos))
        got = ref.step(tok, pos).numpy()
        for index, x_q, out in record:
            x = torch.from_numpy(np.array(x_q))
            assert x.dtype == torch.int8
            np.testing.assert_array_equal(ref._run_layer(index, x).numpy(),
                                          out)
            np.testing.assert_array_equal(cuda._run_layer(index, x).numpy(),
                                          out)
            n_gemms += 1
        tol = LOGIT_TOL * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        bitwise &= bool(np.array_equal(got, want))
        nonzero += bool(np.abs(want).max() > 0)
    assert n_gemms == len(TOKENS) * len(prog.layers)    # each layer once
    record_property("logits_bitwise", bitwise)
    record_property("steps_with_nonzero_logits", nonzero)
    if name != "jamba-v0.1-52b" or seed:
        assert nonzero


def test_out_of_range_tokens_take_the_reference_rows(programs):
    """A token past the embedding table (what the launcher's compiled
    session gets: full-vocabulary prompts on the smoke program) or a
    negative one takes the row the reference's gather takes: JAX
    indexing counts a negative index from the end, then clamps."""
    prog, jprog = programs["llama3.2-1b"]
    vocab = prog.layers[-1].dims.n
    jref = JReferenceSession(jprog)
    jref.bind_synthetic_all(seed=0)
    ref, cuda = _ref(prog, 0), _session(prog, "cuda", 0)
    for pos, t in enumerate([vocab + 100, -1, -vocab - 3, vocab - 1]):
        tok = np.array([t], np.int32)
        want = np.asarray(jref.step(tok, pos))
        got = ref.step(tok, pos)
        assert torch.equal(cuda.step(tok, pos), got)
        tol = LOGIT_TOL * max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_cli_decode_report_matches_jax(capsys):
    """``python -m repro_torch.compiler llama3.2-1b --decode --execute
    --torch-device cpu`` decodes 4 tokens with the JAX CLI's checksum
    (the JAX CLI's own golden session)."""
    assert cli.main(["llama3.2-1b", "--decode", "--execute",
                     "--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("decoded")]
    assert len(line) == 1 and line[0].startswith(
        "decoded   4 token(s) via cuda session")
    got = float(line[0].rsplit("sum ", 1)[1].rstrip(")"))
    jprog = jcompile_decode("llama3.2-1b")
    jline = jcli.execute_report(jprog, backend="golden")
    want = float(jline.rsplit("sum ", 1)[1].rstrip(")"))
    assert jline.startswith("decoded   4 token(s) via golden session")
    assert got == pytest.approx(want, rel=LOGIT_TOL)


# ---------------------------------------------------------------------------
# steady-state weight elision and the simulator's decode cycles
# ---------------------------------------------------------------------------


def test_session_multi_step_never_refetches_weights(programs):
    """The session swaps to the steady image after the first step; on
    golden the contract checks run every fetch of every step, and only
    the warm-up program carries weight fetches."""
    prog, _ = programs["llama3.2-1b"]
    sess = _session(prog, "golden")
    assert not sess._warmed
    for pos in range(4):
        sess.step(np.array([1], np.int32), pos)
        assert sess._warmed
    assert _weight_fetches(sess.warm) > 0
    assert _weight_fetches(sess.steady) == 0
    assert sess.steady.stats().bytes_fetched < sess.warm.stats().bytes_fetched


@pytest.mark.parametrize("name", NAMES)
def test_decode_sim_matches_reference(programs, name):
    prog, jprog = programs[name]
    ds, want = simulate_program(prog), jsimulate_program(jprog)
    assert (ds.warmup_cycles, ds.steady_cycles, ds.total_cycles) == \
        (want.warmup_cycles, want.steady_cycles, want.total_cycles)
    assert ds.steady_cycles < ds.warmup_cycles
    assert ds.tokens_cycles(4) == ds.warmup_cycles + 3 * ds.steady_cycles


# ---------------------------------------------------------------------------
# per-slot decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_step_slots_matches_scalar_step_at_batch1(programs, name):
    prog, _ = programs[name]
    scalar, slots = _session(prog, "cuda"), _session(prog, "cuda")
    slots.reset(per_slot=True)
    for pos, tok in enumerate([3, 7, 11, 2]):
        want = scalar.step(tok, pos)
        assert torch.equal(slots.step_slots([tok], [pos]), want), pos


@pytest.mark.parametrize("backend", ["cuda", "golden"])
def test_staggered_slots_match_batch1_sessions(backend):
    """Request A decodes in slot 0 from step 0, request B is admitted
    into slot 1 at step 2 (``reset_slot``) while A is mid-flight; each
    row's logits equal a dedicated batch-1 session's at every step."""
    name = "jamba-v0.1-52b"
    prog2 = compile_decode_network(name, **_kw(batch=2))
    prog1 = compile_decode_network(name, **_kw())
    sess = _session(prog2, backend, seed=7)
    sess.reset(per_slot=True)
    solo = [_ref(prog1, seed=7), _ref(prog1, seed=7)]
    toks = {0: [5, 9, 2, 4, 1], 1: [7, 3, 6]}
    start = {0: 0, 1: 2}
    # slot 1 holds a stale request before B is admitted
    stale = [8, 8]
    for step in range(5):
        if step == start[1]:
            sess.reset_slot(1)
        t1 = toks[1][step - start[1]] if step >= start[1] else stale[step]
        p1 = step - start[1] if step >= start[1] else step
        logits = sess.step_slots([toks[0][step], t1], [step, p1])
        assert torch.equal(logits[0:1], solo[0].step(toks[0][step], step))
        if step >= start[1]:
            assert torch.equal(logits[1:2], solo[1].step(t1, p1)), step


# ---------------------------------------------------------------------------
# refusals, message for message
# ---------------------------------------------------------------------------


def _message(fn, exc=Exception):
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


def _both(fn):
    """The message each package's session raises for ``fn(package)``."""
    got = _message(lambda: fn("torch"), ExecutionError)
    want = _message(lambda: fn("jax"), JExecutionError)
    return got, want


def test_refusals_match_reference(programs):
    prog, jprog = programs["llama3.2-1b"]

    def session(pkg, per_slot=False, bind=True):
        if pkg == "torch":
            s = ExecutorSession(prog, backend="cuda", device=CPU)
        else:
            s = JExecutorSession(jprog, backend="golden")
        if bind:
            s.bind_synthetic_all(seed=0)
        if per_slot:
            s.reset(per_slot=True)
        return s

    cases = {
        "position": lambda p: session(p).step(1, 8),
        "negative position": lambda p: session(p).step(1, -1),
        "no embedding": lambda p: session(p, bind=False).step(1, 0),
        "token shape": lambda p: session(p).step([1, 2], 0),
        "reset_slot": lambda p: session(p).reset_slot(0),
        "slot range": lambda p: session(p, per_slot=True).reset_slot(3),
        "scalar step": lambda p: session(p, per_slot=True).step(1, 0),
        "step_slots": lambda p: session(p).step_slots([1], [0]),
        "slot positions": lambda p: session(p, per_slot=True).step_slots(
            [1], [8]),
    }
    for what, fn in cases.items():
        got, want = _both(fn)
        assert got == want, what
    assert "outside the session's [0, 8) cache window" in \
        _both(cases["position"])[0]

    # a layer no glue unit can place, and a program with no StepSpec
    bad = dataclasses.replace(prog, layers=[dataclasses.replace(
        prog.layers[0], name="b0.attn.w")] + list(prog.layers[1:]))
    jbad = dataclasses.replace(jprog, layers=[dataclasses.replace(
        jprog.layers[0], name="b0.attn.w")] + list(jprog.layers[1:]))
    got = _message(lambda: ReferenceSession(bad, device=CPU), ExecutionError)
    assert got == _message(lambda: JReferenceSession(jbad), JExecutionError)
    assert "cannot place layer 'b0.attn.w'" in got
    fixed = dataclasses.replace(prog, step=None)
    jfixed = dataclasses.replace(jprog, step=None)
    got = _message(lambda: ReferenceSession(fixed, device=CPU),
                   ExecutionError)
    assert got == _message(lambda: JReferenceSession(jfixed),
                           JExecutionError)


def test_bundle_is_refused(programs):
    """A multi-device bundle that is not decode-decorated is refused
    with the reference's message; a decorated ``filter`` x 2 decode
    bundle decodes bit-identically to the single-device
    ``ReferenceSession`` (the mirror of the reference's
    ``test_multi_device_decode_session_matches_single``) — residency
    decoration survives the split."""
    from repro.compiler import partition as jpartition
    from repro_torch.compiler import partition
    prog, _ = programs["llama3.2-1b"]
    bundle = compile_decode_network("llama3.2-1b", devices=2,
                                    partition="filter", **_kw())
    jbundle = jcompile_decode("llama3.2-1b", devices=2, partition="filter",
                              **_kw())
    undecorated = partition.MultiDeviceProgram(
        name=bundle.name, plan=bundle.plan,
        devices=[dataclasses.replace(p, step=None) for p in bundle.devices],
        edges=bundle.edges)
    jundecorated = jpartition.MultiDeviceProgram(
        name=jbundle.name, plan=jbundle.plan,
        devices=[dataclasses.replace(p, step=None) for p in jbundle.devices],
        edges=jbundle.edges)
    got = _message(lambda: ExecutorSession(undecorated, device=CPU),
                   ExecutionError)
    assert got == _message(lambda: JExecutorSession(jundecorated),
                           JExecutionError)
    assert "bundle is not decode-decorated" in got

    ref = ReferenceSession(prog, device=CPU)
    ref.bind_synthetic_all(seed=0)
    sess = ExecutorSession(bundle, backend="cuda", device=CPU)
    sess.bind_synthetic_all(seed=0)
    assert sess.session_name == "multi.cuda"
    for pos, t in enumerate([2, 7]):
        tok = np.array([t], np.int32)
        assert torch.equal(ref.step(tok, pos), sess.step(tok, pos))


def test_cuda_session_refuses_without_a_card(programs, monkeypatch):
    prog, _ = programs["llama3.2-1b"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ExecutorSession(prog),
                 lambda: ReferenceSession(prog)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
