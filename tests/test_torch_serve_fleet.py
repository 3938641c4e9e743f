"""The port's compiled serving path and serving fleet, on the CPU.

The mirror of ``tests/test_serve_fleet.py`` and of the serving cases of
``tests/test_decode_serving.py`` for ``repro_torch``, at llama3.2-1b's
smoke config with every worker on ``torch_device="cpu"`` (the ``cuda``
backend then runs the kernels' plain versions):

  * wire protocol (a copy of the reference's): frame round trips and
    rejections, deterministic array packing, ``N3HBUND1`` sections
    split byte for byte;
  * per-slot decode and staggered admission, bitwise equal to
    dedicated batch-1 sessions;
  * the fleet: registration and heartbeat, tokens bitwise equal to a
    single-process ``greedy_generate_compiled`` for ``cuda`` and
    ``golden`` workers (threads and subprocesses), continuous and
    serial policies, tenant admission, a crashed subprocess worker and
    a step timeout failing the request while the server stays up, and
    a ``cuda`` worker that cannot run on its device refusing to serve;
  * ``BundleFleet`` bitwise equal to the in-process
    ``MultiDeviceExecutor`` for both plan kinds;
  * the launcher's ``ProgramCache`` (LRU hits, misses, eviction, decode
    keys) and ``compiled_program_image`` bytes equal to the JAX
    package's; ``launch.serve --quantize ... --fleet`` end to end.

Every token comparison is exact: the sessions' GEMMs and requants are
bitwise on any device, and a request's tokens do not depend on which
worker or slot served it.
"""
import concurrent.futures
import time

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.compiler import (
    ExecutionError,
    ExecutorSession,
    GemmLayer,
    MultiDeviceExecutor,
    asm,
    compile_decode_network,
    derive_plan,
    from_bundle_binary,
    lower_partitioned,
    to_bundle_binary,
)
from repro_torch.core.scheduler import (
    XC7Z020,
    DspCoreConfig,
    GemmDims,
    LutCoreConfig,
)
from repro_torch.kernels.build import LAUNCHES
from repro_torch.launch import serve
from repro_torch.obs import METRICS
from repro_torch.serve import fleet as fleet_mod
from repro_torch.serve import protocol
from repro_torch.serve.engine import (
    ServeState,
    greedy_generate_compiled,
    make_compiled_decode_fn,
    make_compiled_session,
)
from repro_torch.serve.fleet import (
    AdmissionError,
    BundleFleet,
    FleetError,
    FleetServer,
    RequestFailed,
    TenantPolicy,
    _Request,
    _Slot,
)
from repro_torch.serve.protocol import (
    ProtocolError,
    decode_frame,
    encode_frame,
    pack_arrays,
    split_bundle_image,
    unpack_arrays,
)

ARCH = "llama3.2-1b"
MAX_SEQ = 8
SLOTS = 2
SEED = 0
CPU = "cpu"

LUT = LutCoreConfig(m=8, n=16, k=128)
DSP = DspCoreConfig(n_reg_row_a=13)
CHAIN = [GemmLayer("fc0", GemmDims(24, 32, 48)),
         GemmLayer("fc1", GemmDims(24, 48, 40)),
         GemmLayer("fc2", GemmDims(24, 40, 36)),
         GemmLayer("fc3", GemmDims(24, 36, 20))]


def _chain_bundle(kind):
    plan = derive_plan(CHAIN, 2, kind)
    return lower_partitioned("toy", CHAIN, plan, LUT, DSP, XC7Z020,
                             bits_w_lut=6, bits_a=4, opt_level=1)


# ---------------------------------------------------------------------------
# Wire protocol
# ---------------------------------------------------------------------------


def test_frame_roundtrip_every_kind():
    for kind in protocol.KINDS:
        hdr = {"seq": 7, "slot": 1, "channel": "L2.xdev"}
        payload = bytes(range(64))
        k, h, p = decode_frame(encode_frame(kind, hdr, payload))
        assert (k, h, p) == (kind, hdr, payload)
    assert decode_frame(encode_frame("ping")) == ("ping", {}, b"")
    assert (encode_frame("step", {"b": 1, "a": 2})
            == encode_frame("step", {"a": 2, "b": 1}))


def test_frame_rejects_structural_defects():
    with pytest.raises(ProtocolError):
        encode_frame("warp_cores")          # unknown kind
    good = encode_frame("result", {"seq": 1}, b"xyz")
    with pytest.raises(ProtocolError):
        decode_frame(b"NOPE" + good[4:])    # bad magic
    with pytest.raises(ProtocolError):
        decode_frame(good[:8])              # short frame
    with pytest.raises(ProtocolError):
        decode_frame(good + b"\x00")        # trailing bytes
    bad_ver = bytearray(good)
    bad_ver[4] = 99
    with pytest.raises(ProtocolError):
        decode_frame(bytes(bad_ver))        # unsupported version
    bad_kind = bytearray(good)
    bad_kind[5] = 200
    with pytest.raises(ProtocolError):
        decode_frame(bytes(bad_kind))       # unknown kind code


def test_pack_arrays_roundtrip_and_determinism():
    rng = np.random.default_rng(0)
    arrays = {
        "L0.w_lut": rng.integers(-8, 8, (16, 12)).astype(np.int8),
        "L0.s_lut": rng.random(12).astype(np.float32),
        "embed": rng.random((4, 3, 2)),
        "scalar": np.float64(2.5),
        "big_endian": np.arange(5, dtype=">i4"),
        # what a worker sends back: a tensor's numpy view
        "logits": torch.arange(6, dtype=torch.float32).reshape(2, 3)
        .cpu().numpy(),
    }
    blob = pack_arrays(arrays)
    back = unpack_arrays(blob)
    assert sorted(back) == sorted(arrays)
    for name in arrays:
        np.testing.assert_array_equal(back[name], arrays[name])
    assert back["big_endian"].dtype == np.dtype("<i4")
    reordered = {k: arrays[k] for k in reversed(list(arrays))}
    assert pack_arrays(reordered) == blob


def test_unpack_arrays_rejects_corrupt_payloads():
    blob = pack_arrays({"x": np.arange(4, dtype=np.int32)})
    with pytest.raises(ProtocolError):
        unpack_arrays(blob + b"\x00")       # trailing bytes
    with pytest.raises(ProtocolError):
        unpack_arrays(blob[:-3])            # truncated data
    with pytest.raises(ProtocolError):
        unpack_arrays(b"\xff\xff\xff\xff")  # absurd count, no data


def test_split_bundle_image_sections_byte_exact():
    mdp = _chain_bundle("pipeline")
    image = to_bundle_binary(mdp)
    meta, sections = split_bundle_image(image)
    assert sections == [asm.to_binary(p) for p in mdp.devices]
    assert meta["bundle"] == mdp.name
    assert len(meta["edges"]) == len(mdp.edges)
    with pytest.raises(ProtocolError):
        split_bundle_image(b"BOGUS123" + image[8:])
    with pytest.raises(ProtocolError):
        split_bundle_image(image + b"\x00")


# ---------------------------------------------------------------------------
# Per-slot decode sessions (the continuous-batching substrate)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def oracle():
    """Single-process batch-1 session on the CPU: the fleet's hard
    bit-exactness reference."""
    prog = compile_decode_network(ARCH, batch=1, max_seq=MAX_SEQ,
                                  opt_level=1)
    session = ExecutorSession(prog, backend="cuda", device=CPU)
    session.bind_synthetic_all(seed=SEED)
    return prog, session


def _oracle_tokens(session, prompt, n_new):
    row = greedy_generate_compiled(
        session, np.asarray(prompt, np.int32)[None, :], n_new)
    return row[0].numpy()


def test_step_slots_matches_scalar_step_at_batch1(oracle):
    prog, _ = oracle
    scalar = ExecutorSession(prog, backend="golden", device=CPU)
    scalar.bind_synthetic_all(seed=SEED)
    scalar.reset()
    slots = ExecutorSession(prog, backend="cuda", device=CPU)
    slots.bind_synthetic_all(seed=SEED)
    slots.reset(per_slot=True)
    for pos, tok in enumerate([3, 7, 11, 2]):
        ref = scalar.step(tok, pos)
        got = slots.step_slots([tok], [pos])
        assert torch.equal(got, ref)
    with pytest.raises(ExecutionError):
        slots.step(0, 0)
    with pytest.raises(ExecutionError):
        scalar.reset_slot(0)


def _mk_slot(prompt, n_new):
    return _Slot(_Request(0, "t", np.asarray(prompt, np.int32), n_new,
                          concurrent.futures.Future(), 0.0))


def test_staggered_admission_is_bit_exact(oracle, fleet):
    prog = asm.from_binary(serve.compiled_program_image(fleet.key))
    sess = ExecutorSession(prog, backend="cuda", device=CPU)
    sess.bind_synthetic_all(seed=SEED)
    sess.reset(per_slot=True)
    a = _mk_slot([5, 9], 3)
    b = None
    for step in range(4 + 3):               # a: 4 steps, b: 3, staggered by 2
        if step == 2:
            sess.reset_slot(1)
            b = _mk_slot([7, 3], 2)
        toks = [a.next_token() if not a.done else 0,
                b.next_token() if b and not b.done else 0]
        pos = [a.pos, b.pos if b else 0]
        logits = sess.step_slots(toks, pos).numpy()
        if not a.done:
            a.advance(int(np.argmax(logits[0])))
        if b is not None and not b.done:
            b.advance(int(np.argmax(logits[1])))
    _, osess = oracle
    np.testing.assert_array_equal(
        np.asarray(a.out), _oracle_tokens(osess, [5, 9], 3)[2:])
    np.testing.assert_array_equal(
        np.asarray(b.out), _oracle_tokens(osess, [7, 3], 2)[2:])


# ---------------------------------------------------------------------------
# FleetServer end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fleet():
    server = FleetServer(
        ARCH,
        [("w0", "cuda", "thread"), ("w1", "golden", "thread")],
        batch_slots=SLOTS, max_seq=MAX_SEQ, seed=SEED,
        tenants={"small": TenantPolicy(max_inflight=1, max_programs=1)},
        torch_device=CPU)
    with server as f:
        yield f


def test_worker_registration_and_heartbeat(fleet):
    assert fleet.live_workers() == ["w0", "w1"]
    assert fleet.ping("w0") >= 0.0
    assert fleet.ping("w1") >= 0.0
    assert METRICS.counter("serve.fleet.workers.registered") >= 2
    with pytest.raises(RequestFailed):
        fleet.ping("w99")


REQS = [([5], 2), ([3, 11], 3), ([1, 2, 3], 4), ([9, 8], 2)]


def test_fleet_tokens_bit_exact_vs_single_process(fleet, oracle):
    _, osess = oracle
    before = dict(LAUNCHES)
    futs = [fleet.submit(p, n) for p, n in REQS]
    for (p, n), fut in zip(REQS, futs):
        np.testing.assert_array_equal(np.asarray(fut.result(600)),
                                      _oracle_tokens(osess, p, n))
    assert dict(LAUNCHES) == before       # plain versions on the CPU


@pytest.mark.parametrize("backend,mode,policy", [
    ("cuda", "subprocess", "continuous"), ("golden", "thread", "serial")])
def test_single_backend_fleet_bit_exact(oracle, backend, mode, policy):
    """Each backend alone, in each worker mode and policy, serves the
    single-process tokens."""
    _, osess = oracle
    with FleetServer(ARCH, [("w0", backend, mode)], batch_slots=SLOTS,
                     max_seq=MAX_SEQ, seed=SEED, policy=policy,
                     torch_device=CPU) as server:
        futs = [server.submit(p, n) for p, n in REQS]
        for (p, n), fut in zip(REQS, futs):
            np.testing.assert_array_equal(np.asarray(fut.result(600)),
                                          _oracle_tokens(osess, p, n))


def test_continuous_admission_overlaps_requests(fleet):
    steps0 = METRICS.counter("serve.fleet.steps")
    admitted0 = METRICS.counter("serve.fleet.admitted")
    reqs = [([2, 4], 3)] * 4                # 4 steps each served alone
    futs = [fleet.submit(p, n) for p, n in reqs]
    for fut in futs:
        fut.result(600)
    assert METRICS.counter("serve.fleet.admitted") - admitted0 == 4
    assert METRICS.counter("serve.fleet.steps") - steps0 < 16


def test_submit_validates_request_shape(fleet):
    with pytest.raises(ValueError):
        fleet.submit([], 2)                 # empty prompt
    with pytest.raises(ValueError):
        fleet.submit([1, 2], 0)             # no new tokens
    with pytest.raises(ValueError):
        fleet.submit([1] * MAX_SEQ, 1)      # exceeds the cache window
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        FleetServer(ARCH, [], policy="lifo", torch_device=CPU)


def test_tenant_inflight_admission(fleet):
    fut = fleet.submit([1, 2], 5, tenant="small")
    with pytest.raises(AdmissionError):     # budget: 1 in flight
        fleet.submit([1], 1, tenant="small")
    assert np.asarray(fut.result(600)).shape == (7,)
    fleet.submit([1], 1, tenant="small").result(600)


def test_tenant_program_admission(fleet):
    rejected0 = METRICS.counter("serve.fleet.admission.rejected")
    fleet.admit_program("small", fleet.key)
    with pytest.raises(AdmissionError):     # budget: 1 distinct program
        fleet.admit_program("small", ("decode", "other-arch", 4, 4))
    assert (METRICS.counter("serve.fleet.admission.rejected")
            > rejected0)


# ---------------------------------------------------------------------------
# Failure containment
# ---------------------------------------------------------------------------


def _wait_until(predicate, timeout_s=10.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_worker_crash_fails_request_server_stays_up():
    # a long request (30 steps) killed as soon as the worker admits it:
    # the port's steps take milliseconds, so a fixed sleep could let
    # the request finish first
    server = FleetServer(ARCH, [("w0", "golden", "subprocess")],
                         batch_slots=SLOTS, max_seq=32, seed=SEED,
                         torch_device=CPU)
    with server:
        admitted0 = METRICS.counter("serve.fleet.admitted")
        fut = server.submit([1, 2, 3], 28)
        assert _wait_until(lambda: METRICS.counter("serve.fleet.admitted")
                           > admitted0, timeout_s=60.0)
        server.processes["w0"].kill()
        with pytest.raises(RequestFailed):
            fut.result(120)
        assert server._thread.is_alive()
        assert _wait_until(lambda: server.live_workers() == [])
        with pytest.raises(RequestFailed):
            server.submit([1], 1)           # no live workers left


def test_step_timeout_fails_request_server_stays_up():
    server = FleetServer(ARCH, [("w0", "cuda", "thread")],
                         batch_slots=SLOTS, max_seq=MAX_SEQ, seed=SEED,
                         step_timeout_s=0.001, torch_device=CPU)
    with server:
        fut = server.submit([1, 2], 3)
        with pytest.raises(RequestFailed):
            fut.result(120)
        assert server._thread.is_alive()
        assert _wait_until(lambda: server.live_workers() == [])
        with pytest.raises(RequestFailed):
            server.submit([1], 1)


def test_cuda_worker_without_a_card_does_not_serve(monkeypatch):
    """A ``cuda`` worker on a device it cannot use fails its program
    load (the session refuses a missing card); the worker never
    registers and the fleet does not start. Nothing falls back to the
    CPU or to golden."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fleet_mod, "_prebuild", lambda *a: None)
    server = FleetServer(ARCH, [("w0", "cuda", "thread")],
                         batch_slots=SLOTS, max_seq=MAX_SEQ, seed=SEED,
                         load_timeout_s=2.0, torch_device="cuda")
    with pytest.raises(FleetError, match="did not register"):
        server.start()
    assert server.live_workers() == []


# ---------------------------------------------------------------------------
# Bundle fleet: xdev hand-shake over real transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pipeline", "filter"])
def test_bundle_fleet_bit_exact_vs_in_process(kind):
    mdp = _chain_bundle(kind)
    image = to_bundle_binary(mdp)
    mex = MultiDeviceExecutor(from_bundle_binary(image), backend="cuda",
                              device=CPU)
    for gi in range(mdp.n_layers):
        mex.bind_synthetic(gi)
    x = np.random.default_rng(0).integers(-8, 8, (24, 32)).astype(np.int8)
    ref = mex.run(x).numpy()
    with BundleFleet(image, seed=None, backends=["cuda", "golden"],
                     torch_device=CPU) as bf:
        assert len(bf.sections) == 2
        got = np.asarray(bf.run(x))
    np.testing.assert_array_equal(got, ref)


def test_bundle_fleet_refuses_conv_bundles():
    from repro_torch.compiler import compile_network
    image = to_bundle_binary(compile_network(
        "resnet18", in_hw=32, width=0.25, devices=2, partition="filter"))
    with pytest.raises(FleetError, match="FC bundles"):
        BundleFleet(image, torch_device=CPU)


# ---------------------------------------------------------------------------
# Compiled sessions, the program cache, the launcher
# ---------------------------------------------------------------------------


def test_greedy_generate_compiled_roundtrip():
    sess = make_compiled_session(ARCH, backend="cuda", max_seq=8, seed=0,
                                 torch_device=CPU)
    assert METRICS.snapshot()["gauges"]["serve.decode.steady_cycles"] > 0
    prompts = np.array([[3, 1, 4]], np.int32)
    out = greedy_generate_compiled(sess, prompts, 3)
    assert out.shape == (1, 6) and out.dtype == torch.int32
    assert (out[:, :3].numpy() == prompts).all()
    out2 = greedy_generate_compiled(sess, torch.from_numpy(prompts), 3)
    assert torch.equal(out, out2)
    with pytest.raises(ValueError, match="exceed the session's max_seq=8"):
        greedy_generate_compiled(sess, prompts, 64)
    with pytest.raises(ValueError, match="compiled for batch=1"):
        greedy_generate_compiled(sess, np.zeros((2, 3), np.int32), 1)
    # the uniform decode signature over the same session
    decode_fn = make_compiled_decode_fn(sess)
    sess.reset()
    state = ServeState(cache="untouched", pos=0)
    logits, cache = decode_fn(None, np.array([[3]]), state.cache, state.pos)
    assert cache == "untouched" and logits.shape[0] == 1


def test_program_cache_decode_mode_key():
    cache = serve.ProgramCache(maxsize=4)
    key = serve.ProgramKey(arch=ARCH, mode="decode", batch=1, max_seq=8,
                           opt_level=1)
    image = cache.get(key)
    assert image[:8] == b"N3HPROG1"
    rt = asm.from_binary(image)
    assert rt.step is not None and rt.step.max_seq == 8
    assert cache.get(key) == image          # LRU hit, not a recompile
    assert cache.info()["hits"] == 1
    fixed = cache.get(serve.ProgramKey(arch=ARCH, seq_len=8, opt_level=1))
    assert fixed != image and asm.from_binary(fixed).step is None


def test_serving_program_cache_lru():
    serve.PROGRAM_CACHE.clear()
    key = serve.ProgramKey(arch=ARCH, seq_len=4, opt_level=0)
    img1 = serve.compiled_program_image(key)
    assert img1[:8] == b"N3HPROG1"
    assert serve.compiled_program_image(key) is img1
    info = serve.PROGRAM_CACHE.info()
    assert info["hits"] == 1 and info["misses"] == 1
    bkey = serve.ProgramKey(arch=ARCH, seq_len=4, opt_level=0, devices=2,
                            partition="pipeline")
    assert serve.compiled_program_image(bkey)[:8] == b"N3HBUND1"
    assert serve.PROGRAM_CACHE.info()["misses"] == 2
    serve.PROGRAM_CACHE.clear()


def test_serving_program_cache_evicts():
    cache = serve.ProgramCache(maxsize=1)
    k0 = serve.ProgramKey(arch=ARCH, seq_len=4, opt_level=0)
    k1 = serve.ProgramKey(arch=ARCH, seq_len=8, opt_level=0)
    cache.get(k0)
    cache.get(k1)                         # evicts k0
    cache.get(k0)                         # miss again
    assert cache.info() == {"programs": 1, "hits": 0, "misses": 3,
                            "maxsize": 1}


@pytest.mark.parametrize("fields", [
    dict(bits_w=4, bits_a=8, ratio=0.5, seq_len=64),
    dict(mode="decode", batch=1, max_seq=16, bits_a=4, ratio=0.5),
    dict(bits_a=8, ratio=0.5, seq_len=64, devices=2, partition="filter"),
    dict(mode="decode", batch=1, max_seq=16, devices=2,
         partition="pipeline")],
    ids=["fixed", "decode", "bundle", "decode-bundle"])
def test_compiled_program_image_equals_reference(fields):
    key = serve.ProgramKey(arch=ARCH, **fields)
    got = serve.ProgramCache().get(key)
    want = jserve.ProgramCache().get(jserve.ProgramKey(arch=ARCH, **fields))
    assert got == want


def test_launcher_quantize_accel_and_fleet(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--quantize", "--accel-devices", "2",
                      "--accel-partition", "filter", "--fleet", "2",
                      "--batch", "2", "--prompt-len", "8",
                      "--new-tokens", "8"])
    text = capsys.readouterr().out
    for line in ("# accel program N3HBUND1", "# accel decode program",
                 "# accel decode session [cuda]", "quantized=True",
                 "# fleet[2 workers]: 6 requests"):
        assert line in text, line
    key = jserve.ProgramKey(arch=ARCH, bits_w=4, bits_a=8, ratio=0.5,
                            opt_level=1, seq_len=8, devices=2,
                            partition="filter")
    assert out["accel_image"] == jserve.ProgramCache().get(key)
    # the fleet demo's tokens are a single-process session's
    sess = make_compiled_session(ARCH, backend="golden", batch=1,
                                 max_seq=8, seed=0, torch_device=CPU)
    want = greedy_generate_compiled(sess, np.array([[3, 11]]), 3)[0]
    for row in out["fleet_tokens"]:
        np.testing.assert_array_equal(row, want.numpy())
    assert out["accel_tokens"].shape == (1, 8)
