"""Serving fleet: async program server + executor workers over the wire.

The counterpart of ``repro.serve.fleet``. The production-shaped tier
above ``serve/engine.py``: a
:class:`FleetServer` registers N executor workers (golden or cuda,
in-process threads or subprocesses — both speak the same
length-prefixed socket protocol, ``serve/protocol.py``), ships each
worker the compiled decode program image byte-for-byte from the
``launch/serve.py`` :class:`ProgramCache` plus its weight arrays, and
multiplexes many concurrent requests over decode-resident
``ExecutorSession`` slots:

* **continuous batching** — each worker hosts a ``batch``-slot
  per-slot decode session (``DecodeSession.step_slots``); new requests
  are admitted into free slots at step boundaries without draining the
  in-flight batch. Slot math is per-row bit-exact, so every request's
  tokens match a dedicated single-request session — the fleet's hard
  correctness gate.
* **serial dispatch** — the no-batching baseline (one request in
  service fleet-wide at a time, slot 0 only); the traffic generator's
  hard assert is that continuous beats this on requests/sec.
* **per-tenant admission** — :class:`TenantPolicy` caps a tenant's
  in-flight requests and the distinct compiled programs it may pin in
  the shared ``PROGRAM_CACHE``; violations raise
  :class:`AdmissionError` at submit time.
* **failure containment** — a crashed worker or a step timeout fails
  that worker's in-flight requests (:class:`RequestFailed`) and drops
  the worker; the server and the other workers keep serving.

:class:`BundleFleet` is the multi-device sibling: it splits an
``N3HBUND1`` image into its per-device ``N3HPROG1`` sections
byte-for-byte, ships one section per worker, shards full-layer weights
onto the owners, and drives the bundle's ``*.xdev`` channel hand-shake
over real transport (``chan`` frames carry the boundary activations,
named by the bundle's channel-edge table).

Every worker runs its executors on one explicit torch device
(``torch_device``, the card unless the caller asks for the CPU); a
``cuda`` worker launches the split-GEMM kernels or fails its requests
with :class:`RequestFailed` — it never serves on another backend or
device. Tensors cross the wire as numpy arrays (``.cpu().numpy()``).
The server builds the kernels once before it starts a ``cuda`` worker
on the card, so N workers never run nvcc at the same moment.

CLI: ``python -m repro_torch.serve.fleet --worker --connect HOST:PORT
--id W --backend cuda --torch-device cuda`` is the worker entry (what
subprocess mode spawns); ``python -m repro_torch.serve.fleet --demo``
runs a tiny self-contained fleet.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import concurrent.futures
import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.obs import METRICS
from repro_torch.serve.protocol import (
    FrameStream,
    ProtocolError,
    pack_arrays,
    read_frame,
    split_bundle_image,
    unpack_arrays,
    write_frame,
)


class FleetError(RuntimeError):
    """Base class for serving-fleet failures."""


class RequestFailed(FleetError):
    """A request could not be completed (worker crash, step timeout,
    or no live workers); surfaced on the request's future."""


class AdmissionError(FleetError):
    """Per-tenant admission rejected the request (in-flight or
    program-cache budget exceeded)."""


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission budget for one tenant: concurrent in-flight requests
    and distinct compiled programs pinned in the shared cache."""
    max_inflight: int = 64
    max_programs: int = 4


@dataclasses.dataclass
class _Request:
    rid: int
    tenant: str
    prompt: np.ndarray          # [s0] int32
    n_new: int
    future: concurrent.futures.Future
    submitted_at: float


class _Slot:
    """Per-slot decode state machine mirroring
    ``engine.greedy_generate_compiled``: feed prompt tokens one per
    step, then greedy-feed the argmax back; the request is done after
    ``s0 + n_new - 1`` steps with ``n_new`` collected tokens."""

    def __init__(self, req: _Request):
        self.req = req
        self.fed = 0
        self.pos = 0
        self.out: list[int] = []

    def next_token(self) -> int:
        if self.fed < len(self.req.prompt):
            return int(self.req.prompt[self.fed])
        return self.out[-1]

    def advance(self, argmax_tok: int) -> None:
        self.fed += 1
        self.pos += 1
        if self.fed >= len(self.req.prompt):
            self.out.append(int(argmax_tok))

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.n_new


class _Worker:
    """Server-side view of one registered worker connection."""

    def __init__(self, wid: str, backend: str, reader, writer):
        self.id = wid
        self.backend = backend
        self.reader = reader
        self.writer = writer
        self.alive = True
        self.ready = False
        self._seq = 0
        self.waiters: dict[int, asyncio.Future] = {}

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq


class FleetServer:
    """Async program server for decode-resident serving.

    ``workers`` is a list of ``(worker_id, backend, mode)`` triples
    with ``backend`` in ``{"golden", "cuda"}`` and ``mode`` in
    ``{"thread", "subprocess"}``. All workers serve the same compiled
    decode program (``batch_slots`` per-slot batch, ``max_seq`` cache
    window) shipped from the launcher's ``ProgramCache`` image, on
    ``torch_device``.
    """

    def __init__(self, arch: str, workers, *, batch_slots: int = 4,
                 max_seq: int = 16, bits_w: int = 4, bits_a: int = 4,
                 opt_level: int = 1, seed: int = 0,
                 policy: str = "continuous", step_timeout_s: float = 120.0,
                 load_timeout_s: float = 300.0,
                 heartbeat_s: float = 10.0,
                 tenants: dict[str, TenantPolicy] | None = None,
                 default_tenant_policy: TenantPolicy | None = None,
                 torch_device="cuda"):
        if policy not in ("continuous", "serial"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.arch = arch
        self.worker_specs = [tuple(w) for w in workers]
        self.slots = int(batch_slots)
        self.max_seq = int(max_seq)
        self.policy = policy
        self.step_timeout_s = step_timeout_s
        self.load_timeout_s = load_timeout_s
        self.heartbeat_s = heartbeat_s
        self.seed = seed
        self.torch_device = str(torch_device)
        self._tenants = dict(tenants or {})
        self._default_policy = default_tenant_policy or TenantPolicy()
        self._tenant_lock = threading.Lock()
        self._tenant_inflight: dict[str, int] = {}
        self._tenant_programs: dict[str, set] = {}

        from repro_torch.launch.serve import ProgramKey, \
            compiled_program_image
        self.key = ProgramKey(arch=arch, bits_w=bits_w, bits_a=bits_a,
                              opt_level=opt_level, mode="decode",
                              batch=self.slots, max_seq=self.max_seq)
        self._image = compiled_program_image(self.key)
        from repro_torch.compiler import asm
        prog = asm.from_binary(self._image)
        from repro_torch.compiler.runtime.session import \
            synthetic_decode_arrays
        self.spec = prog.step
        self._weights = pack_arrays(
            synthetic_decode_arrays(prog.layers, prog.step, seed))

        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._server: asyncio.AbstractServer | None = None
        self._running = False
        self.port: int | None = None
        self._workers: dict[str, _Worker] = {}
        self._queue: collections.deque[_Request] = collections.deque()
        self._work_event: asyncio.Event | None = None
        self._serial_lock: asyncio.Lock | None = None
        self._registered: dict[str, concurrent.futures.Future] = {}
        self._rid = 0
        self.threads: dict[str, threading.Thread] = {}
        self.processes: dict[str, subprocess.Popen] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetServer":
        """Start the event loop + listener, spawn the worker roster,
        and block until every worker has registered and loaded its
        program image (or raise :class:`FleetError`)."""
        _prebuild([b for _, b, _ in self.worker_specs], self.torch_device)
        self._running = True
        started = concurrent.futures.Future()
        self._thread = threading.Thread(
            target=self._loop_main, args=(started,), daemon=True,
            name="fleet-server")
        self._thread.start()
        self.port = started.result(timeout=30)
        for wid, backend, mode in self.worker_specs:
            self._registered[wid] = concurrent.futures.Future()
            self._spawn_worker(wid, backend, mode)
        for wid, fut in self._registered.items():
            try:
                fut.result(timeout=self.load_timeout_s)
            except concurrent.futures.TimeoutError:
                self.stop()
                raise FleetError(
                    f"worker {wid} did not register within "
                    f"{self.load_timeout_s}s") from None
        return self

    def _loop_main(self, started: concurrent.futures.Future) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        self._work_event = asyncio.Event()
        self._serial_lock = asyncio.Lock()

        async def _boot():
            self._server = await asyncio.start_server(
                self._handle_conn, "127.0.0.1", 0)
            return self._server.sockets[0].getsockname()[1]

        try:
            port = loop.run_until_complete(_boot())
        except Exception as e:              # pragma: no cover - boot failure
            started.set_exception(e)
            return
        started.set_result(port)
        loop.create_task(self._heartbeat_task())
        try:
            loop.run_forever()
        finally:
            tasks = asyncio.all_tasks(loop)
            for task in tasks:
                task.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True))
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    def _spawn_worker(self, wid: str, backend: str, mode: str) -> None:
        if mode == "thread":
            t = threading.Thread(
                target=_worker_entry,
                args=("127.0.0.1", self.port, wid, backend,
                      self.torch_device),
                daemon=True, name=f"fleet-worker-{wid}")
            t.start()
            self.threads[wid] = t
        elif mode == "subprocess":
            self.processes[wid] = _spawn_process(
                self.port, wid, backend, self.torch_device)
        else:
            raise ValueError(f"unknown worker mode {mode!r}")

    def stop(self) -> None:
        """Shut the fleet down: stop scheduling, close worker
        connections, stop the loop, reap subprocesses."""
        if not self._running:
            return
        self._running = False
        loop = self._loop
        if loop is not None and loop.is_running():
            async def _shutdown():
                for w in list(self._workers.values()):
                    if w.alive:
                        try:
                            write_frame(w.writer, "shutdown",
                                        {"seq": w.next_seq()})
                            await w.writer.drain()
                        except (ConnectionError, OSError):
                            pass
                        w.writer.close()
                if self._server is not None:
                    self._server.close()
                loop.stop()
            asyncio.run_coroutine_threadsafe(_shutdown(), loop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        # the workers leave their frame loop on the shutdown frame or
        # the closed socket; join them so none is left running torch
        # code when the interpreter exits
        for t in self.threads.values():
            t.join(timeout=10)
        for proc in self.processes.values():
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        for req in list(self._queue):
            self._fail(req, RequestFailed("fleet stopped"))
        self._queue.clear()

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- connection handling -------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        try:
            kind, hdr, _ = await read_frame(reader)
        except ProtocolError:
            writer.close()
            return
        if kind != "hello":
            writer.close()
            return
        w = _Worker(hdr.get("worker", "?"), hdr.get("backend", "?"),
                    reader, writer)
        self._workers[w.id] = w
        METRICS.incr("serve.fleet.workers.registered")
        METRICS.gauge("serve.fleet.workers", self._live_count())
        asyncio.get_running_loop().create_task(self._reader_task(w))
        try:
            await self._rpc(w, "load_program", {"per_slot": True},
                            self._image, timeout=self.load_timeout_s)
            await self._rpc(w, "bind_arrays", {}, self._weights,
                            timeout=self.load_timeout_s)
        except FleetError as e:
            self._drop_worker(w, e)
            return
        w.ready = True
        reg = self._registered.get(w.id)
        if reg is not None and not reg.done():
            reg.set_result(w.id)
        asyncio.get_running_loop().create_task(self._worker_loop(w))

    async def _reader_task(self, w: _Worker) -> None:
        try:
            while w.alive:
                kind, hdr, payload = await read_frame(w.reader)
                fut = w.waiters.pop(hdr.get("seq"), None)
                if fut is not None and not fut.done():
                    fut.set_result((kind, hdr, payload))
        except ProtocolError as e:
            self._drop_worker(w, RequestFailed(
                f"worker {w.id} connection lost: {e}"))

    def _drop_worker(self, w: _Worker, exc: Exception) -> None:
        if not w.alive:
            return
        w.alive = False
        w.ready = False
        for fut in list(w.waiters.values()):
            if not fut.done():
                fut.set_exception(RequestFailed(str(exc)))
        w.waiters.clear()
        try:
            w.writer.close()
        except (ConnectionError, OSError):
            pass
        METRICS.incr("serve.fleet.workers.dropped")
        METRICS.gauge("serve.fleet.workers", self._live_count())

    def _live_count(self) -> int:
        return sum(1 for w in self._workers.values() if w.alive)

    def live_workers(self) -> list[str]:
        return sorted(w.id for w in self._workers.values()
                      if w.alive and w.ready)

    # -- RPC -----------------------------------------------------------------

    async def _rpc(self, w: _Worker, kind: str, header: dict,
                   payload: bytes = b"",
                   timeout: float | None = None):
        if not w.alive:
            raise RequestFailed(f"worker {w.id} is dead")
        seq = w.next_seq()
        hdr = dict(header, seq=seq)
        fut = asyncio.get_running_loop().create_future()
        w.waiters[seq] = fut
        try:
            write_frame(w.writer, kind, hdr, payload)
            await w.writer.drain()
            rkind, rhdr, rpayload = await asyncio.wait_for(
                fut, timeout if timeout is not None
                else self.step_timeout_s)
        except asyncio.TimeoutError:
            raise RequestFailed(
                f"worker {w.id} {kind} timed out after "
                f"{timeout if timeout is not None else self.step_timeout_s}"
                f"s") from None
        except (ConnectionError, OSError) as e:
            raise RequestFailed(f"worker {w.id} send failed: {e}") from e
        finally:
            w.waiters.pop(seq, None)
        if rkind == "error":
            raise RequestFailed(
                f"worker {w.id}: {rhdr.get('message', 'remote error')}")
        return rhdr, rpayload

    async def _ping(self, w: _Worker) -> float:
        t0 = time.perf_counter()
        await self._rpc(w, "ping", {}, timeout=self.step_timeout_s)
        METRICS.incr("serve.fleet.heartbeats")
        return time.perf_counter() - t0

    def ping(self, worker_id: str) -> float:
        """Synchronous heartbeat to one worker; returns RTT seconds."""
        w = self._workers.get(worker_id)
        if w is None or not w.alive:
            raise RequestFailed(f"worker {worker_id} is not live")
        return asyncio.run_coroutine_threadsafe(
            self._ping(w), self._loop).result(self.step_timeout_s + 5)

    async def _heartbeat_task(self) -> None:
        while self._running:
            await asyncio.sleep(self.heartbeat_s)
            for w in list(self._workers.values()):
                if not (w.alive and w.ready):
                    continue
                try:
                    await self._ping(w)
                except FleetError as e:
                    self._drop_worker(w, e)

    # -- admission + submission ----------------------------------------------

    def tenant_policy(self, tenant: str) -> TenantPolicy:
        return self._tenants.get(tenant, self._default_policy)

    def admit_program(self, tenant: str, key) -> None:
        """Count ``key`` against the tenant's program-cache budget
        (and warm it in the shared cache); raises
        :class:`AdmissionError` over budget."""
        policy = self.tenant_policy(tenant)
        with self._tenant_lock:
            progs = self._tenant_programs.setdefault(tenant, set())
            if key not in progs and len(progs) >= policy.max_programs:
                METRICS.incr("serve.fleet.admission.rejected")
                raise AdmissionError(
                    f"tenant {tenant!r} exceeds its program budget "
                    f"({policy.max_programs})")
            progs.add(key)
        from repro_torch.launch.serve import compiled_program_image
        compiled_program_image(key)

    def submit(self, prompt, n_new: int, tenant: str = "default"
               ) -> concurrent.futures.Future:
        """Enqueue one request; the future resolves to the full token
        row ``[s0 + n_new] int32`` (prompt + greedy continuation,
        matching ``engine.greedy_generate_compiled``) or raises
        :class:`RequestFailed` / :class:`AdmissionError`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1 or n_new < 1:
            raise ValueError("need a non-empty prompt and n_new >= 1")
        if prompt.size + n_new > self.max_seq:
            raise ValueError(
                f"{prompt.size} prompt + {n_new} new tokens exceed the "
                f"fleet's max_seq={self.max_seq}")
        if not self.live_workers():
            METRICS.incr("serve.fleet.requests.failed")
            raise RequestFailed("no live workers")
        self.admit_program(tenant, self.key)
        policy = self.tenant_policy(tenant)
        with self._tenant_lock:
            if self._tenant_inflight.get(tenant, 0) >= policy.max_inflight:
                METRICS.incr("serve.fleet.admission.rejected")
                raise AdmissionError(
                    f"tenant {tenant!r} exceeds its in-flight budget "
                    f"({policy.max_inflight})")
            self._tenant_inflight[tenant] = \
                self._tenant_inflight.get(tenant, 0) + 1
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._tenant_lock:
            self._rid += 1
            req = _Request(self._rid, tenant, prompt, int(n_new), fut,
                           time.perf_counter())
        METRICS.incr("serve.fleet.requests.submitted")
        self._loop.call_soon_threadsafe(self._enqueue, req)
        return fut

    def _enqueue(self, req: _Request) -> None:
        self._queue.append(req)
        self._work_event.set()

    def _finish(self, req: _Request, tokens: np.ndarray) -> None:
        with self._tenant_lock:
            self._tenant_inflight[req.tenant] = max(
                0, self._tenant_inflight.get(req.tenant, 1) - 1)
        METRICS.incr("serve.fleet.requests.completed")
        METRICS.observe(
            "serve.fleet.request_ms",
            (time.perf_counter() - req.submitted_at) * 1e3)
        if not req.future.done():
            req.future.set_result(tokens)

    def _fail(self, req: _Request, exc: Exception) -> None:
        with self._tenant_lock:
            self._tenant_inflight[req.tenant] = max(
                0, self._tenant_inflight.get(req.tenant, 1) - 1)
        METRICS.incr("serve.fleet.requests.failed")
        if not req.future.done():
            req.future.set_exception(
                exc if isinstance(exc, FleetError)
                else RequestFailed(str(exc)))

    # -- scheduling ----------------------------------------------------------

    async def _wait_for_work(self) -> None:
        self._work_event.clear()
        if self._queue:
            return
        try:
            await asyncio.wait_for(self._work_event.wait(), 0.05)
        except asyncio.TimeoutError:
            pass

    async def _worker_loop(self, w: _Worker) -> None:
        slots: list[_Slot | None] = [None] * self.slots
        try:
            while self._running and w.alive:
                if self.policy == "serial":
                    if not self._queue:
                        await self._wait_for_work()
                        continue
                    req = self._queue.popleft()
                    async with self._serial_lock:
                        await self._serve_serial(w, req)
                    continue
                for j in range(self.slots):
                    if slots[j] is None and self._queue:
                        # claim the slot before the reset RPC so a
                        # worker failure mid-admission fails the
                        # request instead of losing it
                        slots[j] = _Slot(self._queue.popleft())
                        await self._rpc(w, "reset_slot", {"slot": j})
                        METRICS.incr("serve.fleet.admitted")
                if not any(slots):
                    await self._wait_for_work()
                    continue
                logits = await self._step(
                    w,
                    [s.next_token() if s else 0 for s in slots],
                    [s.pos if s else 0 for s in slots])
                for j, s in enumerate(slots):
                    if s is None:
                        continue
                    s.advance(int(np.argmax(logits[j])))
                    if s.done:
                        self._finish(s.req, np.concatenate(
                            [s.req.prompt,
                             np.asarray(s.out, np.int32)]))
                        slots[j] = None
        except (FleetError, ProtocolError) as e:
            for s in slots:
                if s is not None:
                    self._fail(s.req, e)
            self._drop_worker(w, e)

    async def _serve_serial(self, w: _Worker, req: _Request) -> None:
        """The baseline: one request alone on slot 0, run to
        completion before the fleet admits the next."""
        try:
            await self._rpc(w, "reset_slot", {"slot": 0})
            slot = _Slot(req)
            while not slot.done:
                logits = await self._step(
                    w, [slot.next_token()] + [0] * (self.slots - 1),
                    [slot.pos] + [0] * (self.slots - 1))
                slot.advance(int(np.argmax(logits[0])))
            self._finish(req, np.concatenate(
                [req.prompt, np.asarray(slot.out, np.int32)]))
        except (FleetError, ProtocolError) as e:
            self._fail(req, e)
            raise

    async def _step(self, w: _Worker, tokens: list[int],
                    pos: list[int]) -> np.ndarray:
        t0 = time.perf_counter()
        _, payload = await self._rpc(
            w, "step", {"tokens": tokens, "pos": pos},
            timeout=self.step_timeout_s)
        dt = time.perf_counter() - t0
        METRICS.observe(f"serve.fleet.worker.{w.id}.busy_ms", dt * 1e3)
        METRICS.incr("serve.fleet.steps")
        return unpack_arrays(payload)["logits"]


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


def _prebuild(backends, torch_device: str) -> None:
    """Build the kernel libraries once, in the server process, before
    any ``cuda`` worker on the card starts (each worker then only loads
    them); a build failure stops the fleet before it serves."""
    if "cuda" in backends and torch.device(torch_device).type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()


def _spawn_process(port: int, wid: str, backend: str,
                   torch_device: str) -> subprocess.Popen:
    """Start a worker subprocess (``--worker`` CLI) that connects back
    to ``port``."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.fleet", "--worker",
         "--connect", f"127.0.0.1:{port}", "--id", wid,
         "--backend", backend, "--torch-device", torch_device], env=env)


def _worker_entry(host: str, port: int, worker_id: str,
                  backend: str, torch_device="cuda") -> None:
    """Worker main: connect back to the server and serve frames until
    shutdown. Runs identically as an in-process thread or a
    subprocess (``--worker`` CLI) — same socket, same frames. Every
    executor runs on ``torch_device``; results go back as numpy."""
    from repro_torch.compiler import asm
    from repro_torch.compiler.runtime import (ExecutorSession, get_backend,
                                              requantize)

    sock = socket.create_connection((host, port))
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    fs = FrameStream(sock)
    fs.send("hello", {"worker": worker_id, "backend": backend,
                      "pid": os.getpid()})
    session = None
    executor = None
    chans: dict[str, np.ndarray] = {}
    prev_out = None
    try:
        while True:
            kind, hdr, payload = fs.recv()
            seq = hdr.get("seq")
            try:
                if kind == "ping":
                    fs.send("pong", {"seq": seq})
                elif kind == "shutdown":
                    break
                elif kind == "load_program":
                    prog = asm.from_binary(payload)
                    session = ExecutorSession(prog, backend=backend,
                                              device=torch_device)
                    session.reset(per_slot=bool(hdr.get("per_slot", True)))
                    fs.send("ready", {"seq": seq})
                elif kind == "load_section":
                    prog = asm.from_binary(payload)
                    executor = get_backend(backend)(prog,
                                                    device=torch_device)
                    fs.send("ready", {"seq": seq})
                elif kind == "bind_arrays":
                    arrays = unpack_arrays(payload)
                    if session is not None:
                        session.bind_arrays(arrays)
                    else:
                        for li in sorted({int(k.split(".")[0][1:])
                                          for k in arrays}):
                            executor.bind_layer(
                                li,
                                w_lut=arrays.get(f"L{li}.w_lut"),
                                s_lut=arrays.get(f"L{li}.s_lut"),
                                w_dsp=arrays.get(f"L{li}.w_dsp"),
                                s_dsp=arrays.get(f"L{li}.s_dsp"))
                    fs.send("ready", {"seq": seq})
                elif kind == "step":
                    logits = session.step_slots(hdr["tokens"], hdr["pos"])
                    fs.send("result", {"seq": seq},
                            pack_arrays({"logits": logits.cpu().numpy()}))
                elif kind == "reset_slot":
                    session.reset_slot(int(hdr["slot"]))
                    fs.send("ready", {"seq": seq})
                elif kind == "chan":
                    chans[hdr["channel"]] = unpack_arrays(payload)["x"]
                    fs.send("ready", {"seq": seq})
                elif kind == "run_layer":
                    if hdr.get("in_chan"):
                        x = chans.pop(hdr["in_chan"])
                    else:
                        # intra-stage chaining: requantize the held
                        # activation exactly like runtime.chain_layers
                        x = requantize(prev_out, int(hdr["requant_bits"]))
                    prev_out = executor.run_layer(int(hdr["layer"]), x)
                    if hdr.get("return_out"):
                        fs.send("result", {"seq": seq},
                                pack_arrays({"x": prev_out.cpu().numpy()}))
                    else:
                        fs.send("ready", {"seq": seq})
                else:
                    fs.send("error", {"seq": seq,
                                      "message": f"unexpected {kind}"})
            except Exception as e:  # surfaced server-side as RequestFailed
                fs.send("error", {"seq": seq,
                                  "message": f"{type(e).__name__}: {e}"})
    except ProtocolError:
        pass  # server went away
    finally:
        fs.close()


# ---------------------------------------------------------------------------
# Bundle fleet: one worker per device section, xdev hand-shake on the wire
# ---------------------------------------------------------------------------


class BundleFleet:
    """Distribute an ``N3HBUND1`` bundle across per-device workers.

    The server splits the cached bundle image into per-device
    ``N3HPROG1`` sections byte-for-byte, ships one section per worker,
    shards full-layer weights onto the owners (same column math as
    ``MultiDeviceExecutor.bind_layer``), and drives the chain with the
    bundle's ``*.xdev`` channel hand-shake over the socket: boundary
    activations travel as ``chan`` frames named by the channel-edge
    table, intra-stage layers chain locally on the worker.
    ``run(x)`` is bit-exact vs ``MultiDeviceExecutor.run`` on the same
    bundle (FC programs). Every worker runs on ``torch_device``.
    """

    def __init__(self, image: bytes, *, backends=None,
                 worker_mode: str = "thread", seed: int | None = 0,
                 timeout_s: float = 300.0, torch_device="cuda"):
        from repro_torch.compiler import asm
        from repro_torch.compiler.runtime.multi import global_layers
        self.meta, self.sections = split_bundle_image(image)
        self.bundle = asm.from_bundle_binary(image)
        self.glayers = global_layers(self.bundle)
        if any(gl.geometry is not None for gl in self.glayers):
            raise FleetError(
                "BundleFleet drives FC bundles; conv bundles run "
                "in-process via MultiDeviceExecutor")
        n = len(self.sections)
        self.backends = list(backends or ["cuda"] * n)
        if len(self.backends) != n:
            raise ValueError(
                f"{n}-device bundle needs {n} backends, got "
                f"{len(self.backends)}")
        self.worker_mode = worker_mode
        self.seed = seed
        self.timeout_s = timeout_s
        self.torch_device = str(torch_device)
        self._edges_in = {(e.dst_device, e.dst_layer): e
                          for e in self.bundle.edges}
        self._streams: dict[int, FrameStream] = {}
        self._seq = 0
        self._listener: socket.socket | None = None
        self.threads: list[threading.Thread] = []
        self.processes: list[subprocess.Popen] = []

    def start(self) -> "BundleFleet":
        _prebuild(self.backends, self.torch_device)
        self._listener = socket.socket()
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(len(self.sections))
        port = self._listener.getsockname()[1]
        for d, backend in enumerate(self.backends):
            wid = f"dev{d}"
            if self.worker_mode == "thread":
                t = threading.Thread(
                    target=_worker_entry,
                    args=("127.0.0.1", port, wid, backend,
                          self.torch_device),
                    daemon=True, name=f"bundle-worker-{wid}")
                t.start()
                self.threads.append(t)
            else:
                self.processes.append(_spawn_process(
                    port, wid, backend, self.torch_device))
        self._listener.settimeout(self.timeout_s)
        for _ in range(len(self.sections)):
            conn, _addr = self._listener.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            fs = FrameStream(conn)
            kind, hdr, _ = fs.recv()
            if kind != "hello":
                raise FleetError(f"expected hello, got {kind}")
            self._streams[int(hdr["worker"][3:])] = fs
        for d, fs in sorted(self._streams.items()):
            self._call(fs, "load_section", {"device": d},
                       self.sections[d])
        self._bind_synthetic()
        return self

    def _call(self, fs: FrameStream, kind: str, header: dict,
              payload: bytes = b"") -> tuple[dict, bytes]:
        self._seq += 1
        fs.send(kind, dict(header, seq=self._seq), payload)
        rkind, rhdr, rpayload = fs.recv()
        if rkind == "error":
            raise FleetError(rhdr.get("message", "remote error"))
        return rhdr, rpayload

    def _bind_synthetic(self) -> None:
        """Full-layer synthetic weights sharded onto the owners —
        identical RNG streams and column split as
        ``MultiDeviceExecutor.bind_synthetic``."""
        from repro_torch.compiler.runtime import synthetic_weights
        per_worker: dict[int, dict] = {d: {} for d in self._streams}
        for gl in self.glayers:
            w_lut, s_lut, w_dsp, s_dsp = synthetic_weights(
                gl.index, gl.dims.k, gl.n_lut, gl.dims.n - gl.n_lut,
                gl.bits_w_lut, self.seed)
            L = gl.n_lut
            w_lut = None if w_lut is None else np.asarray(w_lut)
            s_lut = None if s_lut is None else np.asarray(s_lut).reshape(-1)
            w_dsp = None if w_dsp is None else np.asarray(w_dsp)
            s_dsp = None if s_dsp is None else np.asarray(s_dsp).reshape(-1)
            for d, li, lo, hi in gl.placements:
                l0, l1 = min(lo, L), min(hi, L)
                d0, d1 = max(lo, L) - L, max(hi, L) - L
                shard = per_worker[d]
                if l1 > l0:
                    shard[f"L{li}.w_lut"] = w_lut[:, l0:l1]
                    shard[f"L{li}.s_lut"] = s_lut[l0:l1]
                if d1 > d0:
                    shard[f"L{li}.w_dsp"] = w_dsp[:, d0:d1]
                    shard[f"L{li}.s_dsp"] = s_dsp[d0:d1]
        for d, arrays in sorted(per_worker.items()):
            self._call(self._streams[d], "bind_arrays", {},
                       pack_arrays(arrays))

    def _chan_name(self, gl, d: int, li: int) -> str:
        edge = self._edges_in.get((d, li))
        suffix = edge.dst_channel if edge is not None else "in"
        return f"L{gl.index}.{suffix}"

    def run(self, x_q) -> np.ndarray:
        """Run the full chain over the fleet; returns the final fp32
        output (bit-exact vs the in-process bundle executor); the
        inter-layer requant runs here on the CPU, bit for bit the
        executors' on any device."""
        from repro_torch.compiler.runtime import requantize
        x = np.asarray(x_q, np.int8)
        prev_d: int | None = None
        out = None
        n = len(self.glayers)
        for gi, gl in enumerate(self.glayers):
            placements = [p for p in gl.placements if p[3] > p[2]]
            if out is not None:
                # server-side inter-layer requant (chain_layers rule)
                x = requantize(torch.from_numpy(out), gl.bits_a).numpy()
            if len(placements) == 1:
                d, li, _lo, _hi = placements[0]
                local = prev_d == d and out is None
                nxt_own = (self.glayers[gi + 1].placements
                           if gi + 1 < n else None)
                boundary = (gi == n - 1 or nxt_own is None
                            or len(nxt_own) != 1 or nxt_own[0][0] != d)
                fs = self._streams[d]
                hdr = {"layer": li, "return_out": boundary}
                if local:
                    hdr["requant_bits"] = gl.bits_a
                else:
                    chan = self._chan_name(gl, d, li)
                    self._call(fs, "chan", {"channel": chan},
                               pack_arrays({"x": x}))
                    hdr["in_chan"] = chan
                _, payload = self._call(fs, "run_layer", hdr)
                out = (unpack_arrays(payload)["x"] if boundary else None)
                prev_d = d
            else:
                # filter shards: scatter the activation, gather the
                # column shards in device order (the gather core role)
                shards = []
                for d, li, _lo, _hi in placements:
                    chan = self._chan_name(gl, d, li)
                    self._call(self._streams[d], "chan",
                               {"channel": chan}, pack_arrays({"x": x}))
                    _, payload = self._call(
                        self._streams[d], "run_layer",
                        {"layer": li, "in_chan": chan,
                         "return_out": True})
                    shards.append(unpack_arrays(payload)["x"])
                out = np.concatenate(shards, axis=1)
                prev_d = None
        return out

    def stop(self) -> None:
        for fs in self._streams.values():
            try:
                self._seq += 1
                fs.send("shutdown", {"seq": self._seq})
            except (ProtocolError, OSError):
                pass
            fs.close()
        if self._listener is not None:
            self._listener.close()
        for t in self.threads:
            t.join(timeout=10)
        for p in self.processes:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()

    def __enter__(self) -> "BundleFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serving-fleet worker / demo entry")
    ap.add_argument("--worker", action="store_true",
                    help="run as a fleet worker (connect back to the "
                         "server)")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT")
    ap.add_argument("--id", default="w0")
    ap.add_argument("--backend", default="cuda",
                    choices=("golden", "cuda"))
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device the worker's executors run on "
                         "(cpu runs the kernels' plain versions)")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny 2-worker fleet end to end")
    ap.add_argument("--arch", default="llama3.2-1b")
    args = ap.parse_args(argv)

    if args.worker:
        if not args.connect:
            raise SystemExit("--worker needs --connect HOST:PORT")
        host, port = args.connect.rsplit(":", 1)
        _worker_entry(host, int(port), args.id, args.backend,
                      args.torch_device)
        return

    if args.demo:
        with FleetServer(args.arch,
                         [("w0", "golden", "thread"),
                          ("w1", "golden", "thread")],
                         batch_slots=2, max_seq=8,
                         torch_device=args.torch_device) as fleet:
            futs = [fleet.submit([3, 11], 3) for _ in range(4)]
            for i, f in enumerate(futs):
                print(f"request {i}: {f.result(300).tolist()}")
        return

    ap.print_help()


if __name__ == "__main__":
    main()
