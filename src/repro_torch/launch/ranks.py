"""Start the ranks of a process group on one host, one process each.

``run_ranks(body, world, *args)`` spawns ``world`` processes. Each one
sets torch's thread count where ``threads`` is given, takes
``cuda:rank`` under NCCL, joins a ``backend`` group of ``world`` ranks
through ``init_method`` (by default ``tcp://127.0.0.1:<a free port>``),
calls ``body(rank, world, *args)``, waits at a barrier and leaves the
group. With ``backend=None`` it joins none: the body makes its own, as
a ``torchrun`` child's launcher does. A rank's exception fails the call
with its traceback; ranks still alive after ``timeout`` seconds are
killed and the call raises ``TimeoutError``.

The multi-rank CPU tests run gloo ranks on a ``file://`` store;
``chip_smoke.py`` runs gloo ranks that share one card, or NCCL ranks
with one card each. ``body`` must be importable by the spawned
processes (a module-level function).
"""
from __future__ import annotations

import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _enter(rank: int, world: int, backend: str | None, init_method: str,
           threads: int | None, body, args) -> None:
    if threads is not None:
        torch.set_num_threads(threads)
    if backend is None:
        body(rank, world, *args)
        return
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        body(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(body, world: int, *args, backend: str | None = "gloo",
              init_method: str | None = None, timeout: float = 120.0,
              threads: int | None = None) -> None:
    """``body(rank, world, *args)`` on ``world`` spawned ranks (see the
    module docstring)."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _enter, args=(world, backend, init_method, threads, body, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {body.__name__} ran "
                                   f"past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
