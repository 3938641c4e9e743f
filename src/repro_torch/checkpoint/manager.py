"""Async, atomic checkpointing of the port's training state, in the
reference's on-disk format.

The counterpart of ``repro.checkpoint.manager``, written for torch
trees (nested dicts and lists of tensors, and the dataclasses
``TrainState`` / ``OptState`` / ``CompressionState``) but keeping the
reference's format byte for byte, so a checkpoint crosses between the
packages in both directions:

  * ``step_XXXXXXXXXX/`` holds ``manifest.json`` (``{"step", "leaves":
    {key: {"file", "shape", "dtype"}}}``) and one ``leaf_XXXXX.npy`` per
    leaf, numbered in the sorted order of the keys;
  * a key is the leaf's path joined by ``//`` as the reference's
    ``jax.tree_util`` paths print: a dict key as itself, a list index as
    its number, a dataclass field as ``.name`` (``.params//layers//wq``,
    ``.opt//.m//…``, ``.opt//.count``, ``.step``); a None field holds no
    leaf;
  * bf16 leaves are stored as their ``uint16`` bits, with ``"bfloat16"``
    in the manifest;
  * writes go to ``step_XXXXXXXXXX.tmp-<nonce>/`` and are published by one
    atomic ``os.rename``; stale tmp directories of a killed process are
    removed when a manager is made; the newest ``max_to_keep`` steps are
    kept; ``latest_step`` finds the newest published step (auto-resume).

``save`` copies the state to host memory at once and writes it on a
background thread; ``wait`` joins it and raises what it raised.
``restore(like)`` loads into the structure of ``like``, each leaf on
``like``'s leaf's device and in its dtype: onto another card, the CPU or
another precision, from the same files.

Under ``torch.distributed`` (a default process group of more than one
rank) the files are still full arrays: a DTensor leaf is gathered whole
(``full_tensor``, which every rank calls), only rank 0 writes, and every
rank's ``wait`` returns once the write is published. ``restore(like,
shardings=...)`` is the elastic restore: each leaf that the congruent
tree of ``NamedSharding``s names is distributed onto that mesh with its
spec's placements, whatever mesh or world size wrote it; a DTensor leaf
of ``like`` without one keeps its own mesh and placements.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_SEP = "//"


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> dict[str, Any]:
    """{key: leaf} in the reference's key strings (see the module
    docstring)."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in sorted(tree.items())]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f".{f.name}", getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif tree is None:
        return {}
    else:
        return {_SEP.join(prefix): tree}
    flat = {}
    for name, sub in items:
        flat.update(_flatten_with_paths(sub, prefix + (name,)))
    return flat


def _rebuild(tree: Any, leaves: dict[str, Any], prefix: tuple = ()) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             prefix + (f".{f.name}",))
            for f in dataclasses.fields(tree)})
    if tree is None:
        return None
    return leaves[_SEP.join(prefix)]


def _dist_world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _full(t: Any) -> Any:
    """A DTensor leaf gathered whole (a collective), else ``t``."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _to_host(t: Any) -> tuple[np.ndarray, str]:
    """A leaf as (the array to store, its logical dtype name): bf16 as its
    uint16 bits, anything else as itself."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_stored(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded array (``np.load``: contiguous, writable) as a CPU tensor
    of its logical dtype, without a copy."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False
        # GC stale tmp dirs from a previous crashed process (on the
        # writing rank only: another rank's would race its writes).
        for name in (os.listdir(self.dir) if _dist_world()[0] == 0
                     else ()):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- paths ---------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot now (a host copy of every leaf, DTensors gathered
        whole), write in the background (atomic publish); with more than
        one rank, rank 0 writes and every rank calls this."""
        self.wait()                                   # one in flight at a time
        full = {k: _full(v) for k, v in _flatten_with_paths(state).items()}
        self._pending = True
        if _dist_world()[0] != 0:
            if blocking:
                self.wait()
            return
        host = {k: _to_host(v) for k, v in full.items()}
        del full

        def work():
            try:
                self._write(step, host)
                self._retain()
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: dict[str, tuple]) -> None:
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for i, (key, (arr, dtype_name)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype_name,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):                     # overwrite same step
            shutil.rmtree(final)
        os.rename(tmp, final)                          # atomic publish

    def wait(self) -> None:
        """Join the write in flight; with more than one rank, every rank
        returns once rank 0's write is published (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            if _dist_world()[1] > 1:
                dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def restore(self, like: Any, step: int | None = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like`` (a tree of tensors):
        each leaf on the device and in the dtype of ``like``'s leaf (the
        stored arrays are full host arrays, so another device or
        precision is the same code path). ``shardings`` (optional, a
        congruent tree of ``parallel.sharding.NamedSharding``, None
        where a leaf takes none) distributes each named leaf onto its
        mesh with its spec's placements: the elastic restore, onto any
        mesh. Raises if a leaf is missing or its shape differs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        flat_like = _flatten_with_paths(like)
        missing = set(flat_like) - set(manifest["leaves"])
        if missing:
            raise KeyError(f"checkpoint step {step} missing leaves "
                           f"{sorted(missing)[:5]}...")
        flat_sh = (_flatten_with_paths(shardings)
                   if shardings is not None else {})
        restored = {}
        for key, want in flat_like.items():
            meta = manifest["leaves"][key]
            arr = _from_stored(np.load(os.path.join(d, meta["file"])),
                               meta["dtype"])
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint "
                    f"{tuple(arr.shape)} vs expected {tuple(want.shape)}")
            restored[key] = _place(arr, want, flat_sh.get(key))
        return _rebuild(like, restored)


def _place(arr: torch.Tensor, want: Any, sharding) -> torch.Tensor:
    """A restored full array in ``want``'s dtype: distributed per
    ``sharding`` (a ``NamedSharding``), or onto ``want``'s own mesh and
    placements where it is a DTensor, else on ``want``'s device."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if sharding is not None:
        mesh, where = sharding.mesh, sharding.placements
    elif isinstance(want, DTensor):
        mesh, where = want.device_mesh, want.placements
    else:
        return arr.to(device=want.device, dtype=want.dtype)
    return distribute_tensor(arr.to(device=mesh.device_type,
                                    dtype=want.dtype), mesh, where)
