"""Pluggable executor backends for compiled Programs.

  base.py    — :class:`ExecutorBackend` interface + shared binding,
               validation, chaining; error taxonomy.
  golden.py  — :class:`GoldenExecutor`: contract-checking reference
               interpreter, tile by tile through ``kernels/ref.py``.
  cuda.py    — :class:`CudaExecutor`: one fused split-GEMM kernel
               launch per *layer* on the card (im2col-free convs;
               ``fused=False`` for the per-partition path).
  multi.py   — :class:`MultiDeviceExecutor`: steps a
               ``partition.MultiDeviceProgram`` bundle, one backend
               executor per simulated device (all on one torch device),
               with the cross-device hand-off.
  session.py — decode sessions: :class:`ExecutorSession` (resident
               weights + live KV/state over a backend, warm-up then
               steady program) and the plain :class:`ReferenceSession`.

Select by name via :func:`get_backend` (the CLI's ``--backend`` flag
resolves here).
"""
from repro_torch.compiler.runtime.base import (
    ExecutionError,
    ExecutorBackend,
    LayerWeights,
    apply_pool,
    bind_numpy_weights,
    bind_synthetic,
    chain_layers,
    im2col_patches,
    requantize,
    requantize_rows,
    spatialize,
    synthetic_weights,
)
from repro_torch.compiler.runtime.cuda import CudaExecutor
from repro_torch.compiler.runtime.golden import GoldenExecutor
from repro_torch.compiler.runtime.multi import MultiDeviceExecutor, \
    global_layers
from repro_torch.compiler.runtime.session import (
    DecodeSession,
    ExecutorSession,
    ReferenceSession,
    decode_step_ref,
    synthetic_decode_arrays,
)

BACKENDS: dict[str, type[ExecutorBackend]] = {
    GoldenExecutor.name: GoldenExecutor,
    CudaExecutor.name: CudaExecutor,
}


def get_backend(name: str) -> type[ExecutorBackend]:
    """Resolve an executor backend class by registry name."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown executor backend {name!r}; available: "
            f"{sorted(BACKENDS)}") from None


__all__ = [
    "BACKENDS", "CudaExecutor", "DecodeSession", "ExecutionError",
    "ExecutorBackend", "ExecutorSession", "GoldenExecutor", "LayerWeights",
    "MultiDeviceExecutor", "ReferenceSession", "apply_pool",
    "bind_numpy_weights", "bind_synthetic", "chain_layers",
    "decode_step_ref", "get_backend", "global_layers", "im2col_patches",
    "requantize", "requantize_rows", "spatialize", "synthetic_decode_arrays",
    "synthetic_weights",
]
