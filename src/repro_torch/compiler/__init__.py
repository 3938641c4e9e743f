"""NN→ISA compiler toolchain, with executors on the card.

Pipeline::

    core/workloads                         (what to run)
        └─ networks.network_layers          → GEMM layer list
            └─ lower.lower_network          → Program (streams + DDR map)
                └─ passes.PassPipeline      → optimized Program (-O1)
                    ├─ core.scheduler.simulate_program → Fig. 5 latency
                    ├─ runtime.GoldenExecutor → contract-checked
                    │                         reference outputs, tile by tile
                    └─ runtime.CudaExecutor → functional outputs on the
                                              card (split-GEMM kernels)

Decode programs (``cli.compile_decode_network``, ``lower_network(step=
...)``) run through sessions: ``runtime.ExecutorSession`` binds the
weights once, runs the warm-up program on the first token and
``lower.steady_program`` after it.

``program``, ``lower``, ``passes`` and ``networks`` are copies of the
reference's modules; ``cli`` and ``runtime`` are ports.
"""
from repro_torch.compiler.cli import compile_decode_network, \
    compile_network, execute_report, summarize
from repro_torch.compiler.lower import lower_network, steady_program
from repro_torch.compiler.networks import list_networks, network_layers
from repro_torch.compiler.passes import OPT_LEVELS, optimize_program
from repro_torch.compiler.program import (
    ConvGeometry,
    CoreProgram,
    GemmLayer,
    LayerProgram,
    Program,
)
from repro_torch.compiler.runtime import (
    BACKENDS,
    CudaExecutor,
    DecodeSession,
    ExecutionError,
    ExecutorBackend,
    ExecutorSession,
    GoldenExecutor,
    ReferenceSession,
    bind_numpy_weights,
    bind_synthetic,
    decode_step_ref,
    get_backend,
    synthetic_decode_arrays,
    synthetic_weights,
)

__all__ = [
    "compile_decode_network", "compile_network", "execute_report",
    "summarize", "lower_network", "steady_program",
    "list_networks", "network_layers", "OPT_LEVELS", "optimize_program",
    "ConvGeometry", "CoreProgram", "GemmLayer", "LayerProgram", "Program",
    "BACKENDS", "CudaExecutor", "ExecutionError", "ExecutorBackend",
    "GoldenExecutor", "bind_numpy_weights", "bind_synthetic", "get_backend",
    "synthetic_weights", "DecodeSession", "ExecutorSession",
    "ReferenceSession",
    "decode_step_ref", "synthetic_decode_arrays",
]
