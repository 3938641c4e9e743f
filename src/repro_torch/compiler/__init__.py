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

Multi-device plans (``--devices N``): partition.derive_plan splits the
network (pipeline stages or filter-parallel shards, derived from the
``parallel/`` axis rules) and partition.lower_partitioned emits a
MultiDeviceProgram — per-device Programs wired by cross-device
``*.xdev`` Sync channels — consumed by asm.to_bundle_binary
(``N3HBUND1``), simulate_program (cross-device makespan under the
plan's LinkModel) and runtime.MultiDeviceExecutor (bit-exact vs the
single-device program; every simulated device on one torch device).

Decode programs (``cli.compile_decode_network``, ``lower_network(step=
...)``) run through sessions: ``runtime.ExecutorSession`` binds the
weights once, runs the warm-up program on the first token and
``lower.steady_program`` after it.

``program``, ``lower``, ``passes``, ``networks``, ``asm`` and
``partition`` are copies of the reference's modules; ``cli`` and
``runtime`` are ports.
"""
from repro_torch.compiler import asm
from repro_torch.compiler.asm import (
    assemble,
    disassemble,
    disassemble_bundle,
    from_binary,
    from_bundle_binary,
    to_binary,
    to_bundle_binary,
)
from repro_torch.compiler.cli import compile_decode_network, \
    compile_network, execute_report, summarize, summarize_bundle
from repro_torch.compiler.lower import lower_network, steady_program
from repro_torch.compiler.networks import list_networks, network_layers
from repro_torch.compiler.partition import (
    BundleSim,
    ChannelEdge,
    LinkModel,
    MultiDeviceProgram,
    PartitionError,
    PartitionPlan,
    decorate_decode_bundle,
    derive_plan,
    kind_from_rules,
    lower_partitioned,
    optimize_bundle,
    simulate_bundle,
    steady_bundle,
    validate_bundle,
)
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
    MultiDeviceExecutor,
    ReferenceSession,
    bind_numpy_weights,
    bind_synthetic,
    decode_step_ref,
    get_backend,
    global_layers,
    synthetic_decode_arrays,
    synthetic_weights,
)

__all__ = [
    "asm", "assemble", "disassemble", "disassemble_bundle", "from_binary",
    "from_bundle_binary", "to_binary", "to_bundle_binary",
    "compile_decode_network", "compile_network", "execute_report",
    "summarize", "summarize_bundle", "lower_network", "steady_program",
    "BundleSim", "ChannelEdge", "LinkModel", "MultiDeviceProgram",
    "PartitionError", "PartitionPlan", "decorate_decode_bundle",
    "derive_plan", "kind_from_rules", "lower_partitioned",
    "optimize_bundle", "simulate_bundle", "steady_bundle",
    "validate_bundle",
    "list_networks", "network_layers", "OPT_LEVELS", "optimize_program",
    "ConvGeometry", "CoreProgram", "GemmLayer", "LayerProgram", "Program",
    "BACKENDS", "CudaExecutor", "ExecutionError", "ExecutorBackend",
    "GoldenExecutor", "MultiDeviceExecutor", "bind_numpy_weights",
    "bind_synthetic", "get_backend", "global_layers",
    "synthetic_weights", "DecodeSession", "ExecutorSession",
    "ReferenceSession",
    "decode_step_ref", "synthetic_decode_arrays",
]
