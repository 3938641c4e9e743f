"""Distribution substrate: meshes, logical-axis sharding, compression,
the pipeline.

The framework describes every parameter/activation with *logical* axis
names ("batch", "embed", "heads", "experts", ...). A rule table maps
logical axes onto mesh axes (("pod",) "data", "model"), with automatic
divisibility fallback (an axis that does not divide evenly is left
replicated rather than unevenly sharded). This is the same design as
MaxText/T5X logical axis rules, reimplemented minimally. The port
resolves the rules onto a ``torch.distributed`` ``DeviceMesh`` and
DTensor placements; the int8 gradient all-reduce and the GPipe
schedule run on ``torch.distributed`` process groups. Under a mesh the
models take DTensor parameters and make the reference's activation
constraints: tensor parallelism over "model" (``sharding.py``).
"""
from repro_torch.parallel.compress import (
    CompressionState,
    compress_int8,
    compressed_grad_allreduce,
    decompress_int8,
    init_compression_state,
)
from repro_torch.parallel.pipeline import gpipe, stage_params_from_stack
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    FILTER_PARALLEL_AXES,
    KV_SHARDED_RULES,
    AxisRules,
    MeshAxes,
    MeshShape,
    NamedSharding,
    PartitionSpec,
    current_mesh,
    logical_to_spec,
    placements,
    shard_params_tree,
    spec_tree_for,
    use_mesh,
    with_logical_constraint,
    zero1_spec,
)

__all__ = [
    "DEFAULT_RULES",
    "AxisRules",
    "logical_to_spec",
    "shard_params_tree",
    "spec_tree_for",
    "with_logical_constraint",
    "zero1_spec",
    "CompressionState",
    "compress_int8",
    "decompress_int8",
    "init_compression_state",
    "compressed_grad_allreduce",
    "gpipe",
    "stage_params_from_stack",
    # the port's own
    "FILTER_PARALLEL_AXES",
    "KV_SHARDED_RULES",
    "MeshAxes",
    "MeshShape",
    "NamedSharding",
    "PartitionSpec",
    "current_mesh",
    "placements",
    "use_mesh",
]
