"""Distribution substrate: logical-axis sharding rules and gradient
compression.

The framework describes every parameter/activation with *logical* axis
names ("batch", "embed", "heads", "experts", ...). A rule table maps
logical axes onto mesh axes (("pod",) "data", "model"). Only the rule
tables are ported so far; the compiler's partitioner reads them. The
int8 gradient compression with error feedback runs on one device (the
train step's ``compress_grads``); its pod all-reduce waits for the
parallel layer.
"""
from repro_torch.parallel.compress import (
    CompressionState,
    compress_int8,
    compressed_grad_allreduce,
    decompress_int8,
    init_compression_state,
)
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    FILTER_PARALLEL_AXES,
    AxisRules,
    MeshAxes,
)

__all__ = ["DEFAULT_RULES", "FILTER_PARALLEL_AXES", "AxisRules", "MeshAxes",
           "CompressionState", "compress_int8", "decompress_int8",
           "init_compression_state", "compressed_grad_allreduce"]
