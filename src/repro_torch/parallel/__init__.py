"""Distribution substrate: logical-axis sharding rules.

The framework describes every parameter/activation with *logical* axis
names ("batch", "embed", "heads", "experts", ...). A rule table maps
logical axes onto mesh axes (("pod",) "data", "model"). Only the rule
tables are ported so far; the compiler's partitioner reads them.
"""
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    FILTER_PARALLEL_AXES,
    AxisRules,
    MeshAxes,
)

__all__ = ["DEFAULT_RULES", "FILTER_PARALLEL_AXES", "AxisRules", "MeshAxes"]
