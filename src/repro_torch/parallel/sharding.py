"""Logical-axis sharding rules, the table half.

Every parameter and activation in the model zoo carries a tuple of
logical axis names (one per dimension, ``None`` for "no preference").
``AxisRules`` maps logical names to mesh axis names. The default rules
implement the baseline distribution plan: batch -> (pod, data); heads /
mlp / experts / vocab -> model; everything else replicated.

The counterpart of the table half of ``repro.parallel.sharding``: the
rule tables the NN->ISA compiler reads (``compiler/partition.py``).
Resolving rules onto a device mesh comes with the parallel slice
(ROADMAP queue 1, "Parallel, then the dry-run").
"""
from __future__ import annotations

import dataclasses


MeshAxes = tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Ordered logical-name -> mesh-axes mapping."""
    rules: tuple[tuple[str, MeshAxes], ...]

    def lookup(self, name: str) -> MeshAxes:
        for n, axes in self.rules:
            if n == name:
                return axes
        return ()

    def replace(self, **overrides: MeshAxes | None) -> "AxisRules":
        """Return a copy with some logical names remapped (None removes)."""
        out = []
        seen = set()
        for n, axes in self.rules:
            if n in overrides:
                seen.add(n)
                if overrides[n] is not None:
                    out.append((n, tuple(overrides[n])))
            else:
                out.append((n, axes))
        for n, axes in overrides.items():
            if n not in seen and axes is not None:
                out.append((n, tuple(axes)))
        return AxisRules(tuple(out))


# Baseline rules. "pod" only exists on the multi-pod mesh; mesh axes not
# present in the mesh are dropped at resolution time.
DEFAULT_RULES = AxisRules((
    ("batch", ("pod", "data")),
    ("expert_group", ("pod", "data")),   # MoE dispatch group dim
    ("vocab", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    # --- activation names (model code constraints). A name MISSING from
    # this table silently means "replicate": an absent "vocab_act" rule
    # cost a 67 GB/step fp32 logits all-gather on gemma train_4k before
    # these entries existed. Keep every constraint name listed.
    ("vocab_act", ("model",)),
    ("act_heads", ("model",)),
    ("act_kv_heads", ("model",)),
    ("act_seq_attn", ()),                # bound to ("model",) for archs
                                         # whose heads don't divide the mesh
    ("act_mlp", ("model",)),
    ("act_experts", ("model",)),
    ("kv_seq", ()),                      # decode KV cache seq: replicated in
                                         # baseline; hillclimb shards it
    ("act_res", ("model",)),             # Megatron-style sequence-parallel
                                         # residual stream: layer-boundary
                                         # activations sharded over model —
                                         # shrinks saved scan carries 16x
    ("embed", ("data",)),                # FSDP/ZeRO-3: weight embed dims
                                         # sharded over data; XLA all-gathers
                                         # per layer and frees after use
    ("seq", ()),
    ("layers", ()),
    ("head_dim", ()),
    ("state", ()),
    ("capacity", ()),
))

#: Logical axes whose sharding means "split output filters/columns".
#: Single source of truth shared with the NN→ISA compiler: rule tables
#: that map any of these onto a mesh axis translate to filter-parallel
#: (shard-N) multi-device plans in ``repro_torch.compiler.partition``, while
#: a sharded "layers" axis translates to pipeline stages.
FILTER_PARALLEL_AXES = ("mlp", "heads", "experts", "vocab")
