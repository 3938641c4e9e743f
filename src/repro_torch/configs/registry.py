"""Architecture registry of the port: each arch binds its published
model config, and a reduced same-family smoke config for CPU tests, to
one model module of ``repro_torch.models``.

The counterpart of ``repro.configs.registry``, with all ten of its
archs and their sharding-rule overrides (``rule_overrides``, which
``DEFAULT_RULES.replace`` applies: yi-34b's and qwen2-vl-2b's), and the
dry-run's shape set: ``SHAPES`` (each ``ShapeSpec`` with its own rule
overrides) and the shapes an arch skips (``skip_shapes``, ``shapes()``).
Modules are named as strings and imported on first use, only from
``repro_torch``.

Shape semantics:
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (forward, no loss)
  decode_32k   seq 32768,  global_batch 128  -> serve_step (1 new token,
                                                KV cache of seq_len)
  long_500k    seq 524288, global_batch 1    -> serve_step; only for the
               sub-quadratic archs (jamba, mamba2); the eight pure
               full-attention archs skip it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode
    rule_overrides: dict = dataclasses.field(default_factory=dict)


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec(
        "decode_32k", 32768, 128, "decode",
        rule_overrides={"kv_seq": ("model",), "act_kv_heads": ()}),
    "long_500k": ShapeSpec(
        "long_500k", 524288, 1, "decode",
        rule_overrides={"kv_seq": ("data", "model"), "act_kv_heads": ()}),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    model: Any                         # LMConfig / SSMLMConfig / ...
    module: str                        # repro_torch.models.{lm,ssm,hybrid,encdec}
    rule_overrides: dict = dataclasses.field(default_factory=dict)
    frontend: str | None = None        # audio | vision (stubbed embeddings)
    skip_shapes: tuple[str, ...] = ("long_500k",)
    smoke: Any = None                  # reduced same-family config
    notes: str = ""

    def model_module(self):
        return importlib.import_module(f"repro_torch.models.{self.module}")

    def shapes(self) -> list[ShapeSpec]:
        return [s for n, s in SHAPES.items() if n not in self.skip_shapes]


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.arch_id}")
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get(arch_id: str) -> ArchConfig:
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


#: config modules under ``repro_torch.configs``, one per arch
_ARCH_MODULES = ["yi_34b", "gemma_7b", "llama32_1b", "qwen3_8b",
                 "mamba2_780m", "jamba_v01_52b", "qwen3_moe_235b_a22b",
                 "deepseek_v2_236b", "qwen2_vl_2b", "seamless_m4t_large_v2"]

_loaded = False


def _load_all():
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
