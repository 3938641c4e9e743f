"""Architecture registry of the port: each arch binds its published
model config, and a reduced same-family smoke config for CPU tests, to
one model module of ``repro_torch.models``.

The counterpart of ``repro.configs.registry``, with all ten of its
archs and their sharding-rule overrides (``rule_overrides``, which
``DEFAULT_RULES.replace`` applies: yi-34b's and qwen2-vl-2b's). The
dry-run's shape sets (``ShapeSpec``, ``SHAPES``, ``skip_shapes``) come
with the dry-run slice (ROADMAP queue 1). Modules are named as strings
and imported on first use, only from ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                        # dense | moe | ssm | hybrid | audio | vlm
    model: Any                         # LMConfig / SSMLMConfig / ...
    module: str                        # repro_torch.models.{lm,ssm,hybrid,encdec}
    rule_overrides: dict = dataclasses.field(default_factory=dict)
    frontend: str | None = None        # audio | vision (stubbed embeddings)
    smoke: Any = None                  # reduced same-family config
    notes: str = ""

    def model_module(self):
        return importlib.import_module(f"repro_torch.models.{self.module}")


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
