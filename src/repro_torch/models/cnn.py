"""ResNet-18 / MobileNet-V2 configurations — the paper's evaluation
workloads, as the compiler needs them.

Every parametric layer maps 1:1 onto a ``ConvSpec`` in
``repro_torch.core.workloads`` (same names, same order). This slice
carries the configuration half of ``repro.models.cnn``: ``CNNConfig``
and ``specs_for``, which the compiler uses to build the reduced
geometry-consistent variants. The fp32 network comes with the model
zoo.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.workloads import ConvSpec, mobilenet_v2_specs, resnet18_specs


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "resnet18"              # resnet18 | mobilenet_v2
    n_classes: int = 1000
    in_hw: int = 224
    width: float = 1.0                  # channel multiplier (reduced smoke)
    param_dtype = torch.float32


def reduced_config(arch: str, n_classes: int = 10) -> CNNConfig:
    return CNNConfig(arch=arch, n_classes=n_classes, in_hw=32, width=0.25)


def _scale_c(c: int, width: float) -> int:
    if width >= 1.0:
        return c
    return max(8, int(round(c * width / 8)) * 8) if c > 8 else c


def specs_for(cfg: CNNConfig) -> list[ConvSpec]:
    """ConvSpec list matching this config (width/input-size scaled).

    Spatial sizes are *propagated* through the layer graph — each
    layer's ``in_hw`` is its producer's (pooled) ``out_hw``, with the
    downsample shortcuts reading the block input three layers back —
    so the scaled specs chain exactly like the full-size network and
    the compiled program's im2col geometry stays executable at any
    input size.
    """
    base = resnet18_specs() if cfg.arch == "resnet18" else mobilenet_v2_specs()
    if cfg.width >= 1.0 and cfg.in_hw == 224 and cfg.n_classes == 1000:
        return base
    out: list[ConvSpec] = []
    for i, s in enumerate(base):
        c_in = 3 if s.is_first else _scale_c(s.c_in, cfg.width)
        c_out = (cfg.n_classes if s.is_last
                 else _scale_c(s.c_out, cfg.width))
        if s.depthwise:
            c_in = c_out = _scale_c(s.c_out, cfg.width)
        if s.is_first:
            in_hw = cfg.in_hw
        else:
            src = out[i - (3 if s.shortcut else 1)]
            in_hw = src.pooled_out_hw
        out.append(dataclasses.replace(s, c_in=c_in, c_out=c_out,
                                       in_hw=in_hw))
    return out

