"""Network frontends: named CNN workloads → GEMM layer lists for the
compiler.

The counterpart of ``repro.compiler.networks``' CNN half: resnet18 /
mobilenet_v2 from the workload zoo (``core/workloads.py``), lowered via
im2col exactly as the latency models see them. The LM architecture
registry is ported with the model zoo in a later slice.
"""
from __future__ import annotations

from repro_torch.core.workloads import WORKLOADS
from repro_torch.compiler.program import GemmLayer


def network_layers(name: str, in_hw: int | None = None,
                   width: float | None = None) -> list[GemmLayer]:
    """GEMM layer list for a named CNN workload.

    ``in_hw``/``width`` compile the geometry-consistent reduced
    variants of ``models/cnn.py`` (``specs_for`` propagates spatial
    sizes through the layer graph, so the scaled programs still chain
    end to end).
    """
    if name not in WORKLOADS:
        raise ValueError(
            f"{name}: not a CNN workload ({', '.join(sorted(WORKLOADS))}); "
            f"the LM architecture registry is ported with the model zoo "
            f"in a later slice")
    if in_hw is not None or width is not None:
        from repro_torch.models.cnn import CNNConfig, specs_for
        cfg = CNNConfig(arch=name, in_hw=in_hw or 224,
                        width=width if width is not None else 1.0)
        specs = specs_for(cfg)
    else:
        specs = WORKLOADS[name]()
    return [GemmLayer.from_conv(s) for s in specs]


def list_networks() -> list[str]:
    return sorted(WORKLOADS)
