"""Heterogeneous-core GEMM co-design.

  isa            — the unified 128-bit instruction set (§3.1)
  scheduler      — instruction streams + event-driven pipeline sim (Fig. 3)
  cost_model     — LUT/BRAM/DSP resource models (Eqs. 3-5)
  latency_model  — closed-form + simulated latency (Eqs. 6-10)
  split          — neuron-based workload split solver (Eqs. 11-12)
  workloads      — im2col GEMM lowering of ResNet-18 / MobileNet-V2
  tpu_cost       — the accelerator adaptation of the cost model, with
                   the H100 chip record
  hetero_linear  — the HeteroLinear module (split + hybrid quant GEMM)
                   on the card's split-GEMM kernels

``isa``, ``scheduler``, ``cost_model``, ``latency_model``, ``split`` and
``workloads`` are copies of the same modules of ``repro.core``, imports
rewritten. ``hetero_linear`` is imported on its own (it pulls in the
kernels and the executors' helpers).
"""
from repro_torch.core.scheduler import (
    DEVICES,
    XC7Z020,
    XC7Z045,
    DspCoreConfig,
    FPGADevice,
    GemmDims,
    LutCoreConfig,
)
from repro_torch.core.cost_model import ResourceReport, system_cost
from repro_torch.core.latency_model import (
    LayerLatency,
    dsp_core_latency,
    layer_latency,
    lut_core_latency,
    network_latency,
)
from repro_torch.core.split import SplitResult, solve_network_splits, \
    solve_split
from repro_torch.core.tpu_cost import (
    H100_SXM,
    HeteroGemmCost,
    RooflineTerms,
    TPUChip,
    hetero_gemm_cost,
    roofline_terms,
    solve_tpu_split,
)

__all__ = [
    "DEVICES", "XC7Z020", "XC7Z045", "DspCoreConfig", "FPGADevice",
    "GemmDims", "LutCoreConfig", "ResourceReport", "system_cost",
    "LayerLatency", "dsp_core_latency", "layer_latency", "lut_core_latency",
    "network_latency", "SplitResult", "solve_network_splits", "solve_split",
    "H100_SXM", "HeteroGemmCost", "RooflineTerms", "TPUChip",
    "hetero_gemm_cost", "roofline_terms", "solve_tpu_split",
]
