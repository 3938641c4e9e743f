"""Neuron-based workload split — paper §5.3, Eqs. (11)-(12).

For layer i with quantization (B_i^{w-L}, B_i^a) fixed by the agent, the
split ratio is chosen to minimize the layer's makespan:

    argmin_ratio max( L_LUT(..., ratio), L_DSP(..., ratio) )

L_LUT is nondecreasing and L_DSP nonincreasing in the number of LUT
filters, so the minimum sits where the two curves cross; we solve it
*exactly* by evaluating the vectorized closed-form over every feasible
integer filter count (c_out <= a few thousand for all workloads), which
is both faster and more robust than bisection on the stepwise curves.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.latency_model import dsp_core_latency, lut_core_latency
from repro_torch.core.scheduler import DspCoreConfig, FPGADevice, LutCoreConfig
from repro_torch.core.workloads import ConvSpec


@dataclasses.dataclass(frozen=True)
class SplitResult:
    n_lut: int
    ratio: float
    cycles: float
    cycles_lut: float
    cycles_dsp: float
    curve: np.ndarray | None = None   # makespan per candidate (for Fig. 7)


def split_curves(g, depthwise: bool, lut_cfg: LutCoreConfig,
                 dsp_cfg: DspCoreConfig, dev: FPGADevice,
                 bits_w_lut: int, bits_a: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate (c_lut, c_dsp, makespan) curves over n_lut in
    {0..n} — the Eq.-(12) inner terms on raw GEMM dims. Shared by this
    module's ConvSpec-facing solver and the compiler's lowering pass."""
    cand = np.arange(0, g.n + 1, dtype=np.float64)
    c_lut = lut_core_latency(g.m, g.k, cand, lut_cfg, dev,
                             bits_w_lut, bits_a, depthwise)
    c_dsp = dsp_core_latency(g.m, g.k, g.n - cand, dsp_cfg, dev, depthwise)
    return c_lut, c_dsp, np.maximum(c_lut, c_dsp)


def solve_split(spec: ConvSpec, lut_cfg: LutCoreConfig, dsp_cfg: DspCoreConfig,
                dev: FPGADevice, bits_w_lut: int, bits_a: int,
                keep_curve: bool = False) -> SplitResult:
    """Exact Eq.-(12) solver over n_lut in {0..c_out}."""
    g = spec.gemm()
    c_lut, c_dsp, makespan = split_curves(g, spec.depthwise, lut_cfg,
                                          dsp_cfg, dev, bits_w_lut, bits_a)
    best = int(np.argmin(makespan))
    return SplitResult(
        n_lut=best,
        ratio=best / max(g.n, 1),
        cycles=float(makespan[best]),
        cycles_lut=float(c_lut[best]),
        cycles_dsp=float(c_dsp[best]),
        curve=makespan if keep_curve else None,
    )


def solve_network_splits(specs: list[ConvSpec], lut_cfg: LutCoreConfig,
                         dsp_cfg: DspCoreConfig, dev: FPGADevice,
                         bits_w_lut: list[int], bits_a: list[int]
                         ) -> list[SplitResult]:
    return [solve_split(s, lut_cfg, dsp_cfg, dev, bw, ba)
            for s, bw, ba in zip(specs, bits_w_lut, bits_a)]


def brute_force_split(spec: ConvSpec, lut_cfg: LutCoreConfig,
                      dsp_cfg: DspCoreConfig, dev: FPGADevice,
                      bits_w_lut: int, bits_a: int) -> SplitResult:
    """Reference scalar-loop solver (used by property tests to pin the
    vectorized path)."""
    g = spec.gemm()
    best_n, best_c = 0, float("inf")
    best_l = best_d = 0.0
    for n in range(g.n + 1):
        cl = float(lut_core_latency(g.m, g.k, n, lut_cfg, dev,
                                    bits_w_lut, bits_a, spec.depthwise))
        cd = float(dsp_core_latency(g.m, g.k, g.n - n, dsp_cfg, dev,
                                    spec.depthwise))
        c = max(cl, cd)
        if c < best_c:
            best_n, best_c, best_l, best_d = n, c, cl, cd
    return SplitResult(best_n, best_n / max(g.n, 1), best_c, best_l, best_d)
