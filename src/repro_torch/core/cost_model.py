"""Resource cost models — paper Eqs. (3)-(5).

The cost model maps an architecture configuration (Table 1 knobs) to
{LUT, BRAM, DSP} utilization, and checks it against the device pool.
Coefficients for the LUT-core are the paper's fitted values
{a, b, c, d} = {1.17, 120.1, 44.1, 718}.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.scheduler import DspCoreConfig, FPGADevice, LutCoreConfig

# Paper's fitted coefficients for Eq. (4).
LUT_COEF_A = 1.17
LUT_COEF_B = 120.1
LUT_COEF_C = 44.1
LUT_COEF_D = 718

# LUT budget of the DSP-core control/instruction logic (constant, §3.3).
LUT_DSP_CORE = 1000

BRAM_DEPTH = 1024   # BRAMs are 1024-deep
BRAM_WIDTH = 32     # 36-bit wide, 32 used


def lut_cost_lut_core(m: int, k: int, n: int) -> float:
    """Eq. (4): LUT_L-core(M, K, N) = M*N*(aK + b + c) + d."""
    return m * n * (LUT_COEF_A * k + LUT_COEF_B + LUT_COEF_C) + LUT_COEF_D


def bram_cost_lut_core(m: int, k: int, n: int, d_a: int, d_w: int) -> int:
    """Eq. (5): BRAM_L-core = ceil(K/32) * (M*ceil(Da/1024) + N*ceil(Dw/1024))."""
    return math.ceil(k / BRAM_WIDTH) * (
        m * math.ceil(d_a / BRAM_DEPTH) + n * math.ceil(d_w / BRAM_DEPTH))


def bram_cost_dsp_core(n_reg_row_a: int, n_reg_col_a: int, n_reg_col_w: int,
                       d_a: int, d_w: int) -> int:
    """Eq. (3). One activation buffer spans ceil(Nrow_a*4/32) BRAM columns
    (4-bit padded activations); there are Ncol_a activation buffers and
    Ncol_w/2 weight buffers (one buffer feeds two register columns)."""
    width_brams = math.ceil(n_reg_row_a * 4 / BRAM_WIDTH)
    act = n_reg_col_a * math.ceil(d_a / BRAM_DEPTH)
    wgt = (n_reg_col_w // 2) * math.ceil(d_w / BRAM_DEPTH)
    return width_brams * (act + wgt)


@dataclasses.dataclass(frozen=True)
class ResourceReport:
    luts: float
    brams: int
    dsps: int
    lut_core_luts: float
    lut_core_brams: int
    dsp_core_brams: int

    def fits(self, dev: FPGADevice) -> bool:
        return (self.luts <= dev.luts and self.brams <= dev.bram36
                and self.dsps <= dev.dsps)

    def utilization(self, dev: FPGADevice) -> dict[str, float]:
        return {"lut": self.luts / dev.luts,
                "bram": self.brams / dev.bram36,
                "dsp": self.dsps / dev.dsps}


def system_cost(lut_cfg: LutCoreConfig, dsp_cfg: DspCoreConfig,
                dev: FPGADevice) -> ResourceReport:
    """Whole-accelerator resource utilization.

    Per §3.3: the DSP-core takes all DSPs (DSP_D-core = DSP_available)
    plus a ~constant 1000 LUTs for control; everything else is LUT-core.
    """
    l_lut = lut_cost_lut_core(lut_cfg.m, lut_cfg.k, lut_cfg.n)
    b_lut = bram_cost_lut_core(lut_cfg.m, lut_cfg.k, lut_cfg.n,
                               lut_cfg.d_a, lut_cfg.d_w)
    b_dsp = bram_cost_dsp_core(dsp_cfg.n_reg_row_a, dsp_cfg.n_reg_col_a,
                               dsp_cfg.n_reg_col_w, dsp_cfg.d_a, dsp_cfg.d_w)
    return ResourceReport(
        luts=l_lut + LUT_DSP_CORE,
        brams=b_lut + b_dsp,
        dsps=dev.dsps,  # fully allocated at design time
        lut_core_luts=l_lut,
        lut_core_brams=b_lut,
        dsp_core_brams=b_dsp,
    )


def max_lut_core_mn(dev: FPGADevice, k: int) -> int:
    """Largest M*N product the LUT budget admits for a given K (used to
    prune the DSE action space)."""
    per_dpu = LUT_COEF_A * k + LUT_COEF_B + LUT_COEF_C
    budget = dev.luts - LUT_DSP_CORE - LUT_COEF_D
    return max(0, int(budget // per_dpu))
