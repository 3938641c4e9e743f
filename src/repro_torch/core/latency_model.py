"""Latency models — paper Eqs. (6)-(10).

Two levels of fidelity, both derived from the same Fig.-3 pipeline:

  * ``simulate_*`` (in scheduler.py) — event-driven instruction-stream
    simulation; the ground truth (the paper validates its model against
    hardware at <2% error; we validate the closed form against this
    simulator — the Fig. 5 reproduction).
  * ``lut_core_latency`` / ``dsp_core_latency`` — closed-form cycle
    counts, vectorizable over candidate workload splits, used inside the
    DSE loops (Eq. 7 / Eq. 9 simplifications).

Network latency is inter-layer synchronous (Eq. 10):

    Latency = sum_i max(L_LUT^i, L_DSP^i)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    LutCoreConfig,
    simulate_dsp_core,
    simulate_lut_core,
)
from repro_torch.core.workloads import ConvSpec, split_gemm


def _dma(n_bytes, dev: FPGADevice):
    return np.ceil(n_bytes / dev.dma_bytes_per_cycle) + dev.dma_setup_cycles


# ---------------------------------------------------------------------------
# Closed-form LUT-core latency — Eq. (9):
#   L_LUT = f(B_a, B_wL, M, K, N, D_L,buf^a)
# ---------------------------------------------------------------------------

def lut_core_latency(g_m, g_k, g_n, cfg: LutCoreConfig, dev: FPGADevice,
                     bits_w, bits_a, depthwise: bool = False):
    """Closed-form cycles for the LUT-core partition. Vectorized: any of
    the GEMM dims / bit-widths may be numpy arrays."""
    g_m, g_k, g_n = np.asarray(g_m), np.asarray(g_k), np.asarray(g_n)
    bits_w, bits_a = np.asarray(bits_w), np.asarray(bits_a)

    nt_m = np.ceil(g_m / cfg.m)
    nt_n = np.ceil(g_n / cfg.n)
    if depthwise:
        tile_exec = np.ceil(g_k * bits_w * bits_a /
                            (cfg.k * cfg.dw_efficiency)) + cfg.pipeline_fill
        bytes_l = g_m * g_n * bits_a / 8.0          # NHWC, no channel reuse
        bytes_r_tile = g_k * cfg.n * bits_w / 8.0
    else:
        nt_k = np.ceil(g_k / cfg.k)
        tile_exec = nt_k * bits_w * bits_a + cfg.pipeline_fill
        bytes_l = g_m * g_k * bits_a / 8.0
        bytes_r_tile = cfg.n * g_k * bits_w / 8.0
    bytes_out_tile = cfg.m * cfg.n * bits_a / 8.0   # requantized write-back

    # Activation residency (see scheduler.lut_core_streams): when the
    # serialized L matrix exceeds the M x D_a x K-bit buffer pool it is
    # re-streamed once per weight column tile.
    a_capacity_bits = cfg.m * cfg.d_a * cfg.k
    a_resident = bytes_l * 8 <= a_capacity_bits

    dma_r = _dma(bytes_r_tile, dev)
    dma_l = _dma(bytes_l, dev)
    dma_out = _dma(bytes_out_tile, dev)

    t_start = dma_r + dma_l + 4
    per_col_exec = nt_m * (tile_exec + 2) + 2
    exec_span = nt_n * per_col_exec
    # Fetch engine must move every byte; when it is the bottleneck the
    # makespan is its total footprint plus the last column's compute tail.
    per_col_fetch = dma_r + 2 + np.where(a_resident, 0.0, dma_l + 2)
    fetch_total = t_start + np.maximum(nt_n - 1, 0) * per_col_fetch \
        + per_col_exec
    res_span = nt_m * nt_n * (dma_out + 2)
    total = np.maximum(
        t_start + np.maximum(exec_span, res_span),
        fetch_total,
    ) + dma_out + 2
    return np.where(g_n <= 0, 0.0, total)


# ---------------------------------------------------------------------------
# Closed-form DSP-core latency — Eq. (7):
#   L_DSP = g(N_reg,row^a, D_D,buf^a, D_D,buf^w)
# ---------------------------------------------------------------------------

def dsp_core_latency(g_m, g_k, g_n, cfg: DspCoreConfig, dev: FPGADevice,
                     depthwise: bool = False):
    """Closed-form cycles for the DSP-core partition (int4 fixed)."""
    g_m, g_k, g_n = np.asarray(g_m), np.asarray(g_k), np.asarray(g_n)
    R = cfg.n_reg_row_a
    kstep = cfg.w_fill_cycles + cfg.n_reg_col_w + cfg.a_fill_cycles

    nt_m = np.ceil(g_m / R)
    nt_n = np.ceil(g_n / cfg.n_reg_col_w)
    if depthwise:
        tile_exec = np.ceil(g_k * kstep /
                            (cfg.n_reg_col_a * cfg.dw_efficiency))
        bytes_a_tile = R * cfg.n_reg_col_w * 4 / 8.0
        bytes_w_tile = g_k * cfg.n_reg_col_w * 4 / 8.0
    else:
        nt_k = np.ceil(g_k / cfg.n_reg_col_a)
        tile_exec = nt_k * kstep
        bytes_a_tile = R * g_k * 4 / 8.0
        bytes_w_tile = g_k * cfg.n_reg_col_w * 4 / 8.0
    bytes_out_tile = R * cfg.n_reg_col_w * 4 / 8.0

    w_capacity_bits = (cfg.n_reg_col_w // 2) * cfg.d_w * (cfg.n_reg_col_a * 4)
    w_resident = nt_n * bytes_w_tile * 8 <= w_capacity_bits

    dma_a = _dma(bytes_a_tile, dev)
    dma_w = _dma(bytes_w_tile, dev)
    dma_out = _dma(bytes_out_tile, dev)

    dma_wall = _dma(nt_n * bytes_w_tile, dev)
    w_resident = np.asarray(w_resident)
    per_mtile_exec = nt_n * (tile_exec + 2) + np.where(w_resident, 2, 2 + nt_n)
    t_start = np.where(w_resident, dma_wall + dma_a + 4, dma_a + 2)
    per_mtile_fetch = np.where(w_resident, dma_a + 2,
                               dma_a + 2 + nt_n * (dma_w + 2))

    exec_span = nt_m * per_mtile_exec
    fetch_total = t_start + np.maximum(nt_m - 1, 0) * per_mtile_fetch \
        + per_mtile_exec
    res_span = nt_m * nt_n * (dma_out + 2)
    total = np.maximum(
        t_start + np.maximum(exec_span, res_span),
        fetch_total,
    ) + dma_out + 2
    return np.where(g_n <= 0, 0.0, total)


# ---------------------------------------------------------------------------
# Layer / network latency (Eq. 10)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerLatency:
    name: str
    cycles_lut: float
    cycles_dsp: float
    n_lut: int
    n_total: int

    @property
    def cycles(self) -> float:
        return max(self.cycles_lut, self.cycles_dsp)

    @property
    def ratio(self) -> float:
        return self.n_lut / max(self.n_total, 1)


def layer_latency(spec: ConvSpec, n_lut: int, lut_cfg: LutCoreConfig,
                  dsp_cfg: DspCoreConfig, dev: FPGADevice,
                  bits_w_lut: int, bits_a: int,
                  use_simulator: bool = False) -> LayerLatency:
    """Latency of one layer under a filter split (Eq. 12 inner term)."""
    g_lut, g_dsp = split_gemm(spec, n_lut)
    if use_simulator:
        c_lut = simulate_lut_core(g_lut, lut_cfg, dev, bits_w_lut, bits_a,
                                  spec.depthwise).total_cycles
        c_dsp = simulate_dsp_core(g_dsp, dsp_cfg, dev,
                                  spec.depthwise).total_cycles
    else:
        c_lut = float(lut_core_latency(g_lut.m, g_lut.k, g_lut.n, lut_cfg, dev,
                                       bits_w_lut, bits_a, spec.depthwise))
        c_dsp = float(dsp_core_latency(g_dsp.m, g_dsp.k, g_dsp.n, dsp_cfg, dev,
                                       spec.depthwise))
    return LayerLatency(spec.name, c_lut, c_dsp, n_lut, spec.gemm().n)


def network_latency(specs: list[ConvSpec], n_luts: list[int],
                    bits_w_lut: list[int], bits_a: list[int],
                    lut_cfg: LutCoreConfig, dsp_cfg: DspCoreConfig,
                    dev: FPGADevice) -> tuple[float, list[LayerLatency]]:
    """Eq. (10): sum over layers of max(L_LUT, L_DSP). Returns (ms, per-layer)."""
    per_layer = []
    cycles = 0.0
    for spec, n_lut, bw, ba in zip(specs, n_luts, bits_w_lut, bits_a):
        ll = layer_latency(spec, n_lut, lut_cfg, dsp_cfg, dev, bw, ba)
        per_layer.append(ll)
        cycles += ll.cycles
    return dev.cycles_to_ms(cycles), per_layer
