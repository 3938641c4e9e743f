"""Accelerator-side cost model — the hardware adaptation of Eqs. (6)-(10).

The counterpart of ``repro.core.tpu_cost``, with the same functions
(numpy, float64) and the same chip record type, :class:`TPUChip`,
under its name: a record of a chip's peak rates. The port's record is
:data:`H100_SXM`, and every default that names a chip names it.

The paper's framework "can adapt to different [hardware] by changing the
available resources in the cost model" (§7). Here the resource pool is
one accelerator chip instead of a Zynq FPGA:

  * bit-parallel path (the DSP-core analogue): packed-int4 weights fed
    to the int8 tensor-core pipeline; latency independent of weight
    bit-width.
  * bitplane path (the LUT-core analogue): weights decomposed into
    ``B_w`` binary planes, one int8 matmul per plane, shifted and
    accumulated (paper Eq. 1); latency proportional to ``B_w`` (and to
    ``B_w * B_a`` if activations are also serialized, the faithful FPGA
    composition).

Each path's latency is a two-term roofline max(compute, memory); paths
compose *temporally* (sum — both time-share the one chip) or
*spatially* (max — the partitions are placed on disjoint chips or
parts of one, restoring the paper's Eq. 10 form).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TPUChip:
    """One accelerator chip's peak rates (the reference's record type,
    kept under its name; it has no default chip here)."""
    name: str
    bf16_flops: float                 # dense bf16 FLOP/s
    int8_ops: float                   # dense int8 OP/s
    hbm_bw: float                     # device memory bytes/s
    ici_bw: float                     # chip-to-chip bytes/s per link
    vmem_bytes: int                   # on-chip scratch bytes
    mxu_dim: int                      # matrix-unit tile edge


#: NVIDIA H100 SXM5 80 GB, dense rates without sparsity, from NVIDIA's
#: data sheet (https://www.nvidia.com/en-us/data-center/h100/), at the
#: full 700 W power limit. NVLink 4 gives 900 GB/s per GPU over 18
#: links, both directions summed: 25 GB/s per link and direction.
#: ``vmem_bytes`` and ``mxu_dim`` are read by no function of this module
#: (nor by the reference's); they hold the card's nearest counterparts,
#: one SM's shared memory (228 KiB, NVIDIA's Hopper tuning guide,
#: https://docs.nvidia.com/cuda/hopper-tuning-guide/) and the M edge of
#: the ``mma.sync`` tile the port's split-GEMM kernels issue (16).
H100_SXM = TPUChip(
    name="h100-sxm",
    bf16_flops=989.4e12,
    int8_ops=1978.9e12,
    hbm_bw=3.35e12,
    ici_bw=25e9,
    vmem_bytes=228 * 1024,
    mxu_dim=16,
)


@dataclasses.dataclass(frozen=True)
class HeteroGemmCost:
    t_parallel: float        # int4 path seconds
    t_bitplane: float        # bitplane path seconds
    t_temporal: float        # sum (single-core time sharing)
    t_spatial: float         # max (disjoint placement)
    bytes_weights: float
    bytes_act: float
    flops: float


def _roofline(flops, op_rate, bytes_moved, bw):
    return np.maximum(flops / op_rate, bytes_moved / bw)


def hetero_gemm_cost(m, k, n, ratio, bits_w_serial, bits_a,
                     chip: TPUChip = H100_SXM,
                     serialize_activations: bool = False,
                     bits_w_parallel: int = 4):
    """Cost of out[m,n] = act[m,k] @ w[k,n] split column-wise by ``ratio``.

    ``ratio`` of the n columns take the bitplane (flexible-precision)
    path; the rest take the packed-int4 path. All inputs may be numpy
    arrays (vectorized for the DSE loops).
    """
    m, k, n = np.asarray(m, np.float64), np.asarray(k, np.float64), np.asarray(n, np.float64)
    ratio = np.asarray(ratio, np.float64)
    bits_w_serial = np.asarray(bits_w_serial, np.float64)
    bits_a = np.asarray(bits_a, np.float64)

    n_serial = np.round(n * ratio)
    n_par = n - n_serial

    # --- bit-parallel path: one int8 matmul over n_par columns
    flops_par = 2.0 * m * k * n_par
    bytes_w_par = k * n_par * bits_w_parallel / 8.0
    bytes_a_par = m * k * 1.0            # int8 activations
    bytes_o_par = m * n_par * 4.0        # int32 accumulators out
    t_par = _roofline(flops_par, chip.int8_ops,
                      bytes_w_par + bytes_a_par + bytes_o_par, chip.hbm_bw)

    # --- bitplane path: B_w (x B_a) binary-plane matmuls
    planes = bits_w_serial * np.where(serialize_activations, bits_a, 1.0)
    flops_ser = 2.0 * m * k * n_serial * planes
    bytes_w_ser = k * n_serial * bits_w_serial / 8.0   # planes are 1-bit each
    bytes_a_ser = m * k * np.where(serialize_activations, bits_a / 8.0, 1.0)
    bytes_o_ser = m * n_serial * 4.0
    t_ser = _roofline(flops_ser, chip.int8_ops,
                      bytes_w_ser + bytes_a_ser + bytes_o_ser, chip.hbm_bw)

    flops = 2.0 * m * k * n
    return HeteroGemmCost(
        t_parallel=t_par, t_bitplane=t_ser,
        t_temporal=t_par + t_ser,
        t_spatial=np.maximum(t_par, t_ser),
        bytes_weights=bytes_w_par + bytes_w_ser,
        bytes_act=bytes_a_par + bytes_a_ser,
        flops=flops,
    )


def solve_tpu_split(m, k, n, bits_w_serial, bits_a, chip: TPUChip = H100_SXM,
                    spatial: bool = False, serialize_activations: bool = False):
    """Accelerator analogue of Eq. (12): pick the ratio minimizing the
    composed latency. In temporal mode the optimum is a boundary
    (whichever path is cheaper per column) unless precision constraints
    force a mix; in spatial mode an interior optimum re-emerges exactly
    as on the FPGA. Returns (best_ratio, best_seconds, curve)."""
    cand = np.linspace(0.0, 1.0, int(n) + 1) if n <= 4096 else np.linspace(0, 1, 513)
    cost = hetero_gemm_cost(m, k, n, cand, bits_w_serial, bits_a, chip,
                            serialize_activations)
    curve = cost.t_spatial if spatial else cost.t_temporal
    i = int(np.argmin(curve))
    return float(cand[i]), float(curve[i]), curve


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
                   n_chips: int, chip: TPUChip = H100_SXM,
                   flops_dtype: str = "bf16") -> RooflineTerms:
    """Three-term roofline from a computation's totals.

    compute    = flops / (chips * peak)
    memory     = bytes / (chips * memory bandwidth)
    collective = collective_bytes / (chips * link bandwidth)

    ``hlo_flops``/``hlo_bytes`` are totals across chips when the
    computation is split over chips (pass per-chip numbers with
    n_chips=1).
    """
    rate = chip.bf16_flops if flops_dtype == "bf16" else chip.int8_ops
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * rate),
        memory_s=hlo_bytes / (n_chips * chip.hbm_bw),
        collective_s=collective_bytes / (n_chips * chip.ici_bw),
    )
