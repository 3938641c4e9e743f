"""HeteroLinear — the paper's heterogeneous-core split GEMM as a module.

The counterpart of ``repro.core.hetero_linear`` on torch tensors. A
linear layer whose output columns (= the paper's "filters"/neurons)
are split between two execution paths (§3.1 + §5.3):

  * **parallel path** (DSP-core analogue): fixed int4 weights, packed,
    on the card's ``int4_gemm`` kernel — latency rigid w.r.t. precision;
  * **serial path** (LUT-core analogue): flexible 2-8 bit weights,
    executed as shifted bitplane matmuls on ``bitserial_gemm`` —
    latency ∝ bit-width.

Column→path allocation follows the paper's KL-divergence rule (filters
whose weight distribution is most damaged by quantization go to the
higher-bit-width path). The split ratio per layer either comes from the
config or is solved with the chip cost model (`solve_tpu_split` on
:data:`~repro_torch.core.tpu_cost.H100_SXM`, the Eq. 12 analogue).

Three operating modes:
  * ``apply_fp``    — plain fp matmul (quantization off; baseline).
  * ``apply_qat``   — fake-quantized STE forward for training (the
    hybrid scheme of §4: per-column bit-widths by core assignment,
    layer-wise activation quantization).
  * ``apply_deploy``— integer inference through the split-GEMM kernels
    on a prepared ``DeployedHeteroLinear`` (integer codes on the
    device): one ``bitserial_gemm`` and one ``int4_gemm`` launch per
    non-empty side on CUDA tensors, their plain versions on CPU
    tensors.

:func:`params_from_numpy` and :func:`deployed_from_numpy` carry the
reference's params and deployed codes across as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.compiler.runtime.base import resolve_device
from repro_torch.core.tpu_cost import H100_SXM, TPUChip, solve_tpu_split
from repro_torch.quant.hybrid import LayerQuantConfig, kl_filter_allocation
from repro_torch.quant.uniform import (
    fake_quant_per_channel,
    fit_scale,
    fit_scale_per_channel,
    qrange,
    quantize,
)


@dataclasses.dataclass(frozen=True)
class HeteroLinearConfig:
    """Per-layer knobs (the DSE action space projected onto one layer)."""
    in_features: int
    out_features: int
    quant: LayerQuantConfig = LayerQuantConfig()
    enabled: bool = True           # False -> plain fp linear
    solve_ratio: bool = False      # override quant.ratio with Eq.-12 solve
    spatial: bool = False          # spatial (max) vs temporal (sum) compose
    chip: TPUChip = H100_SXM

    def resolved_ratio(self, m_tokens: int = 4096) -> float:
        if not self.solve_ratio:
            return self.quant.ratio
        r, _, _ = solve_tpu_split(m_tokens, self.in_features,
                                  self.out_features, self.quant.w_bits_lut,
                                  self.quant.a_bits, self.chip,
                                  spatial=self.spatial)
        return r


def init_hetero_linear(generator: torch.Generator, cfg: HeteroLinearConfig,
                       device="cuda", dtype=torch.float32) -> dict:
    """fp master weights U(-1/sqrt(in), 1/sqrt(in)), drawn from
    ``generator`` on its own device and placed on ``device`` (one
    generator state gives the same weights on every device)."""
    k = 1.0 / (cfg.in_features ** 0.5)
    u = torch.rand((cfg.in_features, cfg.out_features), generator=generator,
                   dtype=dtype, device=generator.device)
    return {"w": (u * (2 * k) - k).to(resolve_device(device))}


def params_from_numpy(params: dict, device="cuda") -> dict:
    """The reference's HeteroLinear params (numpy or JAX arrays) on
    ``device``, with the same bits."""
    return {k: torch.from_numpy(np.array(v)).to(resolve_device(device))
            for k, v in params.items()}


def _split_sizes(cfg: HeteroLinearConfig) -> tuple[int, int]:
    n_serial = int(round(cfg.resolved_ratio() * cfg.out_features))
    return n_serial, cfg.out_features - n_serial


def column_allocation(w: torch.Tensor, cfg: HeteroLinearConfig) -> torch.Tensor:
    """Permutation of output columns: first n_serial slots -> serial path.

    Uses the paper's KL rule on the transposed view (filters = columns).
    """
    n_serial, _ = _split_sizes(cfg)
    qcfg = dataclasses.replace(cfg.quant, ratio=n_serial / max(cfg.out_features, 1))
    return kl_filter_allocation(w.T, qcfg)  # [out] filter indices


# ---------------------------------------------------------------------------
# fp + QAT forwards
# ---------------------------------------------------------------------------


def apply_fp(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def apply_qat(params: dict, x: torch.Tensor,
              cfg: HeteroLinearConfig) -> torch.Tensor:
    """STE fake-quant forward: per-column weight bits by core assignment,
    layer-wise activation quantization at ``a_bits`` (paper §4)."""
    if not cfg.enabled:
        return apply_fp(params, x)
    w = params["w"]
    perm = column_allocation(w.detach(), cfg)
    n_serial, _ = _split_sizes(cfg)
    is_serial_slot = torch.arange(cfg.out_features, device=w.device) < n_serial
    is_serial = is_serial_slot[torch.argsort(perm, stable=True)]  # original order

    fq_serial = fake_quant_per_channel(w, cfg.quant.w_bits_lut, axis=1)
    fq_parallel = fake_quant_per_channel(w, cfg.quant.w_bits_dsp, axis=1)
    w_q = torch.where(is_serial[None, :], fq_serial, fq_parallel)

    # layer-wise activation fake quant (shared by both paths)
    s_a = fit_scale(x.detach(), cfg.quant.a_bits)
    lo, hi = qrange(cfg.quant.a_bits)
    x_q = torch.clamp(torch.round(x / s_a), lo, hi) * s_a
    x_q = x + (x_q - x).detach()                      # STE
    return x_q @ w_q


# ---------------------------------------------------------------------------
# Deployment (integer path through the split-GEMM kernels)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeployedHeteroLinear:
    """Integer codes ready for the kernels; static split boundary."""
    wq_serial: torch.Tensor       # [in, n_serial] int32 codes
    s_serial: torch.Tensor        # [n_serial] fp32
    wq_parallel: torch.Tensor     # [in, n_parallel] int32 codes (int4 range)
    s_parallel: torch.Tensor      # [n_parallel] fp32
    perm: torch.Tensor            # [out] column allocation
    inv_perm: torch.Tensor        # [out]
    bits_serial: int = 4
    a_bits: int = 4

    def to(self, device) -> "DeployedHeteroLinear":
        """The same codes on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def deployed_from_numpy(d, device="cuda") -> DeployedHeteroLinear:
    """The reference's ``DeployedHeteroLinear`` (any object with its
    fields, arrays as numpy or JAX) on ``device``, with the same bits."""
    dev = resolve_device(device)
    tensors = {f.name: torch.from_numpy(np.array(getattr(d, f.name))).to(dev)
               for f in dataclasses.fields(DeployedHeteroLinear)
               if f.name not in ("bits_serial", "a_bits")}
    return DeployedHeteroLinear(**tensors, bits_serial=int(d.bits_serial),
                                a_bits=int(d.a_bits))


def deploy(params: dict, cfg: HeteroLinearConfig) -> DeployedHeteroLinear:
    """Quantize fp master weights into the two-path integer layout, on
    the weights' device."""
    w = params["w"]
    perm = column_allocation(w, cfg)
    n_serial, _ = _split_sizes(cfg)
    w_sorted = w[:, perm]
    w_ser, w_par = w_sorted[:, :n_serial], w_sorted[:, n_serial:]

    s_ser = fit_scale_per_channel(w_ser, cfg.quant.w_bits_lut, axis=1)
    s_par = fit_scale_per_channel(w_par, cfg.quant.w_bits_dsp, axis=1)
    return DeployedHeteroLinear(
        wq_serial=quantize(w_ser, s_ser, cfg.quant.w_bits_lut),
        s_serial=s_ser.reshape(-1),
        wq_parallel=quantize(w_par, s_par, cfg.quant.w_bits_dsp),
        s_parallel=s_par.reshape(-1),
        perm=perm,
        inv_perm=torch.argsort(perm, stable=True),
        bits_serial=cfg.quant.w_bits_lut,
        a_bits=cfg.quant.a_bits,
    )


def apply_deploy(d: DeployedHeteroLinear, x: torch.Tensor,
                 mode: str = "auto") -> torch.Tensor:
    """Integer inference: quantize activations, run both paths, restore
    the original column order, dequantize. ``mode="auto"`` launches the
    kernels on CUDA tensors (their plain versions on CPU tensors),
    ``"ref"`` runs the plain oracles on any device."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    s_a = fit_scale(x2, d.a_bits)
    lo, hi = qrange(d.a_bits)
    x_q = torch.clamp(torch.round(x2 / s_a), lo, hi).to(torch.int8)

    out = kernels.hetero_matmul(x_q, d.wq_serial, d.s_serial, d.bits_serial,
                                d.wq_parallel, d.s_parallel, mode=mode)
    out = out[:, d.inv_perm] * s_a
    return out.reshape(*shape[:-1], out.shape[-1]).to(x.dtype)
