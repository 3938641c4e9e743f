"""Executor backend on the card — the counterpart of the reference's
``PallasExecutor``.

By default ONE fused kernel launch per layer covers both sides of the
Eq.-12 split — the first ``n_lut`` output columns bit-serially at the
layer's LUT bit width, the rest as packed int4 — accumulating into one
int32 [m, n] tile with a per-column fp32 dequant. Three paths, as in
the reference:

  * spatial NHWC input (every layer of a conv chain) goes to
    ``fused_conv_gemm``, which gathers the im2col patches inside the
    kernel;
  * a pre-staged [m, k] input goes to ``fused_hetero_gemm`` (a
    one-sided split to the matching single-path kernel);
  * ``fused=False`` stages im2col with torch and sends each partition
    to ``bitserial_gemm`` or ``int4_gemm``.

Depthwise layers take the same three paths through one hand-written
kernel (``kernels/depthwise_gemm.py``): spatial input is one
``depthwise_conv_gemm`` launch (taps gathered inside the kernel), a
staged [m, k, n] stack one ``grouped_gemm`` launch with both sides, and
``fused=False`` one ``grouped_gemm`` launch per non-empty side on its
channels' slices.

Weights are prepared once, at bind, on the device
(``kernels.ops.prepare_split``): bit planes and packed int4 bytes for
the fused kernels, the same codes as K-major int32 words for the
single-path ones, and split-order scales.
``mode="ref"`` runs the kernels' plain PyTorch versions on the same
prepared operands instead — on the card it is what the kernels are held
against. Every path accumulates exactly in int32 and dequantizes per
element, so all of them agree bit for bit.

Timing/contract checks are off by default here; pass
``check_timing=True`` to keep the per-core scheduler validation.
"""
from __future__ import annotations

import torch

from repro_torch.core import isa
from repro_torch.kernels import ops as kops
from repro_torch.compiler.program import CoreProgram, LayerProgram
from repro_torch.compiler.runtime.base import ExecutionError, ExecutorBackend


class CudaExecutor(ExecutorBackend):
    """One fused split-GEMM kernel launch per layer, on one device."""

    name = "cuda"

    def __init__(self, program, check_timing: bool = False,
                 mode: str = "auto", tracer=None, fused: bool = True,
                 device="cuda"):
        super().__init__(program, check_timing=check_timing, tracer=tracer,
                         device=device)
        if mode not in kops.MODES:
            raise ValueError(f"mode must be one of {kops.MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self.fused = fused
        self._split: dict[int, kops.SplitWeights] = {}

    def bind_layer(self, index: int, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        super().bind_layer(index, w_lut=w_lut, s_lut=s_lut, w_dsp=w_dsp,
                           s_dsp=s_dsp)
        lp = self.program.layers[index]
        wts = self._weights[index]
        self._split[index] = kops.prepare_split(
            lp.dims.k, wts.w_lut, wts.s_lut, lp.bits_w_lut, wts.w_dsp,
            wts.s_dsp, self.device)

    def run_layer(self, index: int, x_q) -> torch.Tensor:
        """One fused kernel launch for the whole layer (both split
        sides); the per-partition path (``ExecutorBackend.run_layer``)
        when ``fused=False``."""
        if not self.fused:
            return super().run_layer(index, x_q)
        lp = self.program.layers[index]
        if index not in self._split:
            raise ExecutionError(f"layer {index} has no bound weights")
        sw = self._split[index]
        for cp in (lp.lut, lp.dsp):
            if cp is not None:
                self._check_stream(lp, cp)
        x_q = self._as_codes(x_q)
        geom = lp.geometry
        with self.tracer.measure(f"exec.{self.name}.fused", lp.name,
                                 layer=lp.index, n=lp.dims.n,
                                 n_lut=lp.n_lut):
            if geom is not None and tuple(x_q.shape) == geom.in_shape:
                # spatial input: im2col happens inside the kernel
                conv = (kops.split_depthwise_matmul if lp.depthwise
                        else kops.split_conv_matmul)
                return conv(x_q, geom.kernel, geom.stride, geom.pad,
                            geom.out_hw, sw, mode=self.mode)
            x_q = self._staged_activations(lp, x_q)
            staged = (kops.split_grouped_matmul if lp.depthwise
                      else kops.split_matmul)
            return staged(x_q, sw, mode=self.mode)

    def _run_core(self, lp: LayerProgram, cp: CoreProgram, x_q,
                  w_codes, w_scales) -> torch.Tensor:
        # the per-partition path (fused=False), on the staged [m, k]
        # matrix (depthwise: the partition's [m, k, n_part] slices) and
        # the weights prepared at bind
        sw = self._split[lp.index]
        if cp.core == isa.CoreSel.LUT:
            fn = kops.lut_grouped_matmul if lp.depthwise else kops.lut_matmul
        else:
            fn = kops.dsp_grouped_matmul if lp.depthwise else kops.dsp_matmul
        return fn(x_q, sw, mode=self.mode)
