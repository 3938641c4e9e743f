"""Multi-device executor: step a fleet of per-device programs.

The counterpart of ``repro.compiler.runtime.multi``. Executes a
:class:`~repro_torch.compiler.partition.MultiDeviceProgram` functionally
by driving one ordinary backend executor (golden or cuda — any
``runtime.BACKENDS`` entry) per device and performing the cross-device
hand-offs the bundle's channel edges describe:

  * pipeline plans — activations flow device-to-device in stage order;
    the boundary requantization is exactly the inter-layer
    requantization of ``ExecutorBackend.run``, so a pipelined chain is
    bit-identical to running the single-device program;
  * filter plans — every device computes its shard of each layer from
    the same (gathered) full activations; concatenating shards in
    device order reproduces the single-device split column order
    exactly, because shards are contiguous in that order by
    construction (``partition.lower_partitioned``).

Every simulated device of the bundle runs on one torch device
(``device``, the card unless the caller asks for the CPU): the bundle
models a fleet of FPGA accelerators, not of GPUs. Weight column shards
and depthwise channel slices are copied contiguous before they reach a
per-device executor, so no strided operand reaches a kernel.

The token pairing itself is honored *by construction* of the execution
order (producers always complete before their edges' consumers run);
:func:`~repro_torch.compiler.partition.validate_bundle` is run at
construction so a corrupt bundle fails before execution, not during.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.scheduler import GemmDims
from repro_torch.compiler.program import ConvGeometry
from repro_torch.compiler.runtime.base import (
    ExecutorBackend,
    chain_layers,
    resolve_device,
    synthetic_weights,
)


@dataclasses.dataclass(frozen=True)
class GlobalLayer:
    """Full-network view of one layer across the device fleet."""
    index: int
    name: str
    dims: GemmDims         # un-sharded GEMM extents
    n_lut: int             # full-layer neuron split (sum of shards)
    bits_w_lut: int
    bits_a: int
    depthwise: bool
    # [(device, local layer index, col_lo, col_hi)] in device order;
    # col bounds are split-column-order output bounds (filter plans
    # shard them; pipeline plans own the whole [0, n) range).
    placements: tuple[tuple[int, int, int, int], ...]
    # full-layer spatial geometry for conv layers (filter shards carry
    # channel-sharded per-device geometries; this is the global one)
    geometry: ConvGeometry | None = None
    # fused elementwise result tail (identical on every shard: the ops
    # are size-free, so the global chain applies them once, full-width)
    elementwise: tuple = ()


def global_layers(bundle) -> list[GlobalLayer]:
    """Build the full-network layer table for a bundle: un-sharded
    extents plus per-device placements. Shared by
    :class:`MultiDeviceExecutor` and the serving fleet (which shards
    full-layer weights onto remote workers without instantiating local
    executors)."""
    plan = bundle.plan
    out = []
    for gi in range(bundle.n_layers):
        owners = bundle.placements(gi)
        if plan.kind == "pipeline":
            d, li = owners[0]
            lp = bundle.devices[d].layers[li]
            placements = ((d, li, 0, lp.dims.n),)
            dims, n_lut = lp.dims, lp.n_lut
            geom = lp.geometry
        else:
            bounds = plan.shards[gi]
            placements = tuple((d, li, bounds[d], bounds[d + 1])
                               for d, li in owners)
            first = bundle.devices[0].layers[gi]
            dims = GemmDims(first.dims.m, first.dims.k, bounds[-1])
            n_lut = sum(bundle.devices[d].layers[li].n_lut
                        for d, li in owners)
            lp = first
            # un-shard the conv geometry: device programs carry the
            # local filter shard's channel counts
            geom = lp.geometry
            if geom is not None:
                n = bounds[-1]
                geom = dataclasses.replace(
                    geom, c_out=n,
                    c_in=n if lp.depthwise else geom.c_in)
        out.append(GlobalLayer(
            index=gi, name=lp.name, dims=dims, n_lut=n_lut,
            bits_w_lut=lp.bits_w_lut, bits_a=lp.bits_a,
            depthwise=lp.depthwise, placements=placements,
            geometry=geom, elementwise=lp.elementwise))
    return out


def _host(a) -> torch.Tensor:
    """A numpy array or tensor as a tensor, without a copy where the
    input allows it (slices are made contiguous by the caller)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))


class MultiDeviceExecutor:
    """Functional executor over a compiled multi-device bundle, every
    per-device executor on the one torch ``device``."""

    def __init__(self, bundle, backend: str | type[ExecutorBackend]
                 = "cuda", tracer=None, device="cuda", **backend_kwargs):
        from repro_torch.compiler.partition import validate_bundle
        from repro_torch.compiler.runtime import get_backend
        validate_bundle(bundle)
        self.bundle = bundle
        self.device = resolve_device(device)
        if tracer is None:
            from repro_torch.obs import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        cls = get_backend(backend) if isinstance(backend, str) else backend
        # per-device executors share the bundle's measured timeline
        self.executors = [cls(p, tracer=tracer, device=self.device,
                              **backend_kwargs)
                          for p in bundle.devices]
        self.layers = global_layers(bundle)

    # -- weight binding ------------------------------------------------------

    def bind_layer(self, index: int, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        """Bind *full-layer* weights (split column order: the Eq.-12
        LUT columns first, then the DSP columns) and shard them onto
        the owning devices per the plan."""
        gl = self.layers[index]
        L = gl.n_lut

        def _cols(w, s, n, what):
            if n == 0:
                if w is not None:
                    raise ValueError(
                        f"layer {index} has no {what} partition")
                return None, None
            w = _host(w)
            s = _host(s).reshape(-1)
            if w.shape[1] != n or s.shape[0] != n:
                raise ValueError(
                    f"layer {index} {what} weights must have {n} columns "
                    f"(full layer), got {tuple(w.shape)}/{tuple(s.shape)}")
            return w, s

        w_lut, s_lut = _cols(w_lut, s_lut, L, "lut")
        w_dsp, s_dsp = _cols(w_dsp, s_dsp, gl.dims.n - L, "dsp")
        for d, li, lo, hi in gl.placements:
            l0, l1 = min(lo, L), min(hi, L)          # lut column overlap
            d0, d1 = max(lo, L) - L, max(hi, L) - L  # dsp column overlap
            self.executors[d].bind_layer(
                li,
                w_lut=w_lut[:, l0:l1].contiguous() if l1 > l0 else None,
                s_lut=s_lut[l0:l1].contiguous() if l1 > l0 else None,
                w_dsp=w_dsp[:, d0:d1].contiguous() if d1 > d0 else None,
                s_dsp=s_dsp[d0:d1].contiguous() if d1 > d0 else None)

    def bind_synthetic(self, index: int, seed: int | None = None) -> None:
        """Full-layer synthetic weights, identical to what
        ``runtime.bind_synthetic`` binds on the single-device program
        (same RNG stream over the same full extents) — then sharded."""
        gl = self.layers[index]
        w_lut, s_lut, w_dsp, s_dsp = synthetic_weights(
            gl.index, gl.dims.k, gl.n_lut, gl.dims.n - gl.n_lut,
            gl.bits_w_lut, seed)
        self.bind_layer(index, w_lut=w_lut, s_lut=s_lut,
                        w_dsp=w_dsp, s_dsp=s_dsp)

    # -- execution -----------------------------------------------------------

    def run_layer(self, index: int, x_q) -> torch.Tensor:
        """Execute one global layer on full activations: the staged
        [m, k] GEMM matrix, the spatial [in_hw, in_hw, c_in] tensor for
        conv layers, or the staged [m, k, n] stack for depthwise.

        Returns the *full* fp32 [m, n] output in single-device split
        column order: shards concatenate in device order (filter), or
        the owning stage computes the whole layer (pipeline).
        """
        gl = self.layers[index]
        x_q = _host(x_q).to(device=self.device, dtype=torch.int8)
        outs = []
        with self.tracer.measure("exec.multi", gl.name, layer=index,
                                 shards=len(gl.placements)):
            for d, li, lo, hi in gl.placements:
                if hi <= lo:
                    continue
                x_d = x_q
                if gl.depthwise and hi - lo != gl.dims.n:
                    # a filter shard of a depthwise layer only consumes
                    # its own channels' input slices — split column
                    # order is the natural channel order for depthwise
                    # (LUT columns are the first n_lut channels), so
                    # channel bounds slice both the spatial [h, w, C]
                    # and staged [m, k, N] forms
                    x_d = x_q[..., lo:hi].contiguous()
                outs.append(self.executors[d].run_layer(li, x_d))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def run(self, x_q, x_scale: float = 1.0) -> torch.Tensor:
        """Chain all global layers through the same ``chain_layers``
        requantization + fused elementwise tail (and, for conv
        programs, spatial NHWC staging) as ``ExecutorBackend.run`` —
        the cross-device hand-off (pipeline boundary or filter gather)
        carries exactly what the single-device chain would."""
        x_q = _host(x_q).to(device=self.device, dtype=torch.int8)
        return chain_layers(self.layers, self.run_layer, x_q,
                            x_scale=x_scale)
