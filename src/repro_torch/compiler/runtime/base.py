"""Executor backend interface for compiled Programs, on torch tensors.

The counterpart of ``repro.compiler.runtime.base``. A backend executes
a :class:`~repro_torch.compiler.program.Program` *functionally* —
integer activations in, fp32 split-order outputs out — against real
weight codes and dequant scales, on one torch device.

This module holds everything backends share: weight binding and
validation, activation checks and im2col staging (conv layers accept
spatial NHWC tensors and are staged per their
:class:`~repro_torch.compiler.program.ConvGeometry`; depthwise layers
stage the per-channel [m, k, n] stack), layer chaining
with inter-layer requantization (FC chains, and spatial NHWC conv
chains that execute each layer's in-program fused elementwise tail —
residual add, activation, pool glue, write-back requant — in absolute
fp32 units), and the error taxonomy.

Every tail op is written to give the reference's float32 bits on any
device: the max pool pads with ``-inf`` exactly like ``reduce_window``
SAME, the global average pool is a row-major sequential float32 sum
times ``float32(1 / n)`` (what ``jnp.mean`` computes), and the requant
divides by a tensor scale (IEEE division; a CPU-scalar divisor would
let CUDA multiply by its reciprocal instead).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.scheduler import simulate
from repro_torch.kernels.ref import conv_patches_ref
from repro_torch.quant.uniform import _inv_hi, fit_scale, qrange
from repro_torch.compiler.program import CORE_NAMES, ConvGeometry, \
    CoreProgram, LayerProgram, Program


class ExecutionError(RuntimeError):
    """An instruction stream violated the ISA/program contract."""


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the
    default everywhere) raises when no card is present: nothing falls
    back to the CPU unless the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "versions on the CPU")
    return device


# ---------------------------------------------------------------------------
# im2col activation staging (§3.2.1)
# ---------------------------------------------------------------------------


def im2col_patches(x_sp: torch.Tensor, geom: ConvGeometry) -> torch.Tensor:
    """Stage a spatial [in_hw, in_hw, C] tensor into im2col patches
    [m, kernel**2, C] (m = out_hw**2, output positions row-major, taps
    in (kh, kw) order). Dense convs flatten the last two axes to the
    [m, k] GEMM activation matrix with k in (kh, kw, c) order — exactly
    the HWIO weight flattening ``w.reshape(k, n)`` contracts against.
    """
    return conv_patches_ref(x_sp, geom.kernel, geom.stride, geom.pad,
                            geom.out_hw)


def spatialize(out: torch.Tensor, geom: ConvGeometry) -> torch.Tensor:
    """A layer's [m, n] output as the NHWC [out_hw, out_hw, c_out]
    spatial tensor the next layer's staging reads (batch 1)."""
    return out.reshape(geom.out_hw, geom.out_hw, geom.c_out)


def _same_pads(n: int, window: int, stride: int) -> tuple[int, int]:
    """(low, high) padding of XLA's SAME rule along one axis."""
    out = (n + stride - 1) // stride
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def apply_pool(x_sp: torch.Tensor, pool: str) -> torch.Tensor:
    """Spatial pooling glue between conv layers: ``"max"`` is the
    ResNet stem's 3x3 stride-2 SAME max pool, ``"gap"`` the global
    average pool before the classifier. ``""`` is the identity.

    The output spatial extents agree with ``core.workloads.pooled_hw``.
    """
    if pool == "max":
        h, w, _ = x_sp.shape
        lo_h, hi_h = _same_pads(h, 3, 2)
        lo_w, hi_w = _same_pads(w, 3, 2)
        t = x_sp.permute(2, 0, 1).unsqueeze(0)
        t = F.pad(t, (lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
        t = F.max_pool2d(t, 3, 2)
        return t[0].permute(1, 2, 0).contiguous()
    if pool == "gap":
        h, w, c = x_sp.shape
        rows = x_sp.reshape(h * w, c)
        acc = rows[0].clone()
        for i in range(1, h * w):           # row-major sequential sum
            acc += rows[i]
        inv_n = float(np.float32(1.0 / (h * w)))
        return (acc * inv_n).reshape(1, 1, c)
    return x_sp


@dataclasses.dataclass
class LayerWeights:
    """Integer weight codes + per-column dequant scales for one layer,
    already split: LUT (bit-serial) columns first, DSP (int4) columns
    after — the same column order ``hetero_gemm_ref`` concatenates."""
    w_lut: torch.Tensor | None      # [k, n_lut] int32 codes
    s_lut: torch.Tensor | None      # [n_lut] fp32
    w_dsp: torch.Tensor | None      # [k, n_dsp] int32 codes (int4 range)
    s_dsp: torch.Tensor | None      # [n_dsp] fp32


class ExecutorBackend:
    """Functional executor over a compiled program on one torch device.

    Subclasses implement :meth:`_run_core` — how one layer partition is
    actually computed. Everything else (binding, validation, chaining)
    is shared so backends are interchangeable and bit-comparable.
    """

    #: registry key; subclasses override ("cuda", ...)
    name = "base"

    def __init__(self, program: Program, check_timing: bool = True,
                 tracer=None, device="cuda"):
        self.program = program
        self.check_timing = check_timing
        self.device = resolve_device(device)
        # measured (wall-clock) timeline sink; the null tracer keeps
        # every hook free when observability is off
        if tracer is None:
            from repro_torch.obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        self._weights: dict[int, LayerWeights] = {}

    # -- weight binding ----------------------------------------------------

    def bind_layer(self, index: int, w_lut=None, s_lut=None,
                   w_dsp=None, s_dsp=None) -> None:
        lp = self.program.layers[index]
        k, n_lut, n_dsp = lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut

        def _chk(w, s, n, what, bits):
            if n == 0:
                if w is not None:
                    raise ValueError(f"layer {index} has no {what} partition")
                return None, None
            w = self._on_device(w, torch.int32)
            s = self._on_device(s, torch.float32).reshape(-1)
            if tuple(w.shape) != (k, n) or tuple(s.shape) != (n,):
                raise ValueError(
                    f"layer {index} {what} weights must be [{k},{n}] "
                    f"(+[{n}] scales), got {tuple(w.shape)}/{tuple(s.shape)}")
            lo, hi = qrange(bits)
            if int(w.min()) < lo or int(w.max()) > hi:
                raise ValueError(f"layer {index} {what} codes exceed "
                                 f"{bits}-bit range [{lo},{hi}]")
            return w, s

        w_lut, s_lut = _chk(w_lut, s_lut, n_lut, "lut", lp.bits_w_lut)
        w_dsp, s_dsp = _chk(w_dsp, s_dsp, n_dsp, "dsp", 4)
        self._weights[index] = LayerWeights(w_lut, s_lut, w_dsp, s_dsp)

    # -- execution ---------------------------------------------------------

    def _on_device(self, a, dtype: torch.dtype) -> torch.Tensor:
        """A numpy array or tensor as ``dtype`` on this executor's
        device."""
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))
        return a.to(device=self.device, dtype=dtype)

    def _as_codes(self, x_q) -> torch.Tensor:
        """Activation codes as an int8 tensor on this executor's device."""
        return self._on_device(x_q, torch.int8)

    def run_layer(self, index: int, x_q) -> torch.Tensor:
        """Execute one layer on int8 activations.

        ``x_q`` is the pre-staged GEMM activation matrix [m, k] (plain
        GEMM layers and dense convs), the spatial NHWC tensor
        [in_hw, in_hw, c_in] for conv layers (staged here per the
        layer's geometry), or the pre-staged per-channel im2col stack
        [m, k, n] for depthwise layers.

        Returns fp32 [m, n] in split column order (LUT partition first),
        i.e. exactly ``kernels.ref.hetero_gemm_ref``'s layout — which
        for depthwise layers is the natural channel order (the Eq.-12
        split assigns the *first* ``n_lut`` filters to the LUT core).
        """
        lp = self.program.layers[index]
        if index not in self._weights:
            raise ExecutionError(f"layer {index} has no bound weights")
        x_q = self._staged_activations(lp, self._as_codes(x_q))
        wts = self._weights[index]

        def _slice(lo, hi):
            # depthwise channel c consumes im2col slice c: hand each
            # partition exactly its channels' slices
            return x_q[:, :, lo:hi] if lp.depthwise else x_q

        outs = []
        if lp.lut is not None:
            self._check_stream(lp, lp.lut)
            with self.tracer.measure(f"exec.{self.name}.lut", lp.name,
                                     layer=lp.index, n=lp.n_lut):
                outs.append(self._run_core(lp, lp.lut, _slice(0, lp.n_lut),
                                           wts.w_lut, wts.s_lut))
        if lp.dsp is not None:
            self._check_stream(lp, lp.dsp)
            with self.tracer.measure(f"exec.{self.name}.dsp", lp.name,
                                     layer=lp.index,
                                     n=lp.dims.n - lp.n_lut):
                outs.append(self._run_core(lp, lp.dsp,
                                           _slice(lp.n_lut, lp.dims.n),
                                           wts.w_dsp, wts.s_dsp))
        return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]

    def _staged_activations(self, lp: LayerProgram,
                            x_q: torch.Tensor) -> torch.Tensor:
        """Normalize layer input to the staged im2col form: [m, k] for
        dense layers, [m, k, n] per-channel slices for depthwise."""
        m, k, n = lp.dims.m, lp.dims.k, lp.dims.n
        geom = lp.geometry
        if geom is not None and tuple(x_q.shape) == geom.in_shape:
            pat = im2col_patches(x_q, geom)
            return pat if lp.depthwise else pat.reshape(m, k)
        if lp.depthwise:
            if tuple(x_q.shape) != (m, k, n):
                want = (f"{geom.in_shape} spatial or " if geom else "")
                raise ExecutionError(
                    f"depthwise layer {lp.index} activations must be "
                    f"{want}[{m},{k},{n}] staged, got {tuple(x_q.shape)}")
            return x_q
        if tuple(x_q.shape) != (m, k):
            want = (f"{geom.in_shape} spatial or " if geom else "")
            raise ExecutionError(
                f"layer {lp.index} activations must be {want}"
                f"[{m},{k}], got {tuple(x_q.shape)}")
        return x_q

    def _check_stream(self, lp: LayerProgram, cp: CoreProgram) -> None:
        """Validate the sync-token protocol (when ``check_timing``) by
        running the event-driven scheduler over the core's streams."""
        if not self.check_timing:
            return
        try:
            simulate(cp.streams, cp.sim_tokens())
        except RuntimeError as e:
            raise ExecutionError(
                f"layer {lp.index} {CORE_NAMES[cp.core]} streams "
                f"deadlock: {e}") from e

    def run(self, x_q, x_scale: float | torch.Tensor = 1.0) -> torch.Tensor:
        """Chain all layers end to end (see :func:`chain_layers`).

        ``x_q`` is int8: [m, k] for FC chains, the spatial
        [in_hw, in_hw, c_in] input image (one image) for conv chains;
        ``x_scale`` is the input's dequant scale, a float or a 0-dim
        float32 tensor (conv chains return absolute fp32 logits for the
        final layer).
        """
        return chain_layers(self.program.layers, self.run_layer,
                            self._as_codes(x_q), x_scale=x_scale)

    # -- backend hook ------------------------------------------------------

    def _run_core(self, lp: LayerProgram, cp: CoreProgram, x_q,
                  w_codes, w_scales) -> torch.Tensor:
        """Compute one layer partition's [m, n_part] fp32 output."""
        raise NotImplementedError


def requantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Inter-layer write-back requantization: fp32 -> int8 codes at
    ``bits`` with a per-tensor max-abs scale (the chain's single
    bit-exactness-critical quantizer)."""
    return requantize_with_scale(x, bits)[0]


def requantize_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Row-independent twin of :func:`requantize`: one max-abs scale
    per batch row instead of per tensor.

    For a single-row input the scale reduction sees exactly the same
    elements as the per-tensor path, so the two are bit-identical at
    batch 1 — which is what lets slot-batched decode
    (``DecodeSession.step_slots``) mix unrelated requests in one batch
    while each slot stays bit-exact against a dedicated batch-1
    session. The scales stay a device tensor, so ``x / s_a`` is IEEE
    division on every device.
    """
    lo, hi = qrange(bits)
    s_a = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) \
        * _inv_hi(bits)
    return torch.clamp(torch.round(x / s_a), lo, hi).to(torch.int8)


def requantize_with_scale(x: torch.Tensor, bits: int):
    """:func:`requantize` that also returns the per-tensor scale (a
    0-dim float32 tensor on ``x``'s device) — the spatial chain tracks
    (codes, scale) pairs so residual adds and the non-scale-invariant
    activations run in absolute fp32 units."""
    s_a = fit_scale(x, bits)
    lo, hi = qrange(bits)
    return torch.clamp(torch.round(x / s_a), lo, hi).to(torch.int8), s_a


def apply_elementwise(y: torch.Tensor, ops, residual=None) -> torch.Tensor:
    """Apply the add/activation ops of a fused elementwise tail to a
    layer's absolute fp32 output ``y`` (``requant`` is the chain's job;
    pool glue applies between the activation and the requant).

    ``residual`` is the dequantized add operand (same shape as ``y``),
    required iff an ``add`` op is present.
    """
    for op in ops:
        if op.kind == "add":
            if residual is None:
                raise ExecutionError("elementwise add without a residual "
                                     "operand")
            y = y + residual
        elif op.kind == "relu":
            y = torch.clamp(y, min=0.0)
        elif op.kind == "relu6":
            y = torch.clamp(y, 0.0, 6.0)
        elif op.kind == "hswish":
            y = y * torch.clamp(y + 3.0, 0.0, 6.0) \
                * float(np.float32(1.0 / 6.0))
        elif op.kind != "requant":
            raise ExecutionError(f"unknown elementwise kind {op.kind!r}")
    return y


def elementwise_tail(ops, pool: str):
    """Build the functional form of one layer's fused elementwise tail:
    ``tail(y_abs, residual=None) -> (y_post, codes, scale)`` — add/act
    ops, the geometry's ``pool`` glue, then the write-back ``requant``
    producing the stored (codes, scale) pair (``(y, None, None)`` when
    the tail carries no requant, i.e. the final layer)."""
    ops = tuple(ops)
    rq = [op for op in ops if op.kind == "requant"]

    def tail(y, residual=None):
        y = apply_elementwise(y, ops, residual)
        y = apply_pool(y, pool)
        if rq:
            codes, scale = requantize_with_scale(y, rq[0].bits)
            return y, codes, scale
        return y, None, None
    return tail


def chain_layers(layers, run_layer, x_q, x_scale: float = 1.0):
    """Chain ``layers`` through ``run_layer(index, x_q)`` with the
    inter-layer requantization the hardware applies on write-back.

    When every layer carries a geometry the chain is spatial (NHWC
    reshape + the in-program fused elementwise tail + im2col staging,
    shortcut layers reading ``src_offset`` producers), otherwise the FC
    rule n_i == k_{i+1} applies.
    """
    layers = list(layers)
    if layers and all(getattr(lp, "geometry", None) is not None
                      for lp in layers):
        return _chain_spatial(layers, run_layer, x_q, x_scale)
    out = None
    for lp in layers:
        if out is not None:
            if out.shape[1] != lp.dims.k or out.shape[0] != lp.dims.m:
                raise ExecutionError(
                    f"layer {lp.index} expects [{lp.dims.m},{lp.dims.k}] "
                    f"activations but layer {lp.index - 1} produced "
                    f"{tuple(out.shape)}; run_layer() drives "
                    f"non-chaining programs layer by layer")
            x_q = requantize(out, lp.bits_a)
        out = run_layer(lp.index, x_q)
    return out


def _chain_spatial(layers, run_layer, x_q: torch.Tensor,
                   x_scale: float) -> torch.Tensor:
    """Spatial NHWC chain over conv layers.

    Layer ``pos`` consumes the stored post-tail codes of layer
    ``pos - src_offset``. The chain tracks a (codes, scale) pair per
    producer: a layer's GEMM result is first scaled to absolute fp32
    units, then its in-program fused elementwise tail runs — residual
    add of the dequantized ``src_offset`` producer, activation, the
    geometry's ``pool`` glue, and the write-back ``requant`` that
    produces the codes + scale its consumers stage. The final layer
    carries no requant: its absolute fp32 output (the logits) is
    returned.
    """
    # per-position (abs fp32 post-pool output, codes, scale); codes are
    # materialized lazily for programs predating the elementwise stage
    stored: list[list] = []

    def _stage(pos: int, bits: int):
        y_abs, codes, scale = stored[pos]
        if codes is None:
            codes, scale = requantize_with_scale(y_abs, bits)
            stored[pos][1:] = [codes, scale]
        return codes, scale

    for pos, lp in enumerate(layers):
        geom = lp.geometry
        ew = tuple(getattr(lp, "elementwise", ()) or ())
        if pos == 0:
            x_sp = x_q
            if tuple(x_sp.shape) != geom.in_shape:
                raise ExecutionError(
                    f"conv chain input must be spatial "
                    f"{geom.in_shape}, got {tuple(x_sp.shape)}")
            s_in = torch.as_tensor(x_scale, dtype=torch.float32,
                                   device=x_sp.device)
        else:
            src = pos - geom.src_offset
            if src < 0:
                raise ExecutionError(
                    f"layer {lp.index} reads producer {src}, which "
                    f"precedes the chain")
            x_sp, s_in = _stage(src, lp.bits_a)
            if tuple(x_sp.shape) != geom.in_shape:
                raise ExecutionError(
                    f"layer {lp.index} expects spatial {geom.in_shape} "
                    f"but producer {src} yields {tuple(x_sp.shape)}")
        y = spatialize(run_layer(lp.index, x_sp), geom) * s_in
        residual = None
        for op in ew:
            if op.kind != "add":
                continue
            r = pos - op.src_offset
            if r < 0:
                raise ExecutionError(
                    f"layer {lp.index} adds producer {r}, which "
                    f"precedes the chain")
            r_codes, r_scale = _stage(r, lp.bits_a)
            if tuple(r_codes.shape) != tuple(y.shape):
                raise ExecutionError(
                    f"layer {lp.index} residual add expects "
                    f"{tuple(y.shape)} but producer {r} yields "
                    f"{tuple(r_codes.shape)}")
            residual = r_codes.to(torch.float32) * r_scale
        y, codes, scale = elementwise_tail(ew, geom.pool)(y, residual)
        stored.append([y, codes, scale])
    # final layer: absolute fp32 logits in GEMM [rows, c_out] form
    return stored[-1][0].reshape(-1, layers[-1].geometry.c_out)


def synthetic_weights(index: int, k: int, n_lut: int, n_dsp: int,
                      bits_w_lut: int, seed: int | None = None):
    """Deterministic synthetic (w_lut, s_lut, w_dsp, s_dsp) numpy arrays
    for a layer — the same generator and draws as the reference, so
    both packages bind the same codes for the same seed.

    Codes span each partition's full quantized range; scales are a
    0.5..1.5 ramp so column mixups cannot cancel out.
    """
    rng = np.random.default_rng(index if seed is None else seed)
    lo_w, hi_w = qrange(bits_w_lut)
    lo_d, hi_d = qrange(4)
    return (
        rng.integers(lo_w, hi_w + 1, (k, n_lut)) if n_lut else None,
        np.linspace(0.5, 1.5, n_lut, dtype=np.float32) if n_lut else None,
        rng.integers(lo_d, hi_d + 1, (k, n_dsp)) if n_dsp else None,
        np.linspace(0.5, 1.5, n_dsp, dtype=np.float32) if n_dsp else None,
    )


def bind_synthetic(ex: ExecutorBackend, lp: LayerProgram,
                   seed: int | None = None) -> None:
    """Bind deterministic synthetic weight codes/scales for one layer."""
    w_lut, s_lut, w_dsp, s_dsp = synthetic_weights(
        lp.index, lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut,
        lp.bits_w_lut, seed)
    ex.bind_layer(lp.index, w_lut=w_lut, s_lut=s_lut,
                  w_dsp=w_dsp, s_dsp=s_dsp)


def bind_numpy_weights(ex: ExecutorBackend, weights: dict) -> None:
    """Bind ``{layer index: (w_lut, s_lut, w_dsp, s_dsp)}`` given as
    numpy arrays (``None`` for an absent split side) — how codes made
    elsewhere, such as another executor's bound weights, are carried
    into this one."""
    for index, (w_lut, s_lut, w_dsp, s_dsp) in sorted(weights.items()):
        ex.bind_layer(index, w_lut=w_lut, s_lut=s_lut,
                      w_dsp=w_dsp, s_dsp=s_dsp)
