"""ResNet-18 / MobileNet-V2 in PyTorch — the paper's evaluation
workloads.

The counterpart of ``repro.models.cnn``. Every parametric layer maps
1:1 onto a ``ConvSpec`` in ``repro_torch.core.workloads`` (same names,
same order), so the compiler sees exactly the GEMM the network executes
(im2col equivalence). ``CNNConfig`` and ``specs_for`` build the reduced
geometry-consistent variants; ``init``, the forwards,
``calibrate_norms`` and ``fold_inference_weights`` are the fp32
network the accuracy harness trains, freezes and folds.

Tensors are NHWC and weights HWIO, as in the reference, so parameters
carry across with :func:`params_from_numpy`; ``conv2d`` permutes them to
torch's layouts (an NHWC tensor viewed as NCHW is channels-last, which
cuDNN takes without a copy). Every forward runs its convolutions in IEEE
fp32 with deterministic algorithms (:func:`fp32_convs`: cuDNN's TF32 off
and ``deterministic`` on for the call).

Quantization-aware forward: with ``quant_cfgs`` given (one
``LayerQuantConfig`` per spec), each conv's filters are fake-quantized
with the paper's hybrid filter-wise scheme (§4: DSP-core filters int4,
LUT-core filters 2–8 bit, KL-based allocation) and activations are
quantized layer-wise — first/last layers at 8 bits, as in the paper.

Normalization is a folded (inference-style) per-channel scale+bias over
a mean-free RMS statistic, which folds into the requantization at
inference exactly like BN does on the accelerator.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.workloads import ConvSpec, mobilenet_v2_specs, resnet18_specs
from repro_torch.compiler.runtime.base import _same_pads
from repro_torch.quant.hybrid import LayerQuantConfig, hybrid_fake_quant_weight
from repro_torch.quant.uniform import fake_quant_per_channel, fit_scale, qrange


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "resnet18"              # resnet18 | mobilenet_v2
    n_classes: int = 1000
    in_hw: int = 224
    width: float = 1.0                  # channel multiplier (reduced smoke)
    param_dtype = torch.float32


def reduced_config(arch: str, n_classes: int = 10) -> CNNConfig:
    return CNNConfig(arch=arch, n_classes=n_classes, in_hw=32, width=0.25)


def _scale_c(c: int, width: float) -> int:
    if width >= 1.0:
        return c
    return max(8, int(round(c * width / 8)) * 8) if c > 8 else c


def specs_for(cfg: CNNConfig) -> list[ConvSpec]:
    """ConvSpec list matching this config (width/input-size scaled).

    Spatial sizes are *propagated* through the layer graph — each
    layer's ``in_hw`` is its producer's (pooled) ``out_hw``, with the
    downsample shortcuts reading the block input three layers back —
    so the scaled specs chain exactly like the full-size network and
    the compiled program's im2col geometry stays executable at any
    input size.
    """
    base = resnet18_specs() if cfg.arch == "resnet18" else mobilenet_v2_specs()
    if cfg.width >= 1.0 and cfg.in_hw == 224 and cfg.n_classes == 1000:
        return base
    out: list[ConvSpec] = []
    for i, s in enumerate(base):
        c_in = 3 if s.is_first else _scale_c(s.c_in, cfg.width)
        c_out = (cfg.n_classes if s.is_last
                 else _scale_c(s.c_out, cfg.width))
        if s.depthwise:
            c_in = c_out = _scale_c(s.c_out, cfg.width)
        if s.is_first:
            in_hw = cfg.in_hw
        else:
            src = out[i - (3 if s.shortcut else 1)]
            in_hw = src.pooled_out_hw
        out.append(dataclasses.replace(s, c_in=c_in, c_out=c_out,
                                       in_hw=in_hw))
    return out



# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init(cfg: CNNConfig, generator: torch.Generator) -> dict:
    """Params keyed by ConvSpec name: {w, scale, bias}, on
    ``generator``'s device. ``w`` is HWIO, ``(k, k, 1, c)`` for
    depthwise layers, drawn N(0, 2 / fan_in)."""
    device = generator.device
    params = {}
    for s in specs_for(cfg):
        if s.depthwise:
            shape = (s.kernel, s.kernel, 1, s.c_out)
            fan = s.kernel * s.kernel
        else:
            shape = (s.kernel, s.kernel, s.c_in, s.c_out)
            fan = s.kernel * s.kernel * s.c_in
        std = math.sqrt(2.0 / fan)
        params[s.name] = {
            "w": std * torch.randn(shape, generator=generator,
                                   dtype=torch.float32, device=device),
            "scale": torch.ones(s.c_out, dtype=torch.float32, device=device),
            "bias": torch.zeros(s.c_out, dtype=torch.float32, device=device),
        }
    return params


def params_from_numpy(tree: Any, device=torch.device("cuda")) -> dict:
    """The reference's ``cnn.init`` params (or folded weights, or frozen
    norms) — nested dicts of numpy or JAX arrays — as the port's, on
    ``device``, with the same structure and bits (the counterpart, for
    the CNNs, of ``models/lm.py::params_from_jax``)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).to(device)


# ---------------------------------------------------------------------------
# Quantized conv primitive
# ---------------------------------------------------------------------------


def _quant_activations(x: torch.Tensor, bits: int) -> torch.Tensor:
    s = fit_scale(x.detach(), bits)
    lo, hi = qrange(bits)
    xq = torch.clamp(torch.round(x / s), lo, hi) * s
    return x + (xq - x).detach()                        # STE


@contextlib.contextmanager
def fp32_convs():
    """Run cuDNN convolutions in IEEE fp32 with deterministic algorithms
    for the duration (TF32 off, ``deterministic`` on, every other cuDNN
    flag as it was; all of them restored after).

    Deterministic algorithms make a training run on the card repeatable
    bit for bit, so that one seed names one trained network. With
    cuDNN's default choice, three trainings of reduced mobilenet_v2 from
    one seed ended in three networks whose top-1 agreement after
    quantization differed (PERF.md §6)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=True, allow_tf32=False):
        yield


def conv2d(x: torch.Tensor, w: torch.Tensor, s: ConvSpec) -> torch.Tensor:
    """The network's raw conv primitive: NHWC x HWIO, ``kernel // 2``
    padding, grouped for depthwise."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=s.stride, padding=s.kernel // 2,
                   groups=s.c_out if s.depthwise else 1)
    return out.permute(0, 2, 3, 1)


def conv_layer(p: dict, x: torch.Tensor, s: ConvSpec,
               q: LayerQuantConfig | None = None, relu: bool = True,
               norm: torch.Tensor | None = None,
               capture: dict | None = None) -> torch.Tensor:
    """NHWC conv + folded norm + optional relu, with hybrid quant.

    ``norm`` freezes the layer's RMS statistic to a precomputed value
    (inference mode — the batch statistic is data-dependent, so two
    different batches normalize differently; frozen norms are what the
    accelerator folds into its weights). ``capture`` records the
    statistic actually used under ``s.name`` (see
    :func:`calibrate_norms`).
    """
    w = p["w"]
    if q is not None:
        a_bits = 8 if (s.is_first or s.is_last) else q.a_bits
        x = _quant_activations(x, a_bits)
        if s.is_first or s.is_last:
            w = fake_quant_per_channel(w, 8, axis=3)
        else:
            # filters live on the last axis -> move to front for the
            # filter-wise hybrid scheme, then restore.
            w_f = torch.movedim(w, 3, 0)
            w_f = hybrid_fake_quant_weight(w_f, q)
            w = torch.movedim(w_f, 0, 3)
    out = conv2d(x, w, s)
    # BN-style per-channel RMS normalization (mean-free)
    if norm is None:
        rms = torch.sqrt(torch.mean(torch.square(out), dim=(0, 1, 2),
                                    keepdim=True) + 1e-6)
    else:
        rms = torch.as_tensor(norm, dtype=torch.float32,
                              device=out.device).reshape(1, 1, 1, -1)
    if capture is not None:
        capture[s.name] = rms.reshape(-1)
    out = (out / rms) * p["scale"] + p["bias"]
    if relu:
        # relu6 as hardtanh: its gradient is 0 at 0 and 6, as
        # jax.nn.relu6's is (clamp's passes there); a depthwise window
        # over relu zeros lands exactly on 0
        out = F.relu6(out) if s.depthwise else F.relu(out)
    return out


def _qc(quant_cfgs, i):
    return None if quant_cfgs is None else quant_cfgs[i]


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 SAME max pool of an NHWC batch, padded with -inf as
    ``reduce_window`` pads it (asymmetric on even maps)."""
    lo_h, hi_h = _same_pads(x.shape[1], 3, 2)
    lo_w, hi_w = _same_pads(x.shape[2], 3, 2)
    t = F.pad(x.permute(0, 3, 1, 2), (lo_w, hi_w, lo_h, hi_h),
              value=float("-inf"))
    return F.max_pool2d(t, 3, 2).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# ResNet-18 forward
# ---------------------------------------------------------------------------


def resnet18_forward(params: dict, x: torch.Tensor, cfg: CNNConfig,
                     quant_cfgs=None, norms: dict | None = None,
                     capture: dict | None = None) -> torch.Tensor:
    specs = {s.name: s for s in specs_for(cfg)}
    qi = {s.name: i for i, s in enumerate(specs_for(cfg))}

    def conv(name, x, relu=True):
        return conv_layer(params[name], x, specs[name],
                          _qc(quant_cfgs, qi[name]), relu,
                          norm=None if norms is None else norms[name],
                          capture=capture)

    x = conv("conv1", x)
    x = _max_pool_same(x)

    def basic_block(x, a, b, ds=None):
        h = conv(a, x)
        h = conv(b, h, relu=False)
        sc = x if ds is None else conv(ds, x, relu=False)
        return F.relu(h + sc)

    x = basic_block(x, "conv2", "conv3")
    x = basic_block(x, "conv4", "conv5")
    x = basic_block(x, "conv6", "conv7", "conv8_ds")
    x = basic_block(x, "conv9", "conv10")
    x = basic_block(x, "conv11", "conv12", "conv13_ds")
    x = basic_block(x, "conv14", "conv15")
    x = basic_block(x, "conv16", "conv17", "conv18_ds")
    x = basic_block(x, "conv19", "conv20")

    x = torch.mean(x, dim=(1, 2), keepdim=True)           # GAP -> [B,1,1,C]
    x = conv("fc", x, relu=False)
    return x[:, 0, 0, :]


# ---------------------------------------------------------------------------
# MobileNet-V2 forward
# ---------------------------------------------------------------------------


def mobilenet_v2_forward(params: dict, x: torch.Tensor, cfg: CNNConfig,
                         quant_cfgs=None, norms: dict | None = None,
                         capture: dict | None = None) -> torch.Tensor:
    all_specs = specs_for(cfg)
    specs = {s.name: s for s in all_specs}
    qi = {s.name: i for i, s in enumerate(all_specs)}

    def conv(name, x, relu=True):
        return conv_layer(params[name], x, specs[name],
                          _qc(quant_cfgs, qi[name]), relu,
                          norm=None if norms is None else norms[name],
                          capture=capture)

    x = conv("conv0", x)
    x = conv("b0_dw", x)
    x = conv("b0_pw", x, relu=False)

    bi = 1
    while f"b{bi}_exp" in specs:
        inp = x
        h = conv(f"b{bi}_exp", x)
        h = conv(f"b{bi}_dw", h)
        h = conv(f"b{bi}_pw", h, relu=False)
        if h.shape == inp.shape:
            h = h + inp                                   # inverted residual
        x = h
        bi += 1

    x = conv("conv_last", x)
    x = torch.mean(x, dim=(1, 2), keepdim=True)
    x = conv("fc", x, relu=False)
    return x[:, 0, 0, :]


def forward(params: dict, x: torch.Tensor, cfg: CNNConfig, quant_cfgs=None,
            norms: dict | None = None,
            capture: dict | None = None) -> torch.Tensor:
    """Logits [B, n_classes] of an NHWC float32 batch, convolutions in
    IEEE fp32 with deterministic algorithms (:func:`fp32_convs`)."""
    with fp32_convs():
        if cfg.arch == "resnet18":
            return resnet18_forward(params, x, cfg, quant_cfgs, norms,
                                    capture)
        if cfg.arch == "mobilenet_v2":
            return mobilenet_v2_forward(params, x, cfg, quant_cfgs, norms,
                                        capture)
    raise ValueError(f"unknown CNN arch {cfg.arch!r}")


# ---------------------------------------------------------------------------
# Inference-mode norm freezing + weight folding
# ---------------------------------------------------------------------------


@torch.no_grad()
def calibrate_norms(params: dict, x: torch.Tensor, cfg: CNNConfig) -> dict:
    """Freeze every layer's data-dependent RMS statistic on one
    calibration batch: ``{name: rms[c_out]}``.

    The batch statistic makes the forward a function of the *batch*,
    not the sample — two batches normalize differently, so dataset
    evaluation (and the accelerator, whose programs have no norm op)
    needs the statistic pinned. Evaluate with
    ``forward(..., norms=calibrate_norms(...))``.
    """
    capture: dict = {}
    forward(params, x, cfg, capture=capture)
    return capture


@torch.no_grad()
def fold_inference_weights(params: dict, cfg: CNNConfig,
                           norms: dict) -> dict:
    """Fold the frozen per-channel norm into effective conv weights:
    ``w_eff[..., c] = w[..., c] * scale[c] / rms[c]`` — exactly the
    BN-fold the accelerator deploys, so a compiled program binding
    quantized ``w_eff`` reproduces the frozen-norm network with no
    norm op in the instruction stream.

    Requires ``bias == 0`` everywhere (the compiled GEMM+elementwise
    pipeline has no bias stage to fold a nonzero bias into).
    """
    folded = {}
    for s in specs_for(cfg):
        p = params[s.name]
        if float(torch.max(torch.abs(p["bias"]))) != 0.0:
            raise ValueError(
                f"layer {s.name} has a nonzero norm bias; the compiled "
                f"pipeline has no bias stage to fold it into")
        gain = (p["scale"] / torch.as_tensor(norms[s.name],
                                             dtype=torch.float32,
                                             device=p["scale"].device)
                ).reshape(1, 1, 1, -1)
        folded[s.name] = p["w"] * gain
    return folded


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
