"""Dataset-scale accuracy validation of compiled CNN programs, on torch.

The counterpart of ``repro.eval.accuracy``. A compiled program being
bit-identical across backends says nothing about how far the
*quantized pipeline itself* drifts from the fp32 network; this module
measures that drift at dataset scale:

  1. an fp32 reference with **frozen norms**
     (``models.cnn.calibrate_norms`` — the data-dependent RMS statistic
     pinned on one calibration batch, so the reference is a per-sample
     function like the accelerator);
  2. the frozen norm **folded into effective weights**
     (``models.cnn.fold_inference_weights`` — the BN-fold the deployed
     accelerator applies, since compiled programs carry no norm op);
  3. the folded weights quantized with the paper's filter-wise hybrid
     split (first ``n_lut`` output columns at the layer's LUT
     bit-width, the rest int4) and bound to a compiled executor;
  4. both evaluated over ``data.SyntheticImages`` and compared by
     **top-1 agreement** — the fraction of samples where the compiled
     int pipeline picks the same class as the fp32 reference.

Deployment uses the identity filter allocation, as the reference does:
the Eq.-12 split holds (first ``n_lut`` filters are LUT-core), the
KL-sensitivity ordering inside it is forfeited because the compiled
chain reads producer segments in natural channel order.

The compiled chain runs **one image at a time**: each image is
quantized to 8-bit codes with its own max-abs scale and driven through
``ex.run``, so every requant reduces over one sample, as the
reference's ``vmap`` does. The fp32 reference runs batched on
``torch_device``; its training and forward run their convolutions in
IEEE fp32 with deterministic algorithms (``models.cnn.fp32_convs``), so
one seed trains the same network on every run on one device.

Every entry point runs on the card unless the caller passes
``torch_device="cpu"``; none falls back to the CPU.

    python -m repro_torch.eval.accuracy --smoke --torch-device cpu
    python -m repro_torch.eval.accuracy --arch resnet18 --backend cuda
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.core.scheduler import (
    XC7Z020,
    DspCoreConfig,
    FPGADevice,
    LutCoreConfig,
    simulate_program,
)
from repro_torch.core.workloads import ConvSpec
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.models import cnn
from repro_torch.models.cnn import CNNConfig, specs_for
from repro_torch.quant.uniform import fit_scale, fit_scale_per_channel, qrange
from repro_torch.compiler.lower import lower_network
from repro_torch.compiler.program import GemmLayer
from repro_torch.compiler.runtime import BACKENDS, get_backend
from repro_torch.compiler.runtime.base import resolve_device

#: Documented top-1 agreement floor for the default harness operating
#: point (reduced-geometry nets, 8-bit activations, 8-bit first/last
#: layers, hybrid w4-LUT/int4-DSP middle layers, SNR-3 synthetic data).
#: ``main`` exits nonzero below it.
AGREEMENT_FLOOR = 0.95

ARCHS = ("resnet18", "mobilenet_v2")


@dataclasses.dataclass(frozen=True)
class AccuracyReport:
    """One dataset-scale agreement measurement. ``train_s`` and
    ``eval_ms_per_image`` are host-clock costs of the run, left out of
    equality so that two runs of one measurement compare equal."""
    arch: str
    backend: str
    n_samples: int
    agreement: float            # fraction in [0, 1]
    top1_compiled: float        # vs the synthetic labels
    top1_ref: float
    latency_ms: float | None    # simulated, single sample
    sim_cycles: int | None
    w_bits: int
    a_bits: int
    ratio: float
    #: seconds to train and freeze the fp32 reference
    train_s: float | None = dataclasses.field(default=None, compare=False)
    #: evaluation (compiled chain and reference) per sample, ms
    eval_ms_per_image: float | None = dataclasses.field(default=None,
                                                        compare=False)

    def bench_row(self) -> dict:
        """The ``accuracy.eval`` BENCH blob (Table 4/5 companion row:
        measured agreement next to the simulated latency)."""
        return {
            "BENCH": "accuracy.eval",
            "network": self.arch,
            "backend": self.backend,
            "n_samples": self.n_samples,
            "agreement": round(self.agreement, 4),
            "top1_compiled": round(self.top1_compiled, 4),
            "top1_ref": round(self.top1_ref, 4),
            "agreement_floor": AGREEMENT_FLOOR,
            "meets_floor": bool(self.agreement >= AGREEMENT_FLOOR),
            "latency_ms": None if self.latency_ms is None
            else round(self.latency_ms, 4),
            "sim_cycles": self.sim_cycles,
            "w_bits": self.w_bits,
            "a_bits": self.a_bits,
            "ratio": self.ratio,
            "train_s": self.train_s,
            "eval_ms_per_image": self.eval_ms_per_image,
        }


# ---------------------------------------------------------------------------
# Reference model
# ---------------------------------------------------------------------------


def train_params(cfg: CNNConfig, steps: int = 200, batch: int = 64,
                 lr: float = 0.05, momentum: float = 0.9, seed: int = 0,
                 snr: float = 3.0, torch_device="cuda") -> dict:
    """Train the fp32 network on the synthetic task (SGD + momentum:
    ``v = momentum * v + g; p = p - lr * v``).

    Agreement between a compiled quantized pipeline and an *untrained*
    network is meaningless: random-init logits have near-zero margins,
    so even sub-percent quantization noise flips argmax on most
    samples. A short training run saturates the separable synthetic
    task and opens real margins — then agreement measures quantization
    damage, not coin flips.

    Norm biases are zeroed after every step so the trained norm stays
    foldable into pure weight gains
    (:func:`~repro_torch.models.cnn.fold_inference_weights`).
    """
    device = resolve_device(torch_device)
    params = cnn.init(cfg, torch.Generator(device=device).manual_seed(seed))
    ds = SyntheticImages(cfg.n_classes, batch, cfg.in_hw, seed=seed,
                         snr=snr, sample_seed=seed)
    leaves = [t.requires_grad_() for p in params.values() for t in p.values()]
    vel = [torch.zeros_like(t) for t in leaves]
    for _ in range(steps):
        b = ds.next_batch()
        x, y = b["images"].to(device), b["labels"].to(device)
        with cnn.fp32_convs():
            loss = cnn.cross_entropy(cnn.forward(params, x, cfg), y)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, v, g in zip(leaves, vel, grads):
                v.mul_(momentum).add_(g)
                p.sub_(lr * v)
            for p in params.values():            # keep the fold exact
                p["bias"].zero_()
    return {name: {k: t.detach() for k, t in p.items()}
            for name, p in params.items()}


def build_reference(cfg: CNNConfig, seed: int = 0, calib_batch: int = 64,
                    snr: float = 3.0, train_steps: int = 200,
                    torch_device="cuda"):
    """(params, frozen norms, fp32 forward) for one config.

    Trains for ``train_steps`` SGD steps first (``train_steps=0`` skips
    — random init, only useful for plumbing tests). The calibration
    batch comes from the *train*-side sample stream (``sample_seed =
    seed``); evaluation uses a disjoint stream, so the frozen
    statistics are genuinely out-of-sample for the eval set. The
    forward takes an NHWC batch on any device and returns logits on
    ``torch_device``.
    """
    device = resolve_device(torch_device)
    if train_steps:
        params = train_params(cfg, steps=train_steps, seed=seed, snr=snr,
                              torch_device=device)
    else:
        params = cnn.init(cfg,
                          torch.Generator(device=device).manual_seed(seed))
    calib = SyntheticImages(cfg.n_classes, calib_batch, cfg.in_hw,
                            seed=seed, snr=snr, sample_seed=seed)
    norms = cnn.calibrate_norms(
        params, calib.next_batch()["images"].to(device), cfg)

    @torch.no_grad()
    def ref_fn(x: torch.Tensor) -> torch.Tensor:
        return cnn.forward(params, x.to(device), cfg, norms=norms)

    return params, norms, ref_fn


# ---------------------------------------------------------------------------
# Folded weights -> quantized [k, n] bindings
# ---------------------------------------------------------------------------


def fold_to_matrix(w_eff: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """HWIO effective weight -> the [k, n] GEMM matrix the executor
    binds: rows in im2col ``(kh, kw, c_in)`` patch order (dense) or
    ``(kh, kw)`` per channel (depthwise), columns = output filters."""
    if spec.depthwise:
        return torch.reshape(w_eff, (spec.kernel * spec.kernel, spec.c_out))
    return torch.reshape(
        w_eff, (spec.kernel * spec.kernel * spec.c_in, spec.c_out))


def quantize_folded_matrix(w_mat: torch.Tensor, n_lut: int, w_bits_lut: int):
    """Identity-allocation hybrid quantization of one [k, n] matrix:
    first ``n_lut`` columns at ``w_bits_lut``, the rest int4, each with
    per-column max-abs scales. Returns the ``bind_layer`` quadruple
    (``None`` for an empty partition)."""
    n = w_mat.shape[1]

    def _part(cols, bits):
        if cols.shape[1] == 0:
            return None, None
        s = fit_scale_per_channel(cols, bits, axis=1)
        lo, hi = qrange(bits)
        codes = torch.clamp(torch.round(cols / s), lo, hi).to(torch.int32)
        return codes, s.reshape(-1)

    w_lut, s_lut = _part(w_mat[:, :n_lut], w_bits_lut)
    w_dsp, s_dsp = _part(w_mat[:, n_lut:n], 4)
    return w_lut, s_lut, w_dsp, s_dsp


def bind_folded_weights(ex, program, folded: dict,
                        specs: list[ConvSpec]) -> None:
    """Quantize the folded weights to each layer's compiled split
    (``n_lut`` / LUT bit-width come from the program, so the binding
    realizes exactly the design point that was lowered) and bind."""
    for lp, spec in zip(program.layers, specs):
        w_mat = fold_to_matrix(folded[spec.name], spec)
        w_lut, s_lut, w_dsp, s_dsp = quantize_folded_matrix(
            w_mat, lp.n_lut, lp.bits_w_lut)
        ex.bind_layer(lp.index, w_lut=w_lut, s_lut=s_lut,
                      w_dsp=w_dsp, s_dsp=s_dsp)


# ---------------------------------------------------------------------------
# Compile + evaluate
# ---------------------------------------------------------------------------


def compile_quantized_cnn(cfg: CNNConfig, w_bits: int = 4, a_bits: int = 8,
                          ratio: float = 0.5,
                          device: FPGADevice = XC7Z020,
                          lut_cfg: LutCoreConfig | None = None,
                          dsp_cfg: DspCoreConfig | None = None,
                          opt_level: int = 1):
    """Lower ``cfg``'s network at the paper's quantization policy:
    first/last layers 8-bit (all-LUT, so the 8-bit weights fit a
    partition — the DSP core is fixed int4), middle layers hybrid
    ``w_bits``-LUT / int4-DSP at ``ratio``, activations ``a_bits``
    (8-bit first/last). ``device`` is the modelled FPGA. Returns
    ``(program, specs)``."""
    lut_cfg = lut_cfg or LutCoreConfig(m=8, n=16, k=128)
    dsp_cfg = dsp_cfg or DspCoreConfig(
        n_reg_row_a=DspCoreConfig.rows_for_device(device))
    specs = specs_for(cfg)
    layers = [GemmLayer.from_conv(s) for s in specs]
    edge = [s.is_first or s.is_last for s in specs]
    bw = [8 if e else w_bits for e in edge]
    ba = [8 if e else a_bits for e in edge]
    n_luts = [gl.dims.n if e else int(round(ratio * gl.dims.n))
              for gl, e in zip(layers, edge)]
    prog = lower_network(cfg.arch, layers, lut_cfg, dsp_cfg, device,
                         bits_w_lut=bw, bits_a=ba, n_luts=n_luts,
                         opt_level=opt_level)
    return prog, specs


def _batched_runner(ex):
    """The compiled chain over a batch, one image at a time: quantize
    each image to 8-bit codes with its own max-abs scale (a 0-dim tensor
    on the executor's device, so the division is IEEE on every device),
    run the chain, return logits [B, classes]."""
    lo, hi = qrange(8)

    def run(images: torch.Tensor) -> torch.Tensor:
        out = []
        for img in images.to(ex.device):
            s = fit_scale(img, 8)
            x_q = torch.clamp(torch.round(img / s), lo, hi).to(torch.int8)
            out.append(ex.run(x_q, x_scale=s).reshape(-1))
        return torch.stack(out)

    return run


def evaluate_agreement(ex, ref_fn, cfg: CNNConfig, n_samples: int,
                       batch: int = 64, seed: int = 0,
                       snr: float = 3.0) -> dict:
    """Stream ``n_samples`` synthetic images through the compiled
    executor and the fp32 reference; returns raw counts
    (``agree`` / ``correct_compiled`` / ``correct_ref`` / ``total``).

    Deterministic: the eval stream is seeded (``sample_seed = seed +
    10_000``, disjoint from the calibration stream) and the compiled
    chain is a pure function of the sample. The reference sees the
    whole batch, as the reference package's does.
    """
    ds = SyntheticImages(cfg.n_classes, batch, cfg.in_hw, seed=seed,
                         snr=snr, sample_seed=seed + 10_000)
    runner = _batched_runner(ex)
    agree = correct_c = correct_r = total = 0
    while total < n_samples:
        b = ds.next_batch()
        x, labels = b["images"], b["labels"].numpy()
        take = min(batch, n_samples - total)
        pred_c = torch.argmax(runner(x[:take]), dim=-1).cpu().numpy()
        pred_r = torch.argmax(ref_fn(x), dim=-1).cpu().numpy()[:take]
        labels = labels[:take]
        agree += int((pred_c == pred_r).sum())
        correct_c += int((pred_c == labels).sum())
        correct_r += int((pred_r == labels).sum())
        total += take
    return {"agree": agree, "correct_compiled": correct_c,
            "correct_ref": correct_r, "total": total}


def measure(arch: str, n_samples: int = 10_000, batch: int = 64,
            backend: str = "cuda", w_bits: int = 4, a_bits: int = 8,
            ratio: float = 0.5, seed: int = 0, snr: float = 3.0,
            reduced: bool = True, opt_level: int = 1,
            simulate: bool = True, train_steps: int = 200,
            device: FPGADevice = XC7Z020,
            torch_device="cuda") -> AccuracyReport:
    """End-to-end dataset-scale measurement for one architecture:
    train + freeze the fp32 reference, compile + bind the quantized
    network, evaluate agreement over ``n_samples``, and (optionally)
    simulate the program for the companion latency column. ``device``
    is the modelled FPGA, ``torch_device`` where the work runs."""
    dev = resolve_device(torch_device)
    cfg = cnn.reduced_config(arch) if reduced else CNNConfig(arch=arch)
    t0 = time.perf_counter()
    params, norms, ref_fn = build_reference(cfg, seed=seed, snr=snr,
                                            train_steps=train_steps,
                                            torch_device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    folded = cnn.fold_inference_weights(params, cfg, norms)
    prog, specs = compile_quantized_cnn(
        cfg, w_bits=w_bits, a_bits=a_bits, ratio=ratio, device=device,
        opt_level=opt_level)
    ex = get_backend(backend)(prog, device=dev)
    bind_folded_weights(ex, prog, folded, specs)
    t0 = time.perf_counter()
    counts = evaluate_agreement(ex, ref_fn, cfg, n_samples, batch=batch,
                                seed=seed, snr=snr)
    t = counts["total"]
    eval_ms = 1e3 * (time.perf_counter() - t0) / t
    cycles = latency_ms = None
    if simulate:
        cycles = int(simulate_program(prog).total_cycles)
        latency_ms = device.cycles_to_ms(cycles)
    return AccuracyReport(
        arch=arch, backend=backend, n_samples=t,
        agreement=counts["agree"] / t,
        top1_compiled=counts["correct_compiled"] / t,
        top1_ref=counts["correct_ref"] / t,
        latency_ms=latency_ms, sim_cycles=cycles,
        w_bits=w_bits, a_bits=a_bits, ratio=ratio,
        train_s=train_s, eval_ms_per_image=eval_ms)


# ---------------------------------------------------------------------------
# DSE hook
# ---------------------------------------------------------------------------


def make_accuracy_fn(cfg: CNNConfig, n_samples: int = 256,
                     batch: int = 32, seed: int = 0, snr: float = 3.0,
                     backend: str = "cuda", train_steps: int = 200,
                     torch_device="cuda"):
    """Package the harness as ``fn(program) -> agreement_pct`` for the
    design-space search: the reference, frozen norms and folded fp32
    weights are built **once** (they do not depend on the searched
    config); each elite's compiled program is then bound with its own
    quantization of those folded weights and scored by measured top-1
    agreement (percent, so it slots into the Eq.-18 reward where the
    proxy's accuracy term went).
    """
    cls = get_backend(backend)
    dev = resolve_device(torch_device)
    params, norms, ref_fn = build_reference(cfg, seed=seed, snr=snr,
                                            train_steps=train_steps,
                                            torch_device=dev)
    folded = cnn.fold_inference_weights(params, cfg, norms)
    specs = specs_for(cfg)

    def accuracy_fn(program) -> float:
        ex = cls(program, device=dev)
        bind_folded_weights(ex, program, folded, specs)
        counts = evaluate_agreement(ex, ref_fn, cfg, n_samples,
                                    batch=batch, seed=seed, snr=snr)
        return 100.0 * counts["agree"] / counts["total"]

    return accuracy_fn


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """Measure each arch on each backend and print one ``bench_row``
    JSON line per pair; exit 1 when a row misses
    :data:`AGREEMENT_FLOOR` (unless ``--no-gate``)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval.accuracy",
        description="dataset-scale compiled-vs-fp32 top-1 agreement")
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="architecture(s); default: both")
    ap.add_argument("--backend", action="append", choices=sorted(BACKENDS),
                    help="executor backend(s); default: cuda")
    ap.add_argument("--samples", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the task, the weights' init and the "
                         "training and eval streams")
    ap.add_argument("--smoke", action="store_true",
                    help="CI size: 96 samples, no latency simulation "
                         "(training stays at the documented 200 steps "
                         "— the floor is calibrated for a converged "
                         "reference)")
    ap.add_argument("--no-gate", action="store_true",
                    help="report only; do not exit nonzero below the "
                         "agreement floor")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device the reference and the compiled "
                         "chain run on (cpu runs the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    n_samples, simulate = args.samples, True
    if args.smoke:
        n_samples, simulate = 96, False
    ok = True
    for arch in args.arch or list(ARCHS):
        for backend in args.backend or ["cuda"]:
            rep = measure(arch, n_samples=n_samples, batch=args.batch,
                          backend=backend, w_bits=args.w_bits,
                          a_bits=args.a_bits, ratio=args.ratio,
                          seed=args.seed, train_steps=args.train_steps,
                          simulate=simulate, torch_device=args.torch_device)
            print(json.dumps(rep.bench_row(), sort_keys=True), flush=True)
            if rep.agreement < AGREEMENT_FLOOR:
                print(f"FAIL: accuracy.eval.{arch}.{backend} below "
                      f"agreement floor {AGREEMENT_FLOOR}", file=sys.stderr)
                ok = False
    return 0 if (ok or args.no_gate) else 1


if __name__ == "__main__":
    sys.exit(main())
