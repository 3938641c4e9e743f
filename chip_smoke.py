#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing its lines before the last:

1. card: ``nvidia-smi`` name and power limit; build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` with nvcc, time the build and
   print ptxas's register, shared-memory and spill report.
2. kernels: every split-GEMM kernel against its plain PyTorch version,
   on the card, at each of full-width resnet18's 21 layer shapes (the
   shapes the main path gives it), plus bit widths 2/4/8 and one-sided
   splits. Required: bitwise equality. Times: the kernel and the plain
   version (CUDA events after a warm-up), ``torch._int_mm`` on the
   reconstructed int8 weights as the library yardstick, and the bound
   (bytes at the weights' code width over 3.35 TB/s vs 2·m·k·n int8
   operations over 1,979 TOP/s).
3. slice: compile resnet18 (224, width 1.0, -O 0) with
   ``repro_torch.compiler``, bind synthetic weights, and drive four
   images through ``CudaExecutor``'s fused path, four through
   ``fused=False`` and image 0's per-layer inputs through the staged
   ``run_layer`` path, with the launch counts set to 0 just before each
   path and read just after it. Required: each path's counts exactly
   what its layers launch (``fused_conv_gemm`` 21 per image on the
   fused path; ``bitserial_gemm`` and ``int4_gemm`` one per split side
   on ``fused=False``; ``fused_hetero_gemm`` one per two-sided layer
   when staged; none in ``mode="ref"``), and logits bitwise equal to
   the plain versions on the card (``mode="ref"``), to ``fused=False``,
   to the staged path, and to the CPU run of the same image.

The line before the last is the kernels' JSON summary; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero and prints no result. It exits non-zero at once when
CUDA is unavailable or the package is not beside it.
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15          # H100 SXM dense int8 tensor cores
SOURCE = "src/repro_torch/kernels/csrc/split_gemm.cu"
REPLACES = {
    "fused_conv_gemm": "src/repro/kernels/fused_hetero_gemm.py:232",
    "fused_hetero_gemm": "src/repro/kernels/fused_hetero_gemm.py:106",
    "bitserial_gemm": "src/repro/kernels/bitserial_gemm.py:62",
    "int4_gemm": "src/repro/kernels/int4_gemm.py:55",
}
#: the executor path whose counted run each kernel's launches come from
KERNEL_PATH = {
    "fused_conv_gemm": "fused",
    "fused_hetero_gemm": "staged",
    "bitserial_gemm": "fused=False",
    "int4_gemm": "fused=False",
}
N_IMAGES = 4


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def require_equal(torch, name: str, got, want) -> float:
    """Bitwise equality (fp32 bits) or raise; returns max |got - want|."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    same = torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32))
    if not same:
        raise AssertionError(f"{name}: kernel != plain (max |err| {err})")
    return err


def bound_ms(x_bytes: int, m: int, k: int, bits: int, n_lut: int,
             n_dsp: int) -> tuple[float, str]:
    """Least time for one split GEMM: the activations, each weight at its
    code width (``bits`` per LUT weight, 4 per DSP weight) and the fp32
    scales read once and the fp32 output written once, vs the 2·m·k·n
    operations of the integer product at the int8 rate. The int8 bit
    planes the kernels read hold each LUT weight in 8x its bits."""
    n = n_lut + n_dsp
    nbytes = (x_bytes + -(-(bits * n_lut + 4 * n_dsp) * k // 8) + 4 * n
              + 4 * m * n)
    ops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def int_mm_fn(torch, x_col, codes, scale):
    """``torch._int_mm`` on the reconstructed int8 weights, zero-padded
    to its constraints (M > 16, K and N multiples of 8), then x scale."""
    m, k = x_col.shape
    n = codes.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((mp, kp), dtype=torch.int8, device=x_col.device)
    a[:m, :k] = x_col
    w = torch.zeros((np_, kp), dtype=torch.int8, device=x_col.device)
    w[:n, :k] = codes.t().to(torch.int8)
    b = w.t()                                   # column-major [kp, np_]
    s = torch.zeros(np_, dtype=torch.float32, device=x_col.device)
    s[:n] = scale
    return lambda: torch._int_mm(a, b).to(torch.float32) * s


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def phase_card(torch, details: dict):
    from repro_torch.kernels import build
    details["card"] = nvidia_smi()
    print(f"card: {details['card']}")
    built = build.library_path().exists() and build.report_path().exists()
    t0 = time.time()
    build.build()
    build.load_library()
    details["build_s"] = time.time() - t0
    details["ptxas"] = build.report_path().read_text()
    usage = [ln.split(":", 1)[-1].strip() for ln in
             details["ptxas"].splitlines() if "Used" in ln or "spill" in ln]
    print(f"build: {'cached library, load' if built else 'nvcc + load'} "
          f"{details['build_s']:.2f} s ({build.library_path().name}); "
          f"ptxas: {'; '.join(usage)}")


def layer_inputs(torch, prog, seed: int = 1):
    """Per layer: spatial codes at its input shape and their staging."""
    from repro_torch.compiler.runtime.base import im2col_patches
    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = []
    for lp in prog.layers:
        g = lp.geometry
        x_sp = torch.randint(-8, 8, g.in_shape, generator=gen,
                             dtype=torch.int8).cuda()
        x_col = im2col_patches(x_sp, g).reshape(lp.dims.m, lp.dims.k)
        out.append((x_sp, x_col.contiguous()))
    return out


def phase_kernels(torch, prog, ex, details: dict) -> dict:
    """Each kernel vs its plain version at the main path's 21 shapes
    (timed) and at extra bit widths / one-sided splits (checked)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bitserial_gemm import bitserial_gemm, \
        bitserial_gemm_plain
    from repro_torch.kernels.fused_hetero_gemm import fused_conv_gemm, \
        fused_conv_gemm_plain, fused_hetero_gemm, fused_hetero_gemm_plain
    from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain

    names = ("fused_conv_gemm", "fused_hetero_gemm", "bitserial_gemm",
             "int4_gemm")
    tot = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0, "max_abs_err": 0.0, "bytes": 0.0,
               "operations": 0.0} for n in names}
    rows = details.setdefault("layers", [])
    for lp, (x_sp, x_col) in zip(prog.layers, layer_inputs(torch, prog)):
        g, sw = lp.geometry, ex._split[lp.index]
        wts = ex._weights[lp.index]
        m, k, bits = lp.dims.m, lp.dims.k, lp.bits_w_lut
        n_lut, n_dsp = sw.n_lut, sw.n_dsp
        codes = torch.cat([c for c in (wts.w_lut, wts.w_dsp)
                           if c is not None], dim=1)
        conv = (g.kernel, g.stride, g.pad, g.out_hw)
        cases = {
            "fused_conv_gemm": (
                lambda: fused_conv_gemm(x_sp, sw.planes, sw.packed, sw.scale,
                                        bits, n_lut, n_dsp, *conv),
                lambda: fused_conv_gemm_plain(x_sp, sw.planes, sw.packed,
                                              sw.scale, bits, n_lut, n_dsp,
                                              *conv),
                int_mm_fn(torch, x_col, codes, sw.scale),
                bound_ms(x_sp.numel(), m, k, bits, n_lut, n_dsp)),
            "fused_hetero_gemm": (
                lambda: fused_hetero_gemm(x_col, sw.planes, sw.packed,
                                          sw.scale, bits, n_lut, n_dsp),
                lambda: fused_hetero_gemm_plain(x_col, sw.planes, sw.packed,
                                                sw.scale, bits, n_lut, n_dsp),
                int_mm_fn(torch, x_col, codes, sw.scale),
                bound_ms(x_col.numel(), m, k, bits, n_lut, n_dsp)),
            "bitserial_gemm": (
                lambda: bitserial_gemm(x_col, sw.planes, sw.s_lut, bits),
                lambda: bitserial_gemm_plain(x_col, sw.planes, sw.s_lut,
                                             bits),
                int_mm_fn(torch, x_col, wts.w_lut, sw.s_lut),
                bound_ms(x_col.numel(), m, k, bits, n_lut, 0)),
            "int4_gemm": (
                lambda: int4_gemm(x_col, sw.packed, sw.s_dsp, n_dsp),
                lambda: int4_gemm_plain(x_col, sw.packed, sw.s_dsp, n_dsp),
                int_mm_fn(torch, x_col, wts.w_dsp, sw.s_dsp),
                bound_ms(x_col.numel(), m, k, 0, 0, n_dsp)),
        }
        for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
            err = require_equal(torch, f"{name} {lp.name}", kern(), plain())
            row = {"kernel": name, "layer": lp.name, "m": m, "k": k,
                   "n_lut": n_lut if name != "int4_gemm" else 0,
                   "n_dsp": n_dsp if name != "bitserial_gemm" else 0,
                   "ms": cuda_ms(torch, kern),
                   "plain_ms": cuda_ms(torch, plain, iters=5),
                   "library_ms": cuda_ms(torch, lib),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            t = tot[name]
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += row[key]
            t[b_by] += b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
    for name in names:
        t = tot[name]
        print(f"kernel {name}: 21 resnet18 shapes bitwise equal to plain; "
              f"per image {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
              f"_int_mm {t['library_ms']:.4f}, bound {t['bound_ms']:.4f})")

    # extra corners: bit widths 2/4/8 and one-sided splits at the
    # conv1 / conv2 / conv8_ds / conv17 geometries and the staged fc
    gen = torch.Generator(device="cpu").manual_seed(7)
    picks = [lp for lp in prog.layers
             if lp.name in ("conv1", "conv2", "conv8_ds", "conv17", "fc")]
    n_checked = 0
    for lp in picks:
        g, m, k, n = lp.geometry, lp.dims.m, lp.dims.k, lp.dims.n
        x_sp = torch.randint(-128, 128, g.in_shape, generator=gen,
                             dtype=torch.int8).cuda()
        x_col = ref.conv_patches_ref(x_sp, g.kernel, g.stride, g.pad,
                                     g.out_hw).reshape(m, k).contiguous()
        for bits in (2, 4, 8):
            for n_lut in (0, lp.n_lut - 1, n):
                lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
                w_lut = torch.randint(lo, hi, (k, n_lut), generator=gen)
                w_dsp = torch.randint(-8, 8, (k, n - n_lut), generator=gen)
                s = torch.rand(n, generator=gen) + 0.5
                sw = ops.prepare_split(k, w_lut, s[:n_lut], bits, w_dsp,
                                       s[n_lut:], torch.device("cuda"))
                tag = f"{lp.name} bits={bits} n_lut={n_lut}/{n}"
                conv = (g.kernel, g.stride, g.pad, g.out_hw)
                require_equal(
                    torch, f"fused_conv_gemm {tag}",
                    ops.split_conv_matmul(x_sp, *conv, sw),
                    ops.split_conv_matmul(x_sp, *conv, sw, mode="ref"))
                require_equal(torch, f"split_matmul {tag}",
                              ops.split_matmul(x_col, sw),
                              ops.split_matmul(x_col, sw, mode="ref"))
                if n_lut:
                    require_equal(torch, f"bitserial_gemm {tag}",
                                  ops.lut_matmul(x_col, sw),
                                  ops.lut_matmul(x_col, sw, mode="ref"))
                if n - n_lut:
                    require_equal(torch, f"int4_gemm {tag}",
                                  ops.dsp_matmul(x_col, sw),
                                  ops.dsp_matmul(x_col, sw, mode="ref"))
                n_checked += 1
    print(f"kernels: {n_checked} extra (layer, bits, split) corners "
          f"bitwise equal to plain")
    return tot


def expected_launches(prog, ex) -> dict:
    """Per path, the launches of one image: the fused path launches
    ``fused_conv_gemm`` once per layer; ``fused=False`` one single-path
    kernel per non-empty split side; staged ``run_layer`` one
    ``fused_hetero_gemm`` per two-sided layer, else the side's kernel."""
    want = {p: collections.Counter() for p in ("fused", "fused=False",
                                               "staged")}
    for lp in prog.layers:
        sw = ex._split[lp.index]
        sides = [name for name, n in (("bitserial_gemm", sw.n_lut),
                                      ("int4_gemm", sw.n_dsp)) if n]
        want["fused"]["fused_conv_gemm"] += 1
        want["fused=False"].update(sides)
        want["staged"][sides[0] if len(sides) == 1
                       else "fused_hetero_gemm"] += 1
    return want


def read_launches(launches, per_image: dict, n_images: int,
                  path: str) -> dict:
    """The counts of one path's run; raise unless they are exactly
    ``per_image`` times ``n_images``."""
    got = {name: count for name, count in launches.items() if count}
    want = {name: count * n_images for name, count in per_image.items()}
    if got != want:
        raise AssertionError(f"{path} path launches {got} != {want}")
    return got


def phase_slice(torch, prog, ex, details: dict) -> dict:
    """Each CudaExecutor path on full-width resnet18, its launches
    counted in a window of its own; returns each kernel's count."""
    import numpy as np
    from repro_torch.compiler import CudaExecutor, bind_synthetic, \
        compile_network, execute_report
    from repro_torch.compiler.runtime.base import chain_layers, \
        im2col_patches
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.quant.uniform import qrange

    # warm-up: the CLI's own --execute path (builds, binds, one image)
    print(f"cli: {execute_report(prog, backend='cuda').strip()}")
    ex_ref = CudaExecutor(prog, mode="ref")
    ex_split = CudaExecutor(prog, fused=False)
    for e in (ex_ref, ex_split):
        for lp in prog.layers:
            bind_synthetic(e, lp, seed=lp.index)
    rng = np.random.default_rng(0)
    lo, hi = qrange(prog.layers[0].bits_a)
    images = [rng.integers(lo, hi + 1, prog.layers[0].geometry.in_shape)
              .astype(np.int8) for _ in range(N_IMAGES)]
    ex.run(images[0])
    torch.cuda.synchronize()
    want = expected_launches(prog, ex)

    # each path runs with the counts set to 0 just before it and read
    # just after it; its counts must be exactly what its layers launch
    LAUNCHES.clear()
    logits, lat = [], []
    for x in images:
        t0 = time.perf_counter()
        y = ex.run(x)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        logits.append(y)
    paths = {"fused": read_launches(LAUNCHES, want["fused"], N_IMAGES,
                                    "fused")}

    LAUNCHES.clear()
    split_logits = [ex_split.run(x) for x in images]
    paths["fused=False"] = read_launches(LAUNCHES, want["fused=False"],
                                         N_IMAGES, "fused=False")
    for i, y in enumerate(split_logits):
        require_equal(torch, f"image {i} fused vs fused=False", logits[i], y)

    # the staged run_layer path on image 0's per-layer inputs, recorded
    # by one more fused run outside the counted window
    inputs, outs = {}, {}

    def record(index, x_sp):
        inputs[index] = x_sp
        outs[index] = ex.run_layer(index, x_sp)
        return outs[index]
    chain_layers(prog.layers, record, ex._as_codes(images[0]))
    staged = {lp.index: im2col_patches(inputs[lp.index], lp.geometry)
              .reshape(lp.dims.m, lp.dims.k) for lp in prog.layers}
    torch.cuda.synchronize()
    LAUNCHES.clear()
    staged_outs = {i: ex.run_layer(i, x) for i, x in staged.items()}
    paths["staged"] = read_launches(LAUNCHES, want["staged"], 1, "staged")
    for lp in prog.layers:
        require_equal(torch, f"{lp.name} staged vs spatial",
                      staged_outs[lp.index], outs[lp.index])

    # plain versions on the card (they launch no kernel), and the CPU
    # run of image 0
    LAUNCHES.clear()
    for i, x in enumerate(images):
        require_equal(torch, f"image {i} kernels vs plain",
                      logits[i], ex_ref.run(x))
    read_launches(LAUNCHES, {}, N_IMAGES, "mode=ref")
    ex_cpu = CudaExecutor(prog, device="cpu")
    for lp in prog.layers:
        bind_synthetic(ex_cpu, lp, seed=lp.index)
    require_equal(torch, "image 0 card vs cpu", logits[0].cpu(),
                  ex_cpu.run(images[0]))
    y0 = logits[0].cpu().numpy()
    if y0.shape != (1, 1000) or not np.isfinite(y0).all():
        raise AssertionError(f"logits {y0.shape} not finite [1, 1000]")
    # a reduced resnet18 on the card and on the CPU
    small = compile_network("resnet18", in_hw=32, width=0.25)
    xs = images[0][:32, :32]
    ys = []
    for dev in ("cuda", "cpu"):
        e = CudaExecutor(small, device=dev)
        for lp in small.layers:
            bind_synthetic(e, lp, seed=lp.index)
        ys.append(e.run(xs).cpu())
    require_equal(torch, "reduced resnet18 card vs cpu", ys[0], ys[1])

    med = statistics.median(lat)
    print(f"slice: resnet18 224 x{N_IMAGES} images via CudaExecutor: "
          f"per-image latency median {med:.3f} ms ({', '.join(f'{v:.3f}' for v in lat)}); "
          f"|out| sum image 0 {float(np.abs(y0).sum()):.6e}; bitwise equal "
          f"to plain, fused=False, staged and CPU")
    for path, counts in paths.items():
        print(f"slice: {path} path launches {counts} "
              f"({'1 image' if path == 'staged' else f'{N_IMAGES} images'})")
    details["latency_ms"] = lat
    details["launches"] = paths
    # each kernel's launches, read from the run of the path that uses it
    launches = {name: paths[path].get(name, 0)
                for name, path in KERNEL_PATH.items()}
    missing = [name for name, count in launches.items() if not count]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing} ({paths})")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the card, build time, ptxas report, "
                         "per-layer timings, per-image latencies and "
                         "per-path launches as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"error: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.compiler import CudaExecutor, bind_synthetic, \
        compile_network

    details: dict = {}
    phase_card(torch, details)
    t0 = time.time()
    prog = compile_network("resnet18")
    print(f"compile: resnet18 224 -O 0, {len(prog.layers)} layers, "
          f"fingerprint {prog.fingerprint()[:12]}, {time.time() - t0:.2f} s")
    ex = CudaExecutor(prog)
    for lp in prog.layers:
        bind_synthetic(ex, lp, seed=lp.index)
    tot = phase_kernels(torch, prog, ex, details)
    counts = phase_slice(torch, prog, ex, details)
    kernels = []
    for name, replaces in REPLACES.items():
        t = tot[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bytes"] >= t["operations"]
            else "operations",
            "library_ms": t["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(details, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
