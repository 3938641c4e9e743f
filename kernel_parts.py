#!/usr/bin/env python3
"""Where a fused split-GEMM launch spends its device time, on one NVIDIA
card.

    python3 kernel_parts.py [--out PATH]

Builds variants of ``src/repro_torch/kernels/csrc/fused_split_gemm.cu``
into ``build/kernel_parts/``, each with parts of the K loop taken out,
and times ``fused_hetero_gemm`` of each at resnet18's distinct layer
shapes under ``fused_hetero_gemm.split_plan``'s tile and K split:

    full         the kernel as it is
    no_mma       without the tensor-core passes
    no_transpose without the transpose of the raw B tiles
    copies_only  only the cp.async copies (no transpose, no mma)
    empty        no copies either: launch, pipeline skeleton, split-K
                 reduction and stores

Device time per launch is ``chip_smoke.device_times``': CUDA events
around 20 launches, enqueued in full behind a spin kernel. A part's cost
is the difference between two variants; the variants compute wrong
numbers, only their times mean anything. Exits non-zero without CUDA or when the source no longer has
the statements a variant takes out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src/repro_torch/kernels/csrc/fused_split_gemm.cu"
OUT_DIR = ROOT / "build" / "kernel_parts"

_NO_MMA = ("    if (!mma_warp) continue;\n", "    continue;\n")
_NO_TRANSPOSE = ("    t.transpose_stage(st % NST);\n", "")
_NO_COPIES = [
    ("    if (lut)\n      load_raw<BN>(", "    if (false)\n      load_raw<BN>("),
    ("    else\n      load_raw<BN / 2>(",
     "    else if (false)\n      load_raw<BN / 2>("),
    ("    if (p.a_vec == 16)\n      load_a_vec<16>(as, k0);",
     "    if (true) {}")]
#: variant -> (statement, replacement) edits of the source
VARIANTS = {
    "full": [],
    "no_mma": [_NO_MMA],
    "no_transpose": [_NO_TRANSPOSE],
    "copies_only": [_NO_MMA, _NO_TRANSPOSE],
    "empty": [_NO_MMA, _NO_TRANSPOSE, *_NO_COPIES],
}
#: resnet18's distinct fused-GEMM shapes (M, K, n_lut, n_dsp), bits 4
SHAPES = {
    "conv1": (12544, 147, 48, 16), "conv2": (3136, 576, 48, 16),
    "conv7": (784, 1152, 96, 32), "conv8_ds": (784, 64, 64, 64),
    "conv12": (196, 2304, 192, 64), "conv17": (49, 4608, 432, 80),
    "conv18_ds": (49, 256, 416, 96), "fc": (1, 512, 680, 320),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """One nvcc per variant, all started together."""
    from repro_torch.kernels import build
    text = SOURCE.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"error: variant {name}: {old!r} is not "
                                 f"in {SOURCE.name} exactly once")
            src = src.replace(old, new)
        (OUT_DIR / f"{name}.cu").write_text(src)
        lib = OUT_DIR / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(OUT_DIR / f"{name}.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"error: nvcc failed on variant {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].fused_hetero_gemm
        fn.argtypes = build.SOURCES["fused_split_gemm"]["fused_hetero_gemm"]
        fn.restype = ctypes.c_int
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the times as "
                    "JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import device_times, nvidia_smi
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hetero_gemm import split_plan

    print(f"card: {nvidia_smi()}")
    libs = build_variants()
    gen = torch.Generator().manual_seed(0)
    rows = []
    for layer, (m, k, n_lut, n_dsp) in SHAPES.items():
        plan = split_plan(m, k, n_lut, n_dsp)
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        sw = ops.prepare_split(
            k, torch.randint(-8, 8, (k, n_lut), generator=gen),
            torch.ones(n_lut), 4,
            torch.randint(-8, 8, (k, n_dsp), generator=gen),
            torch.ones(n_dsp), torch.device("cuda"))
        out = torch.empty((m, n_lut + n_dsp), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            rc = lib.fused_hetero_gemm(
                x.data_ptr(), m, k, sw.planes.data_ptr(), 4, n_lut,
                sw.packed.data_ptr(), n_dsp, sw.scale.data_ptr(),
                out.data_ptr(), plan.bm, plan.bn, plan.split, stream)
            if rc:
                raise RuntimeError(f"launch failed with error {rc}")
        us = {name: 1e3 * t for name, t in device_times(
            torch, {name: (lambda lib=lib: call(lib), 20)
                    for name, lib in libs.items()}).items()}
        rows.append({"layer": layer, "m": m, "k": k, "n_lut": n_lut,
                     "n_dsp": n_dsp, "plan": list(plan), "us": us})
        print(f"{layer}: M={m} K={k} {n_lut}/{n_dsp} BM={plan.bm} "
              f"BN={plan.bn} S={plan.split}: " + "; ".join(
                  f"{name} {t:.2f} us" for name, t in us.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
