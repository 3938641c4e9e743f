#!/usr/bin/env python3
"""Where a kernel launch spends its device time, on one NVIDIA card.

    python3 kernel_parts.py [--out PATH] [--only {split,flash,bwd}]

Builds variants of the kernel sources into ``build/kernel_parts/``, each
with parts of the main loop taken out, and times them: the split-GEMM
kernels at resnet18's distinct layer shapes, each launch under
``fused_hetero_gemm.split_plan``'s tile and K split, and the flash kernel
at the serving prefill, S=2048, decode, decode4 and the three D=256
shapes (:data:`FLASH_SHAPES`), each under ``flash_attention.flash_plan``,
and the flash backward's two entry points (:data:`BWD_SHAPES`). Each
variant's ptxas report (registers, spills) is printed as it is
built.

``src/repro_torch/kernels/csrc/fused_split_gemm.cu``, its
``fused_hetero_gemm`` on both sides of the split (:data:`VARIANTS`):

    full         the kernel as it is
    no_mma       without the tensor-core passes
    no_transpose without the transpose of the raw B tiles
    copies_only  only the cp.async copies (no transpose, no mma)
    empty        no copies either: launch, pipeline skeleton, split-K
                 reduction and stores

``src/repro_torch/kernels/csrc/split_gemm.cu``, its ``bitserial_gemm`` on
the LUT side and ``int4_gemm`` on the DSP side, each under the plan of
its one-sided shape (:data:`SPLIT_VARIANTS`):

    full         the kernel as it is
    no_mma       each mma replaced by one integer add of its operands, so
                 the fragments are still built
    no_unpack    the weight words passed to the mma as they are: no
                 spreading of bits or nibbles to bytes
    copies_only  only the cp.async copies (no fragments, no mma)
    empty        no copies either

``src/repro_torch/kernels/csrc/flash_attention.cu``, its
``flash_attention`` (:data:`FLASH_VARIANTS`):

    full         the kernel as it is
    no_mma       each mma replaced by one add of its operands (a LOP3
                 and an FADD on the FP32 pipe, as split_gemm's no_mma),
                 so the ldmatrix fragments, the softmax and the P
                 packing stay
    copies_only  only the cp.async copies of Q, K and V and the epilogue
                 (no fragments, no mma, no softmax)
    empty        no copies either: launch, the KV loop's barriers and the
                 epilogue
    one_pass     DV=256 in one pass over the KV tiles, acc for all 256
                 output columns in registers (the kernel takes two passes
                 of 128 columns, which spill nothing)

and, at a shape ``flash_plan`` gives the decode form, ``prefill_form``:
the full kernel launched in the prefill form instead (one 64-row block
per query head), which computes the same output, to weigh the decode
form against it.

``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, each entry point
alone and the two back to back (``pair``, as a train step runs them) at
seamless's encoder shape, llama's S=2048, qwen2-vl's D=128, the D=128
GQA shape whose tiles cross the diagonal and the wide pairs' training
shapes, MLA's (192, 128) and gemma's (256, 256) (:data:`BWD_SHAPES`), as
variants (:data:`BWD_VARIANTS`; each edits the wide instance too):

    full          the kernel as it is
    no_mma        the tensor-core products taken out (the wgmma
                  instructions commented out, their accumulators left
                  as they are), so the tile loop, the softmax and the
                  masks stay
    copies_only   only the streamed tiles' copies and the epilogue (the
                  consumers release each stage as it lands)
    empty         no copies either: launch, the pipeline's barriers and
                  the epilogue
    no_pdl        dkdv launched as an ordinary launch, not as a
                  programmatic dependent of dq (timed as the pair)
    no_stagger    the wide dkdv's WG-K issues dp as soon as its tile
                  lands, beside WG-V's s, instead of once s is done (at
                  the wide shapes only)

With ``--parent-bwd PATH`` (an earlier ``flash_attention_bwd.cu`` with
the same entry points, e.g. ``git show
a4c59dd:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, the
wide pairs on ``mma.sync``) it prints, for each kernel both sources
have, whether the two compile to the same SASS (``cuobjdump``), and
times that source's pair
beside this one's at the same shapes, in turns (``turns/parent_1``,
``this_1``, ``this_2``, ``parent_2``), so that a change to the source is
weighed on one card in one call.

Device time per launch is ``chip_smoke.device_times``': CUDA events
around 20 launches, enqueued in full behind a spin kernel. A part's cost
is the difference between two variants; the variants compute wrong
numbers, only their times mean anything. Exits non-zero without CUDA or
when a source no longer has the statements a variant takes out.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
OUT_DIR = ROOT / "build" / "kernel_parts"

_NO_MMA = ("    if (!mma_warp) continue;\n", "    continue;\n")
_NO_TRANSPOSE = ("    t.transpose_stage(st % NST);\n", "")
_NO_COPIES = [
    ("    if (lut)\n      load_raw<BN>(", "    if (false)\n      load_raw<BN>("),
    ("    else\n      load_raw<BN / 2>(",
     "    else if (false)\n      load_raw<BN / 2>("),
    ("    if (p.a_vec == 16)\n      load_a_vec<16>(as, k0);",
     "    if (true) {}")]
#: fused_split_gemm.cu: variant -> (statement, replacement) edits
VARIANTS = {
    "full": [],
    "no_mma": [_NO_MMA],
    "no_transpose": [_NO_TRANSPOSE],
    "copies_only": [_NO_MMA, _NO_TRANSPOSE],
    "empty": [_NO_MMA, _NO_TRANSPOSE, *_NO_COPIES],
}
_SPLIT_NO_MMA = (
    "for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[kk][i], bf[kk][j][0], "
    "bf[kk][j][1]);",
    "for (int j = 0; j < NI; ++j) acc[i][j][0] += (int)(a[kk][i][0] ^ "
    "bf[kk][j][0] ^ bf[kk][j][1]);")
_SPLIT_NO_UNPACK = [
    ("  b0 = (((w >> (4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * sc;\n"
     "  b1 = (((w >> (16 + 4 * q)) & 0xFu) * 0x00204081u & 0x01010101u) * "
     "sc;\n", "  b0 = w;\n  b1 = w ^ sc;\n"),
    ("  b0 = spread_int4(row[q >> 1] >> sh);\n"
     "  b1 = spread_int4(row[2 + (q >> 1)] >> sh);\n",
     "  b0 = row[q >> 1] >> sh;\n  b1 = row[2 + (q >> 1)];\n")]
_SPLIT_NO_COPIES = [
    ("    if (p.a_vec == 16)\n      load_a_vec<16>(as, k0);",
     "    if (true) {}"),
    ("    load_words(Bs + buf * bstage, step);\n", "")]
#: split_gemm.cu: variant -> (statement, replacement) edits
SPLIT_VARIANTS = {
    "full": [],
    "no_mma": [_SPLIT_NO_MMA],
    "no_unpack": _SPLIT_NO_UNPACK,
    "copies_only": [_NO_MMA],
    "empty": [_NO_MMA, *_SPLIT_NO_COPIES],
}
_FLASH_NO_MMA = (
    """  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
""",
    """  c[0] += __uint_as_float(a[0] ^ b0 ^ b1);
""")
_FLASH_NO_COMPUTE = ("      if (skip) continue;\n", "      continue;\n")
_FLASH_NO_COPIES = [
    ("      issue_q();\n", ""),
    ("    load_tile<DQK, BKV>(ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0, "
     "tid);\n"
     "    load_tile<DV, BKV>(ks + KTILE, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0, "
     "tid);\n", "")]
#: flash_attention.cu: variant -> (statement, replacement) edits
FLASH_VARIANTS = {
    "full": [],
    "no_mma": [_FLASH_NO_MMA],
    "copies_only": [_FLASH_NO_COMPUTE],
    "empty": [_FLASH_NO_COMPUTE, *_FLASH_NO_COPIES],
    "one_pass": [("  constexpr int NPASS = DV >= 256 ? 2 : 1;\n",
                  "  constexpr int NPASS = 1;\n")],
}
#: (statement, replacement, occurrences): the wgmma helpers, one per shape
#: and operand form
_BWD_NO_MMA = ('"wgmma.mma_async', '"// wgmma.mma_async', 4)
_BWD_NO_COMPUTE = [("dkdv_tile<D>(", "if (false) dkdv_tile<D>("),
                   ("dq_tile<D>(", "if (false) dq_tile<D>("),
                   ("dq_wide_tile<D, DV>(", "if (false) dq_wide_tile<D, DV>("),
                   ("dv_tile<D, DV>(", "if (false) dv_tile<D, DV>("),
                   ("dk_tile<D, DV>(", "if (false) dk_tile<D, DV>(")]
_BWD_NO_COPIES = [
    ('"cp.async.bulk.tensor', '"// cp.async.bulk.tensor'),
    ('"mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;',
     '"mbarrier.arrive.shared::cta.b64 _, [%0];')]
#: flash_attention_bwd.cu (dq and dkdv on wgmma and TMA): variant ->
#: edits
BWD_VARIANTS = {
    "full": [],
    "no_mma": [_BWD_NO_MMA],
    "copies_only": _BWD_NO_COMPUTE,
    "empty": [*_BWD_NO_COMPUTE, *_BWD_NO_COPIES],
    "no_pdl": [("m, a, true);", "m, a, false);", 4)],
    "no_stagger": [("  bar_arrive(BAR_S_DONE, 2 * WG);\n", ""),
                   ("  bar_sync(BAR_S_DONE, 2 * WG);\n", "")],
}
#: variants that differ from "full" only at the wide pairs, timed there
WIDE_VARIANTS = ("no_stagger",)
#: chip_smoke.BWD_SHAPES rows timed here: seamless's encoder (the
#: training path's), llama's GQA at S 2048, qwen2-vl's D=128, the D=128
#: GQA shape whose tiles cross the diagonal, and the wide pairs' training
#: shapes (deepseek-v2's MLA, gemma-7b's D 256)
BWD_SHAPES = ("seamless_enc", "llama_s2048", "qwen2vl_d128", "gqa_d128",
              "mla_train", "d256_train")
#: chip_smoke.FLASH_SHAPES rows timed here: the serving prefill, S=2048,
#: the two decode-form shapes, the three at D=256 and deepseek-v2's MLA
#: prefill (keys 192 wide, values 128)
FLASH_SHAPES = ("prefill", "s2048", "decode", "decode4", "d256_prefill",
                "d256_ragged", "d256_decode4", "mla_prefill")
#: resnet18's distinct split-GEMM shapes (M, K, n_lut, n_dsp), bits 4
SHAPES = {
    "conv1": (12544, 147, 48, 16), "conv2": (3136, 576, 48, 16),
    "conv7": (784, 1152, 96, 32), "conv8_ds": (784, 64, 64, 64),
    "conv12": (196, 2304, 192, 64), "conv17": (49, 4608, 432, 80),
    "conv18_ds": (49, 256, 416, 96), "fc": (1, 512, 680, 320),
}


def build_variants(source: str, variants: dict) -> dict[str, ctypes.CDLL]:
    """One nvcc per variant of ``csrc/<source>.cu``, all started
    together; each library's entry points bound as ``build.SOURCES``
    says. An edit is (statement, replacement), the statement found
    exactly once, or (statement, replacement, n), found exactly n
    times."""
    from repro_torch.kernels import build
    path = CSRC / f"{source}.cu"
    text = path.read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        src = text
        for old, new, *n in edits:
            if src.count(old) != (n[0] if n else 1):
                raise SystemExit(f"error: variant {name}: {old!r} is not "
                                 f"in {path.name} {n[0] if n else 1} "
                                 f"time(s)")
            src = src.replace(old, new)
        stem = OUT_DIR / f"{source}-{name}"
        stem.with_suffix(".cu").write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))]
        procs[name] = (stem.with_suffix(".so"),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"error: nvcc failed on {source} variant "
                             f"{name}:\n{err}")
        usage = [ln.split(":", 1)[-1].strip()
                 for ln in (out + err).splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"build: {source} {name}: ptxas: {'; '.join(usage)}")
        libs[name] = ctypes.CDLL(str(lib))
        for entry, argtypes in build.SOURCES[source].items():
            fn = getattr(libs[name], entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the times as "
                    "JSON here")
    ap.add_argument("--only", choices=("split", "flash", "bwd"),
                    default=None, help="time one kernel family only")
    ap.add_argument("--parent-bwd", default=None, metavar="PATH",
                    help="also time the flash_attention_bwd.cu at PATH (an "
                         "earlier version with the same entry points) beside "
                         "this one's, in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import device_times, nvidia_smi

    print(f"card: {nvidia_smi()}")
    rows = []
    for family, fn in (("split", time_split), ("flash", time_flash),
                       ("bwd", time_bwd)):
        if args.only in (None, family):
            rows += fn(torch, device_times, *(
                [args.parent_bwd] if family == "bwd" else []))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


def time_flash(torch, device_times) -> list[dict]:
    """The flash variants at :data:`FLASH_SHAPES`, each under its plan,
    and the full kernel in the prefill form where the plan is the decode
    form."""
    from chip_smoke import FLASH_SHAPES as SMOKE_SHAPES
    from repro_torch.kernels.flash_attention import flash_plan, kernel_args
    libs = build_variants("flash_attention", FLASH_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for shape in SMOKE_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        if name not in FLASH_SHAPES:
            continue
        dv = shape.v_dim
        q, k, v = (torch.randn((b, s, h, e), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for s, h, e in ((sq, hq, d), (skv, hkv, d),
                                   (skv, hkv, dv)))
        out = torch.empty((b, sq, hq, dv), device="cuda",
                          dtype=torch.bfloat16)
        plan = flash_plan(b, sq, skv, hq, hkv, d, dv)
        cargs = {form: kernel_args(q, k, v, out, d ** -0.5, causal, off,
                                   plan._replace(form=form))
                 for form in {plan.form, "prefill"}}
        stream = torch.cuda.current_stream().cuda_stream

        def run(lib, form=plan.form):
            rc = lib.flash_attention(*cargs[form], stream)
            if rc:
                raise RuntimeError(f"launch failed with error {rc}")
        fns = {vname: (lambda lib=lib: run(lib), 20)
               for vname, lib in libs.items()}
        if plan.form == "decode":
            fns["prefill_form"] = (lambda: run(libs["full"], "prefill"), 20)
        us = {vname: 1e3 * t
              for vname, t in device_times(torch, fns).items()}
        rows.append({"kernel": "flash_attention", "shape": name, "b": b,
                     "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d,
                     "dv": dv, "form": plan.form, "grid": list(plan.grid),
                     "us": us})
        print(f"flash_attention {name}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} DV={dv} {plan.form} grid {plan.grid}: "
              + "; ".join(
                  f"{vname} {t:.2f} us" for vname, t in us.items()))
    return rows


def build_parent(path: str) -> ctypes.CDLL:
    """``path``, an earlier flash_attention_bwd.cu with this one's entry
    points (the value head size after D), built as the variants are."""
    from repro_torch.kernels import build
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / "flash_attention_bwd-parent.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), path], capture_output=True,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"error: nvcc failed on {path}:\n{proc.stderr}")
    usage = [ln.split(":", 1)[-1].strip()
             for ln in (proc.stdout + proc.stderr).splitlines()
             if "Used" in ln or "spill" in ln]
    print(f"build: flash_attention_bwd parent: ptxas: {'; '.join(usage)}")
    lib = ctypes.CDLL(str(lib_path))
    for entry, argtypes in build.SOURCES["flash_attention_bwd"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def sass_of(lib: Path) -> dict[str, str]:
    """Each kernel's SASS in ``lib`` (``cuobjdump -sass``, beside nvcc), by
    its name less the source's anonymous namespace, with the instruction
    addresses' comments taken out."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_\w{8}", "", name.strip())
        out[name] = re.sub(r"/\*[0-9a-f]{4,}\*/", "", body)
    return out


def same_sass(this: Path, parent: Path) -> None:
    """Print, for each kernel of the parent's library that this one also
    has, whether the two compiled to the same SASS."""
    mine, theirs = sass_of(this), sass_of(parent)
    for name in sorted(set(mine) & set(theirs)):
        print(f"sass {name[:48]}: "
              + ("the parent's" if mine[name] == theirs[name]
                 else "differs from the parent's"))


def time_bwd(torch, device_times, parent: str | None = None) -> list[dict]:
    """The backward's variants at :data:`BWD_SHAPES`, each entry point
    timed alone and the two as a pair; with ``parent``, that source's
    pair beside this one's, in turns (parent, this, this, parent)."""
    from chip_smoke import BWD_SHAPES as SMOKE_SHAPES
    from repro_torch.kernels import flash_attention_bwd as fab
    libs = build_variants("flash_attention_bwd", BWD_VARIANTS)
    old = build_parent(parent) if parent else None
    if old is not None:
        same_sass(OUT_DIR / "flash_attention_bwd-full.so",
                  OUT_DIR / "flash_attention_bwd-parent.so")
    gen = torch.Generator(device="cuda").manual_seed(12)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for shape in SMOKE_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        if name not in BWD_SHAPES:
            continue
        dv = shape.v_dim
        q, k, v, out, dout = (
            torch.randn(sh, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
            for sh in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                       (b, sq, hq, dv), (b, sq, hq, dv)))
        # the row statistics of a softmax over ~Skv keys of unit scores
        lse = torch.full((b, hq, sq), math.log(skv), device="cuda")
        delta = torch.empty((b, hq, sq), device="cuda")
        grads = [torch.empty_like(t) for t in (q, k, v)]
        args = fab.entry_args(q, k, v, out, dout, lse, delta, *grads,
                              d ** -0.5, causal, off)

        def run(lib, entry):
            rc = getattr(lib, entry)(*args[entry], stream)
            if rc:
                raise RuntimeError(f"{entry} failed with error {rc}")

        def pair(lib):
            for entry in fab.ENTRY_POINTS:
                run(lib, entry)
        fns = {}
        wide = d > 128
        for vname, lib in libs.items():
            if vname in WIDE_VARIANTS and not wide:
                continue  # the same kernels as "full" at (64, 64), (128, 128)
            if vname != "no_pdl":
                for entry in fab.ENTRY_POINTS:
                    short = entry.replace("flash_attention_bwd_", "")
                    fns[f"{vname}/{short}"] = (
                        lambda lib=lib, entry=entry: run(lib, entry), 20)
            if vname in ("full", "no_pdl", *WIDE_VARIANTS):
                fns[f"{vname}/pair"] = (lambda lib=lib: pair(lib), 20)
        if old is not None:
            def old_pair():
                for entry in fab.ENTRY_POINTS:
                    rc = getattr(old, entry)(*args[entry], stream)
                    if rc:
                        raise RuntimeError(f"parent {entry} failed with "
                                           f"error {rc}")
            for key, fn in (
                    ("turns/parent_1", old_pair),
                    ("turns/this_1", lambda: pair(libs["full"])),
                    ("turns/this_2", lambda: pair(libs["full"])),
                    ("turns/parent_2", old_pair)):
                fns[key] = (fn, 20)
        # dkdv alone reads the delta dq writes
        run(libs["full"], "flash_attention_bwd_dq")
        us = {key: 1e3 * t for key, t in device_times(torch, fns).items()}
        rows.append({"kernel": "flash_attention_bwd", "shape": name, "b": b,
                     "sq": sq, "skv": skv, "hq": hq, "hkv": hkv, "d": d,
                     "dv": dv, "causal": causal, "kv_offset": off, "us": us})
        print(f"flash_attention_bwd {name}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} DV={dv} causal={causal}: " + "; ".join(
                  f"{key} {t:.2f} us" for key, t in us.items()))
        del q, k, v, out, dout, lse, delta, grads
    return rows


def time_split(torch, device_times) -> list[dict]:
    """The split-GEMM variants at resnet18's :data:`SHAPES`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hetero_gemm import split_plan
    fused_libs = build_variants("fused_split_gemm", VARIANTS)
    split_libs = build_variants("split_gemm", SPLIT_VARIANTS)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for layer, (m, k, n_lut, n_dsp) in SHAPES.items():
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        sw = ops.prepare_split(
            k, torch.randint(-8, 8, (k, n_lut), generator=gen),
            torch.ones(n_lut), 4,
            torch.randint(-8, 8, (k, n_dsp), generator=gen),
            torch.ones(n_dsp), torch.device("cuda"))
        out = torch.empty((m, n_lut + n_dsp), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        # (kernel, its plan, the call of one variant's library)
        calls = {
            "fused_hetero_gemm": (
                split_plan(m, k, n_lut, n_dsp),
                lambda lib, pl: lib.fused_hetero_gemm(
                    x.data_ptr(), m, k, sw.planes.data_ptr(), 4, n_lut,
                    sw.packed.data_ptr(), n_dsp, sw.scale.data_ptr(),
                    out.data_ptr(), pl.bm, pl.bn, pl.split, stream)),
            "bitserial_gemm": (
                split_plan(m, k, n_lut, 0),
                lambda lib, pl: lib.bitserial_gemm(
                    x.data_ptr(), m, k, sw.lut_words.data_ptr(), 4, n_lut,
                    sw.s_lut.data_ptr(), out.data_ptr(), pl.bm, pl.bn,
                    pl.split, stream)),
            "int4_gemm": (
                split_plan(m, k, 0, n_dsp),
                lambda lib, pl: lib.int4_gemm(
                    x.data_ptr(), m, k, sw.dsp_words.data_ptr(), n_dsp,
                    sw.s_dsp.data_ptr(), out.data_ptr(), pl.bm, pl.bn,
                    pl.split, stream)),
        }
        for kernel, (plan, call) in calls.items():
            libs = fused_libs if kernel == "fused_hetero_gemm" else \
                split_libs

            def run(lib, call=call, plan=plan):
                rc = call(lib, plan)
                if rc:
                    raise RuntimeError(f"launch failed with error {rc}")
            us = {name: 1e3 * t for name, t in device_times(
                torch, {name: (lambda lib=lib: run(lib), 20)
                        for name, lib in libs.items()}).items()}
            rows.append({"kernel": kernel, "layer": layer, "m": m, "k": k,
                         "n_lut": n_lut, "n_dsp": n_dsp, "plan": list(plan),
                         "us": us})
            print(f"{kernel} {layer}: M={m} K={k} {n_lut}/{n_dsp} "
                  f"BM={plan.bm} BN={plan.bn} S={plan.split} blocks="
                  f"{plan.blocks}: " + "; ".join(
                      f"{name} {t:.2f} us" for name, t in us.items()))
    return rows


if __name__ == "__main__":
    sys.exit(main())
