#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing its lines before the last:

1. card: ``nvidia-smi`` name and power limit; build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (``fused_split_gemm.cu``,
   ``split_gemm.cu``, ``depthwise_gemm.cu`` and ``flash_attention.cu``,
   one nvcc each, started together), time the build and print ptxas's
   register, shared-memory and spill report.
2. kernels: every split-GEMM kernel against its plain PyTorch version,
   on the card, at each of full-width resnet18's 21 layer shapes (the
   shapes the main path gives it), plus bit widths 2/4/8 and one-sided
   splits, with each launch's tile and K split
   (``fused_hetero_gemm.split_plan``; the single-path kernels on their
   one-sided shape) printed per layer and kernel. The fused kernels are
   also held at corners (M = 1, 13, 49; K not a multiple of S·BK; C = 3,
   24, 48, 64; the split boundary inside a tile; one-sided splits), and
   the single-path kernels on their K-major words at M = 1, 13, 49 and
   K = 31, 33, 147, 4608 (``bitserial_gemm`` at bits 1-8, ``int4_gemm``
   at odd column counts), each under the chooser's plan and under every
   compiled tile and cluster size into a NaN-filled output. Required:
   bitwise equality. Times: the kernel, the
   plain version and ``torch._int_mm`` on the reconstructed int8
   weights (the library yardstick), each as device time per call
   (:func:`device_times`: CUDA events around calls that a spin kernel
   let the host enqueue in full; the kernels' row reports these) and as
   CUDA events over back-to-back calls (``events_*``), which at a few µs
   a call measure the host's launch rate; and the
   bound (bytes at the weights' code width over 3.35 TB/s vs 2·m·k·n
   int8 operations over 1,979 TOP/s).
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
   to the staged path, and to the CPU run of the same image. Times, for
   the fused path and for ``fused=False``: per-image latency (host
   clock, median of the four) and the device's busy share of it (device
   time of one image from a profiler trace, :func:`busy_ms`).
4. mobilenet_v2: compile it (224, width 1.0, -O 0), bind synthetic
   weights, and hold the depthwise kernel (``depthwise_conv_gemm`` on
   the spatial block, ``grouped_gemm`` on the staged stack, each side
   alone) bitwise to its plain version at the 17 depthwise layers and at
   :data:`DW_CORNERS`; hold the split-GEMM kernels bitwise at the 21
   distinct dense shapes (spatial, staged and single-path forms). Then
   every path as in phase 3, with ``depthwise_conv_gemm`` once per
   depthwise layer on the fused path, ``grouped_gemm`` once per
   non-empty side on ``fused=False`` and once per layer staged, and the
   logits bitwise equal across the fused, ``fused=False``, staged,
   ``mode="ref"`` and CPU runs. Times per image, device time
   (:func:`device_times`): the depthwise kernel's spatial and staged
   forms, its plain version and ``F.conv2d(groups=C)`` in fp32 with TF32
   off times the scale (the library yardstick, exact here: every sum is
   below 2^24), beside the bytes bound; ``fused_conv_gemm`` over the 36
   dense layers beside its plain version, ``_int_mm`` and the bound.
5. flash: the flash-attention kernel against its plain version in bf16
   at eight shapes: the serving prefill (B=8, S=64, 32 query heads over
   8 KV heads, D=64, causal), S=2048 causal, S=1000 causal (ragged),
   S=333 non-causal, 64 queries at offset 960 of 1024 keys, one query at
   offset 1023 (decode), S=512 causal at D=128 with 16 query and 16 KV
   heads, and 4 queries at offset 997 of 1001 keys (the decode form's
   16-row edge), each with the plan it ran under
   (``flash_attention.flash_plan``: form and grid). Required: max |err|
   within :func:`flash_tol`, and every output row within
   :data:`FLASH_ROW_TOL` of its plain row's norm (:func:`flash_row_err`).
   Times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` on the KV heads repeated (the
   library yardstick): device time per call (:func:`device_times`; the
   kernels' row reports these), and CUDA
   events over back-to-back calls, which at small shapes measure the
   host's launch rate. The bound: q, k, v and out once over 3.35 TB/s
   vs 4·B·Hq·D·(unmasked pairs) over 989 TFLOP/s bf16.
6. serve: full-width llama3.2-1b (16 layers, bf16, weights from
   ``torch.Generator`` seed 0 on the card) through the port's launcher
   ``repro_torch.launch.serve.main`` (batch 8, prompt 64, 32 new
   tokens), then through ``repro_torch.serve.engine``'s prefill and
   decode with each in a launch window of its own. Required: exactly
   16 ``flash_attention`` launches per prefill (the launcher's run
   included) and none in decode or with ``mode="ref"``; finite
   [8, 64, 128256] logits; prefill logits within :data:`LOGIT_TOL` of
   the ``mode="ref"`` run; the first generated token equal to the
   ``mode="ref"`` run's in every row whose top-2 logit gap exceeds the
   tolerance. Times: prefill (median of 7 after a warm-up), decode per
   step over 31 steps, tokens/s, and the device's busy share of each
   (device time from a profiler trace over the host-clock time, or "not
   measured" where the profiler records no device time).

7. decode: decode sessions (``compiler/runtime/session.py``) on the
   card. Full-width llama3.2-1b (113 layers) and mamba2-780m (193
   layers), and jamba-v0.1-52b at its smoke config (at 52 B parameters
   its full width does not fit one card), each compiled as
   ``compile_decode_network`` does (batch 8, max_seq 64, ``-O 0``,
   bits 4) but at the full config, with ``synthetic_decode_arrays``
   (seed 0) bound into a ``ReferenceSession``, a fused ``CudaExecutor``
   session and a ``fused=False`` one (the host arrays dropped once
   bound; peak device memory printed). Each decodes
   :data:`DECODE_STEPS` greedy steps (1 warm-up + the rest steady)
   with its launches counted in a window of its own. Required: every
   step's logits bitwise equal to the reference session's; exactly the
   program's launches per step (``fused_hetero_gemm`` per two-sided
   layer, the side's single-path kernel per one-sided layer;
   ``bitserial_gemm`` / ``int4_gemm`` per side on ``fused=False``);
   a staggered ``step_slots`` run (slots admitted at steps 0-2 by
   ``reset_slot``) bitwise equal to a per-slot reference session.
   Then each decode-path kernel is held bitwise to its plain version at
   every distinct full-width layer shape (M = 8) and timed: device ms
   per step of the kernel, its plain version and ``torch._int_mm`` with
   M padded to 32, beside the code-width bound and, for
   ``fused_hetero_gemm``, the bytes of the int8 planes it reads. Times:
   host ms per warm-up and per steady step (median), device ms per
   steady step (profiler) and its busy share; rows with non-zero logits
   per step (the synthetic models' glue sends rows to 0). Last, golden
   sessions at the three smoke configs (batch 1, max_seq 8, ``-O 1``, 4
   steps): bitwise equal to the reference session, no kernel launched,
   weight fetches in the warm-up program and none in the steady one.
8. golden: one full-width resnet18 image through ``GoldenExecutor`` on
   the card (the ISA contract checked instruction by instruction, every
   tile through the exact plain oracles: no kernel may launch), bitwise
   equal to ``CudaExecutor``'s fused path and ``mode="ref"``; then one
   full-width mobilenet_v2 image the same way; then a weight fetch
   planted at another layer's segment must raise ``ExecutionError``.
   Times: seconds per image.
9. accuracy: a convolution inside ``models.cnn.fp32_convs`` against
   float64 (required within 1e-5 of max |out|, which TF32 is not); then
   ``repro_torch.eval.accuracy.measure`` (train the fp32
   reference on the card with TF32 off, freeze and fold its norms,
   compile at ``-O 1`` with 8-bit all-LUT first and last layers, bind,
   and evaluate top-1 agreement one image at a time) at
   :data:`HARNESS` on both reduced nets, required at or above
   ``AGREEMENT_FLOOR``, and on full-width resnet18 (224, 1000 classes),
   recorded; each run's launches counted in a window of their own and
   required to be exactly the fused path's per evaluated image. Then
   the cross checks, each on networks trained, folded, compiled and
   bound here through the harness's public functions: on each reduced
   net two more trainings (whether they fold to the same weights is
   printed, not required), the first bound into a golden and a fused
   executor on the card and one on the CPU: equal agreement counts over
   :data:`CROSS_SAMPLES` and bitwise-equal logits on the first batch of
   :data:`CROSS_BATCH`; on full-width resnet18 one more training, whose
   folded weights give bitwise-equal logits on the card and the CPU for
   :data:`FULL_CPU_IMAGES` images. Times: training seconds, eval ms per
   image (host clock).
10. multi: multi-device bundles and compiled serving, every simulated
   device on the one card. :data:`CNN_BUNDLES` (full-width resnet18
   ``filter`` x 2 and x 3 and ``pipeline`` x 2, mobilenet_v2 ``filter``
   and ``pipeline`` x 2, ``-O 0``, the synthetic binding of phase 3)
   through ``MultiDeviceExecutor(backend="cuda")``, fused and
   ``fused=False``: every global layer and 4 images' logits bitwise
   equal to the single-device fused path of phases 3 and 4, launches
   exactly what the bundle's device programs launch; each shard's
   kernel bitwise to its plain version and timed beside the
   single-device layers'; ``python -m repro_torch.compiler resnet18
   --devices 2 --partition filter --execute`` prints the single-device
   checksum. Full-width llama3.2-1b decode bundles
   (:data:`DECODE_BUNDLES`, batch 8, max_seq 64): the single-device
   ``ReferenceSession``'s logits recorded for :data:`MULTI_STEPS` greedy
   steps and the session freed, then each bundle's ``ExecutorSession``
   (one at a time), every step bitwise equal, launches exactly the
   device programs' per step, each shard's kernel bitwise and timed.
   ``launch.serve`` with :data:`SERVE_ACCEL` exits 0 on the card and
   (``--smoke --device cpu``) on the CPU with the same image magics and
   lengths, and in-process exactly one flash launch per prefill layer
   plus the compiled session's kernels. A ``FleetServer`` with a
   subprocess and a thread ``cuda`` worker serves :data:`FLEET_REQUESTS`
   bitwise equal to a single-request session on the card, continuous
   faster than serial; ``BundleFleet`` on a 2-device ``filter`` and
   ``pipeline`` FC bundle bitwise equal to ``MultiDeviceExecutor``.
   Times: per-image latency, beside the single-device path timed in
   turns, and device busy share per CNN bundle; ms per steady decode
   step, device ms and busy share; compile and bind seconds and peak
   device memory; fleet requests/s and tokens/s; ``BundleFleet`` ms per
   run; each shard's kernel also beside its code-width bound and
   ``torch._int_mm`` on its reconstructed int8 weights (depthwise shards:
   ``F.conv2d(groups=C)``).
11. codesign: the co-design loop on the card. ``HeteroLinear``
   (:data:`HETERO`: the quickstart layer, and llama3.2-1b's MLP
   up-projection at ratio 0.5 and at the ratio ``solve_tpu_split(...,
   spatial=True)`` gives on ``H100_SXM``): ``deploy`` on the card, then
   ``apply_deploy`` launches exactly one ``bitserial_gemm`` and one
   ``int4_gemm`` and is bitwise equal to ``mode="ref"`` and to the CPU
   run of the same codes, and within :data:`QAT_DEPLOY_TOL` of
   ``apply_qat``; both kernels timed beside their plain versions,
   ``torch._int_mm`` on the codes and the code-width bound. A one-layer
   FC program of the MLP shape bound with ``bind_deployed``: one
   ``fused_hetero_gemm`` launch, bitwise equal to ``hetero_matmul``'s
   LUT-first output, timed the same way. The README's search
   (:data:`DSE_README`, agent on the card), its sim-gap check, and
   ``ProgramEvaluator.verify`` of the winner (golden vs ``CudaExecutor``
   on the card). The measured-accuracy search on reduced resnet18
   (``make_accuracy_fn(backend="cuda")``, ``reward_source ==
   "measured"``) with exactly ``fused_conv_gemm`` once per layer per
   evaluated image, ``verify`` of its winner; the winner's design point
   at full-width resnet18 through ``verify`` if golden would take at
   most :data:`GOLDEN_VERIFY_S` there, else its program layer by layer
   on the kernels against ``mode="ref"``. :data:`QAT_STEPS` QAT steps of
   reduced resnet18 on the card: the loss falls.

Each phase prints its seconds ("time: phase ..."). The line before the
last is the kernels' JSON summary; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero and prints no result. It exits non-zero at once when
CUDA is unavailable or the package is not beside it.
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15          # H100 SXM dense int8 tensor cores
BF16_FLOP_PER_S = 9.89e14          # H100 SXM dense bf16 tensor cores
#: the spin that holds the stream while timed calls are enqueued: ~10 ms
#: at the H100's 1.98 GHz boost clock (device_times lengthens it if short)
SPIN_CYCLES = 20_000_000
CSRC = "src/repro_torch/kernels/csrc"
SOURCE = {
    "fused_conv_gemm": f"{CSRC}/fused_split_gemm.cu",
    "fused_hetero_gemm": f"{CSRC}/fused_split_gemm.cu",
    "bitserial_gemm": f"{CSRC}/split_gemm.cu",
    "int4_gemm": f"{CSRC}/split_gemm.cu",
    "flash_attention": f"{CSRC}/flash_attention.cu",
    "depthwise_gemm": f"{CSRC}/depthwise_gemm.cu",
}
REPLACES = {
    "fused_conv_gemm": "src/repro/kernels/fused_hetero_gemm.py:232",
    "fused_hetero_gemm": "src/repro/kernels/fused_hetero_gemm.py:106",
    "bitserial_gemm": "src/repro/kernels/bitserial_gemm.py:62",
    "int4_gemm": "src/repro/kernels/int4_gemm.py:55",
    "flash_attention": "src/repro/kernels/flash_attention.py:78",
    "depthwise_gemm": "src/repro/kernels/ops.py:256 (int32 einsum, no "
                      "Pallas kernel)",
}
#: the executor path whose counted run each kernel's launches come from
KERNEL_PATH = {
    "fused_conv_gemm": "fused",
    "fused_hetero_gemm": "staged",
    "bitserial_gemm": "fused=False",
    "int4_gemm": "fused=False",
}
#: the same for full-width mobilenet_v2's kernels
MOBILENET_PATH = {
    "fused_conv_gemm": "fused",
    "depthwise_conv_gemm": "fused",
    "grouped_gemm": "staged",
}
N_IMAGES = 4
#: per network, the single-device fused path of phase 3 / 4: its bound
#: executor, image 0 and that image's logits, latency and device time,
#: which the multi-device phase holds its bundles against
SINGLE: dict = {}
#: depthwise kernel corners, (H=W, C, kernel, stride, pad, bits, n_lut):
#: odd C, all-DSP (n_lut 0) and all-LUT (n_lut C) layers, in_hw that
#: stride 2 does not divide (15, 9, 13, 57), one channel, a 5x5 window
#: (K = 25), bits 1, 2 and 8, full-width b0_dw's 112x112 map
DW_CORNERS = [(15, 33, 3, 2, 1, 3, 11), (7, 17, 3, 1, 1, 4, 0),
              (9, 40, 3, 2, 1, 8, 40), (13, 1, 3, 2, 1, 1, 1),
              (10, 24, 5, 2, 2, 5, 7), (57, 65, 3, 2, 1, 4, 0),
              (112, 32, 3, 1, 1, 2, 32)]
#: fused-kernel corners, (M, K, bits, n_lut, n_dsp) dense and (H=W, C,
#: kernel, stride, pad, bits, n_lut, n_dsp) conv: M = 1, 13 and 49, K
#: not a multiple of S·BK, the split boundary inside a tile, one-sided
#: splits, and C = 3 (scalar gather), 24 (8-byte copies), 48 and 64
#: (16-byte copies)
DENSE_CORNERS = [(1, 512, 4, 680, 320), (13, 72, 3, 2, 62),
                 (49, 4608, 4, 432, 80), (49, 1000, 8, 100, 0),
                 (49, 1000, 4, 0, 100)]
CONV_CORNERS = [(15, 3, 7, 2, 3, 4, 48, 16), (14, 48, 3, 2, 1, 5, 30, 50),
                (7, 64, 3, 1, 1, 4, 40, 24), (9, 64, 1, 2, 0, 4, 64, 0),
                (9, 24, 3, 1, 1, 4, 0, 33)]
#: single-path kernel corners (M, K): M = 1, 13 and 49; K = 31 and 33
#: (a word boundary, K not a multiple of 4), 147 (byte-gathered A, as
#: conv1) and 4608 (conv17, split eight ways); each at bits 1-8 on the
#: LUT side and an odd column count on the DSP side, (n_lut, n_dsp) in
#: turn from SINGLE_COLUMNS
SINGLE_CORNERS = [(m, k) for m in (1, 13, 49) for k in (31, 33, 147, 4608)]
SINGLE_COLUMNS = [(33, 23), (100, 77), (680, 5)]
#: (name, B, Sq, Skv, Hq, Hkv, D, causal, kv_offset); the first is the
#: serving prefill's shape, the one the kernel's row reports; d128_mha
#: runs the D=128 instantiation with one query head per KV head, decode4
#: the decode form at Sq * Hq / Hkv = 16 over a KV length that does not
#: split evenly over its 4 warps
FLASH_SHAPES = [
    ("prefill", 8, 64, 64, 32, 8, 64, True, 0),
    ("s2048", 1, 2048, 2048, 32, 8, 64, True, 0),
    ("ragged", 2, 1000, 1000, 32, 8, 64, True, 0),
    ("noncausal", 2, 333, 333, 32, 8, 64, False, 0),
    ("offset", 8, 64, 1024, 32, 8, 64, True, 960),
    ("decode", 8, 1, 1024, 32, 8, 64, True, 1023),
    ("d128_mha", 2, 512, 512, 16, 16, 128, True, 0),
    ("decode4", 8, 4, 1001, 32, 8, 64, True, 997),
]
#: the serving run: llama3.2-1b at batch 8, prompt 64, 32 new tokens
SERVE = dict(arch="llama3.2-1b", batch=8, prompt=64, new=32, seed=0)
#: prefill logits of the kernel run vs the mode="ref" run: within 8 bf16
#: steps (2^-8 relative each) of the largest |logit|. The two runs differ
#: only in attention's fp32 summation order, which flips an occasional
#: bf16 rounding; 16 layers of bf16 matmuls carry such flips to the
#: logits, which are themselves bf16 products (x @ embed.T) cast to fp32.
LOGIT_TOL = 8 * 2 ** -8


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


def device_times(torch, fns: dict, warmup: int = 2,
                 attempts: int = 4) -> dict:
    """Device time per call of each ``fn`` in ``fns`` (name -> (fn,
    iters)), without the host's cost of issuing the calls: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues the
    ``iters`` calls between two CUDA events, so the events time the calls
    back to back on the device (the device's own gaps between launches
    included). If the device reached the first event before the host had
    enqueued the last call (the spin was too short), the spin is made 4x
    longer and the calls timed again; raises after ``attempts``, which is
    also what a host sync inside ``fn`` does. Keep ``iters`` times the
    launches of one call to a few hundred, so that the host never waits
    for room in the launch queue."""
    for fn, _ in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {}
    for name, (fn, iters) in fns.items():
        cycles = SPIN_CYCLES
        for _ in range(attempts):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            covered = not start.query()
            torch.cuda.synchronize()
            if covered:
                times[name] = start.elapsed_time(end) / iters
                break
            cycles *= 4
        else:
            raise AssertionError(f"{name}: the host had not issued {iters} "
                                 f"calls when a spin of {cycles // 4} "
                                 f"cycles ended")
    return times


def busy_ms(torch, fn, iters: int, attempts: int = 2):
    """Device time per call of ``fn`` that may synchronise the host (an
    image, a prefill): the summed durations of the device activities in
    a ``torch.profiler`` trace of ``iters`` calls. The profiler here now
    and then returns traces without device activities, and then keeps
    doing so in that process; after ``attempts`` such traces this returns
    None, which the caller reports as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us:
            return us / 1e3 / iters
    return None


def busy_text(dev_ms, host_ms: float) -> str:
    """``dev_ms`` and its share of ``host_ms``, or "not measured"."""
    if dev_ms is None:
        return "not measured (the profiler recorded no device time)"
    return f"{dev_ms:.4f} ms (busy {100 * dev_ms / host_ms:.1f}%)"


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
    planes the fused kernels read hold each LUT weight in 8x its bits;
    the single-path kernels' K-major words hold it at its code width."""
    n = n_lut + n_dsp
    nbytes = (x_bytes + -(-(bits * n_lut + 4 * n_dsp) * k // 8) + 4 * n
              + 4 * m * n)
    ops = 2 * m * k * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def int_mm_fn(torch, x_col, codes, scale, min_m: int = 17):
    """``torch._int_mm`` on the reconstructed int8 weights, zero-padded
    to its constraints (M > 16, K and N multiples of 8; M to at least
    ``min_m``), then x scale."""
    m, k = x_col.shape
    n = codes.shape[1]
    mp, kp, np_ = max(m, min_m), -(-k // 8) * 8, -(-n // 8) * 8
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
    built = {src: build.is_built(src) for src in build.SOURCES}
    t0 = time.time()
    build.build_all()
    for src in build.SOURCES:
        build.load_library(src)
    details["build_s"] = time.time() - t0
    details["ptxas"] = {}
    for src in build.SOURCES:
        report = build.report_path(src).read_text()
        details["ptxas"][src] = report
        usage = [ln.split(":", 1)[-1].strip() for ln in report.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"build: {src}: {'cached library' if built[src] else 'nvcc'} "
              f"({build.library_path(src).name}); ptxas: "
              f"{'; '.join(usage)}")
    print(f"build: all sources built and loaded in "
          f"{details['build_s']:.2f} s")


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
        fused_conv_gemm_plain, fused_hetero_gemm, fused_hetero_gemm_plain, \
        split_plan
    from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain

    names = ("fused_conv_gemm", "fused_hetero_gemm", "bitserial_gemm",
             "int4_gemm")
    times = ("ms", "plain_ms", "library_ms", "events_ms", "events_plain_ms",
             "events_library_ms")
    tot = {n: {**dict.fromkeys(times, 0.0), "bound_ms": 0.0,
               "max_abs_err": 0.0, "bytes": 0.0, "operations": 0.0}
           for n in names}
    rows = details.setdefault("layers", [])
    for lp, (x_sp, x_col) in zip(prog.layers, layer_inputs(torch, prog)):
        g, sw = lp.geometry, ex._split[lp.index]
        wts = ex._weights[lp.index]
        m, k, bits = lp.dims.m, lp.dims.k, lp.bits_w_lut
        n_lut, n_dsp = sw.n_lut, sw.n_dsp
        codes = torch.cat([c for c in (wts.w_lut, wts.w_dsp)
                           if c is not None], dim=1)
        conv = (g.kernel, g.stride, g.pad, g.out_hw)
        plan = split_plan(m, k, n_lut, n_dsp)
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
                lambda: bitserial_gemm(x_col, sw.lut_words, sw.s_lut, bits,
                                       n_lut),
                lambda: bitserial_gemm_plain(x_col, sw.lut_words, sw.s_lut,
                                             bits, n_lut),
                int_mm_fn(torch, x_col, wts.w_lut, sw.s_lut),
                bound_ms(x_col.numel(), m, k, bits, n_lut, 0)),
            "int4_gemm": (
                lambda: int4_gemm(x_col, sw.dsp_words, sw.s_dsp, n_dsp),
                lambda: int4_gemm_plain(x_col, sw.dsp_words, sw.s_dsp,
                                        n_dsp),
                int_mm_fn(torch, x_col, wts.w_dsp, sw.s_dsp),
                bound_ms(x_col.numel(), m, k, 0, 0, n_dsp)),
        }
        plans = {"fused_conv_gemm": plan, "fused_hetero_gemm": plan,
                 "bitserial_gemm": split_plan(m, k, n_lut, 0),
                 "int4_gemm": split_plan(m, k, 0, n_dsp)}
        for name, (kern, plain, lib, (b_ms, b_by)) in cases.items():
            err = require_equal(torch, f"{name} {lp.name}", kern(), plain())
            row = {"kernel": name, "layer": lp.name, "m": m, "k": k,
                   "n_lut": n_lut if name != "int4_gemm" else 0,
                   "n_dsp": n_dsp if name != "bitserial_gemm" else 0,
                   **device_times(torch, {"ms": (kern, 10),
                                          "plain_ms": (plain, 3),
                                          "library_ms": (lib, 10)}),
                   "events_ms": cuda_ms(torch, kern),
                   "events_plain_ms": cuda_ms(torch, plain, iters=5),
                   "events_library_ms": cuda_ms(torch, lib),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "plan": list(plans[name])}
            rows.append(row)
            t = tot[name]
            for key in (*times, "bound_ms"):
                t[key] += row[key]
            t[b_by] += b_ms
            t["max_abs_err"] = max(t["max_abs_err"], err)
        ms = {r["kernel"]: r["ms"] for r in rows[-len(cases):]}
        print(f"plan {lp.name}: M={m} K={k} n_lut={n_lut} n_dsp={n_dsp}; "
              + "; ".join(f"{name} (BM={pl.bm} BN={pl.bn} S={pl.split} "
                          f"blocks={pl.blocks}) {ms[name]:.4f} ms"
                          for name, pl in plans.items()))
    for name in names:
        t = tot[name]
        print(f"kernel {name}: 21 resnet18 shapes bitwise equal to plain; "
              f"per image device {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f}, _int_mm {t['library_ms']:.4f}, bound "
              f"{t['bound_ms']:.4f}); events {t['events_ms']:.4f} ms "
              f"(plain {t['events_plain_ms']:.4f}, _int_mm "
              f"{t['events_library_ms']:.4f})")

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
    fused_corners(torch, details)
    single_corners(torch, details)
    return tot


def launch_planned(torch, name, x, sw, geom, plan):
    """The split-GEMM kernel ``name`` under a given (BM, BN, S) ``plan``
    rather than the chooser's, into a NaN-filled output (a block that
    writes nothing shows); ``geom`` is the conv's (kernel, stride, pad,
    out_hw), None for the dense kernels."""
    from repro_torch.kernels.build import launch
    if name == "bitserial_gemm":
        n, args = sw.n_lut, (*x.shape, sw.lut_words.data_ptr(), sw.bits,
                             sw.n_lut, sw.s_lut.data_ptr())
    elif name == "int4_gemm":
        n, args = sw.n_dsp, (*x.shape, sw.dsp_words.data_ptr(), sw.n_dsp,
                             sw.s_dsp.data_ptr())
    else:
        n = sw.n_lut + sw.n_dsp
        lead = tuple(x.shape) if geom is None else (*x.shape, *geom)
        args = (*lead, sw.planes.data_ptr(), sw.bits, sw.n_lut,
                sw.packed.data_ptr(), sw.n_dsp, sw.scale.data_ptr())
    m = x.shape[0] if geom is None else geom[3] ** 2
    out = torch.full((m, n), float("nan"), device=x.device)
    launch(name, x, x.data_ptr(), *args, out.data_ptr(), *plan)
    return out


def fused_corners(torch, details: dict) -> None:
    """The fused kernels at :data:`DENSE_CORNERS` and
    :data:`CONV_CORNERS`, under the chooser's plan and under every
    compiled (BM, BN) tile and cluster size S, each bitwise equal to the
    plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_hetero_gemm import SPLITS, TILES, \
        fused_conv_gemm, fused_conv_gemm_plain, fused_hetero_gemm, \
        fused_hetero_gemm_plain, split_plan
    gen = torch.Generator(device="cpu").manual_seed(13)

    def weights(k, bits, n_lut, n_dsp):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        s = torch.rand(n_lut + n_dsp, generator=gen) + 0.5
        return ops.prepare_split(
            k, torch.randint(lo, hi, (k, n_lut), generator=gen), s[:n_lut],
            bits, torch.randint(-8, 8, (k, n_dsp), generator=gen),
            s[n_lut:], torch.device("cuda"))

    cases = []
    for m, k, bits, n_lut, n_dsp in DENSE_CORNERS:
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        sw = weights(k, bits, n_lut, n_dsp)
        args = (sw.planes, sw.packed, sw.scale, bits, n_lut, n_dsp)
        cases.append((f"dense M={m} K={k} bits={bits} {n_lut}/{n_dsp}",
                      "fused_hetero_gemm", x, sw, None,
                      split_plan(m, k, n_lut, n_dsp),
                      fused_hetero_gemm(x, *args),
                      fused_hetero_gemm_plain(x, *args)))
    for hw, c, ks, st, pad, bits, n_lut, n_dsp in CONV_CORNERS:
        out_hw = (hw + 2 * pad - ks) // st + 1
        k = ks * ks * c
        x = torch.randint(-128, 128, (hw, hw, c), generator=gen,
                          dtype=torch.int8).cuda()
        sw = weights(k, bits, n_lut, n_dsp)
        geom = (ks, st, pad, out_hw)
        args = (sw.planes, sw.packed, sw.scale, bits, n_lut, n_dsp, *geom)
        cases.append((f"conv {hw}x{hw}x{c} k{ks}s{st}p{pad} bits={bits} "
                      f"{n_lut}/{n_dsp}", "fused_conv_gemm", x, sw, geom,
                      split_plan(out_hw ** 2, k, n_lut, n_dsp),
                      fused_conv_gemm(x, *args),
                      fused_conv_gemm_plain(x, *args)))
    n_checked = 0
    for tag, name, x, sw, geom, plan, got, want in cases:
        require_equal(torch, f"{name} {tag} {tuple(plan)}", got, want)
        for (bm, bn), split in itertools.product(TILES, SPLITS):
            require_equal(torch, f"{name} {tag} BM={bm} BN={bn} S={split}",
                          launch_planned(torch, name, x, sw, geom,
                                         (bm, bn, split)), want)
        n_checked += 1 + len(TILES) * len(SPLITS)
    details["fused_corners"] = [(tag, list(plan))
                                for tag, _, _, _, _, plan, _, _ in cases]
    print(f"kernels: fused corners bitwise equal to plain: {len(cases)} "
          f"shapes x (chooser's plan + {len(TILES)} tiles x {len(SPLITS)} "
          f"cluster sizes) = {n_checked} launches")


def single_corners(torch, details: dict) -> None:
    """The single-path kernels at :data:`SINGLE_CORNERS`, under the
    chooser's plan and under every compiled (BM, BN) tile and cluster
    size S into a NaN-filled output, each bitwise equal to the plain
    version: ``bitserial_gemm`` at every bit width 1-8, ``int4_gemm`` at
    odd column counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitserial_gemm import bitserial_gemm_plain
    from repro_torch.kernels.fused_hetero_gemm import SPLITS, TILES, \
        split_plan
    from repro_torch.kernels.int4_gemm import int4_gemm_plain
    gen = torch.Generator(device="cpu").manual_seed(17)
    n_launches, n_shapes = 0, 0
    for i, (m, k) in enumerate(SINGLE_CORNERS):
        x = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        n_lut, n_dsp = SINGLE_COLUMNS[i % len(SINGLE_COLUMNS)]
        cases = []
        for bits in range(1, 9):
            lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
            s = torch.rand(n_lut, generator=gen) + 0.5
            sw = ops.prepare_split(
                k, torch.randint(lo, hi, (k, n_lut), generator=gen), s,
                bits, None, None, torch.device("cuda"))
            cases.append((f"bits={bits} n={n_lut}", "bitserial_gemm", sw,
                          split_plan(m, k, n_lut, 0),
                          ops.lut_matmul(x, sw),
                          bitserial_gemm_plain(x, sw.lut_words, sw.s_lut,
                                               bits, n_lut)))
        s = torch.rand(n_dsp, generator=gen) + 0.5
        sw = ops.prepare_split(
            k, None, None, 0, torch.randint(-8, 8, (k, n_dsp), generator=gen),
            s, torch.device("cuda"))
        cases.append((f"n={n_dsp}", "int4_gemm", sw,
                      split_plan(m, k, 0, n_dsp), ops.dsp_matmul(x, sw),
                      int4_gemm_plain(x, sw.dsp_words, sw.s_dsp, n_dsp)))
        for tag, name, sw, plan, got, want in cases:
            tag = f"{name} M={m} K={k} {tag}"
            require_equal(torch, f"{tag} {tuple(plan)}", got, want)
            for (bm, bn), split in itertools.product(TILES, SPLITS):
                require_equal(torch, f"{tag} BM={bm} BN={bn} S={split}",
                              launch_planned(torch, name, x, sw, None,
                                             (bm, bn, split)), want)
            n_launches += 1 + len(TILES) * len(SPLITS)
            n_shapes += 1
    details["single_corners"] = {"shapes": SINGLE_CORNERS,
                                 "columns": SINGLE_COLUMNS,
                                 "launches": n_launches}
    print(f"kernels: single-path corners bitwise equal to plain: "
          f"{len(SINGLE_CORNERS)} (M, K) x (bitserial_gemm at bits 1-8 + "
          f"int4_gemm) = {n_shapes} cases x (chooser's plan + {len(TILES)} "
          f"tiles x {len(SPLITS)} cluster sizes) = {n_launches} launches")


def expected_launches(prog, ex) -> dict:
    """Per path, the launches of one image: the fused path launches
    ``fused_conv_gemm`` once per layer; ``fused=False`` one single-path
    kernel per non-empty split side; staged ``run_layer`` one
    ``fused_hetero_gemm`` per two-sided layer, else the side's kernel.
    A depthwise layer launches ``depthwise_conv_gemm`` once on the fused
    path, ``grouped_gemm`` once per non-empty side on ``fused=False``
    and ``grouped_gemm`` once staged."""
    want = {p: collections.Counter() for p in ("fused", "fused=False",
                                               "staged")}
    for lp in prog.layers:
        sw = ex._split[lp.index]
        if lp.depthwise:
            want["fused"]["depthwise_conv_gemm"] += 1
            want["fused=False"].update(["grouped_gemm"] * ((sw.n_lut > 0)
                                                           + (sw.n_dsp > 0)))
            want["staged"]["grouped_gemm"] += 1
            continue
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


def phase_slice(torch, prog, ex, details: dict,
                network: str = "resnet18") -> dict:
    """Each CudaExecutor path on full-width ``network``, its launches
    counted in a window of its own; returns each path's counts."""
    import numpy as np
    from repro_torch.compiler import CudaExecutor, bind_synthetic, \
        compile_network, execute_report
    from repro_torch.compiler.runtime.base import chain_layers
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
    ex_split.run(images[0])
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
    split_logits, split_lat = [], []
    for x in images:
        t0 = time.perf_counter()
        split_logits.append(ex_split.run(x))
        torch.cuda.synchronize()
        split_lat.append(1e3 * (time.perf_counter() - t0))
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
    staged = {lp.index: ex._staged_activations(lp, inputs[lp.index])
              for lp in prog.layers}
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
    # a reduced network on the card and on the CPU
    small = compile_network(network, in_hw=32, width=0.25)
    xs = images[0][:32, :32]
    ys = []
    for dev in ("cuda", "cpu"):
        e = CudaExecutor(small, device=dev)
        for lp in small.layers:
            bind_synthetic(e, lp, seed=lp.index)
        ys.append(e.run(xs).cpu())
    require_equal(torch, f"reduced {network} card vs cpu", ys[0], ys[1])

    med = statistics.median(lat)
    image_dev = busy_ms(torch, lambda: ex.run(images[0]), iters=4)
    print(f"slice: device time per image {busy_text(image_dev, med)} of "
          f"the median latency")
    details["image_device_ms"] = image_dev
    split_med = statistics.median(split_lat)
    split_dev = busy_ms(torch, lambda: ex_split.run(images[0]), iters=4)
    print(f"slice: fused=False per-image latency median {split_med:.3f} ms "
          f"({', '.join(f'{v:.3f}' for v in split_lat)}); device time per "
          f"image {busy_text(split_dev, split_med)}")
    details["split_latency_ms"] = split_lat
    details["split_image_device_ms"] = split_dev
    print(f"slice: {network} 224 x{N_IMAGES} images via CudaExecutor: "
          f"per-image latency median {med:.3f} ms ({', '.join(f'{v:.3f}' for v in lat)}); "
          f"|out| sum image 0 {float(np.abs(y0).sum()):.6e}; bitwise equal "
          f"to plain, fused=False, staged and CPU")
    for path, counts in paths.items():
        print(f"slice: {path} path launches {counts} "
              f"({'1 image' if path == 'staged' else f'{N_IMAGES} images'})")
    details["latency_ms"] = lat
    details["launches"] = paths
    SINGLE[network] = {"ex": ex, "image": images[0], "logits": logits[0],
                       "latency_ms": med, "device_ms": image_dev}
    return paths


def path_launches(paths: dict, kernel_path: dict) -> dict:
    """Each kernel's launches, read from the run of the path that uses
    it (``kernel_path``: kernel -> path); raise if one is 0."""
    launches = {name: paths[path].get(name, 0)
                for name, path in kernel_path.items()}
    missing = [name for name, count in launches.items() if not count]
    if missing:
        raise AssertionError(f"kernels not launched on their path: "
                             f"{missing} ({paths})")
    return launches


def dw_conv2d_fn(torch, x_sp, codes, scale, conv):
    """The library yardstick of a depthwise layer:
    ``F.conv2d(..., groups=C)`` in fp32 on the codes (input permuted to
    NCHW and converted outside the timed call), times the scale; with
    TF32 off every sum (below 2^24) is exact. Returns [1, C, oh, ow]."""
    import torch.nn.functional as F
    kernel, stride, pad, _ = conv
    c = x_sp.shape[2]
    xf = x_sp.permute(2, 0, 1).unsqueeze(0).float().contiguous()
    wf = codes.t().reshape(c, 1, kernel, kernel).float().contiguous()
    s = scale.reshape(1, c, 1, 1)
    return lambda: F.conv2d(xf, wf, stride=stride, padding=pad,
                            groups=c) * s


def depthwise_layers(torch, prog, ex, details: dict) -> dict:
    """The depthwise kernel at each depthwise layer of ``prog`` (its
    bound weights, random int8 input): both entry points and each side
    alone bitwise equal to the plain version, and the spatial form timed
    per image beside the staged form, the plain version and
    ``F.conv2d(groups=C)``; returns the per-image totals."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.depthwise_gemm import depthwise_conv_gemm, \
        depthwise_conv_gemm_plain, grouped_gemm, grouped_gemm_plain
    gen = torch.Generator(device="cpu").manual_seed(19)
    times = ("ms", "grouped_ms", "plain_ms", "library_ms")
    tot = {**dict.fromkeys(times, 0.0), "bound_ms": 0.0, "bytes": 0.0,
           "operations": 0.0, "max_abs_err": 0.0, "library_err": 0.0}
    rows = details.setdefault("depthwise", [])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for lp in prog.layers:
            if not lp.depthwise:
                continue
            g, sw, wts = lp.geometry, ex._split[lp.index], \
                ex._weights[lp.index]
            m, k, n, bits = lp.dims.m, lp.dims.k, lp.dims.n, lp.bits_w_lut
            conv = (g.kernel, g.stride, g.pad, g.out_hw)
            x_sp = torch.randint(-128, 128, g.in_shape, generator=gen,
                                 dtype=torch.int8).cuda()
            x_col = ref.conv_patches_ref(x_sp, *conv).contiguous()
            args = (sw.planes, sw.packed, sw.scale, bits, sw.n_lut, sw.n_dsp)
            kern = lambda: depthwise_conv_gemm(x_sp, *args, *conv)  # noqa: E731
            plain = lambda: depthwise_conv_gemm_plain(x_sp, *args, *conv)  # noqa: E731
            staged = lambda: grouped_gemm(x_col, *args)  # noqa: E731
            want = plain()
            err = require_equal(torch, f"depthwise_conv_gemm {lp.name}",
                                kern(), want)
            require_equal(torch, f"grouped_gemm {lp.name}", staged(),
                          grouped_gemm_plain(x_col, *args))
            require_equal(torch, f"grouped_gemm {lp.name} vs spatial",
                          staged(), want)
            for side, n_side, fn, cols in (
                    ("lut", sw.n_lut, ops.lut_grouped_matmul,
                     slice(0, sw.n_lut)),
                    ("dsp", sw.n_dsp, ops.dsp_grouped_matmul,
                     slice(sw.n_lut, n))):
                if n_side:
                    xs = x_col[:, :, cols].contiguous()
                    require_equal(torch, f"grouped_gemm {lp.name} {side} "
                                  f"side", fn(xs, sw), fn(xs, sw, mode="ref"))
            codes = torch.cat([c for c in (wts.w_lut, wts.w_dsp)
                               if c is not None], dim=1)
            lib = dw_conv2d_fn(torch, x_sp, codes, sw.scale, conv)
            lib_err = float((lib().reshape(n, m).t() - want).abs().max())
            b_ms, b_by = bound_ms(x_sp.numel(), m, k, bits, sw.n_lut,
                                  sw.n_dsp)
            row = {"layer": lp.name, "m": m, "k": k, "n": n,
                   "n_lut": sw.n_lut, "in_hw": g.in_hw, "stride": g.stride,
                   **device_times(torch, {"ms": (kern, 10),
                                          "grouped_ms": (staged, 10),
                                          "plain_ms": (plain, 3),
                                          "library_ms": (lib, 10)}),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_err": lib_err}
            rows.append(row)
            for key in (*times, "bound_ms"):
                tot[key] += row[key]
            tot[b_by] += b_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["library_err"] = max(tot["library_err"], lib_err)
            print(f"depthwise {lp.name}: {g.in_hw}x{g.in_hw}x{n} stride "
                  f"{g.stride} (M={m} N={n} n_lut={sw.n_lut}): device "
                  f"{row['ms']:.4f} ms (staged form "
                  f"{row['grouped_ms']:.4f}, plain {row['plain_ms']:.4f}, "
                  f"conv2d {row['library_ms']:.4f} with max |err| "
                  f"{lib_err:.3g}, bound {b_ms:.4f} by {b_by})")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"kernel depthwise_gemm: {len(rows)} mobilenet_v2 depthwise layers "
          f"bitwise equal to plain (spatial, staged and one-side forms); "
          f"per image device {tot['ms']:.4f} ms (staged form "
          f"{tot['grouped_ms']:.4f}, plain {tot['plain_ms']:.4f}, conv2d "
          f"groups=C {tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f})")
    return tot


def depthwise_corners(torch, details: dict) -> None:
    """The depthwise kernel's two entry points at :data:`DW_CORNERS`,
    each bitwise equal to the plain version."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.depthwise_gemm import depthwise_conv_gemm, \
        depthwise_conv_gemm_plain, grouped_gemm, grouped_gemm_plain
    gen = torch.Generator(device="cpu").manual_seed(29)
    for hw, c, ks, st, pad, bits, n_lut in DW_CORNERS:
        out_hw = (hw + 2 * pad - ks) // st + 1
        conv, k = (ks, st, pad, out_hw), ks * ks
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1)
        s = torch.rand(c, generator=gen) + 0.5
        sw = ops.prepare_split(
            k, torch.randint(lo, hi, (k, n_lut), generator=gen), s[:n_lut],
            bits, torch.randint(-8, 8, (k, c - n_lut), generator=gen),
            s[n_lut:], torch.device("cuda"))
        x_sp = torch.randint(-128, 128, (hw, hw, c), generator=gen,
                             dtype=torch.int8).cuda()
        x_col = ref.conv_patches_ref(x_sp, *conv).contiguous()
        args = (sw.planes, sw.packed, sw.scale, bits, n_lut, c - n_lut)
        tag = f"{hw}x{hw}x{c} k{ks}s{st}p{pad} bits={bits} {n_lut}/{c - n_lut}"
        require_equal(torch, f"depthwise_conv_gemm {tag}",
                      depthwise_conv_gemm(x_sp, *args, *conv),
                      depthwise_conv_gemm_plain(x_sp, *args, *conv))
        require_equal(torch, f"grouped_gemm {tag}", grouped_gemm(x_col, *args),
                      grouped_gemm_plain(x_col, *args))
    details["depthwise_corners"] = DW_CORNERS
    print(f"kernels: depthwise corners bitwise equal to plain: "
          f"{len(DW_CORNERS)} shapes x 2 entry points")


def dense_shapes(torch, prog, ex, details: dict) -> dict:
    """The split-GEMM kernels at each distinct dense layer shape of
    ``prog`` (its bound weights, random int8 input), each bitwise equal
    to the plain version: ``fused_conv_gemm`` on the spatial block, and
    on the staged matrix ``split_matmul`` (``fused_hetero_gemm``, or the
    side's single-path kernel for a one-sided layer) and each side's
    single-path kernel; ``fused_conv_gemm`` timed per image (each shape
    times its layers) beside its plain version, ``_int_mm`` and the
    bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_hetero_gemm import split_plan
    gen = torch.Generator(device="cpu").manual_seed(23)
    groups: dict = {}
    for lp in prog.layers:
        if not lp.depthwise:
            g, sw = lp.geometry, ex._split[lp.index]
            groups.setdefault((g.in_hw, g.c_in, g.kernel, g.stride, g.pad,
                               sw.n_lut, sw.n_dsp), []).append(lp)
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    rows = details.setdefault("dense", [])
    for lps in groups.values():
        lp = lps[0]
        g, sw, wts = lp.geometry, ex._split[lp.index], ex._weights[lp.index]
        m, k = lp.dims.m, lp.dims.k
        conv = (g.kernel, g.stride, g.pad, g.out_hw)
        x_sp = torch.randint(-128, 128, g.in_shape, generator=gen,
                             dtype=torch.int8).cuda()
        x_col = ref.conv_patches_ref(x_sp, *conv).reshape(m, k).contiguous()
        kern = lambda: ops.split_conv_matmul(x_sp, *conv, sw)  # noqa: E731
        plain = lambda: ops.split_conv_matmul(x_sp, *conv, sw,  # noqa: E731
                                              mode="ref")
        require_equal(torch, f"fused_conv_gemm {lp.name}", kern(), plain())
        require_equal(torch, f"split_matmul {lp.name}",
                      ops.split_matmul(x_col, sw),
                      ops.split_matmul(x_col, sw, mode="ref"))
        if sw.n_lut:
            require_equal(torch, f"bitserial_gemm {lp.name}",
                          ops.lut_matmul(x_col, sw),
                          ops.lut_matmul(x_col, sw, mode="ref"))
        if sw.n_dsp:
            require_equal(torch, f"int4_gemm {lp.name}",
                          ops.dsp_matmul(x_col, sw),
                          ops.dsp_matmul(x_col, sw, mode="ref"))
        codes = torch.cat([c for c in (wts.w_lut, wts.w_dsp)
                           if c is not None], dim=1)
        row = {"layers": [lp.name for lp in lps], "m": m, "k": k,
               "n_lut": sw.n_lut, "n_dsp": sw.n_dsp,
               "plan": list(split_plan(m, k, sw.n_lut, sw.n_dsp)),
               **device_times(torch, {
                   "ms": (kern, 10), "plain_ms": (plain, 3),
                   "library_ms": (int_mm_fn(torch, x_col, codes, sw.scale),
                                  10)}),
               "bound_ms": bound_ms(x_sp.numel(), m, k, lp.bits_w_lut,
                                    sw.n_lut, sw.n_dsp)[0]}
        rows.append(row)
        for key in tot:
            tot[key] += len(lps) * row[key]
        print(f"dense {lp.name} (x{len(lps)}): M={m} K={k} n_lut={sw.n_lut} "
              f"n_dsp={sw.n_dsp} plan {tuple(row['plan'])}: bitwise equal; "
              f"fused_conv_gemm {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f}, _int_mm {row['library_ms']:.4f}, "
              f"bound {row['bound_ms']:.4f})")
    n_dense = sum(len(lps) for lps in groups.values())
    print(f"kernel fused_conv_gemm: {len(groups)} distinct mobilenet_v2 dense "
          f"shapes ({n_dense} layers) bitwise equal to plain, staged and "
          f"single-path forms too; per image device {tot['ms']:.4f} ms "
          f"(plain {tot['plain_ms']:.4f}, _int_mm {tot['library_ms']:.4f}, "
          f"bound {tot['bound_ms']:.4f})")
    details["fused_conv_gemm_per_image"] = tot
    return tot


def phase_mobilenet(torch, details: dict):
    """Full-width mobilenet_v2 (224, width 1.0, -O 0): the depthwise
    kernel at its 17 layers and at corners, the split-GEMM kernels at its
    dense shapes, and every CudaExecutor path with exact launch counts;
    returns the depthwise kernel's per-image row and its launches on the
    fused path."""
    from repro_torch.compiler import CudaExecutor, bind_synthetic, \
        compile_network
    t0 = time.time()
    prog = compile_network("mobilenet_v2")
    n_dw = sum(lp.depthwise for lp in prog.layers)
    print(f"compile: mobilenet_v2 224 -O 0, {len(prog.layers)} layers "
          f"({n_dw} depthwise), fingerprint {prog.fingerprint()[:12]}, "
          f"{time.time() - t0:.2f} s")
    ex = CudaExecutor(prog)
    for lp in prog.layers:
        bind_synthetic(ex, lp, seed=lp.index)
    row = depthwise_layers(torch, prog, ex, details)
    depthwise_corners(torch, details)
    dense_shapes(torch, prog, ex, details)
    counts = path_launches(phase_slice(torch, prog, ex, details,
                                       "mobilenet_v2"), MOBILENET_PATH)
    return row, counts["depthwise_conv_gemm"]


def flash_tol(v) -> float:
    """Kernel vs plain, bf16: two steps of bf16's 2^-8 relative spacing on
    max |v|. Each output is a convex combination of v rows; p is rounded
    to bf16 (half a step) in both versions, at running maxima taken over
    other tiles, and the output is rounded to bf16 (a step where the two
    fp32 values straddle a rounding boundary)."""
    return 2 * 2 ** -8 * float(v.abs().max())


#: kernel vs plain, bf16, per output row: |got - want| over |want| (L2
#: norms over the head dimension). p and the output are rounded to bf16
#: at running maxima taken over different tiles, which leaves a row an
#: rms relative error near 2^-9; 1e-2 is five times that. Unlike
#: :func:`flash_tol`, which is scaled to max |v| and so is about as large
#: as a typical output once a row averages ~1000 keys, it sees a fault
#: that moves a row by a fraction of its size (a key masked or dropped).
FLASH_ROW_TOL = 1e-2


def flash_row_err(got, want) -> float:
    """The largest relative error of an output row [..., D] (see
    :data:`FLASH_ROW_TOL`)."""
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / want.float().norm(dim=-1).clamp_min(1e-30)).max())


def flash_bound_ms(b, sq, skv, hq, hkv, d, causal, kv_offset):
    """Least time for one attention call: q, k, v (at the KV heads) and
    out in bf16 read / written once over the HBM rate, vs 4·B·Hq·D FLOP
    per unmasked (query, key) pair over the bf16 tensor-core rate."""
    nbytes = 2 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    if causal:
        pairs = sum(min(skv, r + kv_offset + 1) for r in range(sq))
    else:
        pairs = sq * skv
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * b * hq * d * pairs / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def sdpa_fn(torch, q, k, v, causal, kv_offset):
    """``F.scaled_dot_product_attention`` on [B, H, S, D] views with the
    KV heads repeated outside the timed call, its output viewed back as
    [B, S, H, D]; the causal mask is aligned to the lower right (query i
    at key position i + Skv - Sq), which is what every causal shape here
    uses."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    sq, skv = q.shape[1], k.shape[1]
    if causal and kv_offset != skv - sq:
        raise ValueError(f"causal offset {kv_offset} is not lower-right")
    mask = causal_lower_right(sq, skv) if causal and sq != skv else None
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and sq == skv
    ).transpose(1, 2)


def phase_flash(torch, details: dict) -> dict:
    """The flash-attention kernel against its plain version at the
    :data:`FLASH_SHAPES`, each under its plan, timed beside SDPA and the
    bound; returns the serving prefill shape's row and the largest error
    over all shapes."""
    from repro_torch.kernels.flash_attention import flash_attention, \
        flash_attention_plain, flash_plan
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = details.setdefault("flash", [])
    for name, b, sq, skv, hq, hkv, d, causal, off in FLASH_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
        kw = dict(causal=causal, kv_offset=off)
        kern = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: flash_attention_plain(q, k, v, **kw)  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"flash {name}: {tuple(got.shape)} output "
                                 f"not finite or not {tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        tol = flash_tol(v)
        row_err = flash_row_err(got, want)
        if not (err <= tol and row_err <= FLASH_ROW_TOL):
            raise AssertionError(
                f"flash {name}: kernel vs plain max |err| {err} (tol {tol}), "
                f"row error {row_err} (tol {FLASH_ROW_TOL})")
        lib = sdpa_fn(torch, q, k, v, causal, off)
        lib_err = float((lib().float() - want.float()).abs().max())
        b_ms, b_by = flash_bound_ms(b, sq, skv, hq, hkv, d, causal, off)
        plan = flash_plan(b, sq, skv, hq, hkv, d)
        row = {"shape": name, "b": b, "sq": sq, "skv": skv, "hq": hq,
               "hkv": hkv, "d": d, "causal": causal, "kv_offset": off,
               "form": plan.form, "grid": list(plan.grid),
               "smem": plan.smem,
               "max_abs_err": err, "tol": tol, "row_err": row_err,
               "sdpa_err": lib_err,
               **device_times(torch, {"ms": (kern, 10),
                                      "plain_ms": (plain, 2),
                                      "library_ms": (lib, 10)}),
               "bound_ms": b_ms,
               "bound_by": b_by, "events_ms": cuda_ms(torch, kern),
               "events_plain_ms": cuda_ms(torch, plain, iters=5),
               "events_library_ms": cuda_ms(torch, lib)}
        rows.append(row)
        print(f"flash {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} "
              f"D={d} causal={causal} kv_offset={off}, {plan.form} form, "
              f"grid {plan.grid}: max |err| {err:.3g} "
              f"(tol {tol:.3g}; sdpa {lib_err:.3g}), row error "
              f"{row_err:.3g} (tol {FLASH_ROW_TOL}); device {row['ms']:.4f} "
              f"ms (plain {row['plain_ms']:.4f}, sdpa "
              f"{row['library_ms']:.4f}, bound {b_ms:.4f} by {b_by}); "
              f"events {row['events_ms']:.4f} ms (plain "
              f"{row['events_plain_ms']:.4f}, sdpa "
              f"{row['events_library_ms']:.4f})")
    return dict(rows[0], max_abs_err=max(r["max_abs_err"] for r in rows))


def read_window(launches, want: dict, what: str) -> dict:
    """The counts of one launch window; raise unless exactly ``want``."""
    got = {name: count for name, count in launches.items() if count}
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")
    return got


def phase_serve(torch, details: dict) -> int:
    """Full-width llama3.2-1b through the launcher, then through the
    engine with prefill and decode counted in windows of their own and
    held against the mode="ref" run; returns the flash launches of one
    prefill."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.obs import METRICS
    from repro_torch.serve import engine

    b, s0, n_new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    arch = registry.get(SERVE["arch"])
    cfg, dev = arch.model, torch.device("cuda")
    per_prefill = {"flash_attention": cfg.n_layers}

    # the user's entry point: one batch of requests, one prefill
    LAUNCHES.clear()
    summary = serve.main(["--arch", SERVE["arch"], "--batch", str(b),
                          "--prompt-len", str(s0), "--new-tokens",
                          str(n_new), "--seed", str(SERVE["seed"])])
    torch.cuda.synchronize()
    read_window(LAUNCHES, per_prefill, "launcher (1 prefill + decode)")
    details["serve_metrics"] = METRICS.snapshot()

    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(SERVE["seed"])
        params = arch.model_module().init(cfg, gen)
        prompts = SyntheticTokens(cfg.vocab, b, s0, seed=SERVE["seed"]
                                  ).next_batch()["tokens"].to(dev)
        if not torch.equal(prompts.cpu(), summary["prompts"]):
            raise AssertionError("engine prompts != the launcher's")
        prefill = engine.make_prefill_fn(arch)
        prefill_ref = engine.make_prefill_fn(arch, attn_mode="ref")
        decode = engine.make_decode_fn(arch)

        def run_prefill(fn):
            cache = engine.make_cache(arch, b, s0 + n_new, cfg.param_dtype,
                                      dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(params, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            return logits, cache, 1e3 * (time.perf_counter() - t0)

        def run_decode(logits, cache):
            tok = engine.greedy_token(logits[:, -1])
            toks = [tok]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_new - 1):
                step, cache = decode(params, tok, cache, s0 + i)
                tok = engine.greedy_token(step)
                toks.append(tok)
            torch.cuda.synchronize()
            return torch.cat(toks, 1), 1e3 * (time.perf_counter() - t0)

        run_prefill(prefill)                                    # warm-up
        LAUNCHES.clear()
        logits, cache, _ = run_prefill(prefill)
        windows = {"prefill": read_window(LAUNCHES, per_prefill, "prefill")}
        LAUNCHES.clear()
        tokens, t_decode = run_decode(logits, cache)
        windows["decode"] = read_window(LAUNCHES, {}, f"{n_new - 1} decode "
                                        f"steps")
        LAUNCHES.clear()
        ref_logits, ref_cache, _ = run_prefill(prefill_ref)
        ref_tokens, _ = run_decode(ref_logits, ref_cache)
        windows["mode=ref"] = read_window(LAUNCHES, {}, "mode=ref prefill "
                                          "+ decode")
        prefill_ms = [run_prefill(prefill)[2] for _ in range(7)]
        # device time of one prefill and of one decode step
        cache_d = run_prefill(prefill)[1]
        tok_d = tokens[:, :1]
        prefill_dev = busy_ms(torch, lambda: run_prefill(prefill), iters=3)
        decode_dev = busy_ms(torch, lambda: decode(params, tok_d, cache_d,
                                                   s0), iters=5)

    want_shape = (b, s0, cfg.vocab)
    if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             f"finite {want_shape}")
    err = float((logits - ref_logits).abs().max())
    tol = LOGIT_TOL * float(ref_logits.abs().max())
    if not err <= tol:
        raise AssertionError(f"prefill logits kernel vs mode=ref: max |err| "
                             f"{err} > {tol}")
    top2 = ref_logits[:, -1].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    first_same = tokens[:, 0] == ref_tokens[:, 0]
    if not bool(first_same[clear].all()):
        raise AssertionError(f"first token differs from mode=ref in a row "
                             f"whose top-2 gap exceeds {tol}: "
                             f"{tokens[:, 0].tolist()} vs "
                             f"{ref_tokens[:, 0].tolist()}")
    agree = int((tokens == ref_tokens).sum())
    logits_equal = float((logits == ref_logits).float().mean())
    same_as_launcher = bool(torch.equal(tokens.cpu(), summary["tokens"]))
    med = statistics.median(prefill_ms)
    per_step = t_decode / (n_new - 1)
    print(f"serve: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
          f"{cfg.param_dtype}, batch {b} prompt {s0} new {n_new}: "
          f"launches per window {windows}")
    print(f"serve: prefill logits vs mode=ref max |err| {err:.4g} (tol "
          f"{tol:.4g}), {100 * logits_equal:.3f}% bitwise equal; first "
          f"tokens equal in {int(first_same.sum())}/{b} "
          f"rows ({int(clear.sum())} with a top-2 gap above tol); greedy "
          f"tokens equal {agree}/{tokens.numel()}; engine tokens "
          f"{'equal' if same_as_launcher else 'differ from'} the launcher's")
    print(f"serve: prefill median {med:.3f} ms over 7 "
          f"({', '.join(f'{t:.3f}' for t in prefill_ms)}), "
          f"{b * s0 / med * 1e3:.0f} tok/s; decode {per_step:.3f} ms/step "
          f"over {n_new - 1} steps, {b * (n_new - 1) / t_decode * 1e3:.0f} "
          f"tok/s; launcher prefill {summary['prefill_ms']:.3f} ms, decode "
          f"{summary['decode_ms_per_step']:.3f} ms/step")
    print(f"serve: device time per prefill {busy_text(prefill_dev, med)} "
          f"of the median, per decode step "
          f"{busy_text(decode_dev, per_step)}")
    details["serve"] = {
        "windows": windows, "logit_err": err, "logit_tol": tol,
        "first_tokens_equal": int(first_same.sum()),
        "rows_above_tol": int(clear.sum()), "tokens_equal": agree,
        "tokens": tokens.cpu().tolist(), "ref_tokens":
        ref_tokens.cpu().tolist(), "prefill_ms": prefill_ms,
        "decode_ms_per_step": per_step, "logits_bitwise_equal":
        logits_equal, "prefill_device_ms": prefill_dev,
        "decode_step_device_ms": decode_dev, "launcher": {
            k: summary[k] for k in ("prefill_ms", "decode_ms",
                                    "decode_ms_per_step")},
        "logits_abs_sum": float(np.abs(logits.float().cpu().numpy()).sum())}
    return windows["prefill"]["flash_attention"]


#: the accuracy harness's operating point on the card (both reduced
#: nets, and full-width resnet18)
HARNESS = dict(n_samples=256, batch=64, train_steps=200)
#: reduced nets: samples evaluated through golden, the card and the CPU
#: on the same folded weights, in batches of CROSS_BATCH; the first
#: batch's logits are held bitwise
CROSS_SAMPLES = 64
CROSS_BATCH = 16
#: full-width resnet18: images held bitwise between the card and the CPU
FULL_CPU_IMAGES = 2


def n_tiles(prog) -> int:
    """Tiles golden executes for one image: per layer and core, the
    partition's row tiles times its column tiles."""
    total = 0
    for lp in prog.layers:
        for cp, n, (tm, tn) in (
                (lp.lut, lp.n_lut, (prog.lut_cfg.m, prog.lut_cfg.n)),
                (lp.dsp, lp.n_dsp, (prog.dsp_cfg.n_reg_row_a,
                                    prog.dsp_cfg.n_reg_col_w))):
            if cp is not None:
                total += -(-lp.dims.m // tm) * -(-n // tn)
    return total


def golden_image(torch, prog, image, what: str):
    """One image through ``GoldenExecutor`` on the card (no kernel may
    launch: golden runs the exact oracles), held bitwise against the
    fused path and ``mode="ref"``; returns its seconds."""
    from repro_torch.compiler import CudaExecutor, GoldenExecutor, \
        bind_synthetic
    from repro_torch.kernels.build import LAUNCHES
    golden = GoldenExecutor(prog)
    for lp in prog.layers:
        bind_synthetic(golden, lp, seed=lp.index)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    y = golden.run(image)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    read_window(LAUNCHES, {}, f"golden {what}")
    for path, kw in (("fused", {}), ("mode=ref", {"mode": "ref"})):
        ex = CudaExecutor(prog, **kw)
        for lp in prog.layers:
            bind_synthetic(ex, lp, seed=lp.index)
        require_equal(torch, f"{what}: golden vs {path}", y, ex.run(image))
    return secs


def phase_golden(torch, prog, details: dict) -> None:
    """``GoldenExecutor`` on the card: one full-width resnet18 image and
    one mobilenet_v2 image bitwise equal to ``CudaExecutor``'s fused
    path and ``mode="ref"``, then a weight fetch planted at the wrong
    segment must raise ``ExecutionError``."""
    import dataclasses

    import numpy as np
    from repro_torch.compiler import ExecutionError, GoldenExecutor, \
        bind_synthetic, compile_network
    from repro_torch.core import isa
    from repro_torch.quant.uniform import qrange

    def image(p):
        lo, hi = qrange(p.layers[0].bits_a)
        return np.random.default_rng(0).integers(
            lo, hi + 1, p.layers[0].geometry.in_shape).astype(np.int8)

    out = details.setdefault("golden", {})
    secs = golden_image(torch, prog, image(prog), "resnet18 224")
    tiles = n_tiles(prog)
    out["resnet18"] = {"s": secs, "tiles": tiles}
    print(f"golden: resnet18 224, {tiles} tiles, one image {secs:.2f} s "
          f"({1e6 * secs / tiles:.0f} us a tile); bitwise equal to the fused "
          f"path and mode=ref; no kernel launched")
    mob = compile_network("mobilenet_v2")
    mob_s = golden_image(torch, mob, image(mob), "mobilenet_v2 224")
    out["mobilenet_v2"] = {"s": mob_s, "tiles": n_tiles(mob)}
    print(f"golden: mobilenet_v2 224, {n_tiles(mob)} tiles, one image "
          f"{mob_s:.2f} s "
          f"({1e6 * mob_s / n_tiles(mob):.0f} us a tile); bitwise equal to "
          f"the fused path and mode=ref; no kernel launched")

    # a planted fault: layer 0's first weight fetch at layer 1's segment
    bad = compile_network("resnet18")
    cp = bad.layers[0].lut
    n = next(i for i, op in enumerate(cp.streams["fetch"])
             if isinstance(op.instr, isa.FetchInstr)
             and op.instr.stage_ctrl == 0)
    wrong = bad.memory["L1.wgt.lut"].base
    cp.streams["fetch"][n] = dataclasses.replace(
        cp.streams["fetch"][n],
        instr=dataclasses.replace(cp.streams["fetch"][n].instr,
                                  ddr_base=wrong))
    golden = GoldenExecutor(bad)
    bind_synthetic(golden, bad.layers[0], seed=0)
    try:
        golden.run_layer(0, image(bad))
    except ExecutionError as e:
        if "weight fetch addresses" not in str(e):
            raise AssertionError(f"planted fault raised {e!r}") from e
        out["planted"] = str(e)
        print(f"golden: planted weight fetch at L1.wgt.lut raised "
              f"ExecutionError: {e}")
    else:
        raise AssertionError("golden ran a weight fetch at the wrong "
                             "segment without raising")


def harness_launches(prog) -> dict:
    """Launches of one image of a compiled harness net: the fused path,
    spatial input on every layer."""
    want = collections.Counter()
    for lp in prog.layers:
        want["depthwise_conv_gemm" if lp.depthwise else "fused_conv_gemm"] += 1
    return want


def measured(torch, cfg, what: str, **kw):
    """``measure(cfg.arch, backend="cuda", **HARNESS, **kw)`` with its
    launches counted in a window of their own: exactly the fused path's
    of the program ``compile_quantized_cnn(cfg)`` gives, once per
    evaluated image. Returns (report, launches)."""
    from repro_torch.eval import accuracy as acc
    from repro_torch.kernels.build import LAUNCHES
    prog, _ = acc.compile_quantized_cnn(cfg)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    rep = acc.measure(cfg.arch, backend="cuda", **HARNESS, **kw)
    torch.cuda.synchronize()
    launches = read_launches(LAUNCHES, harness_launches(prog),
                             rep.n_samples, f"harness {what}")
    print(f"accuracy: {what}: agreement {rep.agreement:.4f} (floor "
          f"{acc.AGREEMENT_FLOOR}), top-1 compiled {rep.top1_compiled:.4f}, "
          f"top-1 fp32 {rep.top1_ref:.4f} over {rep.n_samples} samples; "
          f"training {rep.train_s:.2f} s ({HARNESS['train_steps']} steps, "
          f"batch {HARNESS['batch']}); eval {rep.eval_ms_per_image:.3f} ms "
          f"per image; simulated FPGA latency {rep.latency_ms} ms; "
          f"launches {launches}")
    return rep, launches


def trained(torch, cfg):
    """A reference trained at :data:`HARNESS`'s steps on the card, its
    norms folded; returns (folded weights, reference forward, seconds)."""
    from repro_torch.eval import accuracy as acc
    from repro_torch.models import cnn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, norms, ref_fn = acc.build_reference(
        cfg, train_steps=HARNESS["train_steps"])
    folded = cnn.fold_inference_weights(params, cfg, norms)
    torch.cuda.synchronize()
    return folded, ref_fn, time.perf_counter() - t0


def bound(prog, specs, folded: dict, backend: str, device: str):
    """A ``backend`` executor of ``prog`` on ``device`` with ``folded``
    bound through the harness."""
    from repro_torch.compiler import get_backend
    from repro_torch.eval import accuracy as acc
    ex = get_backend(backend)(prog, device=device)
    acc.bind_folded_weights(
        ex, prog, {k: w.to(ex.device) for k, w in folded.items()}, specs)
    return ex


def folded_diff(a: dict, b: dict) -> tuple[bool, float]:
    """Whether two folded weight sets are bitwise equal, and max |a - b|."""
    same = all(a[k].shape == b[k].shape and bool((a[k] == b[k]).all())
               for k in a)
    return same, max(float((a[k] - b[k]).abs().max()) for k in a)


def cross_check(torch, arch: str, cfg, prog, specs, folded: dict,
                ref_fn) -> dict:
    """The same folded weights bound into golden and the fused path on
    the card and the fused path's plain versions on the CPU:
    ``evaluate_agreement`` over :data:`CROSS_SAMPLES` gives equal counts
    on the three, and the first batch's logits are bitwise equal."""
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.eval import accuracy as acc
    from repro_torch.kernels.build import LAUNCHES
    # evaluate_agreement's first batch (seed 0: sample_seed 10_000)
    first = SyntheticImages(cfg.n_classes, CROSS_BATCH, cfg.in_hw,
                            sample_seed=10_000).next_batch()["images"]
    counts, logits, secs = {}, {}, {}
    for name, backend, device in (("golden", "golden", "cuda"),
                                  ("cuda", "cuda", "cuda"),
                                  ("cpu", "cuda", "cpu")):
        ex = bound(prog, specs, folded, backend, device)
        torch.cuda.synchronize()
        LAUNCHES.clear()
        t0 = time.perf_counter()
        counts[name] = acc.evaluate_agreement(ex, ref_fn, cfg, CROSS_SAMPLES,
                                              batch=CROSS_BATCH)
        secs[name] = time.perf_counter() - t0
        read_launches(LAUNCHES, harness_launches(prog) if name == "cuda"
                      else {}, CROSS_SAMPLES, f"{arch} reduced {name}")
        logits[name] = acc._batched_runner(ex)(first).cpu()
    for name in ("golden", "cpu"):
        if counts[name] != counts["cuda"]:
            raise AssertionError(f"{arch} reduced: {name} counts "
                                 f"{counts[name]} != {counts['cuda']}")
        require_equal(torch, f"{arch} reduced: {name} vs card logits",
                      logits[name], logits["cuda"])
    print(f"accuracy: {arch} reduced, a training of its own: counts "
          f"{counts['cuda']} equal on golden, the card and the CPU; "
          f"first-batch logits ({CROSS_BATCH} images) bitwise equal; ms per "
          "image " + ", ".join(f"{n} {1e3 * t / CROSS_SAMPLES:.2f}"
                              for n, t in secs.items()))
    return {"cross_counts": counts["cuda"], "cross_ms_per_image": {
        n: 1e3 * t / CROSS_SAMPLES for n, t in secs.items()}}


def phase_accuracy(torch, details: dict) -> dict:
    """The accuracy harness on the card: ``measure`` on both reduced
    nets (gated at the floor) and on full-width resnet18 (recorded);
    on the reduced nets two more trainings (whether they fold to the same
    weights), the first bound into golden and the fused path on the card
    and on the CPU (equal counts, bitwise first-batch logits); on
    full-width resnet18 one more training on the card and the CPU
    (bitwise logits). Returns the harness's launches per kernel."""
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.eval import accuracy as acc
    from repro_torch.models import cnn

    import numpy as np
    out = details.setdefault("accuracy", {})
    # the reference's convolutions: IEEE fp32 inside fp32_convs, against
    # float64 (outside it cuDNN's default may use TF32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 64, 56, 56, device="cuda", generator=gen)
    w = torch.randn(64, 64, 3, 3, device="cuda", generator=gen)
    want = torch.nn.functional.conv2d(x.double(), w.double(), padding=1)

    def conv_err():
        got = torch.nn.functional.conv2d(x, w, padding=1).double()
        return float((got - want).abs().max() / want.abs().max())
    with cnn.fp32_convs():
        inside = conv_err()
    outside = conv_err()
    out["conv_rel_err"] = {"fp32_convs": inside, "default": outside}
    print(f"accuracy: conv vs float64, max |err| / max |out|: "
          f"{inside:.3g} in fp32_convs, {outside:.3g} with cuDNN's default "
          f"flags (allow_tf32={torch.backends.cudnn.allow_tf32})")
    if not inside < 1e-5:
        raise AssertionError(f"fp32_convs conv error {inside} is not fp32's")
    totals = collections.Counter()
    for arch in ("resnet18", "mobilenet_v2"):
        cfg = cnn.reduced_config(arch)
        rep, launches = measured(torch, cfg, f"{arch} reduced")
        totals.update(launches)
        if rep.agreement < acc.AGREEMENT_FLOOR:
            raise AssertionError(f"{arch} reduced: agreement "
                                 f"{rep.agreement} below the floor")
        folded, ref_fn, s_a = trained(torch, cfg)
        folded_b, _, s_b = trained(torch, cfg)
        same, diff = folded_diff(folded, folded_b)
        print(f"accuracy: {arch} reduced: two more trainings ({s_a:.2f} s, "
              f"{s_b:.2f} s) fold to "
              f"{'bitwise the same weights' if same else 'other weights'} "
              f"(max |diff| {diff:.3g})")
        prog, specs = acc.compile_quantized_cnn(cfg)
        out[arch] = {"report": rep.bench_row(), "retrain_s": [s_a, s_b],
                     "trainings_bitwise_equal": same,
                     "trainings_max_abs_diff": diff,
                     **cross_check(torch, arch, cfg, prog, specs, folded,
                                   ref_fn)}

    cfg = cnn.CNNConfig(arch="resnet18")
    rep, launches = measured(torch, cfg, "resnet18 224", reduced=False)
    totals.update(launches)
    folded, _, secs = trained(torch, cfg)
    prog, specs = acc.compile_quantized_cnn(cfg)
    images = SyntheticImages(1000, FULL_CPU_IMAGES, 224,
                             sample_seed=10_000).next_batch()["images"]
    logits = [acc._batched_runner(bound(prog, specs, folded, "cuda", dev))(
        images).cpu() for dev in ("cuda", "cpu")]
    require_equal(torch, "resnet18 224 harness: card vs cpu", logits[0],
                  logits[1])
    y = logits[0].numpy()
    if y.shape != (FULL_CPU_IMAGES, 1000) or not np.isfinite(y).all():
        raise AssertionError(f"harness logits {y.shape} not finite")
    print(f"accuracy: resnet18 224: one more training ({secs:.2f} s); "
          f"{FULL_CPU_IMAGES} images' logits bitwise equal on the card and "
          f"the CPU")
    out["resnet18_224"] = {"report": rep.bench_row(), "retrain_s": secs}
    return dict(totals)


#: the decode phase: full-width sessions at batch 8 over a 64-position
#: window (1 warm-up step, the rest steady), jamba-v0.1-52b at its smoke
#: config (52 B parameters do not fit one card at full width), then
#: golden sessions at the three smoke configs
DECODE = dict(batch=8, max_seq=64, seed=0)
DECODE_STEPS = {"llama3.2-1b": 16, "mamba2-780m": 8, "jamba-v0.1-52b": 8}
#: step_slots calls of the staggered per-slot run; slot j is admitted
#: (``reset_slot``) at step j % 3 and holds a stale request before that
SLOT_STEPS = 4
GOLDEN_DECODE = dict(batch=1, max_seq=8, steps=4)
#: the decode path's kernels, in the order of the decode rows
DECODE_KERNELS = ("fused_hetero_gemm", "bitserial_gemm", "int4_gemm")


def compile_decode(name: str, smoke: bool, **kw):
    """The decode-step program of ``name`` at :data:`DECODE`'s batch and
    window (``kw`` overrides), as ``compile_decode_network`` compiles it
    at its defaults, but at the full config when ``smoke`` is False."""
    from repro_torch.compiler.lower import lower_network
    from repro_torch.compiler.networks import decode_step_layers
    kw = {"batch": DECODE["batch"], "max_seq": DECODE["max_seq"], **kw}
    opt_level = kw.pop("opt_level", 0)
    layers, spec = decode_step_layers(name, smoke=smoke, **kw)
    return lower_network(f"{name}.decode", layers, *compiler_cfgs(),
                         bits_w_lut=4, bits_a=4, opt_level=opt_level,
                         step=spec)


def compiler_cfgs():
    """The compiler's defaults: its LUT and DSP core configs and the
    XC7Z020."""
    from repro_torch.core.scheduler import DEVICES, DspCoreConfig, \
        LutCoreConfig
    dev = DEVICES["XC7Z020"]
    return (LutCoreConfig(m=8, n=16, k=128),
            DspCoreConfig(n_reg_row_a=DspCoreConfig.rows_for_device(dev)),
            dev)


def decode_launches(prog) -> dict:
    """Per path, the launches of one decode step, read from the program:
    ``CudaExecutor``'s fused path launches ``fused_hetero_gemm`` for a
    two-sided layer and the side's single-path kernel for a one-sided
    one; ``fused=False`` one single-path kernel per non-empty side."""
    want = {p: collections.Counter() for p in ("fused", "fused=False")}
    for lp in prog.layers:
        want["fused"][staged_kernel(lp)] += 1
        want["fused=False"].update(name for name, n in (
            ("bitserial_gemm", lp.n_lut), ("int4_gemm", lp.dims.n - lp.n_lut))
            if n)
    return want


def staged_kernel(lp) -> str:
    """The kernel the fused path launches on a staged [m, k] layer:
    ``fused_hetero_gemm`` for a two-sided split, else the side's
    single-path kernel."""
    sides = [name for name, n in (("bitserial_gemm", lp.n_lut),
                                  ("int4_gemm", lp.dims.n - lp.n_lut)) if n]
    return sides[0] if len(sides) == 1 else "fused_hetero_gemm"


def weight_fetches(prog) -> int:
    """Stage-0 fetches that target a ``weights``-resident segment."""
    from repro_torch.core import isa
    wbases = {s.base for s in prog.memory.segments
              if s.residency == "weights"}
    return sum(1 for lp in prog.layers for cp in (lp.lut, lp.dsp)
               if cp is not None for op in cp.streams["fetch"]
               if isinstance(op.instr, isa.FetchInstr)
               and op.instr.stage_ctrl == 0 and op.instr.ddr_base in wbases)


def greedy(torch, sess, steps: int):
    """``steps`` greedy steps from token j + 1 in row j, each step's
    token fed back; (logits per step, host ms per step), each step timed
    to a ``torch.cuda.synchronize()``."""
    tok = torch.arange(1, sess.spec.batch + 1, device=sess.device)
    logits, ms = [], []
    for pos in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.step(tok, pos)
        tok = out.argmax(dim=-1)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        logits.append(out)
    return logits, ms


def staggered(torch, sess):
    """:data:`SLOT_STEPS` ``step_slots`` calls: slot j is admitted at
    step j % 3 (``reset_slot``) and decodes from position 0; before
    that it runs a stale request at positions 20 + j + step. Greedy
    tokens fed back; returns the logits of each call."""
    B = sess.spec.batch
    sess.reset(per_slot=True)
    admit = [j % 3 for j in range(B)]
    tok = torch.arange(1, B + 1, device=sess.device)
    out = []
    for step in range(SLOT_STEPS):
        for j in range(B):
            if admit[j] == step and step:
                sess.reset_slot(j)
        pos = [step - a if step >= a else 20 + j + step
               for j, a in enumerate(admit)]
        logits = sess.step_slots(tok, pos)
        tok = logits.argmax(dim=-1)
        out.append(logits)
    return out


def decode_kernel_times(torch, prog, ex, gen) -> dict:
    """Each kernel of the decode path against its plain version at each
    distinct layer shape of ``prog`` (M = batch), bitwise, then timed:
    device ms per launch of the kernel, its plain version and
    ``torch._int_mm`` with M padded to 32, times the layers of that
    shape; per path and kernel, the sums over one step with the code-
    width bound and, for ``fused_hetero_gemm``, the bytes of the layout
    it reads (int8 bit planes + packed int4) over the HBM rate."""
    from repro_torch.kernels.bitserial_gemm import bitserial_gemm, \
        bitserial_gemm_plain
    from repro_torch.kernels.fused_hetero_gemm import fused_hetero_gemm, \
        fused_hetero_gemm_plain
    from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain
    shapes = collections.OrderedDict()
    for lp in prog.layers:
        key = (lp.dims.k, lp.n_lut, lp.dims.n - lp.n_lut)
        shapes.setdefault(key, [lp.index, 0])[1] += 1
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "layout_ms",
            "bytes", "operations")
    tot = {}
    m = prog.step.batch
    for (k, n_lut, n_dsp), (index, count) in shapes.items():
        sw, wts = ex._split[index], ex._weights[index]
        bits = sw.bits
        x = torch.randint(-8, 8, (m, k), generator=gen,
                          dtype=torch.int8).cuda()
        cases = {}
        if n_lut and n_dsp:
            codes = torch.cat([wts.w_lut, wts.w_dsp], dim=1)
            cases[("fused", "fused_hetero_gemm")] = (
                lambda: fused_hetero_gemm(x, sw.planes, sw.packed, sw.scale,
                                          bits, n_lut, n_dsp),
                lambda: fused_hetero_gemm_plain(x, sw.planes, sw.packed,
                                                sw.scale, bits, n_lut,
                                                n_dsp),
                int_mm_fn(torch, x, codes, sw.scale, min_m=32),
                bound_ms(x.numel(), m, k, bits, n_lut, n_dsp),
                (m * k + bits * k * n_lut + k * ((n_dsp + 1) // 2)
                 + 4 * (n_lut + n_dsp) * (m + 1)) / HBM_BYTES_PER_S * 1e3)
        sides = []
        if n_lut:
            sides.append(("bitserial_gemm", (
                lambda: bitserial_gemm(x, sw.lut_words, sw.s_lut, bits,
                                       n_lut),
                lambda: bitserial_gemm_plain(x, sw.lut_words, sw.s_lut, bits,
                                             n_lut),
                int_mm_fn(torch, x, wts.w_lut, sw.s_lut, min_m=32),
                bound_ms(x.numel(), m, k, bits, n_lut, 0), None)))
        if n_dsp:
            sides.append(("int4_gemm", (
                lambda: int4_gemm(x, sw.dsp_words, sw.s_dsp, n_dsp),
                lambda: int4_gemm_plain(x, sw.dsp_words, sw.s_dsp, n_dsp),
                int_mm_fn(torch, x, wts.w_dsp, sw.s_dsp, min_m=32),
                bound_ms(x.numel(), m, k, 0, 0, n_dsp), None)))
        if len(sides) == 1:
            cases[("fused", sides[0][0])] = sides[0][1]
        for name, case in sides:
            cases[("fused=False", name)] = case
        for (path, name), (kern, plain, lib, (b_ms, b_by), lay) in \
                cases.items():
            err = require_equal(torch, f"{name} {prog.name} M={m} K={k} "
                                f"{n_lut}/{n_dsp}", kern(), plain())
            t = device_times(torch, {"ms": (kern, 10), "plain_ms": (plain, 2),
                                     "library_ms": (lib, 10)})
            row = tot.setdefault(f"{path} {name}", {
                **dict.fromkeys(keys, 0.0), "launches": 0,
                "max_abs_err": 0.0, "shapes": []})
            row["shapes"].append({"k": k, "n_lut": n_lut, "n_dsp": n_dsp,
                                  "layers": count, **t, "bound_ms": b_ms})
            for key in ("ms", "plain_ms", "library_ms"):
                row[key] += count * t[key]
            row["bound_ms"] += count * b_ms
            row[b_by] += count * b_ms
            row["layout_ms"] += count * (b_ms if lay is None else lay)
            row["launches"] += count
            row["max_abs_err"] = max(row["max_abs_err"], err)
    for row in tot.values():
        row["bound_by"] = "bytes" if row["bytes"] >= row["operations"] \
            else "operations"
    return tot


def decode_sessions(torch, name: str, prog, steps: int, out: dict):
    """Bind the synthetic weights into the reference, a fused and a
    ``fused=False`` ``ExecutorSession`` on the card, decode ``steps``
    greedy tokens through each (each CUDA session's launches counted in
    a window of its own: exactly the program's per step) and the
    staggered per-slot run through the fused one; every logit bitwise
    equal to the reference's. Returns (the fused session, launches)."""
    import gc

    import numpy as np
    from repro_torch.compiler import ExecutorSession, ReferenceSession, \
        synthetic_decode_arrays
    from repro_torch.kernels.build import LAUNCHES

    t0 = time.time()
    arrays = synthetic_decode_arrays(prog.layers, prog.step,
                                     seed=DECODE["seed"])
    draw_s = time.time() - t0
    n_params = sum(a.size for key, a in arrays.items() if ".w_" in key)
    t0 = time.time()
    ref = ReferenceSession(prog)
    sessions = {"fused": ExecutorSession(prog, backend="cuda"),
                "fused=False": ExecutorSession(prog, backend="cuda",
                                               fused=False)}
    for sess in (ref, *sessions.values()):
        sess.bind_arrays(arrays)
    torch.cuda.synchronize()
    bind_s = time.time() - t0
    del arrays
    gc.collect()
    peak = torch.cuda.max_memory_allocated()
    print(f"decode: {name}: {len(prog.layers)} layers, {n_params:,} weight "
          f"codes drawn in {draw_s:.1f} s, bound into the reference, fused "
          f"and fused=False sessions in {bind_s:.1f} s; host arrays dropped; "
          f"peak device memory {peak / 2 ** 30:.2f} GiB")

    want = decode_launches(prog)
    LAUNCHES.clear()
    ref_logits, ref_ms = greedy(torch, ref, steps)
    read_window(LAUNCHES, {}, f"{name} reference session")
    windows, host = {}, {}
    for path, sess in sessions.items():
        LAUNCHES.clear()
        logits, ms = greedy(torch, sess, steps)
        windows[path] = read_window(
            LAUNCHES, {k: v * steps for k, v in want[path].items()},
            f"{name} {path} session, {steps} steps")
        for pos, (got, exp) in enumerate(zip(logits, ref_logits)):
            require_equal(torch, f"{name} {path} step {pos} vs reference",
                          got, exp)
        host[path] = {"warmup_ms": ms[0],
                      "steady_ms": statistics.median(ms[1:]), "ms": ms}
        if not sess._warmed:
            raise AssertionError(f"{name} {path}: session never warmed")
    last = ref_logits[-1]
    if tuple(last.shape) != (prog.step.batch, prog.layers[-1].dims.n) or \
            not bool(torch.isfinite(last).all()):
        raise AssertionError(f"{name} logits {tuple(last.shape)} not finite")
    tokens = torch.stack([lg.argmax(dim=-1) for lg in ref_logits], 1)

    LAUNCHES.clear()
    slots = staggered(torch, sessions["fused"])
    windows["step_slots"] = read_window(
        LAUNCHES, {k: v * SLOT_STEPS for k, v in want["fused"].items()},
        f"{name} staggered step_slots")
    ref_slots = staggered(torch, ref)
    for i, (got, exp) in enumerate(zip(slots, ref_slots)):
        require_equal(torch, f"{name} step_slots call {i} vs reference",
                      got, exp)
    live_slots = [int((lg != 0).any(dim=-1).sum()) for lg in ref_slots]

    # device time of one steady step (the caches take the same position
    # again; the logits above are already checked)
    tok = tokens[:, 0].contiguous()
    busy = {}
    for path, sess in sessions.items():
        sess.reset(per_slot=False)
        sess.step(tok, 0)
        busy[path] = busy_ms(torch, lambda s=sess: s.step(tok, 1), iters=3)
    sums = [float(np.abs(lg.cpu().numpy()).sum()) for lg in ref_logits]
    # rows whose logits are not all 0: a row whose activations requant
    # to 0 codes (a per-tensor scale set by another row, or an SSM gate
    # 1 + tanh(mean) at 0) carries 0 through every later layer
    live = [int((lg != 0).any(dim=-1).sum()) for lg in ref_logits]
    peak_run = torch.cuda.max_memory_allocated()
    for path in sessions:
        h = host[path]
        print(f"decode: {name} {path}: {steps} steps bitwise equal to the "
              f"reference session; host ms warm-up {h['warmup_ms']:.3f}, "
              f"steady median {h['steady_ms']:.3f} "
              f"({', '.join(f'{v:.2f}' for v in h['ms'][1:])}); device per "
              f"steady step {busy_text(busy[path], h['steady_ms'])}; "
              f"launches {windows[path]}")
    print(f"decode: {name}: reference session host ms per step median "
          f"{statistics.median(ref_ms[1:]):.3f}; staggered step_slots x"
          f"{SLOT_STEPS} bitwise equal to the per-slot reference (rows with "
          f"non-zero logits {live_slots}), launches "
          f"{windows['step_slots']}; |logits| sum per step "
          f"{', '.join(f'{v:.4e}' for v in sums)}; rows with non-zero "
          f"logits per step {live}; last tokens "
          f"{tokens[:, -1].tolist()}; peak device memory "
          f"{peak_run / 2 ** 30:.2f} GiB")
    out[name] = {"layers": len(prog.layers), "weight_codes": n_params,
                 "draw_s": draw_s, "bind_s": bind_s, "peak_bytes": peak,
                 "host": host, "device_step_ms": busy, "windows": windows,
                 "ref_step_ms": ref_ms, "logits_abs_sum": sums,
                 "live_rows": live, "live_slot_rows": live_slots,
                 "peak_run_bytes": peak_run,
                 "tokens": tokens.cpu().tolist()}
    launches = collections.Counter()
    for counts in windows.values():
        launches.update(counts)
    return sessions["fused"], launches


def golden_sessions(torch, out: dict) -> None:
    """Golden ``ExecutorSession`` at each decode family's smoke config on
    the card: :data:`GOLDEN_DECODE` steps bitwise equal to the reference
    session, no kernel launched, and the steady program (what every step
    after the first runs, its fetches checked one by one) with no weight
    fetch."""
    from repro_torch.compiler import ExecutorSession, ReferenceSession, \
        compile_decode_network
    from repro_torch.kernels.build import LAUNCHES
    g = GOLDEN_DECODE
    for name in DECODE_STEPS:
        prog = compile_decode_network(name, batch=g["batch"],
                                      max_seq=g["max_seq"], opt_level=1)
        ref, sess = ReferenceSession(prog), ExecutorSession(prog,
                                                            backend="golden")
        for s in (ref, sess):
            s.bind_synthetic_all(seed=DECODE["seed"])
        LAUNCHES.clear()
        t0 = time.time()
        logits, ms = greedy(torch, sess, g["steps"])
        secs = time.time() - t0
        want, _ = greedy(torch, ref, g["steps"])
        read_window(LAUNCHES, {}, f"{name} golden session")
        for pos, (got, exp) in enumerate(zip(logits, want)):
            require_equal(torch, f"{name} golden step {pos} vs reference",
                          got, exp)
        warm, steady = weight_fetches(sess.warm), weight_fetches(sess.steady)
        if not (warm > 0 and steady == 0 and sess._warmed):
            raise AssertionError(f"{name} golden: weight fetches warm {warm}"
                                 f", steady {steady}")
        print(f"decode: golden {name} smoke, {len(prog.layers)} layers, "
              f"{g['steps']} steps in {secs:.2f} s (warm-up "
              f"{ms[0]:.0f} ms, steady {statistics.median(ms[1:]):.0f} ms): "
              f"bitwise equal to the reference session; weight fetches warm "
              f"{warm}, steady {steady}; no kernel launched")
        out.setdefault("golden", {})[name] = {
            "steps_s": secs, "step_ms": ms, "weight_fetches_warm": warm,
            "weight_fetches_steady": steady}


def phase_decode(torch, details: dict):
    """Decode sessions on the card: full-width llama3.2-1b and
    mamba2-780m, jamba-v0.1-52b at its smoke config, each through the
    fused and ``fused=False`` ``ExecutorSession`` and the staggered
    per-slot run, bitwise equal to the reference session at every step;
    every decode-path kernel bitwise and timed at each full-width layer
    shape; golden sessions at the smoke configs. Returns the launches of
    every counted window, per kernel."""
    import gc
    out = details.setdefault("decode", {})
    gen = torch.Generator(device="cpu").manual_seed(23)
    launches = collections.Counter()
    for name, steps in DECODE_STEPS.items():
        smoke = name.startswith("jamba")
        t0 = time.time()
        prog = compile_decode(name, smoke)
        print(f"compile: {name}{' smoke' if smoke else ''} decode batch "
              f"{prog.step.batch} max_seq {prog.step.max_seq} -O 0: "
              f"{len(prog.layers)} layers, fingerprint "
              f"{prog.fingerprint()[:12]}, {time.time() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        sess, counts = decode_sessions(torch, name, prog, steps, out)
        launches.update(counts)
        if not smoke:
            tot = decode_kernel_times(torch, prog, sess._warm_ex, gen)
            per_step = {key: {"launches": row["launches"],
                              "ms": row["ms"], "bound_ms": row["bound_ms"]}
                        for key, row in tot.items()}
            want = decode_launches(prog)
            for key, row in tot.items():
                path, kname = key.split(" ")
                if row["launches"] != want[path][kname]:
                    raise AssertionError(f"{name} {key}: {row['launches']} "
                                         f"layers timed, program launches "
                                         f"{want[path][kname]}")
                print(f"decode: {name} {key}: {row['launches']} launches per "
                      f"step, device {row['ms']:.4f} ms per step (plain "
                      f"{row['plain_ms']:.4f}, _int_mm at M=32 "
                      f"{row['library_ms']:.4f}), bound {row['bound_ms']:.4f}"
                      f" ms ({row['bound_by']}; "
                      f"{row['ms'] / row['bound_ms']:.1f}x), the bytes of "
                      f"the layout it reads {row['layout_ms']:.4f} ms "
                      f"({row['ms'] / row['layout_ms']:.1f}x); "
                      f"bitwise at {len(row['shapes'])} shapes")
            out[name]["kernels"] = tot
            out[name]["kernels_per_step"] = per_step
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    golden_sessions(torch, out)
    return dict(launches)


#: the multi-device phase's CNN bundles, (network, plan kind, devices),
#: each at full width, -O 0, batch 1
CNN_BUNDLES = [("resnet18", "filter", 2), ("resnet18", "filter", 3),
               ("resnet18", "pipeline", 2), ("mobilenet_v2", "filter", 2),
               ("mobilenet_v2", "pipeline", 2)]
#: full-width llama3.2-1b decode bundles, (plan kind, devices), and the
#: greedy steps each decodes
DECODE_BUNDLES = [("filter", 2), ("pipeline", 2)]
MULTI_STEPS = 8
#: the compiled-serving command (``launch.serve``), as a user runs it
SERVE_ACCEL = ["--arch", "llama3.2-1b", "--quantize", "--accel-devices",
               "2", "--accel-partition", "filter", "--accel-backend",
               "cuda", "--fleet", "2"]
#: the cuda fleet: llama3.2-1b's smoke decode program (as the launcher
#: and the reference's fleet serve it), 2 slots a worker, and the
#: requests (prompt, new tokens) it serves under each policy
FLEET = dict(arch="llama3.2-1b", batch_slots=2, max_seq=8, seed=0)
FLEET_REQUESTS = [([3, 11], 4), ([5], 5), ([1, 2, 3], 3), ([9, 8], 4),
                  ([7], 6), ([2, 4, 6], 4), ([11, 13], 3), ([4], 5)]
#: the FC chain BundleFleet distributes, (m, k, n) per layer
FC_CHAIN = [(32, 256, 512), (32, 512, 384), (32, 384, 256), (32, 256, 128)]


def decode_bundle(name: str, kind: str, n_dev: int):
    """The decode-step bundle of ``name`` at its full config, as
    ``compile_decode_network(devices=n_dev, partition=kind)`` compiles
    its smoke config: ``lower_partitioned`` at :data:`DECODE`'s batch
    and window, ``-O 0``, then ``decorate_decode_bundle``."""
    from repro_torch.compiler.networks import decode_step_layers
    from repro_torch.compiler.partition import decorate_decode_bundle, \
        derive_plan, lower_partitioned
    lut, dsp, dev = compiler_cfgs()
    layers, spec = decode_step_layers(name, batch=DECODE["batch"],
                                      max_seq=DECODE["max_seq"],
                                      smoke=False)
    plan = derive_plan(layers, n_dev, kind)
    return decorate_decode_bundle(lower_partitioned(
        f"{name}.decode", layers, plan, lut, dsp, dev, bits_w_lut=4,
        bits_a=4, opt_level=0), spec)


def bundle_launches(mdp, executors, path: str, per_program) -> dict:
    """The launches of one traversal of a bundle, summed over its device
    programs (a one-sided shard launches its side's kernel): read from
    each device program by ``per_program(program, executor)[path]``."""
    want = collections.Counter()
    for prog, ex in zip(mdp.devices, executors):
        want.update(per_program(prog, ex)[path])
    return dict(want)


def shard_yardsticks(torch, ex, li: int, x):
    """A shard's code-width bound (:func:`bound_ms`) and its library call:
    ``torch._int_mm`` on its reconstructed int8 weights (staged through
    im2col for a conv shard, M padded to 32 for a decode shard), or
    ``F.conv2d(groups=C)`` for a depthwise one."""
    from repro_torch.compiler.runtime.base import im2col_patches
    lp = ex.program.layers[li]
    sw, wts = ex._split[li], ex._weights[li]
    codes = torch.cat([c for c in (wts.w_lut, wts.w_dsp) if c is not None],
                      dim=1)
    g, m, k = lp.geometry, lp.dims.m, lp.dims.k
    bound = bound_ms(x.numel(), m, k, sw.bits, sw.n_lut, sw.n_dsp)
    if lp.depthwise:
        lib = dw_conv2d_fn(torch, x, codes, sw.scale,
                           (g.kernel, g.stride, g.pad, g.out_hw))
    elif g is not None and tuple(x.shape) == g.in_shape:
        lib = int_mm_fn(torch, im2col_patches(x, g).reshape(m, k)
                        .contiguous(), codes, sw.scale)
    else:
        lib = int_mm_fn(torch, x, codes, sw.scale, min_m=32)
    return bound, lib


def shard_kernels(torch, executors, shards, what: str) -> dict:
    """Each shard's kernel launch (``shards``: (executor index, local
    layer, input, kernel name)) held bitwise to its plain version on the
    card, then timed (:func:`device_times`) beside its library call and
    with its code-width bound (:func:`shard_yardsticks`); returns, by
    kernel name, device ms per traversal of the kernels, the library
    calls and the bounds, and what bounds the sum."""
    fns, names, bounds = {}, {}, {}
    for i, (d, li, x, kname) in enumerate(shards):
        ex = executors[d]
        ex.mode = "ref"
        want = ex.run_layer(li, x)
        ex.mode = "auto"
        require_equal(torch, f"{what} shard dev{d} L{li} kernel vs plain",
                      ex.run_layer(li, x), want)
        fns[i] = (lambda e=ex, li=li, x=x: e.run_layer(li, x), 5)
        bounds[i], fns[("library", i)] = shard_yardsticks(torch, ex, li, x)
        fns[("library", i)] = (fns[("library", i)], 5)
        names[i] = kname
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        times = device_times(torch, fns)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    tot = {}
    for i, kname in names.items():
        t = tot.setdefault(kname, {"ms": 0.0, "library_ms": 0.0,
                                   "bound_ms": 0.0, "bytes": 0.0,
                                   "operations": 0.0})
        b_ms, b_by = bounds[i]
        t["ms"] += times[i]
        t["library_ms"] += times[("library", i)]
        t["bound_ms"] += b_ms
        t[b_by] += b_ms
    for t in tot.values():
        t["bound_by"] = "bytes" if t.pop("bytes") >= t.pop("operations") \
            else "operations"
    slow = sorted(names, key=times.get, reverse=True)[:3]
    print(f"multi: {what}: slowest shards " + "; ".join(
        f"dev{shards[i][0]} L{shards[i][1]} {names[i]} "
        f"{shard_shape(executors[shards[i][0]], shards[i][1])} "
        f"{1e3 * times[i]:.1f} us" for i in slow))
    return tot


def shard_shape(ex, li: int) -> str:
    """A shard's GEMM extents, split and the fused kernels' plan."""
    from repro_torch.kernels.fused_hetero_gemm import split_plan
    lp = ex.program.layers[li]
    n_dsp = lp.dims.n - lp.n_lut
    return (f"(M={lp.dims.m} K={lp.dims.k} n_lut={lp.n_lut} n_dsp={n_dsp}"
            f"{' depthwise' if lp.depthwise else ''}, plan "
            f"{tuple(split_plan(lp.dims.m, lp.dims.k, lp.n_lut, n_dsp))})")


def conv_kernel(lp) -> str:
    return "depthwise_gemm" if lp.depthwise else "fused_conv_gemm"


def decode_shards(torch, sess, gen) -> list:
    """Each shard of a decode bundle session's steady executors at its
    M = batch shape, on random int8 activations, for
    :func:`shard_kernels`."""
    shards = []
    for d, ex in enumerate(sess._steady_ex.executors):
        for lp in ex.program.layers:
            x = torch.randint(-8, 8, (lp.dims.m, lp.dims.k), generator=gen,
                              dtype=torch.int8).to("cuda")
            shards.append((d, lp.index, x, staged_kernel(lp)))
    return shards


def cnn_bundles(torch, out: dict) -> dict:
    """Full-width resnet18 and mobilenet_v2 bundles through
    ``MultiDeviceExecutor`` on the card, fused and ``fused=False``:
    every global layer and the logits bitwise equal to the single-device
    fused path, launches exactly the device programs'; then the CLI's
    bundle checksum. Returns the launches of the counted windows."""
    import os

    from repro_torch.compiler import MultiDeviceExecutor, compile_network, \
        execute_report
    from repro_torch.compiler.runtime.base import chain_layers
    from repro_torch.kernels.build import LAUNCHES
    launches = collections.Counter()
    for network, kind, n_dev in CNN_BUNDLES:
        single = SINGLE[network]
        ex, image, want = single["ex"], single["image"], single["logits"]
        tag = f"{network} {kind} x{n_dev}"
        t0 = time.time()
        mdp = compile_network(network, devices=n_dev, partition=kind)
        compile_s = time.time() - t0
        t0 = time.time()
        mexs = {"fused": MultiDeviceExecutor(mdp, backend="cuda"),
                "fused=False": MultiDeviceExecutor(mdp, backend="cuda",
                                                   fused=False)}
        for mex in mexs.values():
            for gi in range(mdp.n_layers):
                mex.bind_synthetic(gi, seed=gi)
        torch.cuda.synchronize()
        bind_s = time.time() - t0
        # every global layer (its shards joined) on the single-device
        # chain's own inputs
        inputs, outs = {}, {}

        def record(i, x):
            inputs[i] = x
            outs[i] = ex.run_layer(i, x)
            return outs[i]
        chain_layers(ex.program.layers, record, ex._as_codes(image))
        for gi, x in inputs.items():
            require_equal(torch, f"{tag} layer {gi} vs single-device",
                          mexs["fused"].run_layer(gi, x), outs[gi])
        row = {"compile_s": compile_s, "bind_s": bind_s,
               "single_ms": single["latency_ms"],
               "single_device_ms": single["device_ms"]}
        for path, mex in mexs.items():
            mex.run(image)
            torch.cuda.synchronize()
            per_image = bundle_launches(mdp, mex.executors, path,
                                        expected_launches)
            LAUNCHES.clear()
            lat, ys = [], []
            for _ in range(N_IMAGES):
                t0 = time.perf_counter()
                ys.append(mex.run(image))
                torch.cuda.synchronize()
                lat.append(1e3 * (time.perf_counter() - t0))
            counts = read_launches(LAUNCHES, per_image, N_IMAGES,
                                   f"{tag} {path}")
            for y in ys:
                require_equal(torch, f"{tag} {path} logits vs single-device",
                              y, want)
            launches.update(counts)
            # the single-device fused path timed beside the bundle, in
            # turns (the host clock moves from phase to phase)
            side = {"bundle": [], "single": []}
            for i in range(2 * N_IMAGES):
                who = "bundle" if i % 4 in (1, 2) else "single"
                run = mex.run if who == "bundle" else ex.run
                t0 = time.perf_counter()
                run(image)
                torch.cuda.synchronize()
                side[who].append(1e3 * (time.perf_counter() - t0))
            med = statistics.median(lat)
            side_med = {k: statistics.median(v) for k, v in side.items()}
            dev = busy_ms(torch, lambda m=mex: m.run(image), iters=4)
            row[path] = {"latency_ms": lat, "median_ms": med,
                         "device_ms": dev, "launches_per_image": per_image,
                         "in_turns_ms": side}
            print(f"multi: {tag} {path}: {N_IMAGES} images bitwise equal to "
                  f"the single-device logits; per-image latency median "
                  f"{med:.3f} ms ({', '.join(f'{v:.3f}' for v in lat)}); in "
                  f"turns with the single-device fused path: bundle "
                  f"{side_med['bundle']:.3f} ms, single "
                  f"{side_med['single']:.3f} ms; device "
                  f"{busy_text(dev, med)}; launches per image {per_image}")
        if kind == "filter":
            # the shards' kernels at their narrower shapes, beside the
            # single-device layers' kernels timed the same way
            fused = mexs["fused"]
            shards = []
            for gl in fused.layers:
                x = inputs[gl.index]
                for d, li, lo, hi in gl.placements:
                    x_d = x[..., lo:hi].contiguous() if gl.depthwise else x
                    shards.append((d, li, x_d, conv_kernel(gl)))
            row["shard_kernel_ms"] = shard_kernels(
                torch, fused.executors, shards, tag)
            row["single_kernel_ms"] = shard_kernels(
                torch, [ex], [(0, lp.index, inputs[lp.index],
                               conv_kernel(lp)) for lp in ex.program.layers],
                f"{network} single-device")
            print(f"multi: {tag}: kernel device ms per image, shards "
                  f"{row['shard_kernel_ms']} vs single-device "
                  f"{row['single_kernel_ms']}")
        print(f"multi: {tag}: compile {compile_s:.2f} s, bind (two "
              f"executors) {bind_s:.2f} s; every layer bitwise equal to the "
              f"single-device layer")
        out.setdefault("cnn", {})[tag] = row
        del mexs
    # the CLI on a bundle: the single-device run's checksum
    single_line = execute_report(SINGLE["resnet18"]["ex"].program,
                                 backend="cuda")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.compiler", "resnet18",
         "--devices", "2", "--partition", "filter", "--execute"],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    if proc.returncode != 0:
        raise AssertionError(f"compiler CLI on a bundle exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    bundle_line = proc.stdout.strip().splitlines()[-1]
    if "x2 devices" not in bundle_line or \
            bundle_line.split("|out| sum")[1] != \
            single_line.split("|out| sum")[1]:
        raise AssertionError(f"CLI bundle checksum: {bundle_line!r} vs "
                             f"single {single_line!r}")
    print(f"multi: cli resnet18 --devices 2 --partition filter --execute: "
          f"{bundle_line}; the single-device run's |out| sum")
    out["cli"] = {"bundle": bundle_line, "single": single_line}
    return dict(launches)


def decode_bundles(torch, out: dict) -> dict:
    """Full-width llama3.2-1b decode bundles (``filter`` and
    ``pipeline`` x 2) through ``ExecutorSession`` on the card, every
    step's logits bitwise equal to the single-device reference session,
    launches exactly the device programs' per step; at most two
    sessions held at once. Returns the launches of the counted
    windows."""
    import gc

    from repro_torch.compiler import ExecutorSession, ReferenceSession, \
        synthetic_decode_arrays
    from repro_torch.kernels.build import LAUNCHES
    name = "llama3.2-1b"
    t0 = time.time()
    prog = compile_decode(name, False)
    single_s = time.time() - t0
    t0 = time.time()
    arrays = synthetic_decode_arrays(prog.layers, prog.step,
                                     seed=DECODE["seed"])
    draw_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    ref = ReferenceSession(prog)
    ref.bind_arrays(arrays)
    LAUNCHES.clear()
    ref_logits, ref_ms = greedy(torch, ref, MULTI_STEPS)
    read_window(LAUNCHES, {}, f"{name} reference session")
    ref_peak = torch.cuda.max_memory_allocated()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    print(f"multi: {name} decode: single-device program compiled in "
          f"{single_s:.2f} s, codes drawn in {draw_s:.1f} s; reference "
          f"session {MULTI_STEPS} steps recorded (host ms median "
          f"{statistics.median(ref_ms[1:]):.1f}), peak device memory "
          f"{ref_peak / 2 ** 30:.2f} GiB; freed")
    rows = {"single_compile_s": single_s, "draw_s": draw_s,
            "ref_peak_bytes": ref_peak}
    launches = collections.Counter()
    gen = torch.Generator(device="cpu").manual_seed(29)
    for kind, n_dev in DECODE_BUNDLES:
        tag = f"{name} decode {kind} x{n_dev}"
        t0 = time.time()
        mdp = decode_bundle(name, kind, n_dev)
        compile_s = time.time() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        sess = ExecutorSession(mdp, backend="cuda")
        session_s = time.time() - t0
        t0 = time.time()
        sess.bind_arrays(arrays)
        torch.cuda.synchronize()
        bind_s = time.time() - t0
        per_step = bundle_launches(
            mdp, sess._warm_ex.executors, "fused",
            lambda p, _e: decode_launches(p))
        LAUNCHES.clear()
        logits, ms = greedy(torch, sess, MULTI_STEPS)
        counts = read_window(
            LAUNCHES, {k: v * MULTI_STEPS for k, v in per_step.items()},
            f"{tag}, {MULTI_STEPS} steps")
        for pos, (got, exp) in enumerate(zip(logits, ref_logits)):
            require_equal(torch, f"{tag} step {pos} vs reference", got, exp)
        launches.update(counts)
        steady = statistics.median(ms[1:])
        tok = logits[0].argmax(dim=-1)
        sess.reset()
        sess.step(tok, 0)
        dev = busy_ms(torch, lambda: sess.step(tok, 1), iters=3)
        kernel_ms = shard_kernels(torch, sess._steady_ex.executors,
                                  decode_shards(torch, sess, gen), tag)
        peak = torch.cuda.max_memory_allocated()
        rows[f"{kind} x{n_dev}"] = {
            "compile_s": compile_s, "session_s": session_s,
            "bind_s": bind_s, "host_ms": ms, "steady_ms": steady,
            "device_step_ms": dev, "launches_per_step": per_step,
            "kernel_ms_per_step": kernel_ms, "peak_bytes": peak}
        print(f"multi: {tag}: compiled in {compile_s:.2f} s, session "
              f"(steady_bundle + executors) {session_s:.2f} s, bound in "
              f"{bind_s:.1f} s; {MULTI_STEPS} steps bitwise equal to the "
              f"reference session; host ms warm-up {ms[0]:.3f}, steady "
              f"median {steady:.3f} ({', '.join(f'{v:.2f}' for v in ms[1:])}"
              f"); device per steady step {busy_text(dev, steady)}; "
              f"launches per step {per_step}; shard kernels device ms per "
              f"step {kernel_ms}; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB")
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    del arrays
    out["decode"] = rows
    return dict(launches)


def serve_line(text: str, prefix: str) -> str:
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    if len(lines) != 1:
        raise AssertionError(f"launcher printed {len(lines)} lines "
                             f"starting {prefix!r}:\n{text[-3000:]}")
    return lines[0]


def compiled_serving(torch, out: dict) -> dict:
    """``launch.serve --quantize ... --fleet 2`` as a user runs it, on the
    card and (``--smoke --device cpu``, the same programs) on the CPU:
    exit 0, the accel and fleet lines, the same image magics and lengths
    and the same compiled-session and fleet tokens. Then the same path
    in-process with its launches counted: one flash launch per prefill
    layer and the compiled session's kernels per step. Returns those
    launches."""
    import os

    from repro_torch.compiler import compile_decode_network
    from repro_torch.configs import registry
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = {}
    for where, extra in (("card", []), ("cpu", ["--smoke", "--device",
                                                  "cpu"])):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             *SERVE_ACCEL, *extra], capture_output=True, text=True,
            timeout=900, env=env, cwd=ROOT)
        secs = time.time() - t0
        if proc.returncode != 0:
            raise AssertionError(f"launch.serve {' '.join(SERVE_ACCEL + extra)}"
                                 f" exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        lines = {key: serve_line(proc.stdout, prefix) for key, prefix in (
            ("image", "# accel program "), ("decode", "# accel decode program"),
            ("session", "# accel decode session [cuda]"),
            ("fleet", "# fleet[2 workers]"), ("prefill", "prefill:"),
            ("decode_ms", "decode:"))}
        runs[where] = {"s": secs, "lines": lines}
        print(f"multi: launch.serve {' '.join(SERVE_ACCEL + extra)}: exit 0 "
              f"in {secs:.1f} s")
        for line in lines.values():
            print(f"multi:   {line}")

    def image(line):                     # magic and length of an image
        return re.search(r"(N3H\w+) (\d+) B", line).groups()

    def tokens(line):
        return line.split("tokens ")[-1]
    card, cpu = runs["card"]["lines"], runs["cpu"]["lines"]
    for key in ("image", "decode"):
        if image(card[key]) != image(cpu[key]):
            raise AssertionError(f"{key} image on the card {image(card[key])}"
                                 f" != on the CPU {image(cpu[key])}")
    # the fleet serves fixed prompts on both; the compiled session's
    # prompts are each run's own (full and smoke vocabularies). The
    # sessions' glue (softmax, silu) is not bitwise across devices, so
    # the fleet's tokens are compared, not required equal
    same = tokens(card["fleet"]) == tokens(cpu["fleet"])
    runs["fleet_tokens_equal_card_cpu"] = same
    print(f"multi: compiled serving: images {image(card['image'])} and "
          f"{image(card['decode'])} on the card and the CPU; fleet tokens "
          f"{'equal' if same else 'differ'} on the two")

    # in-process, launches counted: the quantized prefill (one flash
    # launch a layer) and the compiled decode session (its program's
    # kernels each step)
    cfg = registry.get("llama3.2-1b").model
    prog = compile_decode_network("llama3.2-1b", batch=1, max_seq=16,
                                  opt_level=1)
    n_steps = 4 + 4 - 1
    want = collections.Counter({"flash_attention": cfg.n_layers})
    for k, v in decode_launches(prog)["fused"].items():
        want[k] += v * n_steps
    LAUNCHES.clear()
    summary = serve.main(SERVE_ACCEL[:-2] + ["--new-tokens", "2"])
    torch.cuda.synchronize()
    counts = read_window(LAUNCHES, dict(want),
                         "launch.serve --quantize in-process")
    if tokens(card["session"]) != str(summary["accel_tokens"][0, 4:]
                                       .tolist()):
        raise AssertionError(f"in-process session tokens "
                             f"{summary['accel_tokens'].tolist()} != "
                             f"{card['session']}")
    print(f"multi: launch.serve --quantize in-process: launches {counts}; "
          f"prefill {summary['prefill_ms']:.3f} ms")
    out["serve"] = {"runs": runs, "launches": counts,
                    "inprocess_prefill_ms": summary["prefill_ms"]}
    return counts


def fleet_cuda(torch, out: dict) -> dict:
    """``FleetServer`` with a subprocess and a thread ``cuda`` worker on
    the card: each request's tokens bitwise equal to a single-request
    ``ExecutorSession`` on the card, under the continuous and the serial
    policy; continuous must serve more requests/s. Returns the thread
    worker's launches (the subprocess's are its own)."""
    import numpy as np
    from repro_torch.compiler import ExecutorSession, compile_decode_network
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve.engine import greedy_generate_compiled
    from repro_torch.serve.fleet import FleetServer
    prog = compile_decode_network(FLEET["arch"], batch=1,
                                  max_seq=FLEET["max_seq"], opt_level=1)
    oracle = ExecutorSession(prog, backend="cuda")
    oracle.bind_synthetic_all(seed=FLEET["seed"])
    want = [greedy_generate_compiled(oracle, np.array([p], np.int32),
                                     n)[0].numpy()
            for p, n in FLEET_REQUESTS]
    n_tok = sum(n for _, n in FLEET_REQUESTS)
    res, launches = {}, collections.Counter()
    for policy in ("continuous", "serial"):
        t0 = time.time()
        with FleetServer(FLEET["arch"], [("w0", "cuda", "subprocess"),
                                         ("w1", "cuda", "thread")],
                         batch_slots=FLEET["batch_slots"],
                         max_seq=FLEET["max_seq"], seed=FLEET["seed"],
                         policy=policy) as fleet:
            start_s = time.time() - t0
            for f in [fleet.submit([1], 1) for _ in range(4)]:   # warm-up
                f.result(600)
            LAUNCHES.clear()
            t0 = time.perf_counter()
            futs = [fleet.submit(p, n) for p, n in FLEET_REQUESTS]
            rows = [f.result(600) for f in futs]
            secs = time.perf_counter() - t0
            counts = {k: v for k, v in LAUNCHES.items() if v}
        for i, (row, exp) in enumerate(zip(rows, want)):
            if not np.array_equal(row, exp):
                raise AssertionError(f"fleet {policy} request {i}: tokens "
                                     f"{row.tolist()} != single session "
                                     f"{exp.tolist()}")
        launches.update(counts)
        res[policy] = {"s": secs, "req_per_s": len(rows) / secs,
                       "tok_per_s": n_tok / secs, "start_s": start_s,
                       "thread_worker_launches": counts}
        print(f"multi: fleet {policy} (w0 cuda subprocess, w1 cuda thread, "
              f"2 slots each; started in {start_s:.1f} s): "
              f"{len(rows)} requests in {1e3 * secs:.1f} ms, "
              f"{len(rows) / secs:.2f} req/s, {n_tok / secs:.1f} new tok/s; "
              f"tokens bitwise equal to a single-request session on the "
              f"card; thread worker launches {counts}")
    if not res["continuous"]["req_per_s"] > res["serial"]["req_per_s"]:
        raise AssertionError(f"continuous batching {res['continuous']} not "
                             f"faster than serial {res['serial']}")
    out["fleet"] = res
    return dict(launches)


def bundle_fleet(torch, out: dict) -> dict:
    """``BundleFleet`` with two ``cuda`` thread workers on a 2-device
    ``filter`` and ``pipeline`` FC bundle: bitwise equal to the
    in-process ``MultiDeviceExecutor`` on the card, launches exactly the
    device programs'. Returns those launches."""
    import numpy as np
    from repro_torch.compiler import GemmLayer, MultiDeviceExecutor, \
        derive_plan, from_bundle_binary, lower_partitioned, to_bundle_binary
    from repro_torch.core.scheduler import GemmDims
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve.fleet import BundleFleet
    lut, dsp, dev = compiler_cfgs()
    layers = [GemmLayer(f"fc{i}", GemmDims(*d))
              for i, d in enumerate(FC_CHAIN)]
    x = np.random.default_rng(0).integers(
        -8, 8, FC_CHAIN[0][:2]).astype(np.int8)
    launches, res = collections.Counter(), {}
    for kind in ("filter", "pipeline"):
        mdp = lower_partitioned("fc", layers, derive_plan(layers, 2, kind),
                                lut, dsp, dev, bits_w_lut=4, bits_a=4,
                                opt_level=1)
        image = to_bundle_binary(mdp)
        mex = MultiDeviceExecutor(from_bundle_binary(image), backend="cuda")
        for gi in range(mdp.n_layers):
            mex.bind_synthetic(gi)
        want = mex.run(x).cpu()
        per_run = bundle_launches(mdp, mex.executors, "fused",
                                  lambda p, _e: decode_launches(p))
        with BundleFleet(image, seed=None, backends=["cuda", "cuda"]) as bf:
            bf.run(x)
            LAUNCHES.clear()
            ms, got = [], None
            for _ in range(5):
                t0 = time.perf_counter()
                got = bf.run(x)
                ms.append(1e3 * (time.perf_counter() - t0))
            counts = read_launches(LAUNCHES, per_run, 5,
                                   f"BundleFleet {kind}")
        require_equal(torch, f"BundleFleet {kind} vs MultiDeviceExecutor",
                      torch.from_numpy(got), want)
        launches.update(counts)
        res[kind] = {"ms": ms, "median_ms": statistics.median(ms),
                     "launches_per_run": per_run}
        print(f"multi: BundleFleet {kind} x2 (cuda thread workers, FC chain "
              f"{FC_CHAIN}): bitwise equal to MultiDeviceExecutor; "
              f"{statistics.median(ms):.3f} ms per run "
              f"({', '.join(f'{v:.3f}' for v in ms)}); launches per run "
              f"{per_run}")
    out["bundle_fleet"] = res
    return dict(launches)


def phase_multi(torch, details: dict) -> dict:
    """Multi-device bundles and compiled serving on the card: the CNN
    bundles, the llama3.2-1b decode bundles, ``launch.serve --quantize
    ... --fleet 2``, a ``cuda`` fleet and ``BundleFleet``. Returns the
    launches of every counted window, per kernel."""
    out = details.setdefault("multi", {})
    launches = collections.Counter()
    for part in (cnn_bundles, decode_bundles, compiled_serving, fleet_cuda,
                 bundle_fleet):
        t0 = time.time()
        launches.update(part(torch, out))
        out.setdefault("part_s", {})[part.__name__] = time.time() - t0
        print(f"multi: {part.__name__} {time.time() - t0:.1f} s")
    return dict(launches)


#: the co-design phase's HeteroLinear layers, (name, m, k, n, w_bits,
#: a_bits, ratio): the layer of examples/quickstart.py, and llama3.2-1b's
#: MLP up-projection (the ``llama1b.mlp`` row of
#: benchmarks/tpu_hetero.py) at ratio 0.5 and (None) at the ratio
#: ``solve_tpu_split(spatial=True)`` gives on ``H100_SXM``
HETERO = [("quickstart", 16, 256, 192, 6, 8, 0.4),
          ("llama1b.mlp", 4096, 2048, 8192, 4, 4, 0.5),
          ("llama1b.mlp solved", 4096, 2048, 8192, 4, 4, None)]
#: ``apply_deploy`` vs ``apply_qat`` on the card: max |diff| within this
#: fraction of max |y| (the JAX package's own check)
QAT_DEPLOY_TOL = 1e-4
#: the README's search: ``python -m repro_torch.dse --network
#: llama3.2-1b --seq-len 16 --target 1.0 --episodes 12
#: --simulate-elites --top-k 3``
DSE_README = dict(network="llama3.2-1b", seq_len=16, target_latency_ms=1.0,
                  episodes=12, simulate_elites=True, top_k=3)
#: the measured-accuracy search of tests/test_accuracy_eval.py
DSE_MEASURED = dict(episodes=4, sim_every=2, top_k=2, simulate_elites=True,
                    target_latency_ms=50.0, seed=0)
DSE_ACCURACY = dict(n_samples=16, batch=16, train_steps=15)
#: golden's verify of a full-width design point is run when it would
#: take at most this many seconds (golden's µs per tile measured on the
#: reduced winner times the full-width program's tiles)
GOLDEN_VERIFY_S = 60.0
QAT_STEPS = 6


def hetero_layer(torch, name, m, k, n, w_bits, a_bits, ratio, out: dict):
    """One HeteroLinear layer deployed on the card: ``apply_deploy``'s
    launches, bitwise checks and tolerance, then each side's kernel timed
    on the deployed codes. Returns (deployed, x_q, launches)."""
    from repro_torch.core import hetero_linear as hl
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitserial_gemm import bitserial_gemm, \
        bitserial_gemm_plain
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.int4_gemm import int4_gemm, int4_gemm_plain
    from repro_torch.quant import LayerQuantConfig
    from repro_torch.quant.uniform import fit_scale, qrange
    cfg = hl.HeteroLinearConfig(
        k, n, LayerQuantConfig(w_bits_lut=w_bits, a_bits=a_bits,
                               ratio=0.5 if ratio is None else ratio),
        solve_ratio=ratio is None, spatial=True)
    params = hl.init_hetero_linear(torch.Generator().manual_seed(0), cfg)
    x = (0.5 * torch.randn((m, k), generator=torch.Generator().manual_seed(
        1))).cuda()
    t0 = time.perf_counter()
    d = hl.deploy(params, cfg)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    n_ser = d.wq_serial.shape[1]
    LAUNCHES.clear()
    y = hl.apply_deploy(d, x)
    torch.cuda.synchronize()
    want = {kn: 1 for kn, cols in (("bitserial_gemm", n_ser),
                                   ("int4_gemm", n - n_ser)) if cols}
    launches = read_window(LAUNCHES, want, f"apply_deploy {name}")
    require_equal(torch, f"apply_deploy {name} vs mode=ref", y,
                  hl.apply_deploy(d, x, mode="ref"))
    y_cpu = hl.apply_deploy(d.to("cpu"), x.cpu())
    if not torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32)):
        raise AssertionError(f"apply_deploy {name}: card != CPU run")
    y_qat = hl.apply_qat(params, x, cfg)
    qat_err = float((y - y_qat).abs().max() / y_qat.abs().max())
    if not qat_err <= QAT_DEPLOY_TOL:
        raise AssertionError(f"apply_deploy {name} vs apply_qat: {qat_err}")
    # the kernels alone on the deployed codes, at this shape
    s_a = fit_scale(x, a_bits)
    x_q = torch.clamp(torch.round(x / s_a), *qrange(a_bits)).to(torch.int8)
    sw = ops.prepare_split(k, d.wq_serial, d.s_serial, w_bits,
                           d.wq_parallel, d.s_parallel, x_q.device)
    rows = {}
    for kname, (n_lut, n_dsp), kern, plain, codes, scale in (
            ("bitserial_gemm", (n_ser, 0),
             lambda: bitserial_gemm(x_q, sw.lut_words, sw.s_lut, w_bits,
                                    n_ser),
             lambda: bitserial_gemm_plain(x_q, sw.lut_words, sw.s_lut,
                                          w_bits, n_ser),
             d.wq_serial, d.s_serial),
            ("int4_gemm", (0, n - n_ser),
             lambda: int4_gemm(x_q, sw.dsp_words, sw.s_dsp, n - n_ser),
             lambda: int4_gemm_plain(x_q, sw.dsp_words, sw.s_dsp, n - n_ser),
             d.wq_parallel, d.s_parallel)):
        if not n_lut + n_dsp:
            continue
        err = require_equal(torch, f"{kname} {name}", kern(), plain())
        b_ms, b_by = bound_ms(x_q.numel(), m, k, w_bits, n_lut, n_dsp)
        rows[kname] = {
            "n": n_lut + n_dsp, "max_abs_err": err, "bound_ms": b_ms,
            "bound_by": b_by,
            **device_times(torch, {
                "ms": (kern, 5), "plain_ms": (plain, 2),
                "library_ms": (int_mm_fn(torch, x_q, codes, scale), 5)})}
    out.setdefault("hetero", {})[name] = {
        "m": m, "k": k, "n": n, "w_bits": w_bits, "a_bits": a_bits,
        "ratio": cfg.resolved_ratio(), "n_serial": n_ser,
        "deploy_s": deploy_s, "qat_rel_err": qat_err, "launches": launches,
        "kernels": rows}
    print(f"codesign: HeteroLinear {name} (m={m} k={k} n={n} w{w_bits}/"
          f"a{a_bits} ratio {cfg.resolved_ratio():.4f}: {n_ser} serial / "
          f"{n - n_ser} int4 columns): deploy {deploy_s:.2f} s; "
          f"apply_deploy launches {launches}, bitwise equal to mode=ref and "
          f"the CPU run, vs apply_qat {qat_err:.2e} of max |y|; " + "; ".join(
              f"{kn} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, _int_mm "
              f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})" for kn, r in rows.items()))
    return d, x_q, launches


def deployed_program(torch, d, x_q, name, bits_a, out: dict) -> dict:
    """A one-layer FC program of the deployed layer's shape, bound with
    ``bind_deployed``: ``run_layer`` launches ``fused_hetero_gemm`` once
    and is bitwise equal to ``hetero_matmul``'s LUT-first output; the
    kernel timed on the executor's weights."""
    from repro_torch.compiler import CudaExecutor
    from repro_torch.compiler.lower import lower_network
    from repro_torch.compiler.program import GemmLayer
    from repro_torch.core.scheduler import GemmDims
    from repro_torch.kernels import hetero_matmul
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.fused_hetero_gemm import fused_hetero_gemm, \
        fused_hetero_gemm_plain
    m, k = x_q.shape
    n_lut = d.wq_serial.shape[1]
    n = n_lut + d.wq_parallel.shape[1]
    t0 = time.perf_counter()
    prog = lower_network(name, [GemmLayer(name, GemmDims(m, k, n))],
                         *compiler_cfgs(), bits_w_lut=d.bits_serial,
                         bits_a=bits_a, n_luts=[n_lut])
    lower_s = time.perf_counter() - t0
    ex = CudaExecutor(prog)
    ex.bind_deployed(0, d)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    got = ex.run_layer(0, x_q)
    torch.cuda.synchronize()
    launches = read_window(LAUNCHES, {"fused_hetero_gemm": 1},
                           f"bind_deployed {name}")
    want = hetero_matmul(x_q, d.wq_serial, d.s_serial, d.bits_serial,
                         d.wq_parallel, d.s_parallel)
    err = require_equal(torch, f"bind_deployed {name} vs hetero_matmul",
                        got, want)
    sw, wts = ex._split[0], ex._weights[0]
    args = (x_q, sw.planes, sw.packed, sw.scale, sw.bits, sw.n_lut, sw.n_dsp)
    require_equal(torch, f"fused_hetero_gemm {name}",
                  fused_hetero_gemm(*args), fused_hetero_gemm_plain(*args))
    b_ms, b_by = bound_ms(x_q.numel(), m, k, sw.bits, sw.n_lut, sw.n_dsp)
    codes = torch.cat([wts.w_lut, wts.w_dsp], dim=1)
    row = {"m": m, "k": k, "n_lut": n_lut, "n": n, "lower_s": lower_s,
           "n_instructions": prog.n_instructions, "launches": launches,
           "max_abs_err": err, "bound_ms": b_ms, "bound_by": b_by,
           **device_times(torch, {
               "ms": (lambda: fused_hetero_gemm(*args), 5),
               "plain_ms": (lambda: fused_hetero_gemm_plain(*args), 2),
               "library_ms": (int_mm_fn(torch, x_q, codes, sw.scale), 5)})}
    out["bind_deployed"] = row
    print(f"codesign: bind_deployed {name}: one-layer FC program "
          f"({prog.n_instructions} instructions, lowered in {lower_s:.2f} s) "
          f"launches {launches}, bitwise equal to hetero_matmul; "
          f"fused_hetero_gemm {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f}, _int_mm {row['library_ms']:.4f}, bound "
          f"{b_ms:.4f} by {b_by})")
    return launches


def verify_window(torch, ev, info, what: str) -> dict:
    """``ProgramEvaluator.verify`` (golden vs ``CudaExecutor``, both on
    the card) in a launch window: the kernels' executor launches each
    layer's staged kernel once (golden launches none)."""
    from repro_torch.kernels.build import LAUNCHES
    prog = ev._entry(ev.config_key(info), info)[0][0]
    want = collections.Counter(
        "grouped_gemm" if lp.depthwise else staged_kernel(lp)
        for lp in prog.layers)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    ok = ev.verify(info)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"verify {what}: golden != cuda")
    launches = read_window(LAUNCHES, dict(want), f"verify {what}")
    print(f"codesign: verify {what}: golden == cuda on every layer of the "
          f"winner's program ({len(prog.layers)} layers, {n_tiles(prog)} "
          f"golden tiles) in {secs:.2f} s; launches {launches}")
    return launches, secs, n_tiles(prog)


def readme_search(torch, out: dict) -> dict:
    """The README's search through the port's ``run_search`` with the
    agent on the card, then ``verify`` of its winner."""
    from repro_torch.core.scheduler import XC7Z020
    from repro_torch.dse import SIM_GAP_TOL_PCT, ProgramEvaluator, \
        gemm_specs, run_search
    t0 = time.perf_counter()
    res = run_search(**DSE_README)
    wall = time.perf_counter() - t0
    if res.reward_source != "simulated" or \
            not abs(res.sim_gap_pct) <= SIM_GAP_TOL_PCT:
        raise AssertionError(f"README search: source {res.reward_source}, "
                             f"gap {res.sim_gap_pct}")
    info = res.best_info
    print(f"codesign: README search ({DSE_README['network']}, seq "
          f"{DSE_README['seq_len']}, {DSE_README['episodes']} episodes, "
          f"agent on the card) in {wall:.2f} s (run_search's own "
          f"{res.wall_s:.2f}): best reward {res.best_reward:+.4f} "
          f"({res.reward_source}); analytical {res.analytical_latency_ms:.4f}"
          f" ms vs simulated {res.simulated_latency_ms:.4f} ms, gap "
          f"{res.sim_gap_pct:+.2f}% (tolerance {SIM_GAP_TOL_PCT}%); program "
          f"cache {res.evaluator_cache}; winner bits {info['bw_lut']}, "
          f"a-bits {info['ba']}, ratios "
          f"{[round(r, 4) for r in info['ratios']]}")
    ev = ProgramEvaluator(gemm_specs(DSE_README["network"],
                                     seq_len=DSE_README["seq_len"]),
                          XC7Z020, DSE_README["target_latency_ms"])
    launches, secs, tiles = verify_window(torch, ev, info, "README winner")
    out["readme_search"] = {
        "wall_s": wall, "best_reward": res.best_reward,
        "reward_source": res.reward_source,
        "analytical_ms": res.analytical_latency_ms,
        "simulated_ms": res.simulated_latency_ms,
        "gap_pct": res.sim_gap_pct, "cache": res.evaluator_cache,
        "bw_lut": info["bw_lut"], "ba": info["ba"], "ratios": info["ratios"],
        "verify_s": secs, "verify_tiles": tiles}
    return launches


def measured_search(torch, out: dict) -> dict:
    """The measured-accuracy search on reduced resnet18 through
    ``CudaExecutor`` on the card, ``fused_conv_gemm`` launches read
    around it; ``verify`` of its winner; the winner's design point at
    full width verified by golden or held on the kernels against
    ``mode="ref"`` (:data:`GOLDEN_VERIFY_S`)."""
    import numpy as np

    from repro_torch.compiler import CudaExecutor, bind_synthetic
    from repro_torch.core.scheduler import XC7Z020
    from repro_torch.core.workloads import resnet18_specs
    from repro_torch.dse import AccuracyProxy, ProgramEvaluator, \
        evaluate_config, run_search
    from repro_torch.eval.accuracy import make_accuracy_fn
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models import cnn
    from repro_torch.quant.uniform import qrange
    cfg = cnn.reduced_config("resnet18")
    t0 = time.perf_counter()
    fn = make_accuracy_fn(cfg, backend="cuda", **DSE_ACCURACY)
    train_s = time.perf_counter() - t0
    programs = []

    def counted(program):
        programs.append(program)
        return fn(program)
    torch.cuda.synchronize()
    LAUNCHES.clear()
    t0 = time.perf_counter()
    res = run_search("resnet18", specs=cnn.specs_for(cfg),
                     accuracy_fn=counted, **DSE_MEASURED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = collections.Counter()
    for prog in programs:
        for name, count in harness_launches(prog).items():
            want[name] += count * DSE_ACCURACY["n_samples"]
    launches = read_window(LAUNCHES, dict(want), "measured-accuracy search")
    if res.reward_source != "measured" or not res.elites or any(
            r["reward_source"] != "measured" or r["measured_acc"] is None
            for r in res.elites):
        raise AssertionError(f"measured search: {res.reward_source} "
                             f"{res.elites}")
    info = res.best_info
    print(f"codesign: measured-accuracy search (reduced resnet18, "
          f"{DSE_MEASURED['episodes']} episodes, reference trained "
          f"{DSE_ACCURACY['train_steps']} steps in {train_s:.2f} s) in "
          f"{wall:.2f} s: {len(programs)} programs measured over "
          f"{DSE_ACCURACY['n_samples']} images each, launches {launches}; "
          f"winner reward {res.best_reward:+.4f} (measured agreement "
          f"{info['measured_acc']:.2f}%, simulated {info['simulated_latency_ms']:.4f}"
          f" ms); elites' measured agreement "
          f"{[r['measured_acc'] for r in res.elites]}")
    ev = ProgramEvaluator(cnn.specs_for(cfg), XC7Z020,
                          DSE_MEASURED["target_latency_ms"])
    v_launches, v_secs, v_tiles = verify_window(torch, ev, info,
                                                "reduced resnet18 winner")
    for name, count in v_launches.items():
        launches[name] = launches.get(name, 0) + count
    # the winner's design point at full width
    specs = resnet18_specs()
    proxy = AccuracyProxy()
    bw = [8 if s.is_first or s.is_last else b
          for s, b in zip(specs, info["bw_lut"])]
    ba = [8 if s.is_first or s.is_last else b
          for s, b in zip(specs, info["ba"])]
    _r, full_info = evaluate_config(specs, info["lut_cfg"], info["dsp_cfg"],
                                    XC7Z020, bw, ba, proxy, 1e9, 0.01)
    ev_full = ProgramEvaluator(specs, XC7Z020, 1e9)
    t0 = time.perf_counter()
    prog = ev_full._entry(ev_full.config_key(full_info), full_info)[0][0]
    compile_s = time.perf_counter() - t0
    est = v_secs / max(v_tiles, 1) * n_tiles(prog)
    row = {"compile_s": compile_s, "tiles": n_tiles(prog),
           "golden_estimate_s": est}
    if est <= GOLDEN_VERIFY_S:
        row["how"] = "verify (golden vs cuda)"
        full_launches, row["verify_s"], _ = verify_window(
            torch, ev_full, full_info, "full-width resnet18 design point")
        for name, count in full_launches.items():
            launches[name] = launches.get(name, 0) + count
    else:
        row["how"] = "layer by layer on the kernels vs mode=ref"
        gen = np.random.default_rng(0)
        kern, plain = CudaExecutor(prog), CudaExecutor(prog, mode="ref")
        for lp in prog.layers:
            bind_synthetic(kern, lp, seed=lp.index)
            bind_synthetic(plain, lp, seed=lp.index)
            lo, hi = qrange(lp.bits_a)
            x_q = torch.from_numpy(gen.integers(
                lo, hi + 1, (lp.dims.m, lp.dims.k)).astype(np.int8)).cuda()
            require_equal(torch, f"full-width winner layer {lp.name}",
                          kern.run_layer(lp.index, x_q),
                          plain.run_layer(lp.index, x_q))
    print(f"codesign: the winner's design point at full-width resnet18 "
          f"(lut {info['lut_cfg']}, compiled in {compile_s:.2f} s, "
          f"{row['tiles']} golden tiles, golden estimated at {est:.1f} s "
          f"from the reduced verify): checked by {row['how']}")
    out["measured_search"] = {
        "train_s": train_s, "wall_s": wall, "programs": len(programs),
        "best_reward": res.best_reward, "measured_acc": info["measured_acc"],
        "elites": res.elites, "verify_s": v_secs, "full_width": row}
    return launches


def qat_steps(torch, out: dict) -> None:
    """:data:`QAT_STEPS` QAT steps of reduced resnet18 on the card (w8/a8,
    ratio 0.5, SGD 0.05, one batch): the loss falls."""
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.models import cnn
    from repro_torch.quant import LayerQuantConfig
    cfg = cnn.reduced_config("resnet18")
    qcfgs = [LayerQuantConfig(w_bits_lut=8, a_bits=8, ratio=0.5)
             for _ in cnn.specs_for(cfg)]
    p = {name: {k: v.cuda() for k, v in layer.items()} for name, layer in
         cnn.init(cfg, torch.Generator().manual_seed(0)).items()}
    batch = SyntheticImages(10, 16, 32, seed=0).next_batch()
    x, y = batch["images"].cuda(), batch["labels"].cuda()
    losses = []
    t0 = time.perf_counter()
    for _ in range(QAT_STEPS):
        for leaf in (v for layer in p.values() for v in layer.values()):
            leaf.requires_grad_(True)
        loss = cnn.cross_entropy(cnn.forward(p, x, cfg, qcfgs), y)
        loss.backward()
        with torch.no_grad():
            p = {name: {k: v - 0.05 * v.grad for k, v in layer.items()}
                 for name, layer in p.items()}
        losses.append(float(loss.detach()))
    secs = time.perf_counter() - t0
    if not losses[-1] < losses[0]:
        raise AssertionError(f"QAT loss did not fall: {losses}")
    out["qat"] = {"losses": losses, "s": secs}
    print(f"codesign: {QAT_STEPS} QAT steps of reduced resnet18 on the card "
          f"(hybrid fake quant w8/a8, ratio 0.5) in {secs:.2f} s: loss "
          f"{' -> '.join(f'{v:.4f}' for v in losses)}")


def phase_codesign(torch, details: dict) -> dict:
    """The co-design loop on the card (phase 11). Returns the launches of
    every counted window, per kernel."""
    out = details.setdefault("codesign", {})
    launches = collections.Counter()
    for name, m, k, n, w_bits, a_bits, ratio in HETERO:
        d, x_q, counts = hetero_layer(torch, name, m, k, n, w_bits, a_bits,
                                      ratio, out)
        launches.update(counts)
        if name == "llama1b.mlp":
            launches.update(deployed_program(torch, d, x_q, name, a_bits,
                                             out))
        del d, x_q
    for part in (readme_search, measured_search):
        t0 = time.time()
        launches.update(part(torch, out))
        out.setdefault("part_s", {})[part.__name__] = time.time() - t0
    qat_steps(torch, out)
    return dict(launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the card, build time, ptxas reports, "
                         "per-layer timings with each launch's plan, the "
                         "corners, per-image latencies of the fused and "
                         "fused=False paths, per-path launches (resnet18, "
                         "and mobilenet_v2 under its own key), the flash "
                         "shape sweep, the serving run's windows, tokens "
                         "and times, and the decode sessions' step times, "
                         "windows and per-shape kernel times as JSON here")
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

    t_start = time.time()
    details: dict = {"phase_s": {}}

    def phase(name, fn, *args):
        t0 = time.time()
        result = fn(*args)
        details["phase_s"][name] = time.time() - t0
        print(f"time: phase {name} {details['phase_s'][name]:.1f} s")
        return result

    phase("card", phase_card, torch, details)
    t0 = time.time()
    prog = compile_network("resnet18")
    print(f"compile: resnet18 224 -O 0, {len(prog.layers)} layers, "
          f"fingerprint {prog.fingerprint()[:12]}, {time.time() - t0:.2f} s")
    ex = CudaExecutor(prog)
    for lp in prog.layers:
        bind_synthetic(ex, lp, seed=lp.index)
    tot = phase("kernels", phase_kernels, torch, prog, ex, details)
    counts = path_launches(phase("slice", phase_slice, torch, prog, ex,
                                 details), KERNEL_PATH)
    tot["depthwise_gemm"], counts["depthwise_gemm"] = phase(
        "mobilenet_v2", phase_mobilenet, torch,
        details.setdefault("mobilenet_v2", {}))
    for t in tot.values():
        t["bound_by"] = "bytes" if t["bytes"] >= t["operations"] \
            else "operations"
    tot["flash_attention"] = phase("flash", phase_flash, torch, details)
    counts["flash_attention"] = phase("serve", phase_serve, torch, details)
    decode_counts = phase("decode", phase_decode, torch, details)
    for name in DECODE_KERNELS:
        if not decode_counts.get(name):
            raise AssertionError(f"{name} not launched on the decode path "
                                 f"({decode_counts})")
        counts[name] += decode_counts[name]
    phase("golden", phase_golden, torch, prog, details)
    harness = phase("accuracy", phase_accuracy, torch, details)
    print(f"accuracy: harness launches over its measure() runs {harness}")
    multi = phase("multi", phase_multi, torch, details)
    print(f"multi: launches over the phase's counted windows {multi}")
    codesign = phase("codesign", phase_codesign, torch, details)
    print(f"codesign: launches over the phase's counted windows {codesign}")
    for name in ("fused_conv_gemm", "fused_hetero_gemm", "bitserial_gemm",
                 "int4_gemm"):
        if not codesign.get(name):
            raise AssertionError(f"{name} not launched on the co-design "
                                 f"path ({codesign})")
        counts[name] += codesign[name]
    for name in ("fused_conv_gemm", "fused_hetero_gemm", "bitserial_gemm",
                 "int4_gemm", "flash_attention", "depthwise_conv_gemm"):
        if not multi.get(name):
            raise AssertionError(f"{name} not launched on the multi-device "
                                 f"path ({multi})")
        counts["depthwise_gemm" if name == "depthwise_conv_gemm"
               else name] += multi[name]
    kernels = []
    for name, replaces in REPLACES.items():
        t = tot[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    details["total_s"] = time.time() - t_start
    print(f"total: {details['total_s']:.1f} s")
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
