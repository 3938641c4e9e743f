#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing its lines before the last:

1. card: ``nvidia-smi`` name and power limit; build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` (``fused_split_gemm.cu``,
   ``split_gemm.cu``, ``depthwise_gemm.cu``, ``flash_attention.cu``,
   ``flash_attention_bwd.cu`` and ``flash_attention_f32.cu``, one nvcc
   each, started together), time
   the build and print ptxas's register, shared-memory and spill
   report.
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
   at twenty-three shapes (:data:`FLASH_SHAPES`): the serving prefill (B=8,
   S=64, 32 query heads
   over 8 KV heads, D=64, causal), S=2048 causal, S=1000 causal
   (ragged), S=333 non-causal, 64 queries at offset 960 of 1024 keys,
   one query at offset 1023 (decode), S=512 causal at D=128 with 16
   query and 16 KV heads, 4 queries at offset 997 of 1001 keys (the
   decode form's 16-row edge), and the archs phase's: D=256 at gemma-7b's
   prefill (16/16 heads), ragged at S=1000 and in the decode form,
   yi-34b's GQA 56/8, qwen3-8b's 32/8 and qwen3-moe-235b-a22b's 64/4 at
   D=128, deepseek-v2's MLA with keys of 192 over values of 128 (its
   prefill at 128/128 heads, ragged at S=1000, and the decode form), and
   seamless-m4t's non-causal encoder / cross-attention prefill and its
   decode step's cross-attention (Sq=1 over 64 keys, the decode form
   without a causal mask), and phase 14's local heads (llama3.2-1b's
   prefill at 16 over 4, seamless's encoder, decoder and a cross shape
   at 8 over 8), each with the plan it ran under
   (``flash_attention.flash_plan``: form, grid, shared memory). Required:
   max |err|
   within :func:`flash_tol`, and every output row within
   :data:`FLASH_ROW_TOL` of its plain row's norm (:func:`flash_row_err`).
   Times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` on the KV heads repeated (the
   library yardstick): device time per call (:func:`device_times`; the
   kernels' row reports these), and CUDA
   events over back-to-back calls, which at small shapes measure the
   host's launch rate. The bound: q, k, v and out once over 3.35 TB/s
   vs 2·B·Hq·(D + DV)·(unmasked pairs) over 989 TFLOP/s bf16.
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
6b. archs: the other archs the launcher serves, each at :data:`SERVE`'s
   batch, prompt and seed with :data:`ARCHS_NEW` new tokens, one model
   on the card at a time
   (:data:`ARCHS`), every one at its published widths and all but
   seamless at a cut depth: qwen3-8b (GQA 32/8, qk-norm) at 8 of its 36
   layers, gemma-7b (head size 256, GeGLU, tied 256000-token
   vocabulary) at 8 of 28, mamba2-780m at 12 of 48, yi-34b at 4 of 60,
   qwen3-moe-235b-a22b (128 experts top 8 on every layer, GQA 64/4) at
   2 of 94, jamba-v0.1-52b at one period of 8 layers (7 Mamba, 1
   attention, 4 MoE of 16 experts top 2, 4 dense FFNs), deepseek-v2-236b
   (MLA, 160 experts top 6 + 2 shared) at 2 of 60 (the dense first
   layer and one MoE layer), qwen2-vl-2b (M-RoPE over text positions,
   tied embeddings) at 8 of 28, and seamless-m4t-large-v2 (24 encoder +
   24 decoder layers, fed the
   launcher's seeded frames, ``launch.serve.encdec_frames``) whole. Each
   runs once through ``launch.serve.main`` and once through the engine,
   each in launch windows of its own. Required: exactly the
   ``flash_attention`` launches :func:`flash_per_call` reads from the
   code, per prefill and per decode step (``n_layers`` a prefill and none
   a decode step for the LMs, 96 and 24 for seamless), and none with
   ``mode="ref"`` (its decode too); none at all for mamba2-780m and
   jamba-v0.1-52b (whose prompt attention is ``dense_attention``, as in
   the reference; no kernel, no fallback); the checks and times of phase
   6 (the same function, :func:`serve_arch`). For the MoE archs the
   (token, expert) slot assignments of every MoE layer in the kernel
   prefill and the ``mode="ref"`` one are recorded
   (:func:`recorded_routing`) and their differences printed before the
   logits check. qwen3-8b also decodes
   :data:`KV_QUANT_STEPS` steps with the int8 KV cache beside the bf16
   one on the same tokens (relative logit difference printed). Times:
   prefill (median of 3), decode per step, their busy shares, peak
   device memory of the launcher's run and of the engine's.

7. decode: decode sessions (``compiler/runtime/session.py``) on the
   card. Full-width llama3.2-1b cut to 2 of its 16 blocks (15 layers)
   and mamba2-780m cut to 6 of its 48 layers (25 layers)
   (:data:`DECODE_LAYERS`), and jamba-v0.1-52b at its smoke config (at
   52 B parameters its full width does not fit one card), each compiled
   as
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
   full-width mobilenet_v2 image at :data:`GOLDEN_MOBILENET_HW` the same
   way; then a weight fetch
   planted at another layer's segment must raise ``ExecutionError``.
   Times: seconds per image.
9. accuracy: a convolution inside ``models.cnn.fp32_convs`` against
   float64 (required within 1e-5 of max |out|, which TF32 is not); then
   ``repro_torch.eval.accuracy.measure`` (train the fp32 reference on
   the card with TF32 off, freeze and fold its norms, compile at
   ``-O 1`` with 8-bit all-LUT first and last layers, bind, and evaluate
   top-1 agreement one image at a time) at :data:`HARNESS` on both
   reduced nets, required at or above ``AGREEMENT_FLOOR``, and on
   full-width resnet18 (224, 1000 classes, :data:`FULL_TRAIN_STEPS`
   steps), recorded; each run's launches counted in a window of their
   own and required to be exactly the fused path's per evaluated image.
   Then the cross checks, each on networks trained, folded, compiled and
   bound here through the harness's public functions: on each reduced
   net two more trainings of :data:`RETRAIN_STEPS` steps (whether they
   fold to the same weights is
   printed, not required), the first bound into a golden and a fused
   executor on the card and one on the CPU: equal agreement counts over
   :data:`CROSS_SAMPLES` and bitwise-equal logits on the first batch of
   :data:`CROSS_BATCH`; on full-width resnet18 one more training (again
   :data:`FULL_TRAIN_STEPS` steps), whose folded weights give
   bitwise-equal logits on the card and the CPU for
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
12. train: training on the card. The flash-attention backward kernel
   (``flash_attention_bwd.cu``'s dq and dkdv entry points, wgmma and TMA,
   reached through the autograd Function of ``flash_attention``, one
   launch of each entry point) against autograd through the plain
   version at :data:`BWD_SHAPES` (seamless's encoder, decoder and cross
   shapes, llama3.2-1b's GQA 32/8 at S 2048, a ragged causal shape, one
   with ``kv_offset`` > 0, qwen2-vl's (128, 128) at GQA 12/2, and a D=128
   GQA shape whose tiles cross the diagonal, seamless's three at phase
   14's 8 local heads, and the wide pairs' instance at MLA's (192, 128)
   and gemma's (256, 256), each at its training shape and with tiles
   across the diagonal): dq, dk and dv within
   :data:`BWD_TOL` of the gradient's max |.| and every row within
   :data:`BWD_ROW_TOL`, the forward's log-sum-exp within :data:`LSE_TOL`
   of the plain version's, a second backward bitwise equal to the first
   and to the entry points called as a new host thread's first CUDA work
   (:func:`on_new_thread`: no context is current there until a CUDA call
   makes one), the dq launch's delta within :data:`DELTA_TOL` of ``bwd_prep_plain``;
   device ms per entry point, the bound, the plain backward's and SDPA's
   backward's ms, and ptxas's registers and spills; at :data:`FWD_TIMED`
   (the wide training shapes, which the serving rows of phase 5 do not
   have) also the forward launch with its log-sum-exp against the plain
   forward (:func:`fwd_row`), timed beside SDPA and the bound. Then
   seamless-m4t-large-v2 whole at published widths in bf16 through
   ``repro_torch.launch.train.main`` (:data:`TRAIN_SEAMLESS`): exactly
   :func:`train_launches` a step (the forward kernel twice a layer's
   attention with ``remat="full"``'s recompute, each backward entry point
   once, no split GEMM), finite losses and gradient norms, ``state.step``
   advancing; step 1 through the kernels against step 1 with
   ``attn_mode="ref"`` from the same state (:func:`step_agreement`); host
   ms a step, device ms and busy share, tokens/s and peak memory.
   llama3.2-1b at published width and depth (:data:`TRAIN_LLAMA`) on the
   reference's dense attention (no launch at all) with the same numbers.
   Last, a checkpoint of llama3.2-1b's smoke config (fp32) on the card
   saved at step 2 and restored into a fresh state: steps 3-4 bitwise
   equal to steps 3-4 without the restart.
13. parallel: the parallel layer on ``torch.distributed``. First
   ``launch.train.main`` under a world-1 ``torchrun`` environment with
   no group made for it (:func:`torchrun_world_one`): it makes its own
   NCCL group, trains and tears the group down, bitwise equal to one
   plain process. A world-1 NCCL group on the card and
   ``make_host_mesh``: ``shard_params_tree`` of seamless-m4t-large-v2's
   parameters (published widths cut to :data:`PARALLEL_LAYERS` encoder
   and decoder layers, :func:`cut_seamless`) gives DTensors on ``cuda``
   bitwise equal to them, and
   ``compressed_grad_allreduce(axis_name="data")`` over the group is
   bitwise equal to ``axis_name=None``. Then :data:`DP_RANKS` ranks
   spawned over gloo share the card, each running
   ``repro_torch.launch.train.main`` on that arch at
   :data:`PARALLEL_TRAIN` (``TRAIN_SEAMLESS``'s global batch 8 x 256, 2
   steps, a checkpoint each step): each rank's flash launches over the
   run exactly :func:`train_launches`', finite losses, the ranks'
   losses and final states bitwise equal; against the one-process
   launcher on the same global batch, as :func:`step_agreement` holds
   it, step 1's loss and gradient norm and step 2's loss within
   :data:`STEP_TOL`, and step 1's state read back from both runs'
   checkpoints by :func:`state_agreement` (first moments within
   ``STEP_TOL["moments"]``, every updated bf16 parameter within one
   bf16 step); host ms a step, the profiled step's device ms,
   ``reduce_gradients``' ms and bytes, peak GiB per rank, and whether
   gloo reduces bf16 CUDA tensors. Rank 0's last checkpoint restores in
   this process onto the world-1 mesh as DTensors with the spec tree's
   placements, bitwise (a digest of the whole state). ``gpipe`` over 4
   gloo ranks on the card runs llama3.2-1b's 16 decoder layers at
   published width (:data:`PIPE`): every rank's output bitwise equal
   to the same stages run one after another in this process; ms a
   tick. With 2 or more cards the data-parallel run repeats over NCCL,
   one rank a card (up to 4);
   with one it prints that it did not run.
14. tensor: tensor parallelism over the mesh's "model" axis. Two ranks
   spawned over gloo share the card on a :data:`TP_MESH` mesh over
   ("data", "model"); gloo has no all-gather for CUDA tensors (it
   crashes), so the ranks stage that one collective through host memory
   (:func:`stage_gloo_all_gather`, printed), every other collective
   runs on the card's tensors. Each rank runs llama3.2-1b at published
   width and depth (bf16) through ``lm.prefill`` on its shards
   (:data:`TP_PREFILL`: phase 5's batch 8 x prompt 64), the flash kernel
   on its 16 of 32 query heads and 4 of 8 KV heads: the last position's
   logits against the one-process prefill of the same weights: each
   within :data:`TP_LOGIT_STEPS` bf16 steps of its |value| plus its
   row's RMS, each row's error within :data:`TP_LAYERS_REL` of what the
   layers add to it, and every row's argmax equal; exactly one flash
   launch a layer a rank. The check's power is shown in the same run: a
   planted fault, rank 1's attention partial sums lost (its shard of
   ``wo`` zeroed) in the last layer alone, then in every layer, must
   fail both measures each time. Then seamless-m4t-large-v2 cut as in phase 13
   (:func:`cut_seamless`) takes one ``make_train_step(mesh=)`` step from
   the launcher's initial state on its first batch: loss within
   ``STEP_TOL["loss"]`` of phase 13's one-process launcher and the
   gathered step-1 state against that run's checkpoint by
   :func:`state_agreement` (the gate phase 13 uses), every rank's flash
   forward and backward launches exactly :func:`train_launches`'. The
   dry-run (``repro_torch.launch.dryrun``) predicts both runs on a fake
   world of the same mesh, in a subprocess started beside phase 1's
   kernel build and waited for after phase 5 (so it takes no host time
   from the ranks' timed windows):
   each rank's parameter bytes equal to the bytes its local shards hold
   (exactly), its collectives by kind equal to ``CommDebugMode``'s
   counts on the card, and its peak (arguments + temporaries) beside
   ``torch.cuda.max_memory_allocated``, within :data:`TP_PEAK_FACTOR`.
   With 2 or more cards it repeats over NCCL, one rank a card.
15. pairs: every (key, value) head size and dtype the archs send. The
   fp32 kernel (``flash_attention_f32.cu``: a forward with the
   log-sum-exp, dq with delta, dkdv) at :data:`F32_SHAPES` (each smoke
   pair, GQA, ragged causal tiles, ``kv_offset`` > 0, the decode form,
   non-causal cross-attention over a bf16 cache, an LM smoke config's
   training at S 8448) against its plain version and float64
   (:data:`F32_FACTOR`, :data:`F32_FLOOR`), the backward bitwise
   repeatable, timed beside SDPA (and its backward) in fp32 and the fp32
   bound. Then, through ``launch.train.main`` at published widths cut in
   depth (:func:`cut_arch`): deepseek-v2-236b's dense first layer
   (:data:`TRAIN_DEEPSEEK`: MLA at (192, 128) on the bf16 kernels' wide
   backward) and gemma-7b's first 2 layers at S 8448
   (:data:`TRAIN_GEMMA`: (256, 256) above dense_attn_max), each with
   exactly :func:`train_launches`, finite losses, step 1 against
   ``attn_mode="ref"`` (:func:`step_agreement`, :data:`STEP_TOL`), host
   and device ms a step and peak GiB. Then ``launch.serve --smoke`` for
   each of :data:`SMOKE_SERVE` and ``launch.train --smoke`` at
   :data:`SMOKE_TRAIN`, each on the card (exact fp32-kernel launches)
   and with ``--device cpu`` (none); the two launchers draw their
   weights from their devices' generators, so the card is held to the
   CPU on weights made once on the CPU: prefill logits and greedy tokens
   (:data:`SMOKE_LOGIT_TOL`), one train step's loss and gradient norm
   (:data:`SMOKE_STEP_TOL`). Phase 12's :data:`BWD_SHAPES` hold the bf16
   backward's wide pairs (``mla_*``, ``d256_*``).

Each phase prints its seconds ("time: phase ..."). The line before the
last is the kernels' JSON summary; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises, so the script
exits non-zero and prints no result. It exits non-zero at once when
CUDA is unavailable or the package is not beside it.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
INT8_OPS_PER_S = 1.979e15          # H100 SXM dense int8 tensor cores
BF16_FLOP_PER_S = 9.89e14          # H100 SXM dense bf16 tensor cores
FP32_FLOP_PER_S = 6.7e13           # H100 SXM fp32 outside the tensor cores
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
    **{f"flash_attention_bwd_{e}": f"{CSRC}/flash_attention_bwd.cu"
       for e in ("dq", "dkdv")},
    **{name: f"{CSRC}/flash_attention_f32.cu"
       for name in ("flash_attention_f32", "flash_attention_f32_bwd_dq",
                    "flash_attention_f32_bwd_dkdv")},
}
REPLACES = {
    "fused_conv_gemm": "src/repro/kernels/fused_hetero_gemm.py:232",
    "fused_hetero_gemm": "src/repro/kernels/fused_hetero_gemm.py:106",
    "bitserial_gemm": "src/repro/kernels/bitserial_gemm.py:62",
    "int4_gemm": "src/repro/kernels/int4_gemm.py:55",
    "flash_attention": "src/repro/kernels/flash_attention.py:78",
    "depthwise_gemm": "src/repro/kernels/ops.py:256 (int32 einsum, no "
                      "Pallas kernel)",
    **{f"flash_attention_bwd_{e}": "the gradient of "
       "src/repro/models/layers.py:188::blockwise_attention (XLA autodiff; "
       "the Pallas kernel has none)" for e in ("dq", "dkdv")},
    "flash_attention_f32": "src/repro/kernels/flash_attention.py:78 (fp32)",
    **{f"flash_attention_f32_bwd_{e}": "the gradient of "
       "src/repro/models/layers.py:188::blockwise_attention in fp32 (XLA "
       "autodiff; the Pallas kernel has none)" for e in ("dq", "dkdv")},
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
class FlashShape(NamedTuple):
    """One flash shape: q [B, Sq, Hq, D], k [B, Skv, Hkv, D], v [B, Skv,
    Hkv, DV] with DV = ``dv``, or D where ``dv`` is None. In
    :data:`F32_SHAPES`, ``kv_bf16`` puts fp32 queries over bf16 K and V
    (forward only) and ``backward`` holds the gradient too."""
    name: str
    b: int
    sq: int
    skv: int
    hq: int
    hkv: int
    d: int
    causal: bool
    kv_offset: int
    dv: int | None = None
    kv_bf16: bool = False
    backward: bool = False

    @property
    def v_dim(self) -> int:
        return self.d if self.dv is None else self.dv


#: the first is the serving prefill's shape, the one the kernel's row
#: reports; d128_mha runs the D=128 instantiation with one query head per
#: KV head, decode4 the decode form at Sq * Hq / Hkv = 16 over a KV
#: length that does not split evenly over its 4 warps. Then the archs
#: phase's: gemma-7b's serving prefill at D=256 (d256_prefill), D=256
#: with tiles that cross the diagonal (d256_ragged) and in the decode
#: form (d256_decode4, 3 ring stages), yi-34b's 7 query heads a KV head
#: (gqa7), qwen3-8b's serving prefill, qwen3-moe-235b-a22b's
#: (moe_prefill: 16 query heads a KV head, 64 over 4), deepseek-v2's MLA
#: at keys 192 over values 128 (its serving prefill, tiles across the
#: diagonal, and the decode form), and seamless-m4t's non-causal
#: attention: its encoder and prefill cross-attention (cross_prefill) and
#: a decode step's cross-attention over the 64-frame memory
#: (cross_decode, the decode form without a causal mask). Last, phase
#: 14's shapes on each rank's local heads: llama3.2-1b's prefill at 16
#: query heads over 4 (tp_prefill), seamless's encoder, decoder and a
#: cross-attention over a memory of another length at 8 over 8
FLASH_SHAPES = [
    FlashShape("prefill", 8, 64, 64, 32, 8, 64, True, 0),
    FlashShape("s2048", 1, 2048, 2048, 32, 8, 64, True, 0),
    FlashShape("ragged", 2, 1000, 1000, 32, 8, 64, True, 0),
    FlashShape("noncausal", 2, 333, 333, 32, 8, 64, False, 0),
    FlashShape("offset", 8, 64, 1024, 32, 8, 64, True, 960),
    FlashShape("decode", 8, 1, 1024, 32, 8, 64, True, 1023),
    FlashShape("d128_mha", 2, 512, 512, 16, 16, 128, True, 0),
    FlashShape("decode4", 8, 4, 1001, 32, 8, 64, True, 997),
    FlashShape("d256_prefill", 8, 64, 64, 16, 16, 256, True, 0),
    FlashShape("d256_ragged", 2, 1000, 1000, 16, 16, 256, True, 0),
    FlashShape("d256_decode4", 8, 4, 1001, 16, 16, 256, True, 997),
    FlashShape("gqa7", 8, 64, 64, 56, 8, 128, True, 0),
    FlashShape("qwen3_prefill", 8, 64, 64, 32, 8, 128, True, 0),
    FlashShape("moe_prefill", 8, 64, 64, 64, 4, 128, True, 0),
    FlashShape("mla_prefill", 8, 64, 64, 128, 128, 192, True, 0, 128),
    FlashShape("mla_ragged", 2, 1000, 1000, 16, 16, 192, True, 0, 128),
    FlashShape("mla_decode4", 8, 4, 1001, 4, 4, 192, True, 997, 128),
    FlashShape("cross_prefill", 8, 64, 64, 16, 16, 64, False, 0),
    FlashShape("cross_decode", 8, 1, 64, 16, 16, 64, False, 0),
    FlashShape("tp_prefill", 8, 64, 64, 16, 4, 64, True, 0),
    FlashShape("tp_seamless_enc", 8, 256, 256, 8, 8, 64, False, 0),
    FlashShape("tp_seamless_dec", 8, 256, 256, 8, 8, 64, True, 0),
    FlashShape("tp_cross", 8, 200, 320, 8, 8, 64, False, 0),
]
#: the serving run: llama3.2-1b at batch 8, prompt 64, 32 new tokens
SERVE = dict(arch="llama3.2-1b", batch=8, prompt=64, new=32, seed=0)
#: prefill logits of the kernel run vs the mode="ref" run: within 8 bf16
#: steps (2^-8 relative each) of the largest |logit|. The two runs differ
#: only in attention's fp32 summation order, which flips an occasional
#: bf16 rounding; 16 layers of bf16 matmuls carry such flips to the
#: logits, which are themselves bf16 products (x @ embed.T) cast to fp32.
LOGIT_TOL = 8 * 2 ** -8


def timed(what: str, fn, *args, **kw):
    """``fn(*args, **kw)``, printing its wall seconds as a ``time:``
    line (a phase's parts, so that a run shows where its time went)."""
    t0 = time.time()
    result = fn(*args, **kw)
    print(f"time: {what} {time.time() - t0:.1f} s")
    return result


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


def flash_bound_ms(b, sq, skv, hq, hkv, d, causal, kv_offset, dv=None,
                   elem=2, kv_elem=None, rate=BF16_FLOP_PER_S):
    """Least time for one attention call: q and k (head size D), v and
    out (head size DV, default D), k and v at the KV heads, read /
    written once over the HBM rate (``elem`` bytes an element, 2 in bf16
    and 4 in fp32; ``kv_elem`` for K and V, default ``elem``), vs
    2·B·Hq·(D + DV) FLOP per unmasked (query, key) pair (q·k and p·v)
    over ``rate`` (the bf16 tensor cores, or fp32 outside them)."""
    dv = d if dv is None else dv
    kv_elem = elem if kv_elem is None else kv_elem
    nbytes = elem * b * sq * hq * (d + dv) + kv_elem * b * skv * hkv * (
        d + dv)
    if causal:
        pairs = sum(min(skv, r + kv_offset + 1) for r in range(sq))
    else:
        pairs = sq * skv
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * b * hq * (d + dv) * pairs / rate
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
    for shape in FLASH_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        dv = shape.v_dim
        q, k, v = (torch.randn((b, s, h, e), generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for s, h, e in ((sq, hq, d), (skv, hkv, d),
                                   (skv, hkv, dv)))
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
        b_ms, b_by = flash_bound_ms(b, sq, skv, hq, hkv, d, causal, off, dv)
        plan = flash_plan(b, sq, skv, hq, hkv, d, dv)
        row = {"shape": name, "b": b, "sq": sq, "skv": skv, "hq": hq,
               "hkv": hkv, "d": d, "dv": dv, "causal": causal,
               "kv_offset": off,
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
              f"D={d} DV={dv} causal={causal} kv_offset={off}, "
              f"{plan.form} form, smem {plan.smem} B, "
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


@contextlib.contextmanager
def recorded_routing(torch):
    """Record, for each call of ``layers._top_k_dispatch`` (one per MoE
    layer) while the block runs, the capacity slot each (token, expert)
    pair took, -1 where the expert was not chosen or the token was
    dropped; the dispatch itself is returned unchanged."""
    from repro_torch.models import layers
    original = layers._top_k_dispatch
    calls = []

    def recording(probs, top_k, capacity):
        dispatch, combine = original(probs, top_k, capacity)
        calls.append(torch.where(dispatch.sum(-1) > 0, dispatch.argmax(-1),
                                 -1))
        return dispatch, combine

    layers._top_k_dispatch = recording
    try:
        yield calls
    finally:
        layers._top_k_dispatch = original


def routing_diff(got: list, want: list) -> dict:
    """Per MoE layer, between two recorded runs: the (token, expert)
    pairs kept in one run only (``pairs``), the tokens whose kept experts
    differ (``tokens``), the pairs kept in both at another capacity slot
    (``slots``: a shift of the cumulative count, the same product), and
    the pairs the second run kept (``kept``)."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} MoE layers recorded vs "
                             f"{len(want)}")
    out = {"pairs": [], "tokens": [], "slots": [], "kept": []}
    for a, b in zip(got, want):
        one = (a >= 0) != (b >= 0)
        out["pairs"].append(int(one.sum()))
        out["tokens"].append(int(one.any(-1).sum()))
        out["slots"].append(int(((a != b) & (a >= 0) & (b >= 0)).sum()))
        out["kept"].append(int((b >= 0).sum()))
    return out


def flash_per_call(arch) -> tuple[dict, dict]:
    """The flash launches of one prefill and of one decode step, read
    from the code: an LM's prefill launches once a layer (its decode
    attention, MLA's absorbed form included, is plain torch); the
    encoder-decoder's prefill encodes twice (``encode`` for the cross
    cache, then ``forward``) and runs each decoder layer's causal self-
    and non-causal cross-attention, and its decode step runs each
    layer's cross-attention; the ssm and the hybrid launch none."""
    cfg = arch.model
    if arch.module == "lm":
        return {"flash_attention": cfg.n_layers}, {}
    if arch.module == "encdec":
        return ({"flash_attention": 2 * cfg.n_enc_layers
                 + 2 * cfg.n_dec_layers},
                {"flash_attention": cfg.n_dec_layers})
    return {}, {}


def serve_arch(torch, arch_id: str, out: dict, layers=None,
               prefill_runs: int = 3, n_new: int = SERVE["new"]) -> int:
    """One arch at :data:`SERVE`'s batch, prompt and seed and ``n_new``
    new tokens (``layers`` cuts its depth), through the launcher and then
    through
    the engine with prefill, decode and the ``mode="ref"`` run (prefill
    and decode) each in a launch window of its own; an encoder-decoder
    gets the launcher's frames. The model is freed before returning.
    Returns the flash launches of the engine's counted prefill and
    decode steps."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.serve import engine

    b, s0 = SERVE["batch"], SERVE["prompt"]
    arch = registry.get(arch_id)
    argv = ["--arch", arch_id, "--batch", str(b), "--prompt-len", str(s0),
            "--new-tokens", str(n_new), "--seed", str(SERVE["seed"])]
    if layers is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=layers))
        argv += ["--layers", str(layers)]
    cfg, dev = arch.model, torch.device("cuda")
    per_prefill, per_step = flash_per_call(arch)
    per_decode = {k: (n_new - 1) * n for k, n in per_step.items()}

    # the user's entry point: one batch of requests, one prefill
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    summary = serve.main(argv)
    torch.cuda.synchronize()
    windows = {"launcher": read_window(
        LAUNCHES, {k: n + per_decode.get(k, 0)
                   for k, n in per_prefill.items()},
        f"{arch_id} launcher (1 prefill + decode)")}
    launcher_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(SERVE["seed"])
        params = arch.model_module().init(cfg, gen)
        prompts = SyntheticTokens(cfg.vocab, b, s0, seed=SERVE["seed"]
                                  ).next_batch()["tokens"].to(dev)
        if not torch.equal(prompts.cpu(), summary["prompts"]):
            raise AssertionError(f"{arch_id}: engine prompts != the "
                                 f"launcher's")
        batch = {"tokens": prompts}
        if arch.module == "encdec":
            batch["frames"] = serve.encdec_frames(b, s0, cfg.d_model, dev)
        prefill = engine.make_prefill_fn(arch)
        prefill_ref = engine.make_prefill_fn(arch, attn_mode="ref")
        decode = engine.make_decode_fn(arch)
        decode_ref = engine.make_decode_fn(arch, attn_mode="ref")

        def run_prefill(fn):
            cache = engine.make_cache(arch, b, s0 + n_new, cfg.param_dtype,
                                      dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = fn(params, batch, cache)
            torch.cuda.synchronize()
            return logits, cache, 1e3 * (time.perf_counter() - t0)

        def run_decode(logits, cache, fn=decode):
            tok = engine.greedy_token(logits[:, -1])
            toks = [tok]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n_new - 1):
                step, cache = fn(params, tok, cache, s0 + i)
                tok = engine.greedy_token(step)
                toks.append(tok)
            torch.cuda.synchronize()
            return torch.cat(toks, 1), 1e3 * (time.perf_counter() - t0)

        run_prefill(prefill)                                    # warm-up
        LAUNCHES.clear()
        with recorded_routing(torch) as routes:
            logits, cache, _ = run_prefill(prefill)
        windows["prefill"] = read_window(LAUNCHES, per_prefill,
                                         f"{arch_id} prefill")
        LAUNCHES.clear()
        tokens, t_decode = run_decode(logits, cache)
        windows["decode"] = read_window(LAUNCHES, per_decode, f"{arch_id} "
                                        f"{n_new - 1} decode steps")
        LAUNCHES.clear()
        with recorded_routing(torch) as ref_routes:
            ref_logits, ref_cache, _ = run_prefill(prefill_ref)
        ref_tokens, _ = run_decode(ref_logits, ref_cache, decode_ref)
        windows["mode=ref"] = read_window(LAUNCHES, {}, f"{arch_id} "
                                          f"mode=ref prefill + decode")
        prefill_ms = [run_prefill(prefill)[2] for _ in range(prefill_runs)]
        # device time of one prefill and of one decode step
        cache_d = run_prefill(prefill)[1]
        tok_d = tokens[:, :1]
        prefill_dev = busy_ms(torch, lambda: run_prefill(prefill), iters=3)
        decode_dev = busy_ms(torch, lambda: decode(params, tok_d, cache_d,
                                                   s0), iters=5)
        if arch_id == "qwen3-8b":
            out["kv_quant"] = kv_quant_diff(torch, arch, params, prompts,
                                            tokens)
    peak = torch.cuda.max_memory_allocated()

    want_shape = (b, s0, cfg.vocab)
    if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"{arch_id}: prefill logits "
                             f"{tuple(logits.shape)} not finite "
                             f"{want_shape}")
    err = float((logits - ref_logits).abs().max())
    tol = LOGIT_TOL * float(ref_logits.abs().max())
    routing = routing_diff(routes, ref_routes)
    if routes:
        # routing is discontinuous: where an attention output differs in
        # its last bf16 bit, a token can swap its last expert for the
        # next, or take a capacity slot another token then loses; printed
        # before the logits check so that a failure shows its count
        print(f"serve: {arch_id} prefill routing kernel vs mode=ref, per "
              f"MoE layer: (token, expert) pairs kept in one run only "
              f"{routing['pairs']} of {routing['kept']} kept; tokens "
              f"whose kept experts differ {routing['tokens']} of "
              f"{b * s0}; pairs kept in both at another slot "
              f"{routing['slots']}")
    if not err <= tol:
        raise AssertionError(f"{arch_id}: prefill logits kernel vs "
                             f"mode=ref: max |err| {err} > {tol}")
    top2 = ref_logits[:, -1].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    first_same = tokens[:, 0] == ref_tokens[:, 0]
    if not bool(first_same[clear].all()):
        raise AssertionError(f"{arch_id}: first token differs from "
                             f"mode=ref in a row whose top-2 gap exceeds "
                             f"{tol}: {tokens[:, 0].tolist()} vs "
                             f"{ref_tokens[:, 0].tolist()}")
    agree = int((tokens == ref_tokens).sum())
    logits_equal = float((logits == ref_logits).float().mean())
    same_as_launcher = bool(torch.equal(tokens.cpu(), summary["tokens"]))
    med = statistics.median(prefill_ms)
    per_step = t_decode / (n_new - 1)
    cut = f" (cut from {registry.get(arch_id).model.n_layers})" \
        if layers else ""
    depth = serve.model_depth(cfg)
    print(f"serve: {cfg.name} {depth} layers{cut} d_model "
          f"{cfg.d_model} {cfg.param_dtype}, batch {b} prompt {s0} new "
          f"{n_new}: launches per window {windows}; peak memory "
          f"{launcher_peak / 2**30:.2f} GiB launcher, {peak / 2**30:.2f} "
          f"GiB engine")
    print(f"serve: {arch_id} prefill logits vs mode=ref max |err| "
          f"{err:.4g} (tol {tol:.4g}), {100 * logits_equal:.3f}% bitwise "
          f"equal; first tokens equal in {int(first_same.sum())}/{b} "
          f"rows ({int(clear.sum())} with a top-2 gap above tol); greedy "
          f"tokens equal {agree}/{tokens.numel()}; engine tokens "
          f"{'equal' if same_as_launcher else 'differ from'} the launcher's")
    print(f"serve: {arch_id} prefill median {med:.3f} ms over "
          f"{prefill_runs} ({', '.join(f'{t:.3f}' for t in prefill_ms)}), "
          f"{b * s0 / med * 1e3:.0f} tok/s; decode {per_step:.3f} ms/step "
          f"over {n_new - 1} steps, {b * (n_new - 1) / t_decode * 1e3:.0f} "
          f"tok/s; launcher prefill {summary['prefill_ms']:.3f} ms, decode "
          f"{summary['decode_ms_per_step']:.3f} ms/step")
    print(f"serve: {arch_id} device time per prefill "
          f"{busy_text(prefill_dev, med)} of the median, per decode step "
          f"{busy_text(decode_dev, per_step)}")
    out[arch_id] = {
        "layers": depth, "windows": windows, "logit_err": err,
        "logit_tol": tol, "first_tokens_equal": int(first_same.sum()),
        "rows_above_tol": int(clear.sum()), "tokens_equal": agree,
        "tokens": tokens.cpu().tolist(), "ref_tokens":
        ref_tokens.cpu().tolist(), "prefill_ms": prefill_ms,
        "decode_ms_per_step": per_step, "logits_bitwise_equal":
        logits_equal, "tokens_equal_launcher": same_as_launcher,
        "routing_diff": routing,
        "prefill_device_ms": prefill_dev, "decode_step_device_ms":
        decode_dev, "launcher_peak_bytes": launcher_peak,
        "engine_peak_bytes": peak, "launcher": {
            k: summary[k] for k in ("prefill_ms", "decode_ms",
                                    "decode_ms_per_step")},
        "logits_abs_sum": float(np.abs(logits.float().cpu().numpy()).sum())}
    del params, cache, cache_d, ref_cache, logits, ref_logits, routes, \
        ref_routes, batch
    torch.cuda.empty_cache()
    return sum(windows[w].get("flash_attention", 0)
               for w in ("prefill", "decode"))


def phase_serve(torch, details: dict) -> int:
    """Full-width llama3.2-1b (:func:`serve_arch`, 7 timed prefills);
    returns the flash launches of one prefill."""
    from repro_torch.obs import METRICS
    out = details.setdefault("serve", {})
    launches = serve_arch(torch, SERVE["arch"], out, prefill_runs=7)
    details["serve_metrics"] = METRICS.snapshot()
    return launches


#: the archs phase: (arch, layers) served at SERVE's batch, prompt, new
#: tokens and seed, every arch at its published widths; layers None is
#: the published depth. Phase 5 serves llama3.2-1b whole; here the
#: depths are cut to keep the script inside half its time limit (the
#: whole script once ran past its limit on a slower host), each to a
#: few layers that hold every kind of sublayer its arch has:
#: qwen3-8b 8 of 36, gemma-7b 8 of 28, qwen2-vl-2b 8 of 28, yi-34b 4 of
#: 60 (its whole 68.8 GB would not fit the card beside init_params' fp32
#: draw of a stacked leaf in any case), mamba2-780m 12 of 48,
#: qwen3-moe-235b-a22b 2 of 94 (4.98 GB a layer: 128 experts x 3 x 4096
#: x 1536 and 71 M of attention), deepseek-v2-236b 2 of 60 (its dense
#: first layer and one MoE layer, 160 experts x 3 x 5120 x 1536; the
#: launcher's --layers must exceed the dense prefix). jamba-v0.1-52b
#: keeps one period of 8 layers (7 Mamba, 1 attention, 4 MoE and 4 dense
#: FFNs: the launcher serves whole periods), 25.5 GB and 1.1 GB of
#: embeddings, plus the fp32 draw of its MoE leaf [1, 4, 16, 4096,
#: 14336], 15 GB. seamless-m4t-large-v2 (4.1 GB, 24 + 24 layers) runs
#: whole, as phase 12 trains it
ARCHS = [("qwen3-8b", 8), ("gemma-7b", 8), ("yi-34b", 4),
         ("mamba2-780m", 12), ("qwen3-moe-235b-a22b", 2),
         ("jamba-v0.1-52b", 8), ("deepseek-v2-236b", 2),
         ("qwen2-vl-2b", 8), ("seamless-m4t-large-v2", None)]
#: the archs' new tokens: half of :data:`SERVE`'s, to keep the script
#: inside its time
ARCHS_NEW = 8
#: decode steps of qwen3-8b with the int8 KV cache against the bf16 one
KV_QUANT_STEPS = 8


def kv_quant_diff(torch, arch, params, prompts, tokens) -> dict:
    """qwen3-8b through the engine with the int8 KV cache
    (``kv_cache_quant``) and with the bf16 one, fed the same tokens (the
    bf16 run's greedy ones) for :data:`KV_QUANT_STEPS` decode steps;
    the int8 run's prefill launches flash once a layer. Returns the
    relative logit difference max |int8 - bf16| / max |bf16| per step."""
    import dataclasses
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.serve import engine
    b, s0 = prompts.shape
    quant = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, kv_cache_quant=True))
    steps = {}
    for name, a in (("bf16", arch), ("int8", quant)):
        cache = engine.make_cache(a, b, s0 + KV_QUANT_STEPS,
                                  a.model.param_dtype, prompts.device)
        LAUNCHES.clear()
        logits, cache = engine.make_prefill_fn(a)(
            params, {"tokens": prompts}, cache)
        read_window(LAUNCHES, {"flash_attention": a.model.n_layers},
                    f"qwen3-8b {name} cache prefill")
        if name == "int8" and cache["layers"]["k"].dtype != torch.int8:
            raise AssertionError("kv_cache_quant cache is not int8")
        decode = engine.make_decode_fn(a)
        rows = []
        for i in range(KV_QUANT_STEPS):
            step, cache = decode(params, tokens[:, i:i + 1], cache, s0 + i)
            rows.append(step)
        steps[name] = torch.stack(rows)
    if not torch.isfinite(steps["int8"]).all():
        raise AssertionError("int8 KV cache logits not finite")
    ref = steps["bf16"]
    rel = ((steps["int8"] - ref).abs().amax(dim=(1, 2))
           / ref.abs().amax(dim=(1, 2))).tolist()
    agree = float((steps["int8"].argmax(-1) == ref.argmax(-1)).float()
                  .mean())
    print(f"archs: qwen3-8b int8 KV cache vs bf16 over {KV_QUANT_STEPS} "
          f"decode steps: relative logit difference per step "
          f"{', '.join(f'{r:.4f}' for r in rel)}; argmax equal in "
          f"{100 * agree:.1f}% of rows")
    return {"rel_logit_diff": rel, "argmax_equal": agree}


def phase_archs(torch, details: dict) -> int:
    """:data:`ARCHS` through :func:`serve_arch`, one model on the card at
    a time; returns the flash launches of their counted prefills."""
    out = details.setdefault("archs", {})
    return sum(timed(f"archs {arch_id}", serve_arch, torch, arch_id, out,
                     layers, n_new=ARCHS_NEW)
               for arch_id, layers in ARCHS)


#: the accuracy harness's operating point on the card (both reduced
#: nets, and full-width resnet18)
HARNESS = dict(n_samples=256, batch=64, train_steps=200)
#: full-width resnet18's two trainings (recorded, not gated; the second
#: only feeds the card-vs-CPU bitwise check): cut from 200 steps, then
#: 50, 10 and 4, to keep the script inside its time (none converges)
FULL_TRAIN_STEPS = 4
#: reduced nets: samples evaluated through golden, the card and the CPU
#: on the same folded weights, in batches of CROSS_BATCH; the first
#: batch's logits are held bitwise. One batch, cut from 64 samples to
#: keep the script inside half its time limit (golden takes 0.14-0.15 s
#: a reduced resnet18 image and 0.28-0.42 s a reduced mobilenet_v2 one
#: on the card's host)
CROSS_SAMPLES = 16
CROSS_BATCH = 16
#: steps of the reduced nets' two cross-check trainings (the harness's
#: own run trains at HARNESS's 200): any trained weights serve the
#: cross check and the repeat, and 50 keep the script inside its time
RETRAIN_STEPS = 50
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


#: the golden mobilenet_v2 image's side: its channels at full width, its
#: resolution halved from 224 (a quarter of the tiles: golden is host
#: work, 17 s an image at 224 on the card's host) to keep the script
#: inside half its time limit
GOLDEN_MOBILENET_HW = 112


def phase_golden(torch, prog, details: dict) -> None:
    """``GoldenExecutor`` on the card: one full-width resnet18 image and
    one mobilenet_v2 image (at :data:`GOLDEN_MOBILENET_HW`) bitwise
    equal to ``CudaExecutor``'s fused
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
    hw = GOLDEN_MOBILENET_HW
    mob = compile_network("mobilenet_v2", in_hw=hw)
    mob_s = golden_image(torch, mob, image(mob), f"mobilenet_v2 {hw}")
    out["mobilenet_v2"] = {"s": mob_s, "tiles": n_tiles(mob), "in_hw": hw}
    print(f"golden: mobilenet_v2 {hw}, {n_tiles(mob)} tiles, one image "
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
    harness = {**HARNESS, **kw}
    rep = acc.measure(cfg.arch, backend="cuda", **harness)
    torch.cuda.synchronize()
    launches = read_launches(LAUNCHES, harness_launches(prog),
                             rep.n_samples, f"harness {what}")
    print(f"accuracy: {what}: agreement {rep.agreement:.4f} (floor "
          f"{acc.AGREEMENT_FLOOR}), top-1 compiled {rep.top1_compiled:.4f}, "
          f"top-1 fp32 {rep.top1_ref:.4f} over {rep.n_samples} samples; "
          f"training {rep.train_s:.2f} s ({harness['train_steps']} steps, "
          f"batch {HARNESS['batch']}); eval {rep.eval_ms_per_image:.3f} ms "
          f"per image; simulated FPGA latency {rep.latency_ms} ms; "
          f"launches {launches}")
    return rep, launches


def trained(torch, cfg, steps: int = HARNESS["train_steps"]):
    """A reference trained at ``steps`` (:data:`HARNESS`'s) on the card,
    its norms folded; returns (folded weights, reference forward,
    seconds)."""
    from repro_torch.eval import accuracy as acc
    from repro_torch.models import cnn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, norms, ref_fn = acc.build_reference(cfg, train_steps=steps)
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
        folded, ref_fn, s_a = trained(torch, cfg, RETRAIN_STEPS)
        folded_b, _, s_b = trained(torch, cfg, RETRAIN_STEPS)
        same, diff = folded_diff(folded, folded_b)
        print(f"accuracy: {arch} reduced: two more trainings of "
              f"{RETRAIN_STEPS} steps ({s_a:.2f} s, {s_b:.2f} s) fold to "
              f"{'bitwise the same weights' if same else 'other weights'} "
              f"(max |diff| {diff:.3g})")
        prog, specs = acc.compile_quantized_cnn(cfg)
        out[arch] = {"report": rep.bench_row(), "retrain_s": [s_a, s_b],
                     "trainings_bitwise_equal": same,
                     "trainings_max_abs_diff": diff,
                     **cross_check(torch, arch, cfg, prog, specs, folded,
                                   ref_fn)}

    cfg = cnn.CNNConfig(arch="resnet18")
    rep, launches = measured(torch, cfg, "resnet18 224", reduced=False,
                             train_steps=FULL_TRAIN_STEPS)
    totals.update(launches)
    folded, _, secs = trained(torch, cfg, FULL_TRAIN_STEPS)
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
    print(f"accuracy: resnet18 224: one more training ({secs:.2f} s, "
          f"{FULL_TRAIN_STEPS} steps); "
          f"{FULL_CPU_IMAGES} images' logits bitwise equal on the card and "
          f"the CPU")
    out["resnet18_224"] = {"report": rep.bench_row(), "retrain_s": secs}
    return dict(totals)


#: the decode phase: full-width sessions at batch 8 over a 64-position
#: window (1 warm-up step, the rest steady), jamba-v0.1-52b at its smoke
#: config (52 B parameters do not fit one card at full width), then
#: golden sessions at the three smoke configs
DECODE = dict(batch=8, max_seq=64, seed=0)
DECODE_STEPS = {"llama3.2-1b": 8, "mamba2-780m": 4, "jamba-v0.1-52b": 4}
#: the full-width decode programs' depths (phase 7's, and phase 10's
#: llama3.2-1b bundles): llama3.2-1b 2 of its 16 blocks, mamba2-780m 6
#: of its 48 layers, to keep the script inside half its time limit.
#: Drawing the weight codes and binding them into three sessions is host
#: work (54 s and 34 s at the published depths on the card's host), and
#: every layer shape the whole program has is still there, each kernel
#: timed at each of them
DECODE_LAYERS = {"llama3.2-1b": 2, "mamba2-780m": 6}
#: step_slots calls of the staggered per-slot run; slot j is admitted
#: (``reset_slot``) at step j % 3 and holds a stale request before that
SLOT_STEPS = 4
GOLDEN_DECODE = dict(batch=1, max_seq=8, steps=4)
#: the decode path's kernels, in the order of the decode rows
DECODE_KERNELS = ("fused_hetero_gemm", "bitserial_gemm", "int4_gemm")


def decode_arch(name: str) -> str:
    """The arch id whose full config the decode programs of ``name``
    compile: ``name`` cut to :data:`DECODE_LAYERS` (published widths)."""
    return cut_arch(name, DECODE_LAYERS[name]) if name in DECODE_LAYERS \
        else name


def compile_decode(name: str, smoke: bool, **kw):
    """The decode-step program of ``name`` at :data:`DECODE`'s batch and
    window (``kw`` overrides), as ``compile_decode_network`` compiles it
    at its defaults, but at the full config (cut to
    :data:`DECODE_LAYERS`) when ``smoke`` is False."""
    from repro_torch.compiler.lower import lower_network
    from repro_torch.compiler.networks import decode_step_layers
    kw = {"batch": DECODE["batch"], "max_seq": DECODE["max_seq"], **kw}
    opt_level = kw.pop("opt_level", 0)
    layers, spec = decode_step_layers(name if smoke else decode_arch(name),
                                      smoke=smoke, **kw)
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
    mamba2-780m (depths cut to :data:`DECODE_LAYERS`), jamba-v0.1-52b at
    its smoke config, each through the
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
        t0 = t_name = time.time()
        prog = compile_decode(name, smoke)
        print(f"compile: {name + ' smoke' if smoke else decode_arch(name)} "
              f"decode batch {prog.step.batch} max_seq {prog.step.max_seq} "
              f"-O 0: "
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
        print(f"time: decode {name} {time.time() - t_name:.1f} s")
    timed("decode golden sessions", golden_sessions, torch, out)
    return dict(launches)


#: the multi-device phase's CNN bundles, (network, plan kind, devices),
#: each at full width, -O 0, batch 1
CNN_BUNDLES = [("resnet18", "filter", 2), ("resnet18", "filter", 3),
               ("resnet18", "pipeline", 2), ("mobilenet_v2", "filter", 2),
               ("mobilenet_v2", "pipeline", 2)]
#: full-width llama3.2-1b decode bundles, (plan kind, devices), and the
#: greedy steps each decodes
DECODE_BUNDLES = [("filter", 2), ("pipeline", 2)]
MULTI_STEPS = 4
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
    """The decode-step bundle of ``name`` at its full config (cut to
    :data:`DECODE_LAYERS`), as
    ``compile_decode_network(devices=n_dev, partition=kind)`` compiles
    its smoke config: ``lower_partitioned`` at :data:`DECODE`'s batch
    and window, ``-O 0``, then ``decorate_decode_bundle``."""
    from repro_torch.compiler.networks import decode_step_layers
    from repro_torch.compiler.partition import decorate_decode_bundle, \
        derive_plan, lower_partitioned
    lut, dsp, dev = compiler_cfgs()
    layers, spec = decode_step_layers(decode_arch(name),
                                      batch=DECODE["batch"],
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
    import tempfile

    from repro_torch.compiler import compile_decode_network
    from repro_torch.configs import registry
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = {}
    # the two runs side by side (the CPU one needs no card), their output
    # in files, each waited for in turn; their own times are recorded,
    # not compared
    t0 = time.time()
    procs = {}
    for where, extra in (("card", []), ("cpu", ["--smoke", "--device",
                                                  "cpu"])):
        files = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        procs[where] = (extra, files, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve",
             *SERVE_ACCEL, *extra], stdout=files[0], stderr=files[1],
            text=True, env=env, cwd=ROOT))
    try:
        for _, _, proc in procs.values():
            proc.wait(timeout=max(1.0, 900 - (time.time() - t0)))
    finally:
        for _, _, proc in procs.values():
            proc.kill()
            proc.wait()
    for where, (extra, files, proc) in procs.items():
        secs = time.time() - t0
        stdout, stderr = (f.seek(0) or f.read() for f in files)
        for f in files:
            f.close()
        if proc.returncode != 0:
            raise AssertionError(f"launch.serve {' '.join(SERVE_ACCEL + extra)}"
                                 f" exited {proc.returncode}:\n"
                                 f"{stderr[-3000:]}")
        lines = {key: serve_line(stdout, prefix) for key, prefix in (
            ("image", "# accel program "), ("decode", "# accel decode program"),
            ("session", "# accel decode session [cuda]"),
            ("fleet", "# fleet[2 workers]"), ("prefill", "prefill:"),
            ("decode_ms", "decode:"))}
        runs[where] = {"s": secs, "lines": lines}
        print(f"multi: launch.serve {' '.join(SERVE_ACCEL + extra)}: exit 0; "
              f"both runs side by side in {secs:.1f} s")
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
    # both fleets start side by side (their workers load at once), then
    # serve in turn, the idle one launching nothing
    fleets = {policy: FleetServer(
        FLEET["arch"], [("w0", "cuda", "subprocess"),
                        ("w1", "cuda", "thread")],
        batch_slots=FLEET["batch_slots"], max_seq=FLEET["max_seq"],
        seed=FLEET["seed"], policy=policy)
        for policy in ("continuous", "serial")}
    started = {}

    def start(policy):
        t0 = time.time()
        fleets[policy].start()
        started[policy] = time.time() - t0
    try:
        starters = [threading.Thread(target=start, args=(p,))
                    for p in fleets]
        for t in starters:
            t.start()
        for t in starters:
            t.join()
        if set(started) != set(fleets):
            raise AssertionError(f"fleets started {sorted(started)} of "
                                 f"{sorted(fleets)}")
        for policy, fleet in fleets.items():
            start_s = started[policy]
            for f in [fleet.submit([1], 1) for _ in range(4)]:   # warm-up
                f.result(600)
            LAUNCHES.clear()
            t0 = time.perf_counter()
            futs = [fleet.submit(p, n) for p, n in FLEET_REQUESTS]
            rows = [f.result(600) for f in futs]
            secs = time.perf_counter() - t0
            counts = {k: v for k, v in LAUNCHES.items() if v}
            fleet.stop()
            for i, (row, exp) in enumerate(zip(rows, want)):
                if not np.array_equal(row, exp):
                    raise AssertionError(f"fleet {policy} request {i}: "
                                         f"tokens {row.tolist()} != single "
                                         f"session {exp.tolist()}")
            launches.update(counts)
            res[policy] = {"s": secs, "req_per_s": len(rows) / secs,
                           "tok_per_s": n_tok / secs, "start_s": start_s,
                           "thread_worker_launches": counts}
            print(f"multi: fleet {policy} (w0 cuda subprocess, w1 cuda "
                  f"thread, 2 slots each; both fleets started side by side, "
                  f"this one in {start_s:.1f} s): {len(rows)} requests in "
                  f"{1e3 * secs:.1f} ms, {len(rows) / secs:.2f} req/s, "
                  f"{n_tok / secs:.1f} new tok/s; tokens bitwise equal to a "
                  f"single-request session on the card; thread worker "
                  f"launches {counts}")
    finally:
        for fleet in fleets.values():
            fleet.stop()
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
        d, x_q, counts = timed(f"codesign {name}", hetero_layer, torch, name,
                               m, k, n, w_bits, a_bits, ratio, out)
        launches.update(counts)
        if name == "llama1b.mlp":
            launches.update(timed("codesign deployed program",
                                  deployed_program, torch, d, x_q, name,
                                  a_bits, out))
        del d, x_q
    for part in (readme_search, measured_search):
        t0 = time.time()
        launches.update(part(torch, out))
        out.setdefault("part_s", {})[part.__name__] = time.time() - t0
        print(f"time: codesign {part.__name__} {time.time() - t0:.1f} s")
    timed("codesign qat steps", qat_steps, torch, out)
    return dict(launches)


# ---------------------------------------------------------------------------
# Phase 12: training
# ---------------------------------------------------------------------------

#: the backward kernel's shapes: seamless-m4t-large-v2's training
#: attentions at batch 8, sequence 256 (encoder self, decoder self,
#: cross over a memory of another length), llama3.2-1b's GQA at S 2048, a
#: ragged causal shape whose tiles cross the diagonal, kv_offset > 0,
#: qwen2-vl-2b's (128, 128) at 12 query heads over 2, a D=128 GQA
#: shape whose tiles cross the diagonal, seamless's three at phase 14's 8
#: local heads a rank, and the wide pairs' instance: deepseek-v2's MLA
#: (keys 192 over values 128) at phase 15's training shape (128/128 heads,
#: B 2, S 1024), with tiles across the diagonal, and with the last dq
#: block's second warpgroup wholly past Sq (`mla_tail`: 130 rows, blocks
#: of 128), gemma-7b's (256, 256) at its training shape above
#: dense_attn_max (16/16 heads, S 8448) and with tiles across the diagonal
BWD_SHAPES = [
    FlashShape("seamless_enc", 8, 256, 256, 16, 16, 64, False, 0),
    FlashShape("seamless_dec", 8, 256, 256, 16, 16, 64, True, 0),
    FlashShape("cross", 8, 200, 320, 16, 16, 64, False, 0),
    FlashShape("llama_s2048", 2, 2048, 2048, 32, 8, 64, True, 0),
    FlashShape("ragged", 2, 1000, 1000, 32, 8, 64, True, 0),
    FlashShape("offset", 2, 300, 1000, 8, 8, 64, True, 700),
    FlashShape("qwen2vl_d128", 2, 512, 512, 12, 2, 128, True, 0),
    FlashShape("gqa_d128", 2, 1000, 1000, 32, 8, 128, True, 0),
    FlashShape("tp_seamless_enc", 8, 256, 256, 8, 8, 64, False, 0),
    FlashShape("tp_seamless_dec", 8, 256, 256, 8, 8, 64, True, 0),
    FlashShape("tp_cross", 8, 200, 320, 8, 8, 64, False, 0),
    FlashShape("mla_train", 2, 1024, 1024, 128, 128, 192, True, 0, 128),
    FlashShape("mla_ragged", 2, 1000, 1000, 16, 16, 192, True, 0, 128),
    FlashShape("mla_tail", 2, 130, 130, 4, 4, 192, True, 0, 128),
    FlashShape("d256_train", 1, 8448, 8448, 16, 16, 256, True, 0),
    FlashShape("d256_ragged", 2, 1000, 1000, 16, 16, 256, True, 0),
]
#: BWD_SHAPES rows whose forward is also timed (the forward launch a
#: training step makes, with its log-sum-exp): the wide pairs' training
#: shapes, which FLASH_SHAPES (serving) does not have
FWD_TIMED = ("mla_train", "d256_train")
#: kernel vs plain backward, bf16: each of dq, dk, dv within 4 bf16 steps
#: (2^-8 relative) of the gradient's max |.|. The two differ in where they
#: round: the kernel rounds p and ds to bf16 before its products (half a
#: step each), the plain version's autograd rounds dp to bf16 (the
#: gradient of its p.to(bf16)) and sums dk and dv over its query chunks in
#: bf16; both round the gradient itself (half a step)
BWD_TOL = 4 * 2 ** -8
#: kernel vs plain backward, per row of dq, dk and dv: |got - want| over
#: |want| + :data:`BWD_ROW_FLOOR` times the largest row's |want| (L2 norms
#: over the head dimension). On the CPU a causal limit one key short
#: moves a row by 0.24 (dq) to 0.7 (dk, dv), the bf16 plain version
#: against fp32 by 0.01 at most (tests/test_torch_train.py)
BWD_ROW_TOL = 0.1
#: the floor of the per-row check, for rows whose gradient vanishes: a
#: causal query 0 sees one key, so its dq is 0, which the plain version's
#: autograd computes as the difference of its bf16-rounded dp and an fp32
#: delta (noise of 4e-4 of the largest row at seamless's decoder shape)
BWD_ROW_FLOOR = 5e-2
#: the forward's log-sum-exp against the plain version's: absolute (the
#: kernel's exponents are ex2.approx, 2 ulp, and its maximum is taken
#: in base 2)
LSE_TOL = 1e-4
#: the dq launch's delta against ``bwd_prep_plain``, relative to the row's
#: sum of |dout * out|: both are fp32 sums of the same D <= 128 exact
#: products in another order, which differ by at most ~D rounding steps
#: of 2^-24 of that sum (2^-17 at D 128); twice that
DELTA_TOL = 2 ** -16
#: the seamless run: whole, published widths, bf16
TRAIN_SEAMLESS = ["--arch", "seamless-m4t-large-v2", "--batch", "8",
                  "--seq", "256", "--steps", "5", "--seed", "0",
                  "--log-every", "1"]
#: llama3.2-1b at published width and depth, the reference's dense
#: attention below 8192 tokens
TRAIN_LLAMA = ["--arch", "llama3.2-1b", "--batch", "4", "--seq", "2048",
               "--steps", "3", "--seed", "0", "--log-every", "1"]
#: step 1 through the kernels vs with attn_mode="ref", same state and
#: batch: the loss within 1e-3 of itself (the two runs' activations differ
#: by bf16 roundings flipped where attention's fp32 sums are taken in
#: another order, averaged over 2,040 predicted tokens), the gradient
#: norm within 1e-2 of itself; each updated bf16 parameter within one
#: bf16 step of the other run's (2^-7 of its |.|, plus 2 lr for values
#: below a step of lr: step 1 moves a parameter by lr times the sign of
#: its gradient, which can differ where it is near 0); the first moments
#: (0.1 x the clipped gradient, fp32) within 0.1 in relative L2 over all
#: leaves. Those flipped roundings move some of seamless's ReLU inputs
#: across 0, which takes a token's whole term out of a weight's gradient
#: sum: a fraction f of flips moves a leaf's gradient by about sqrt(f) in
#: relative L2 (0.4% of them, one bf16 step's worth at the kink, give
#: 6%). The first guess, 2e-2, was under the 4.9% measured (chip run 8,
#: PR 24); the backward kernel itself is held per shape above
STEP_TOL = dict(loss=1e-3, grad_norm=1e-2, moments=0.1)
#: the resume check: llama3.2-1b's smoke config (fp32), batch 2, seq 64
RESUME = dict(arch="llama3.2-1b", batch=2, seq=64, steps=4, save_at=2)


def bwd_row_err(got, want) -> float:
    """The largest relative error of a gradient row [..., D] (see
    :data:`BWD_ROW_TOL`)."""
    norm = want.float().norm(dim=-1)
    diff = (got.float() - want.float()).norm(dim=-1)
    return float((diff / (norm + BWD_ROW_FLOOR * norm.max())).max())


def bwd_bound_ms(b, sq, skv, hq, hkv, d, causal, kv_offset,
                 entry=None, dv=None, elem=2, rate=BF16_FLOP_PER_S
                 ) -> tuple[float, str]:
    """Least time for the backward of one attention call (``entry`` None),
    or for one entry point (named by its dq / dkdv suffix): bytes of what
    it reads and writes (q, k, v, out, dout, dq, dk, dv of ``elem`` bytes
    each, 2 in bf16 and 4 in fp32; fp32 lse and delta, [B, Hq, Sq]) once
    over the HBM rate, vs its products over ``rate``, each 2·B·Hq per
    unmasked (query, key) pair times its depth: D for s, dk and dq, DV
    (default D) for dp and dv; five for the whole backward (s, dp, dv,
    dk, dq), four for dkdv (s, dp, dv, dk), three for dq (s, dp, dq) and
    delta's 2·B·Sq·Hq·DV (dq reads out, dout, q, k, v and lse, writes dq
    and delta; dkdv reads q, dout, k, v, lse and delta, writes dk and
    dv)."""
    dv = d if dv is None else dv
    qk_b = elem * b * sq * hq              # q, dq per column; out, dout too
    kv_b = elem * b * skv * hkv            # k, dk; v, dv
    st_b = 4 * b * hq * sq                 # lse, delta each
    if causal:
        pairs = sum(min(skv, r + kv_offset + 1) for r in range(sq))
    else:
        pairs = sq * skv
    prod = 2 * b * hq * pairs
    kind = None if entry is None else entry.rsplit("_", 1)[-1]
    nbytes, flops = {
        None: (2 * qk_b * (d + dv) + 2 * kv_b * (d + dv) + 2 * st_b,
               prod * (3 * d + 2 * dv)),
        "dq": (qk_b * (2 * d + 2 * dv) + kv_b * (d + dv) + 2 * st_b,
               prod * (2 * d + dv) + 2 * b * sq * hq * dv),
        "dkdv": (qk_b * (d + dv) + 2 * kv_b * (d + dv) + 2 * st_b,
                 prod * (2 * d + 2 * dv)),
    }[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def sdpa_bwd_fn(torch, q, k, v, dout, causal, kv_offset):
    """The backward of ``F.scaled_dot_product_attention`` alone, on the
    views :func:`sdpa_fn` makes (KV heads repeated outside the timed
    call): one forward with grad, then ``torch.autograd.grad`` on its
    retained graph per call. None where no SDPA backend takes the shape
    (the yardstick is then not measured)."""
    qt, kt, vt = (t.detach().requires_grad_() for t in (q, k, v))
    try:
        with torch.enable_grad():
            out = sdpa_fn(torch, qt, kt, vt, causal, kv_offset)()
        torch.autograd.grad(out, (qt, kt, vt), dout, retain_graph=True)
    except RuntimeError as e:
        print(f"sdpa backward: not measured at q {tuple(q.shape)}, v "
              f"{tuple(v.shape)}: {str(e).splitlines()[0]}")
        return None
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dout,
                                       retain_graph=True)


def fmt_ms(t) -> str:
    """A device time in ms, or "not measured" for None."""
    return "not measured" if t is None else f"{t:.4f}"


def ptxas_usage(torch, source: str) -> list[str]:
    """ptxas's registers and spills per kernel of ``source``."""
    from repro_torch.kernels import build
    lines, name = [], None
    for ln in build.report_path(source).read_text().splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(\w+?_kernel\w*?)E",
                      ln)
        if m:
            name = m.group(1)
        elif "Used" in ln or "spill" in ln:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return lines


def on_new_thread(fn):
    """``fn()`` on a new host thread, which has no current CUDA context
    until a CUDA call makes one (as autograd's device thread when the
    backward is the first work it runs); its result, or its error
    raised here."""
    box: dict = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as e:  # noqa: BLE001 - raised below
            box["err"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


def fwd_row(torch, name: str, q, k, v, out_k, scale: float, causal: bool,
            kv_offset: int) -> dict:
    """The forward launch a training step makes (with the log-sum-exp) at
    a backward shape: its output ``out_k`` against the plain version
    (:func:`flash_tol`, :data:`FLASH_ROW_TOL`), its device time beside
    the plain version's, SDPA's and the bound."""
    from repro_torch.kernels.flash_attention import _forward_kernel, \
        flash_attention_plain
    b, sq, hq, d = q.shape
    _, skv, hkv, dv = v.shape
    kw = dict(causal=causal, kv_offset=kv_offset)
    want = flash_attention_plain(q, k, v, **kw)
    err = float((out_k.float() - want.float()).abs().max())
    tol, row_err = flash_tol(v), flash_row_err(out_k, want)
    if not (err <= tol and row_err <= FLASH_ROW_TOL):
        raise AssertionError(
            f"fwd {name}: kernel vs plain max |err| {err} (tol {tol}), row "
            f"error {row_err} (tol {FLASH_ROW_TOL})")
    del want
    kern = lambda: _forward_kernel(q, k, v, scale, causal,  # noqa: E731
                                   kv_offset, with_lse=True)
    b_ms, b_by = flash_bound_ms(b, sq, skv, hq, hkv, d, causal, kv_offset,
                                dv)
    row = {"max_abs_err": err, "tol": tol, "row_err": row_err,
           **device_times(torch, {"ms": (kern, 10),
                                  "library_ms": (sdpa_fn(torch, q, k, v,
                                                         causal, kv_offset),
                                                 10)}),
           "plain_ms": cuda_ms(torch, lambda: flash_attention_plain(
               q, k, v, **kw), iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"train fwd {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} "
          f"D={d} DV={dv} causal={causal}, with the log-sum-exp: max |err| "
          f"{err:.3g} (tol {tol:.3g}), row error {row_err:.3g} (tol "
          f"{FLASH_ROW_TOL}); device {row['ms']:.4f} ms (plain "
          f"{row['plain_ms']:.4f}, sdpa {row['library_ms']:.4f}, bound "
          f"{b_ms:.4f} by {b_by})")
    return row


def bwd_shapes(torch, details: dict) -> dict:
    """The backward kernel against autograd through the plain version at
    :data:`BWD_SHAPES`, each entry point timed; returns the first shape's
    row per entry point (the kernels line's) with the largest errors."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _forward_kernel, \
        flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import ENTRY_POINTS, \
        bwd_prep_plain, entry_args, flash_attention_bwd, \
        flash_attention_bwd_plain
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = details.setdefault("bwd", [])
    for shape in BWD_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        dv = shape.v_dim
        q, k, v, dout = (torch.randn(sh, generator=gen, device="cuda",
                                     dtype=torch.bfloat16)
                         for sh in ((b, sq, hq, d), (b, skv, hkv, d),
                                    (b, skv, hkv, dv), (b, sq, hq, dv)))
        scale = d ** -0.5
        kw = dict(causal=causal, kv_offset=off)

        def grads():
            # through the autograd Function, as the train step reaches it
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            build.LAUNCHES.clear()
            with torch.enable_grad():
                out = flash_attention(*leaves, **kw)
                got = torch.autograd.grad(out, leaves, dout)
            torch.cuda.synchronize()
            read_window(build.LAUNCHES, {"flash_attention": 1,
                                         **{e: 1 for e in ENTRY_POINTS}},
                        f"bwd {name} forward + backward")
            return got
        got = grads()
        again = grads()
        bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
        want = flash_attention_bwd_plain(q, k, v, dout, **kw)
        errs, row_errs, abs_errs = {}, {}, {}
        for what, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"bwd {name}: {what} not finite or "
                                     f"not {tuple(w.shape)}")
            abs_errs[what] = float((g.float() - w.float()).abs().max())
            errs[what] = abs_errs[what] / float(w.float().abs().max())
            row_errs[what] = bwd_row_err(g, w)
        out_k, lse = _forward_kernel(q, k, v, scale, causal, off,
                                     with_lse=True)
        # the entry points as a fresh thread's first CUDA work: the same
        # gradients, bitwise
        fresh = on_new_thread(lambda: flash_attention_bwd(
            q, k, v, out_k, dout, lse, scale, causal, off))
        torch.cuda.synchronize()
        bitwise = bitwise and all(torch.equal(g, h)
                                  for g, h in zip(got, fresh))
        lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)[1]
        lse_err = float((lse - lse_p).abs().max())
        # each entry point alone, on the kernel forward's out and lse; dq
        # writes delta
        delta = torch.empty((b, hq, sq), device="cuda")
        bufs = [torch.empty_like(t) for t in (q, k, v)]
        args = entry_args(q, k, v, out_k, dout, lse, delta, *bufs, scale,
                          causal, off)
        fns = {e: ((lambda e=e: build.launch(e, q, *args[e])), 10)
               for e in ENTRY_POINTS}
        # the backward as a train step runs it: the entry points back to
        # back, dkdv's start overlapping dq's last blocks
        fns["bwd"] = (lambda: [build.launch(e, q, *args[e])
                               for e in ENTRY_POINTS], 10)
        lib = sdpa_bwd_fn(torch, q, k, v, dout, causal, off)
        if lib is not None:
            fns["sdpa_bwd"] = (lib, 10)
        times = device_times(torch, fns)
        times.setdefault("sdpa_bwd", None)
        # the plain backward's allocations can synchronise the host (its
        # autograd graph outgrows the allocator's pool): CUDA events over
        # back-to-back calls, which a slow yardstick barely notices
        times["plain_bwd"] = cuda_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, dout, **kw), iters=3, warmup=1)
        prod = dout.float() * out_k.float()
        delta_err = float(((delta - bwd_prep_plain(out_k, dout)).abs() /
                           prod.abs().sum(-1).transpose(1, 2).clamp_min(
                               1e-30)).max())
        if not (max(errs.values()) <= BWD_TOL and
                max(row_errs.values()) <= BWD_ROW_TOL and
                lse_err <= LSE_TOL and bitwise and delta_err <= DELTA_TOL):
            raise AssertionError(
                f"bwd {name}: kernel vs plain, relative max |err| {errs} "
                f"(tol {BWD_TOL}), row errors {row_errs} (tol "
                f"{BWD_ROW_TOL}), lse max |err| {lse_err} (tol {LSE_TOL}), "
                f"second call and a new thread's bitwise equal {bitwise}, "
                f"delta relative "
                f"error {delta_err} (tol {DELTA_TOL})")
        fwd = fwd_row(torch, name, q, k, v, out_k, scale, **kw) \
            if name in FWD_TIMED else None
        whole_ms, whole_by = bwd_bound_ms(b, sq, skv, hq, hkv, d, causal,
                                          off, dv=dv)
        row = {"shape": name, "b": b, "sq": sq, "skv": skv, "hq": hq,
               "hkv": hkv, "d": d, "dv": dv, "causal": causal,
               "kv_offset": off,
               "rel_err": errs, "abs_err": abs_errs, "row_err": row_errs,
               "lse_err": lse_err, "bitwise_repeat": bitwise,
               "delta_err": delta_err, "times_ms": times,
               "kernel_bwd_ms": times["bwd"],
               "entry_sum_ms": sum(times[e] for e in ENTRY_POINTS),
               "bound_ms": whole_ms, "bound_by": whole_by,
               "entry_bounds": {e: bwd_bound_ms(b, sq, skv, hq, hkv, d,
                                                causal, off, e, dv=dv)
                                for e in ENTRY_POINTS},
               "forward": fwd}
        rows.append(row)
        print(f"train bwd {name}: B={b} Sq={sq} Skv={skv} Hq={hq} "
              f"Hkv={hkv} D={d} DV={dv} causal={causal} kv_offset={off}: "
              f"relative "
              f"max |err| dq {errs['dq']:.3g} dk {errs['dk']:.3g} dv "
              f"{errs['dv']:.3g} (tol {BWD_TOL:.3g}), row error dq "
              f"{row_errs['dq']:.3g} dk {row_errs['dk']:.3g} dv "
              f"{row_errs['dv']:.3g} (tol {BWD_ROW_TOL}), lse "
              f"{lse_err:.3g} (tol {LSE_TOL}), delta {delta_err:.3g} (tol "
              f"{DELTA_TOL:.3g}), second call and a new thread's bitwise "
              f"equal {bitwise}; "
              "device ms "
              + ", ".join(f"{e.replace('flash_attention_bwd_', '')} "
                          f"{times[e]:.4f}" for e in ENTRY_POINTS)
              + f" (back to back {row['kernel_bwd_ms']:.4f}, sum "
              f"{row['entry_sum_ms']:.4f}; plain backward "
              f"{times['plain_bwd']:.4f}, sdpa backward "
              f"{fmt_ms(times['sdpa_bwd'])}; bound {whole_ms:.4f} by "
              f"{whole_by})")
        del q, k, v, dout, got, again, want, out_k, bufs
    for ln in ptxas_usage(torch, "flash_attention_bwd"):
        print(f"train bwd ptxas: {ln}")
    details["bwd_ptxas"] = ptxas_usage(torch, "flash_attention_bwd")
    first = rows[0]
    grads = {"flash_attention_bwd_dkdv": ("dk", "dv"),
             "flash_attention_bwd_dq": ("dq",)}
    out = {}
    for e in ENTRY_POINTS:
        b_ms, b_by = first["entry_bounds"][e]
        out[e] = {"max_abs_err": max(r["abs_err"][g] for r in rows
                                     for g in grads[e]),
                  "ms": first["times_ms"][e],
                  "plain_ms": first["times_ms"]["plain_bwd"],
                  "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": first["times_ms"]["sdpa_bwd"]}
    return out


def train_launches(arch, steps: int = 1, seq: int = 0) -> dict:
    """The kernel launches of ``steps`` train steps of ``arch`` at
    sequence length ``seq``, read from the code: each
    ``blockwise_attention`` launches the forward once in the forward pass
    and once more in ``remat="full"``'s recompute, and each backward entry
    point once; fp32 configs launch the fp32 kernel's entry points. An
    encoder-decoder makes one call per encoder layer and two per decoder
    layer (self and cross); an LM one a layer where it reaches the kernel
    (MLA always, the others above ``dense_attn_max``,
    ``launch.train.train_flash_heads``), else none."""
    import torch
    from repro_torch.kernels.flash_attention_bwd import entry_points
    from repro_torch.launch.train import train_flash_heads
    cfg = arch.model
    if train_flash_heads(arch, seq) is None:
        return {}
    if arch.module == "encdec":
        n = cfg.n_enc_layers + 2 * cfg.n_dec_layers
    elif arch.module == "lm":
        n = cfg.n_layers
    else:
        raise ValueError(f"{arch.arch_id}: no launch count for "
                         f"{arch.module}")
    fwd = 2 if cfg.remat == "full" else 1
    f32 = cfg.param_dtype == torch.float32
    return {"flash_attention_f32" if f32 else "flash_attention":
            fwd * n * steps,
            **{e: n * steps for e in entry_points(cfg.param_dtype)}}


def run_launcher(torch, argv: list, want: dict, what: str) -> dict:
    """``repro_torch.launch.train.main(argv)`` in a launch window of its
    own: exactly ``want``; finite losses and gradient norms, the step
    count advanced; host seconds a step, tokens/s and peak memory."""
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    res = train.main(argv)
    torch.cuda.synchronize()
    window = read_window(LAUNCHES, want, what)
    steps = int(argv[argv.index("--steps") + 1])
    if int(res["state"].step) != steps:
        raise AssertionError(f"{what}: state.step {int(res['state'].step)} "
                             f"!= {steps}")
    losses = [float(m["loss"]) for m in res["metrics"]]
    norms = [float(m["grad_norm"]) for m in res["metrics"]]
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"{what}: losses {losses}, |g| {norms}")
    return {"window": window, "losses": losses, "grad_norms": norms,
            "step_ms": [1e3 * t for t in res["step_s"]],
            "tok_per_s": res["tok_per_s"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def first_batch(torch, arch, argv: list) -> dict:
    """The launcher's first batch for ``argv`` (its tokens and, for an
    encoder-decoder, its frames), on the card."""
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.launch import train
    get = lambda f: int(argv[argv.index(f) + 1])  # noqa: E731
    b, s, seed = get("--batch"), get("--seq"), get("--seed")
    batch = {k: t.cuda() for k, t in SyntheticTokens(
        arch.model.vocab, b, s, seed=seed).next_batch().items()}
    if arch.module == "encdec":
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        batch["frames"] = train.step_frames(gen, b, s, arch.model.d_model,
                                            "cuda")
    return batch


def state_agreement(torch, params, params_ref, moments, moments_ref,
                    lr: float) -> dict:
    """Two step-1 states (leaf lists) held against each other as
    :data:`STEP_TOL` holds them: the first moments' relative L2 over all
    leaves (m is 0.1 times the clipped gradient, so this holds each
    leaf's gradient) and the four worst leaves'; the updated parameters
    outside one bf16 step (2^-7 |ref| + 2 lr x 1.01: a near-zero
    gradient may take the other sign) and the share of them bitwise
    equal (mean over leaves)."""
    if not (len(params) == len(params_ref) and
            len(moments) == len(moments_ref)):
        raise AssertionError("the two states have different leaves")
    num = den = 0.0
    per_leaf = []
    for i, (a, b) in enumerate(zip(moments, moments_ref)):
        n, dd = float(torch.sum(torch.square(a - b))), \
            float(torch.sum(torch.square(b)))
        num, den = num + n, den + dd
        per_leaf.append((math.sqrt(n / max(dd, 1e-30)), i))
    p_bad, p_frac = 0, []
    for a, b in zip(params, params_ref):
        bf = b.float()
        bound = 2 ** -7 * bf.abs() + 2 * lr * 1.01
        p_bad += int(((a.float() - bf).abs() > bound).sum())
        if b.numel():  # a cut config keeps empty leaves (no MoE layer)
            p_frac.append(float((a == b).float().mean()))
    return {"moments_rel_l2": math.sqrt(num / max(den, 1e-30)),
            "worst_leaves": sorted(per_leaf, reverse=True)[:4],
            "params_outside": p_bad,
            "params_bitwise_share": statistics.mean(p_frac)}


def step_agreement(torch, arch, argv: list) -> dict:
    """Step 1 through the kernels and with ``attn_mode="ref"`` from one
    state on one batch, held to :data:`STEP_TOL`; also the device time
    of a step (profiler) and its busy share."""
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    steps = int(argv[argv.index("--steps") + 1])
    seed = int(argv[argv.index("--seed") + 1])
    opt_cfg = AdamWConfig(total_steps=steps)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state = init_train_state(arch.model_module().init(arch.model, gen))
    batch = first_batch(torch, arch, argv)
    kern = make_train_step(arch, opt_cfg)
    LAUNCHES.clear()
    s_k, m_k = kern(state, batch)
    torch.cuda.synchronize()
    read_window(LAUNCHES, train_launches(
        arch, seq=int(argv[argv.index("--seq") + 1])),
        "train step 1 (kernels)")
    new_k, mom_k = s_k.params, s_k.opt.m
    del s_k
    LAUNCHES.clear()
    s_r, m_r = make_train_step(arch, opt_cfg, attn_mode="ref")(state, batch)
    torch.cuda.synchronize()
    read_window(LAUNCHES, {}, "train step 1 (attn_mode=ref)")
    lr = float(m_r["lr"])
    loss_err = abs(float(m_k["loss"]) - float(m_r["loss"]))
    gn_err = abs(float(m_k["grad_norm"]) - float(m_r["grad_norm"]))
    agree = state_agreement(torch, tree_leaves(new_k),
                            tree_leaves(s_r.params), tree_leaves(mom_k),
                            tree_leaves(s_r.opt.m), lr)
    mom_err, p_bad = agree["moments_rel_l2"], agree["params_outside"]
    worst = agree["worst_leaves"]
    result = {"loss_kernel": float(m_k["loss"]),
              "loss_ref": float(m_r["loss"]), "loss_err": loss_err,
              "grad_norm_kernel": float(m_k["grad_norm"]),
              "grad_norm_ref": float(m_r["grad_norm"]),
              "grad_norm_err": gn_err, **agree}
    del s_r, new_k, mom_k
    print(f"train: {arch.arch_id} step 1 kernels vs attn_mode=ref: loss "
          f"{result['loss_kernel']:.6f} vs {result['loss_ref']:.6f}, |g| "
          f"{result['grad_norm_kernel']:.6f} vs "
          f"{result['grad_norm_ref']:.6f}, moments relative L2 "
          f"{mom_err:.4g}, updated params bitwise equal "
          f"{100 * result['params_bitwise_share']:.3f}% (mean over "
          f"leaves), {p_bad} outside one bf16 step; worst leaves' moments "
          f"(relative L2, leaf index) {[(round(e, 4), i) for e, i in worst]}")
    if not (loss_err <= STEP_TOL["loss"] * abs(result["loss_ref"]) and
            gn_err <= STEP_TOL["grad_norm"] * result["grad_norm_ref"] and
            mom_err <= STEP_TOL["moments"] and p_bad == 0):
        raise AssertionError(f"{arch.arch_id}: step 1 kernels vs "
                             f"attn_mode=ref outside {STEP_TOL}: {result}")
    # device time of one step through the kernels, and its host time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern(state, batch)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    dev = busy_ms(torch, lambda: kern(state, batch), iters=1)
    result.update(step_host_ms=host_ms, step_device_ms=dev)
    del state, batch
    torch.cuda.empty_cache()
    return result


def train_arch(torch, argv: list, out: dict) -> dict:
    """One arch through the launcher at ``argv`` (published config), then
    :func:`step_agreement` where the step launches kernels, else the
    device time of one step."""
    from repro_torch.configs import registry
    from repro_torch.launch.serve import model_depth
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    arch = registry.get(argv[argv.index("--arch") + 1])
    steps = int(argv[argv.index("--steps") + 1])
    tokens = int(argv[argv.index("--batch") + 1]) * int(
        argv[argv.index("--seq") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    want = train_launches(arch, steps, seq)
    run = run_launcher(torch, argv, want, f"train {arch.arch_id} launcher "
                       f"({steps} steps)")
    per_step = train_launches(arch, seq=seq)
    med = statistics.median(run["step_ms"][1:])
    print(f"train: {arch.arch_id} {model_depth(arch.model)} layers d_model "
          f"{arch.model.d_model} bf16, "
          f"{arch.model_module().param_count(arch.model) / 1e9:.3f} B "
          f"params, batch x seq {tokens}: launches per step "
          f"{per_step or 'none'} (window of {steps} steps "
          f"{run['window'] or 'empty'}); losses "
          f"{[round(x, 4) for x in run['losses']]}, |g| "
          f"{[round(x, 3) for x in run['grad_norms']]}; host ms a step "
          f"{', '.join(f'{t:.1f}' for t in run['step_ms'])} (median of "
          f"steps 2-{steps} {med:.1f} ms, {tokens / med * 1e3:.0f} tok/s; "
          f"launcher {run['tok_per_s']:.0f} tok/s over its run); peak "
          f"{run['peak_gib']:.2f} GiB")
    if want:
        step = step_agreement(torch, arch, argv)
    else:
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = init_train_state(arch.model_module().init(arch.model, gen))
        batch = first_batch(torch, arch, argv)
        fn = make_train_step(arch, AdamWConfig(total_steps=steps))
        fn(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(state, batch)
        torch.cuda.synchronize()
        step = {"step_host_ms": 1e3 * (time.perf_counter() - t0),
                "step_device_ms": busy_ms(torch, lambda: fn(state, batch),
                                          iters=1)}
        del state, batch
        torch.cuda.empty_cache()
    print(f"train: {arch.arch_id} one step {step['step_host_ms']:.1f} ms "
          f"host, device "
          f"{busy_text(step['step_device_ms'], step['step_host_ms'])}")
    out[arch.arch_id] = {**run, **step, "median_step_ms": med,
                         "tokens_per_step": tokens,
                         "launches_per_step": per_step}
    return run["window"]


def resume_check(torch, out: dict) -> None:
    """:data:`RESUME`: save at step ``save_at``, restore into a fresh
    state (other random weights), and steps after it bitwise equal to
    the run without the restart; no kernel launches (fp32 smoke config,
    dense attention)."""
    import dataclasses
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    r = RESUME
    arch = registry.get(r["arch"])
    arch = dataclasses.replace(arch, model=arch.smoke)
    mod, cfg = arch.model_module(), arch.model
    data = SyntheticTokens(cfg.vocab, r["batch"], r["seq"], seed=0)
    batches = [{k: t.cuda() for k, t in data.next_batch().items()}
               for _ in range(r["steps"])]
    fn = make_train_step(arch, AdamWConfig(total_steps=r["steps"]))
    fresh = lambda seed: init_train_state(mod.init(  # noqa: E731
        cfg, torch.Generator(device="cuda").manual_seed(seed)))

    def leaves(st):
        return tree_leaves(st.params) + tree_leaves(st.opt.m) + \
            tree_leaves(st.opt.v) + [st.opt.count, st.step]

    LAUNCHES.clear()
    state, metrics = fresh(0), []
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        for i, batch in enumerate(batches):
            if i == r["save_at"]:
                mgr.save(i, state, blocking=True)
            state, m = fn(state, batch)
            metrics.append(m)
        restored = mgr.restore(fresh(1))
    if int(restored.step) != r["save_at"]:
        raise AssertionError(f"resume: restored step {int(restored.step)}")
    rmetrics = []
    for batch in batches[r["save_at"]:]:
        restored, m = fn(restored, batch)
        rmetrics.append(m)
    torch.cuda.synchronize()
    read_window(LAUNCHES, {}, "resume (fp32 smoke, dense attention)")
    same = all(torch.equal(a, b) for a, b in zip(leaves(state),
                                                 leaves(restored)))
    same_m = all(torch.equal(a[k], b[k]) for a, b in
                 zip(metrics[r["save_at"]:], rmetrics)
                 for k in ("loss", "grad_norm"))
    print(f"train: resume {cfg.name} on the card: saved at step "
          f"{r['save_at']}, restored into a fresh state, steps "
          f"{r['save_at'] + 1}-{r['steps']} bitwise equal to the run "
          f"without a restart: state {same}, losses and |g| {same_m}")
    out["resume"] = {"state_bitwise": same, "metrics_bitwise": same_m}
    if not (same and same_m):
        raise AssertionError("resume: steps after the restore differ from "
                             "the run without a restart")


def phase_train(torch, details: dict) -> dict:
    """Phase 12. Returns the backward entry points' rows for the kernels
    line and the launches of the seamless run (the main path's)."""
    out = details.setdefault("train", {})
    rows = timed("train bwd_shapes", bwd_shapes, torch, out)
    window = timed("train seamless", train_arch, torch, TRAIN_SEAMLESS, out)
    llama = timed("train llama3.2-1b", train_arch, torch, TRAIN_LLAMA, out)
    if llama:
        raise AssertionError(f"llama3.2-1b training launched {llama}")
    timed("train resume", resume_check, torch, out)
    return {"rows": rows, "launches": window}


# ---------------------------------------------------------------------------
# Phase 13: the parallel layer
# ---------------------------------------------------------------------------

#: seamless-m4t-large-v2 at published widths cut to this many encoder and
#: decoder layers, so that two data-parallel ranks and the one-process
#: reference share the card and the phase stays short (6, then 3, then 1
#: since the script once ran past its limit: each run's checkpoints, 7 GB
#: a step at 3 + 3 layers, and the fp32 gradient bucket through gloo are
#: host work; the 0.52 B parameters of the embeddings and the output
#: projection stay)
PARALLEL_LAYERS = 1
#: the data-parallel run: TRAIN_SEAMLESS's global batch 8 x seq 256, 2
#: steps, on the cut arch (its id is filled in by :func:`cut_seamless`)
PARALLEL_TRAIN = ["--batch", "8", "--seq", "256", "--steps", "2", "--seed",
                  "0", "--log-every", "1"]
#: ranks sharing the card over gloo in the data-parallel run
DP_RANKS = 2
#: the pipeline: llama3.2-1b's 16 decoder layers at published width, 4
#: stages x 4 layers, 8 micro-batches of 1 x 256 tokens, bf16 inputs
#: 0.5 N(0, 1) from a seeded generator on the card
PIPE = dict(arch="llama3.2-1b", stages=4, n_micro=8, batch=8, seq=256,
            seed=3)
#: the workers' time limit (spawned ranks are killed past it)
RANK_TIMEOUT_S = 400


def cut_seamless() -> str:
    """Register seamless-m4t-large-v2 cut to :data:`PARALLEL_LAYERS`
    encoder and decoder layers (published widths) under an arch id of
    its own, once per process; returns the id."""
    import dataclasses
    from repro_torch.configs import registry
    base = registry.get("seamless-m4t-large-v2")
    n = PARALLEL_LAYERS
    arch_id = f"{base.arch_id}-{n}+{n}L"
    if arch_id not in registry.list_archs():
        registry.register(dataclasses.replace(
            base, arch_id=arch_id, model=dataclasses.replace(
                base.model, n_enc_layers=n, n_dec_layers=n)))
    return arch_id


def _words(torch, b):
    """Bytes (a uint8 tensor) zero-padded to whole int32 words."""
    pad = (-b.numel()) % 4
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32)


def state_digest(torch, state) -> list:
    """Per leaf of a train state (params, moments, count, step), two int64
    sums over its bytes read as int32 words (plain and weighted by the
    word's index mod 1000003): equal tensors give equal digests, and a
    changed word changes them."""
    from repro_torch.models.layers import tree_leaves
    leaves = (tree_leaves(state.params) + tree_leaves(state.opt.m) +
              tree_leaves(state.opt.v) + [state.opt.count, state.step])
    out = []
    for t in leaves:
        w = _words(torch, t.detach().contiguous().reshape(-1)
                   .view(torch.uint8)).long()
        idx = torch.arange(w.numel(), device=w.device) % 1000003 + 1
        out.append([int(w.sum()), int((w * idx).sum())])
    return out


def step1_state(torch, arch, ckpt_dir: str) -> tuple[list, list]:
    """Step 1's parameters and first moments, as leaf lists on the card,
    from the checkpoint that a launcher run with ``--ckpt-every 1``
    wrote (only those leaves are read)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.step import TrainState
    abstract = arch.model_module().abstract(arch.model)
    like = TrainState(
        params=tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cuda"), abstract),
        opt=OptState(m=tree_map(lambda t: torch.empty(
            t.shape, dtype=torch.float32, device="cuda"), abstract),
            v=None, count=None),
        step=None)
    got = CheckpointManager(ckpt_dir).restore(like, step=1)
    return tree_leaves(got.params), tree_leaves(got.opt.m)


def dp_worker(rank: int, world: int, out_dir: str, argv: list,
              ckpt_dir: str) -> None:
    """One data-parallel rank: ``launch.train.main(argv)`` under the group
    with ``--ckpt-dir ckpt_dir --ckpt-every 1`` (rank 0 writes each
    step's state), its flash launches over the run read. Then one more
    step under the profiler (device ms), ``reduce_gradients`` on the
    parameters' shapes timed, the final state's digest and peak memory,
    written to ``out_dir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import make_train_step, reduce_gradients
    arch = registry.get(cut_seamless())
    # whether this group's backend reduces bf16 CUDA tensors (the train
    # step reduces an fp32 bucket either way)
    probe = torch.ones(4, dtype=torch.bfloat16, device="cuda")
    try:
        dist.all_reduce(probe)
        bf16 = f"sums to {probe[0].item()}"
    except RuntimeError as e:
        bf16 = f"refused: {str(e).splitlines()[0][:120]}"
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    res = train.main(["--arch", arch.arch_id, "--ckpt-dir", ckpt_dir,
                      "--ckpt-every", "1", *argv])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    mesh, rows = res["mesh"], res["rows"]
    get = lambda f: int(argv[argv.index(f) + 1])  # noqa: E731
    b, s, seed = get("--batch"), get("--seq"), get("--seed")
    batch = {k: t[rows].cuda() for k, t in SyntheticTokens(
        arch.model.vocab, b, s, seed=seed).next_batch().items()}
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    batch["frames"] = train.step_frames(gen, b, s, arch.model.d_model,
                                        "cuda")[rows]
    step_fn = make_train_step(arch, AdamWConfig(total_steps=get("--steps")),
                              mesh=mesh)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(res["state"], batch)
        torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    LAUNCHES.clear()
    ar_ms = []
    for _ in range(2):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce_gradients(res["state"].params, mesh)
        torch.cuda.synchronize()
        ar_ms.append(1e3 * (time.perf_counter() - t0))
    numel = sum(p.numel() for p in tree_leaves(res["state"].params))
    out = {"rank": rank, "backend": dist.get_backend(),
           "bf16_allreduce": bf16,
           "device": torch.cuda.current_device(),
           "mesh": [list(mesh.mesh_dim_names), list(mesh.shape)],
           "rows": [rows.start, rows.stop], "launches": launches,
           "losses": [float(m["loss"]) for m in res["metrics"]],
           "grad_norms": [float(m["grad_norm"]) for m in res["metrics"]],
           "lrs": [float(m["lr"]) for m in res["metrics"]],
           "step_host_ms": [1e3 * t for t in res["step_s"]],
           "profiled_step_host_ms": host_ms,
           "profiled_step_device_ms": us / 1e3 if us else None,
           "allreduce_ms": ar_ms, "allreduce_bytes": 4 * numel,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "digest": state_digest(torch, res["state"])}
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))


def pipe_stage_body(torch, cfg):
    """One stage's body: its layers of the LM stack in order, each the
    model's own pre-norm block (``lm._layer_apply``) at positions
    0..S-1, as ``lm.forward`` runs them."""
    from repro_torch.models import lm

    def body(p_stage, h):
        pos = lm._positions(h.shape[0], h.shape[1], 0, h.device)
        for i in range(p_stage["ln_attn"].shape[0]):
            h, _ = lm._layer_apply(lm._layer(p_stage, i), h, pos, cfg)
        return h
    return body


def pipe_inputs(torch):
    """:data:`PIPE`'s llama3.2-1b stack (the model's own init from the
    seed) and its input batch, on the card."""
    from repro_torch.configs import registry
    arch = registry.get(PIPE["arch"])
    cfg = arch.model
    params = arch.model_module().init(
        cfg, torch.Generator(device="cuda").manual_seed(PIPE["seed"]))
    layers = params["layers"]
    del params
    x = 0.5 * torch.randn((PIPE["batch"], PIPE["seq"], cfg.d_model),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(PIPE["seed"] + 1), device="cuda")
    return cfg, layers, x.to(cfg.param_dtype)


def pipe_worker(rank: int, world: int, out_dir: str) -> None:
    """One pipeline stage: ``gpipe`` over a ("pod",) mesh of ``world``
    stages on the stacked layers; the output, every rank's equal to rank
    0's (bitwise), and ms a tick of the second call."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel import gpipe, stage_params_from_stack
    cfg, layers, x = pipe_inputs(torch)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("pod",))
    run = gpipe(pipe_stage_body(torch, cfg), mesh, "pod", PIPE["n_micro"])
    stages = stage_params_from_stack(layers, world)
    with torch.no_grad():
        y = run(stages, x)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        y2 = run(stages, x)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    ref = y.clone()
    dist.broadcast(ref, 0)
    out = {"same_as_rank0": bool(torch.equal(y, ref)),
           "second_call_same": bool(torch.equal(y, y2)),
           "ms": ms, "ticks": PIPE["n_micro"] + world - 1,
           "backend": dist.get_backend()}
    if rank == 0:
        torch.save(y.cpu(), Path(out_dir) / "pipe_y.pt")
    (Path(out_dir) / f"pipe{rank}.json").write_text(json.dumps(out))


def one_process_reference(torch, arch_id: str, tmp: str) -> dict:
    """The one-process launcher on the cut arch at :data:`PARALLEL_TRAIN`
    (no process group), with a checkpoint each step under ``tmp``: every
    step's metrics and step 1's parameters and first moments."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    ckpt = str(Path(tmp) / "ckpt-one-process")
    torch.cuda.empty_cache()
    res = train.main(["--arch", arch_id, "--ckpt-dir", ckpt,
                      "--ckpt-every", "1", *PARALLEL_TRAIN])
    keep = {"losses": [float(m["loss"]) for m in res["metrics"]],
            "grad_norms": [float(m["grad_norm"]) for m in res["metrics"]],
            "lrs": [float(m["lr"]) for m in res["metrics"]],
            "step_host_ms": [1e3 * t for t in res["step_s"]]}
    del res
    torch.cuda.empty_cache()
    keep["params"], keep["moments"] = step1_state(
        torch, registry.get(arch_id), ckpt)
    return keep


#: the launcher's own group: llama3.2-1b's smoke config (fp32, no flash
#: launch) under a world-1 torchrun environment, and as one process
TORCHRUN_ARGV = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                 "--seq", "64", "--steps", "2", "--seed", "0",
                 "--log-every", "1"]


def torchrun_world_one(torch, out: dict) -> None:
    """``launch.train.main`` with no group made for it, under a world-1
    ``torchrun`` environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT): it makes an NCCL group on cuda:0 (its log names the
    backend), trains on the (1, 1) host mesh and tears the group down;
    its parameters bitwise equal to the plain one-process run's (a world
    of one reduces nothing)."""
    import io
    import os
    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.ranks import free_port
    from repro_torch.models.layers import tree_leaves
    plain = train.main(TORCHRUN_ARGV)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    if dist.is_initialized() or any(k in os.environ for k in env):
        raise AssertionError("parallel: a group or a torchrun environment "
                             "exists before the torchrun-style run")
    os.environ.update(env)
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            res = train.main(TORCHRUN_ARGV)
    finally:
        for k in env:
            os.environ.pop(k)
    said = [ln for ln in log.getvalue().splitlines()
            if ln.startswith("# data parallel")]
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res["state"].params), tree_leaves(plain["state"].params)))
    got = {"log": said, "mesh": [list(res["mesh"].mesh_dim_names),
                                 list(res["mesh"].shape)],
           "group_left": dist.is_initialized(), "bitwise": same}
    print(f"parallel: launch.train under a world-1 torchrun environment "
          f"(no group made for it): {said}, mesh {got['mesh']}, group torn "
          f"down {not got['group_left']}; params bitwise equal to the plain "
          f"one-process run: {same}")
    out["torchrun"] = got
    if not (said == ["# data parallel: world 1 over nccl, mesh ('data', "
                     "'model') (1, 1)"] and not got["group_left"] and same):
        raise AssertionError(f"parallel: torchrun-style launch {got}")


def nccl_world_one(torch, arch_id: str, out: dict):
    """Item 1: a world-1 NCCL group on the card and ``make_host_mesh``;
    ``shard_params_tree`` of the cut seamless's parameters bitwise equal
    to them, and ``compressed_grad_allreduce(axis_name="data")`` over
    the group bitwise equal to ``axis_name=None``. Returns the mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import free_port
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel import compress, shard_params_tree
    from repro_torch.parallel.sharding import DEFAULT_RULES
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    mesh = make_host_mesh("cuda")
    arch = registry.get(arch_id)
    mod = arch.model_module()
    params = mod.init(arch.model, torch.Generator(device="cuda")
                      .manual_seed(0))
    rules = DEFAULT_RULES.replace(**arch.rule_overrides)
    sharded = shard_params_tree(params, mod.param_axes(arch.model), mesh,
                                rules)
    pairs = list(zip(tree_leaves(params), tree_leaves(sharded)))
    same = all(isinstance(d, DTensor) and d.device.type == "cuda" and
               torch.equal(d.full_tensor(), p) and
               torch.equal(d.to_local(), p) for p, d in pairs)
    grads = {"g": params["dec_layers"]["mlp"]["down"][0],
             "e": params["embed"][:4096].float(),
             "n": params["ln_dec"]}
    state = compress.init_compression_state(grads)
    a, sa = compress.compressed_grad_allreduce(grads, state,
                                               axis_name="data", mesh=mesh)
    b, sb = compress.compressed_grad_allreduce(grads, state)
    c_same = all(torch.equal(x, y) for x, y in
                 zip(tree_leaves(a) + tree_leaves(sa.residual),
                     tree_leaves(b) + tree_leaves(sb.residual)))
    print(f"parallel: world-1 {dist.get_backend()} group, make_host_mesh "
          f"{tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)}; "
          f"shard_params_tree on {arch_id} ({len(pairs)} leaves, "
          f"{sum(p.numel() for p, _ in pairs) / 1e9:.3f} B params) DTensors "
          f"on cuda bitwise equal to the input: {same}; "
          f"compressed_grad_allreduce(axis_name='data') over NCCL bitwise "
          f"equal to axis_name=None (3 leaves, bf16/fp32): {c_same}")
    out["world1"] = {"shard_bitwise": same, "compress_bitwise": c_same}
    if not (same and c_same):
        raise AssertionError(f"parallel: world-1 NCCL checks {out['world1']}")
    del params, sharded, pairs, grads
    torch.cuda.empty_cache()
    return mesh


def elastic_restore(torch, arch_id: str, mesh, ckpt_dir: str,
                    digest: list, out: dict) -> None:
    """Item 4: the data-parallel run's checkpoint (written by rank 0) in
    this process onto the world-1 NCCL mesh, each leaf a DTensor with its
    spec-tree placements: the state's digest equal to rank 0's."""
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.parallel.sharding import DEFAULT_RULES, NamedSharding, \
        spec_tree_for
    from repro_torch.train.step import init_train_state, train_state_axes
    arch = registry.get(arch_id)
    mod = arch.model_module()
    abstract = mod.abstract(arch.model)          # on meta: no storage
    like = init_train_state(abstract)
    specs = spec_tree_for(
        train_state_axes(mod.param_axes(arch.model)), mesh,
        DEFAULT_RULES.replace(**arch.rule_overrides),
        shape_tree=train_state_axes(tree_map(lambda t: tuple(t.shape),
                                             abstract)))
    shardings = tree_map(
        lambda s: None if s is None else NamedSharding(mesh, s), specs)
    t0 = time.perf_counter()
    got = CheckpointManager(ckpt_dir).restore(like, shardings=shardings)
    restore_s = time.perf_counter() - t0
    leaves = tree_leaves(got.params)
    sharded = sum(1 for t in leaves if isinstance(t, DTensor) and any(
        p.is_shard() for p in t.placements))
    full = tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor)
                    else t, got)
    same = state_digest(torch, full) == digest
    print(f"parallel: elastic restore of rank 0's step-"
          f"{int(full.step)} checkpoint in one process onto the world-1 "
          f"NCCL mesh as DTensors ({sharded} of {len(leaves)} parameter "
          f"leaves Shard-placed by the spec tree) in {restore_s:.1f} s: "
          f"state bitwise equal to the ranks' (digest of params, moments, "
          f"count, step): {same}")
    out["elastic"] = {"bitwise": same, "restore_s": restore_s,
                      "sharded_leaves": sharded}
    if not same:
        raise AssertionError("parallel: the elastic restore differs from "
                             "the ranks' final state")
    del got, full, like
    torch.cuda.empty_cache()


def data_parallel(torch, arch_id: str, ref: dict, backend: str, world: int,
                  tmp: str, what: str, out: dict) -> dict:
    """Item 2 (and 5): :func:`dp_worker` on ``world`` ranks over
    ``backend``. Every rank's flash launches over the run exactly
    :func:`train_launches`' for its steps; finite losses; the ranks'
    losses and final states (params, both moments, count, step) bitwise
    equal. Against the one-process launcher (``ref``) as
    :func:`step_agreement` holds it: step 1's loss and gradient norm and
    step 2's loss within :data:`STEP_TOL`, and rank 0's step-1
    checkpoint by :func:`state_agreement` (first moments within
    ``STEP_TOL["moments"]``, every updated bf16 parameter within one
    bf16 step). Step 1 leaves the ranks equal too: the reduced gradient
    is one tensor on every rank, so a rank that differed after step 1
    would still differ after step 2. Returns the ranks' results."""
    from repro_torch.configs import registry
    from repro_torch.launch.ranks import run_ranks
    arch = registry.get(arch_id)
    steps = int(PARALLEL_TRAIN[PARALLEL_TRAIN.index("--steps") + 1])
    want = train_launches(arch, steps)
    ckpt = str(Path(tmp) / f"ckpt-{backend}")
    run_ranks(dp_worker, world, tmp, PARALLEL_TRAIN, ckpt, backend=backend,
              timeout=RANK_TIMEOUT_S)
    ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
             for r in range(world)]
    for r in ranks:
        if r["launches"] != want:
            raise AssertionError(f"{what}: rank {r['rank']} launched "
                                 f"{r['launches']} in {steps} steps, want "
                                 f"{want}")
        if not all(map(math.isfinite, r["losses"] + r["grad_norms"])):
            raise AssertionError(f"{what}: losses {r['losses']}")
    r0 = ranks[0]
    equal = all(r["losses"] == r0["losses"] and r["digest"] == r0["digest"]
                for r in ranks)
    params, moments = step1_state(torch, arch, ckpt)
    agree = state_agreement(torch, params, ref["params"], moments,
                            ref["moments"], ref["lrs"][0])
    del params, moments
    loss_err = [abs(a - b) for a, b in zip(r0["losses"], ref["losses"])]
    gn_err = abs(r0["grad_norms"][0] - ref["grad_norms"][0])
    dev = [r["profiled_step_device_ms"] for r in ranks]
    print(f"parallel: {what}: {world} ranks over {r0['backend']} on "
          f"{'cuda:0 shared' if backend == 'gloo' else 'one card each'}, "
          f"mesh {r0['mesh']}, rows {[r['rows'] for r in ranks]}; flash "
          f"launches per rank in {steps} steps {want} (all ranks); losses "
          f"{[round(x, 6) for x in r0['losses']]} vs one process "
          f"{[round(x, 6) for x in ref['losses']]} (|err| "
          f"{[float(f'{e:.3g}') for e in loss_err]}), |g| step 1 "
          f"{r0['grad_norms'][0]:.6f} vs {ref['grad_norms'][0]:.6f}; step 1 "
          f"(rank 0's checkpoint): moments relative L2 "
          f"{agree['moments_rel_l2']:.4g}, updated params bitwise equal "
          f"{100 * agree['params_bitwise_share']:.3f}% (mean over leaves), "
          f"{agree['params_outside']} outside one bf16 step; worst leaves' "
          f"moments (relative L2, leaf index) "
          f"{[(round(e, 4), i) for e, i in agree['worst_leaves']]}; ranks' "
          f"losses and final states bitwise equal: {equal}; bf16 "
          f"all_reduce of CUDA tensors on this backend: "
          f"{r0['bf16_allreduce']}")
    print(f"parallel: {what}: host ms a step per rank "
          f"{[[round(t, 1) for t in r['step_host_ms']] for r in ranks]} "
          f"(one process {[round(t, 1) for t in ref['step_host_ms']]}); "
          f"profiled step host ms "
          f"{[round(r['profiled_step_host_ms'], 1) for r in ranks]}, device "
          f"ms {[None if d is None else round(d, 3) for d in dev]}; "
          f"reduce_gradients ms "
          f"{[[round(t, 1) for t in r['allreduce_ms']] for r in ranks]} "
          f"for {r0['allreduce_bytes']} bytes (one fp32 bucket) a step; "
          f"peak GiB per rank {[round(r['peak_gib'], 2) for r in ranks]}")
    result = {"ranks": ranks, "ranks_equal": equal, "loss_err": loss_err,
              "grad_norm_err": gn_err, **agree,
              "ref": {k: v for k, v in ref.items()
                      if k not in ("params", "moments")}}
    out[what] = result
    if not equal:
        raise AssertionError(f"{what}: ranks disagree on losses or state")
    if not (all(e <= STEP_TOL["loss"] * abs(b)
                for e, b in zip(loss_err, ref["losses"])) and
            gn_err <= STEP_TOL["grad_norm"] * ref["grad_norms"][0] and
            agree["moments_rel_l2"] <= STEP_TOL["moments"] and
            agree["params_outside"] == 0):
        raise AssertionError(f"{what}: against the one-process launcher "
                             f"outside {STEP_TOL}: loss {loss_err}, |g| "
                             f"{gn_err}, {agree}")
    return result


def pipeline_check(torch, tmp: str, out: dict) -> None:
    """Item 3: :func:`pipe_worker` on :data:`PIPE`'s stages over gloo on
    the card; the output bitwise equal on every rank and to the same
    stages run in this process, one after another, over the same
    micro-batches in the same order."""
    from repro_torch.launch.ranks import run_ranks
    stages, n_micro = PIPE["stages"], PIPE["n_micro"]
    run_ranks(pipe_worker, stages, tmp, timeout=RANK_TIMEOUT_S)
    ranks = [json.loads((Path(tmp) / f"pipe{r}.json").read_text())
             for r in range(stages)]
    y = torch.load(Path(tmp) / "pipe_y.pt").cuda()
    from repro_torch.parallel import stage_params_from_stack
    from repro_torch.models.layers import tree_map
    cfg, layers, x = pipe_inputs(torch)
    body = pipe_stage_body(torch, cfg)
    st = stage_params_from_stack(layers, stages)
    mbs = x.reshape(n_micro, -1, *x.shape[1:])
    with torch.no_grad():
        serial = []
        for m in range(n_micro):
            h = mbs[m]
            for s in range(stages):
                h = body(tree_map(lambda p: p[s], st), h)
            serial.append(h)
        serial = torch.stack(serial).reshape(x.shape)
    same = torch.equal(y, serial)
    ticks = ranks[0]["ticks"]
    print(f"parallel: gpipe {PIPE['arch']} {cfg.n_layers} layers d_model "
          f"{cfg.d_model} bf16, {stages} stages over gloo on the card "
          f"(boundary tensors through host memory), n_micro {n_micro} x "
          f"[{PIPE['batch'] // n_micro}, {PIPE['seq']}]: output bitwise "
          f"equal to the serial layers in one process: {same}; every rank "
          f"equal to rank 0's {all(r['same_as_rank0'] for r in ranks)}; "
          f"ms a tick (second call, {ticks} ticks) "
          f"{[round(r['ms'] / ticks, 3) for r in ranks]}")
    out["pipeline"] = {"bitwise": same, "ranks": ranks}
    if not (same and all(r["same_as_rank0"] for r in ranks)):
        raise AssertionError("parallel: gpipe differs from the serial "
                             "layers")
    del layers, x, st, y, serial
    torch.cuda.empty_cache()


def phase_parallel(torch, details: dict) -> tuple[dict, dict]:
    """Phase 13. Returns the flash launches of the data-parallel ranks'
    runs (the main path's), summed over the ranks, and the one-process
    reference (phase 14 holds its tensor-parallel step to it)."""
    import tempfile
    import torch.distributed as dist
    import gc
    out = details.setdefault("parallel", {})
    gc.collect()
    torch.cuda.empty_cache()
    print(f"parallel: this process holds "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card "
          f"at the phase's start (the spawned ranks share it)")
    arch_id = cut_seamless()
    with tempfile.TemporaryDirectory() as tmp:
        ref = timed("parallel one process", one_process_reference, torch,
                    arch_id, tmp)
    timed("parallel torchrun world 1", torchrun_world_one, torch, out)
    mesh = timed("parallel nccl world 1", nccl_world_one, torch, arch_id,
                 out)
    launches = collections.Counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dp = timed("parallel gloo ranks", data_parallel, torch, arch_id,
                       ref, "gloo", DP_RANKS, tmp, "data-parallel", out)
            for r in dp["ranks"]:
                launches.update(r["launches"])
            timed("parallel elastic restore", elastic_restore, torch,
                  arch_id, mesh, str(Path(tmp) / "ckpt-gloo"),
                  dp["ranks"][0]["digest"], out)
        with tempfile.TemporaryDirectory() as tmp:
            timed("parallel gpipe", pipeline_check, torch, tmp, out)
        n = torch.cuda.device_count()
        if n >= 2:
            with tempfile.TemporaryDirectory() as tmp:
                dp = data_parallel(torch, arch_id, ref, "nccl", min(n, 4),
                                   tmp, "data-parallel nccl", out)
                for r in dp["ranks"]:
                    launches.update(r["launches"])
        else:
            print("parallel: nccl multi-card not run (1 card)")
    finally:
        dist.destroy_process_group()
    return dict(launches), ref

# ---------------------------------------------------------------------------
# Phase 14: tensor parallelism over "model"
# ---------------------------------------------------------------------------

#: the tensor-parallel mesh over ("data", "model"): one rank a "model"
#: shard
TP_MESH = (1, 2)
#: llama3.2-1b's tensor-parallel prefill: phase 5's serving traffic, the
#: weights from the seed on the card, a bf16 cache of the prompt's length
TP_PREFILL = dict(arch="llama3.2-1b", batch=8, prompt=64, seed=0)
#: last-position logits against the one-process prefill, each logit
#: within this many bf16 steps (2^-8 relative) of its own |value| plus
#: its row's RMS: each of the 16 layers' two row-parallel products sums
#: two bf16 partial products (each rounded once) where one process
#: rounds one fp32 sum, the residual stream carries the difference to
#: every logit in proportion to the row's scale, and the bf16 logits
#: round once more on their own scale. A row's RMS, not its largest
#: |logit|: at random init one column (the input token's, through the
#: tied embedding) stands far above the rest. The largest of 8 x 128,256
#: such errors is the far tail of their spread (about 20 steps on the
#: card); rank 1's attention partial sums lost in the last layer alone
#: give about 160
TP_LOGIT_STEPS = 48
#: and the rows' error as a share of what the layers add to the logits:
#: ||tp - one|| / ||one - embedding-only|| a row, the embedding-only
#: logits those of the same weights with every layer's output
#: projections zeroed (at random init the residual stream is mostly the
#: embedding passed through, which both runs share exactly; about 0.016
#: on the card, and 0.13 with the last layer's fault above)
TP_LAYERS_REL = 0.05
#: the dry-run's predicted peak (arguments + temporaries) against the
#: measured one, either way: it runs the attention's plain version on
#: meta tensors (chunked scores the kernel never holds), and the card's
#: caching allocator rounds blocks
TP_PEAK_FACTOR = 3.0
#: the seamless step: phase 13's global batch and seed, one step
TP_TRAIN = dict(batch=8, seq=256, seed=0, steps=2)


def stage_gloo_all_gather(torch) -> list:
    """Route the functional all-gather of CUDA tensors through host
    memory in this process: gloo crashes on an all-gather of CUDA
    tensors (torch 2.11), while its all-reduce, reduce-scatter and
    all-to-all take them. The tensor is copied to the host, gathered by
    the same functional collective over the same group there, and
    copied back; DTensor's redistributions and the port's own gathers
    call the patched functions. Returns their names."""
    import torch.distributed._functional_collectives as funcol
    done = []
    for name in ("all_gather_tensor", "all_gather_single"):
        fn = getattr(funcol, name, None)
        if fn is None:
            continue

        def staged(x, *args, _fn=fn, **kwargs):
            if not x.is_cuda:
                return _fn(x, *args, **kwargs)
            y = funcol.wait_tensor(_fn(x.cpu(), *args, **kwargs))
            return y.to(x.device)
        setattr(funcol, name, staged)
        done.append(name)
    return done


def comm_kinds(counts: dict) -> dict:
    """``CommDebugMode``'s counts by op as the dry-run's kinds."""
    kinds = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
             "all_to_all": "all-to-all", "alltoall": "all-to-all",
             "all_reduce": "all-reduce", "allreduce": "all-reduce",
             "allgather": "all-gather", "send": "collective-permute"}
    out: dict = {}
    for op, n in counts.items():
        name = str(op)
        kind = next((v for k, v in kinds.items() if k in name), name)
        out[kind] = out.get(kind, 0) + int(n)
    return out


def tp_predictions():
    """Start the dry-run of phase 14's two runs on a fake world of
    :data:`TP_MESH` (rank 0's view) in a subprocess (the fake process
    group must not meet this process's groups). Returns a function that
    waits for it and returns its records with its host seconds (its
    ``kill`` ends it). The whole script starts it beside the kernel
    build and waits for it after phase 5, so that it takes no host time
    from the ranks' timed windows (phases 2-5 time the card, and their
    host times are recorded only)."""
    code = f"""
import dataclasses, json, sys
sys.path.insert(0, {str(SRC)!r})
from repro_torch.configs import registry
from repro_torch.launch import dryrun
base = registry.get("seamless-m4t-large-v2")
n = {PARALLEL_LAYERS}
cut = f"{{base.arch_id}}-{{n}}+{{n}}L"
registry.register(dataclasses.replace(base, arch_id=cut, model=dataclasses.replace(
    base.model, n_enc_layers=n, n_dec_layers=n)))
mesh = dryrun.fake_mesh({TP_MESH!r}, ("data", "model"))
recs = {{
    "prefill": dryrun.run_cell({TP_PREFILL["arch"]!r}, registry.ShapeSpec(
        "tp_prefill", {TP_PREFILL["prompt"]}, {TP_PREFILL["batch"]}, "prefill"),
        mesh=mesh, verbose=False),
    "train": dryrun.run_cell(cut, registry.ShapeSpec(
        "tp_train", {TP_TRAIN["seq"]}, {TP_TRAIN["batch"]}, "train"),
        mesh=mesh, verbose=False)}}
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps(recs))
"""
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def wait() -> dict:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            wait.kill()
        if proc.returncode != 0:
            raise AssertionError(f"tensor: the dry-run failed:\n"
                                 f"{err[-3000:]}")
        recs = json.loads(out.strip().splitlines()[-1])
        recs["host_s"] = time.time() - t0
        return recs

    def kill() -> None:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wait.kill = kill
    return wait


def local_bytes(tree) -> int:
    """The bytes the local shards of a DTensor tree hold."""
    from repro_torch.models.layers import tree_leaves
    return sum(t.to_local().untyped_storage().nbytes()
               for t in tree_leaves(tree))


def logit_errors(got, ref, ref0) -> dict:
    """``got`` against ``ref`` [rows, V]: the largest error in bf16 steps
    of each logit's |value| plus its row's RMS (``steps``), and the
    largest row's L2 error over the row's ``ref - ref0`` (``layers_rel``:
    ``ref0`` the embedding-only logits)."""
    rms = ref.square().mean(-1, keepdim=True).sqrt()
    err = (got - ref).abs()
    return {"steps": float((err / (ref.abs() + rms)).max()) / 2 ** -8,
            "layers_rel": float((err.norm(dim=-1) /
                                 (ref - ref0).norm(dim=-1)).max()),
            "max_abs": float(err.max()),
            "max_logit": float(ref.abs().max()),
            "row_rms": [float(x) for x in rms[:, 0]]}


def tp_worker(rank: int, world: int, out_dir: str, backend: str) -> None:
    """One tensor-parallel rank of phase 14 (see the module docstring):
    the llama3.2-1b prefill and the seamless step on a :data:`TP_MESH`
    mesh, each in a launch window and under ``CommDebugMode``, with its
    parameter bytes and peak. Rank 0 also writes the gathered step-1
    state for the parent to hold against phase 13's reference."""
    import gc
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.train import step_frames
    from repro_torch.models.layers import param_axes_tree, tree_leaves
    from repro_torch.parallel import sharding as S
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import arch_rules, init_train_state, \
        make_train_step, shard_train_state
    staged = stage_gloo_all_gather(torch) if backend == "gloo" else []
    mesh = init_device_mesh("cuda", TP_MESH, mesh_dim_names=("data",
                                                             "model"))
    res: dict = {"rank": rank, "backend": backend, "staged": staged}

    # --- llama3.2-1b prefill on each rank's heads
    arch = registry.get(TP_PREFILL["arch"])
    mod, cfg, rules = arch.model_module(), arch.model, arch_rules(arch)
    b, s = TP_PREFILL["batch"], TP_PREFILL["prompt"]
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(
        TP_PREFILL["seed"]))
    tokens = SyntheticTokens(cfg.vocab, b, s, TP_PREFILL["seed"]) \
        .next_batch()["tokens"].cuda()
    with torch.no_grad():
        cache = mod.init_cache(cfg, b, s, torch.bfloat16, device="cuda")
        ref, _ = mod.prefill(params, tokens, cache, cfg, last_only=True)
        lay = params["layers"]
        bare = dict(params, layers=dict(
            lay, attn=dict(lay["attn"], wo=torch.zeros_like(lay["attn"]["wo"])),
            mlp=dict(lay["mlp"], down=torch.zeros_like(lay["mlp"]["down"]))))
        ref0, _ = mod.prefill(bare, tokens, cache, cfg, last_only=True)
    ref, ref0 = ref[:, 0].float(), ref0[:, 0].float()
    del cache, bare, lay
    dp = S.shard_params_tree(params, mod.param_axes(cfg), mesh, rules)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["prefill_param_bytes"] = local_bytes(dp)
    with S.use_mesh(mesh, rules):
        cache = S.shard_params_tree(mod.init_cache(cfg, b, s, torch.bfloat16,
                                            device="cuda"),
                             param_axes_tree(mod.cache_specs(cfg, b, s)),
                             mesh)
        db = S.shard_batch({"tokens": tokens}, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    with torch.no_grad(), S.use_mesh(mesh, rules), CommDebugMode() as comm:
        t0 = time.perf_counter()
        logits, cache = mod.prefill(dp, db["tokens"], cache, cfg,
                                    last_only=True)
        torch.cuda.synchronize()
        res["prefill_host_ms"] = 1e3 * (time.perf_counter() - t0)
    res["prefill_launches"] = dict(LAUNCHES)
    res["prefill_peak"] = torch.cuda.max_memory_allocated()
    res["prefill_comm"] = comm_kinds(comm.get_comm_counts())
    got = logits.full_tensor()[:, 0].float()
    res.update(logit_errors(got, ref, ref0))
    res["argmax_equal"] = int((got.argmax(-1) == ref.argmax(-1)).sum())
    top2 = torch.topk(ref, 2, dim=-1).values
    res["min_margin"] = float((top2[:, 0] - top2[:, 1]).min())
    with torch.no_grad(), S.use_mesh(mesh, rules):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.prefill(dp, db["tokens"], cache, cfg, last_only=True)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    res["prefill_warm_host_ms"] = times
    # the check's power: rank 1's attention partial sums lost (its shard
    # of wo zeroed), in the last layer, then in every layer
    wo = dp["layers"]["attn"]["wo"].to_local()
    res["faults"] = {}
    with torch.no_grad(), S.use_mesh(mesh, rules):
        for name, layers in (("last_layer", slice(-1, None)),
                             ("every_layer", slice(None))):
            if rank == 1:
                wo[layers].zero_()
            bad, _ = mod.prefill(dp, db["tokens"], cache, cfg,
                                 last_only=True)
            res["faults"][name] = logit_errors(
                bad.full_tensor()[:, 0].float(), ref, ref0)
    del dp, cache, db, logits, wo, bad
    gc.collect()
    torch.cuda.empty_cache()

    # --- seamless cut to PARALLEL_LAYERS: one tensor-parallel train step
    arch = registry.get(cut_seamless())
    mod, cfg, rules = arch.model_module(), arch.model, arch_rules(arch)
    b, s, seed = TP_TRAIN["batch"], TP_TRAIN["seq"], TP_TRAIN["seed"]
    state = init_train_state(mod.init(cfg, torch.Generator(
        device="cuda").manual_seed(seed)))
    state = shard_train_state(state, mod.param_axes(cfg), mesh, rules)
    gc.collect()
    torch.cuda.empty_cache()
    res["train_param_bytes"] = local_bytes(state.params)
    batch = {k: t.cuda() for k, t in SyntheticTokens(
        cfg.vocab, b, s, seed=seed).next_batch().items()}
    batch["frames"] = step_frames(torch.Generator(device="cuda")
                                  .manual_seed(seed + 1), b, s, cfg.d_model,
                                  "cuda")
    step = make_train_step(arch, AdamWConfig(total_steps=TP_TRAIN["steps"]),
                           mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    with CommDebugMode() as comm:
        t0 = time.perf_counter()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        res["train_host_ms"] = 1e3 * (time.perf_counter() - t0)
    res["train_launches"] = dict(LAUNCHES)
    res["train_peak"] = torch.cuda.max_memory_allocated()
    res["train_comm"] = comm_kinds(comm.get_comm_counts())
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    del state
    params = [t.full_tensor() for t in tree_leaves(new.params)]
    moments = [t.full_tensor() for t in tree_leaves(new.opt.m)]
    if rank == 0:
        torch.save({"params": [t.cpu() for t in params],
                    "moments": [t.cpu() for t in moments]},
                   Path(out_dir) / "tp_state.pt")
    (Path(out_dir) / f"tp{rank}.json").write_text(json.dumps(res))


def tensor_run(torch, backend: str, ref: dict, predicted: dict, tmp: str,
               out: dict) -> dict:
    """:func:`tp_worker` on 2 ranks over ``backend``, checked (see the
    module docstring) against the dry-run's ``predicted`` records;
    returns the launches summed over the ranks."""
    from repro_torch.configs import registry
    from repro_torch.launch.ranks import run_ranks
    world = math.prod(TP_MESH)
    run_ranks(tp_worker, world, tmp, backend, backend=backend,
              timeout=RANK_TIMEOUT_S)
    ranks = [json.loads((Path(tmp) / f"tp{r}.json").read_text())
             for r in range(world)]
    arch = registry.get(cut_seamless())
    n_layers = registry.get(TP_PREFILL["arch"]).model.n_layers
    want_prefill = {"flash_attention": n_layers}
    want_train = train_launches(arch, 1)
    pre, tr = predicted["prefill"], predicted["train"]
    r0 = ranks[0]
    if r0["staged"]:
        print(f"tensor: {backend}: the all-gather of CUDA tensors goes "
              f"through host memory on these ranks (gloo crashes on it; "
              f"{', '.join(r0['staged'])} patched in the ranks); the other "
              f"collectives run on the card's tensors")
    state = torch.load(Path(tmp) / "tp_state.pt")
    agree = state_agreement(
        torch, [t.cuda() for t in state["params"]], ref["params"],
        [t.cuda() for t in state["moments"]], ref["moments"], ref["lrs"][0])
    del state
    torch.cuda.empty_cache()
    loss_err = abs(r0["metrics"]["loss"] - ref["losses"][0])
    peak_ratio = {
        "prefill": [(pre["mem_argument_size_in_bytes"] +
                     pre["mem_temp_size_in_bytes"]) / r["prefill_peak"]
                    for r in ranks],
        "train": [(tr["mem_argument_size_in_bytes"] +
                   tr["mem_temp_size_in_bytes"]) / r["train_peak"]
                  for r in ranks]}
    gib = 2 ** 30
    print(f"tensor: {backend}: llama3.2-1b bf16 {n_layers} layers, prefill "
          f"batch {TP_PREFILL['batch']} x {TP_PREFILL['prompt']} on "
          f"{world} ranks, mesh {TP_MESH}: last-position logits vs one "
          f"process: bf16 steps of |logit| + row RMS "
          f"{[round(r['steps'], 3) for r in ranks]} (tolerance "
          f"{TP_LOGIT_STEPS}), share of the layers' part "
          f"{[round(r['layers_rel'], 5) for r in ranks]} (tolerance "
          f"{TP_LAYERS_REL}), max |err| "
          f"{[round(r['max_abs'], 5) for r in ranks]} at max |logit| "
          f"{r0['max_logit']:.4f}, row RMS "
          f"{min(r0['row_rms']):.4f}-{max(r0['row_rms']):.4f}; argmax equal "
          f"{[r['argmax_equal'] for r in ranks]} of {TP_PREFILL['batch']} "
          f"(smallest top-2 margin {r0['min_margin']:.4f}); flash launches "
          f"a rank {[r['prefill_launches'] for r in ranks]} (want "
          f"{want_prefill}); host ms {[round(r['prefill_host_ms'], 1) for r in ranks]} "
          f"(warm {[[round(t, 1) for t in r['prefill_warm_host_ms']] for r in ranks]})")
    for name, f in r0["faults"].items():
        print(f"tensor: {backend}: planted fault, rank 1's attention "
              f"partial sums lost ({name.replace('_', ' ')}): bf16 steps "
              f"{f['steps']:.3f}, share of the layers' part "
              f"{f['layers_rel']:.5f}, max |err| {f['max_abs']:.4f} (must "
              f"fail both tolerances)")
    print(f"tensor: {backend}: {arch.arch_id} one train step on {world} "
          f"ranks: loss {r0['metrics']['loss']:.6f} vs phase 13's one "
          f"process {ref['losses'][0]:.6f} (|err| {loss_err:.3g}); step 1 "
          f"moments relative L2 {agree['moments_rel_l2']:.4g}, params "
          f"bitwise equal {100 * agree['params_bitwise_share']:.3f}%, "
          f"{agree['params_outside']} outside one bf16 step; flash launches "
          f"a rank {[r['train_launches'] for r in ranks]} (want "
          f"{want_train}); host ms {[round(r['train_host_ms'], 1) for r in ranks]}")
    print(f"tensor: {backend}: dry-run vs ranks: parameter bytes a rank "
          f"predicted {pre['param_bytes_per_device']} / "
          f"{tr['param_bytes_per_device']}, measured "
          f"{[r['prefill_param_bytes'] for r in ranks]} / "
          f"{[r['train_param_bytes'] for r in ranks]}; collectives "
          f"predicted {pre['collective_counts_per_device']} / "
          f"{tr['collective_counts_per_device']}, CommDebugMode "
          f"{[r['prefill_comm'] for r in ranks]} / "
          f"{[r['train_comm'] for r in ranks]}; peak GiB predicted "
          f"{(pre['mem_argument_size_in_bytes'] + pre['mem_temp_size_in_bytes']) / gib:.2f} / "
          f"{(tr['mem_argument_size_in_bytes'] + tr['mem_temp_size_in_bytes']) / gib:.2f}, "
          f"measured {[round(r['prefill_peak'] / gib, 2) for r in ranks]} / "
          f"{[round(r['train_peak'] / gib, 2) for r in ranks]} (ratio "
          f"{[[round(x, 2) for x in v] for v in peak_ratio.values()]}, "
          f"within {TP_PEAK_FACTOR}x required); predicted FLOPs a rank "
          f"{pre['flops_per_device']:.4g} / {tr['flops_per_device']:.4g}, "
          f"collective bytes {pre['collective_bytes_total']} / "
          f"{tr['collective_bytes_total']}")
    result = {"ranks": ranks, "agree": agree, "loss_err": loss_err,
              "peak_ratio": peak_ratio}
    out[backend] = result
    bad = []
    for r in ranks:
        if not (r["steps"] <= TP_LOGIT_STEPS and
                r["layers_rel"] <= TP_LAYERS_REL):
            bad.append(f"rank {r['rank']} logits {r['steps']} steps, "
                       f"{r['layers_rel']} of the layers' part")
        for name, f in r["faults"].items():
            if not (f["steps"] > TP_LOGIT_STEPS and
                    f["layers_rel"] > TP_LAYERS_REL):
                bad.append(f"rank {r['rank']}: the logits check passes a "
                           f"lost partial sum ({name}: {f})")
        if r["argmax_equal"] != TP_PREFILL["batch"]:
            bad.append(f"rank {r['rank']} argmax {r['argmax_equal']}")
        if r["prefill_launches"] != want_prefill:
            bad.append(f"rank {r['rank']} prefill launches")
        if r["train_launches"] != want_train:
            bad.append(f"rank {r['rank']} train launches")
        if r["prefill_param_bytes"] != pre["param_bytes_per_device"] or \
                r["train_param_bytes"] != tr["param_bytes_per_device"]:
            bad.append(f"rank {r['rank']} parameter bytes")
        if r["prefill_comm"] != pre["collective_counts_per_device"] or \
                r["train_comm"] != tr["collective_counts_per_device"]:
            bad.append(f"rank {r['rank']} collective counts")
        if not math.isfinite(r["metrics"]["loss"]):
            bad.append(f"rank {r['rank']} loss {r['metrics']['loss']}")
    for v in peak_ratio.values():
        if not all(1 / TP_PEAK_FACTOR <= x <= TP_PEAK_FACTOR for x in v):
            bad.append(f"peak ratio {peak_ratio}")
    if not (loss_err <= STEP_TOL["loss"] * abs(ref["losses"][0]) and
            agree["moments_rel_l2"] <= STEP_TOL["moments"] and
            agree["params_outside"] == 0):
        bad.append(f"train step against phase 13's one process outside "
                   f"{STEP_TOL}: loss {loss_err}, {agree}")
    if bad:
        raise AssertionError(f"tensor: {backend}: {bad}")
    launches = collections.Counter()
    for r in ranks:
        launches.update(r["prefill_launches"])
        launches.update(r["train_launches"])
    return dict(launches)


def phase_tensor(torch, details: dict, ref: dict | None = None,
                 predicted: dict | None = None) -> dict:
    """Phase 14. ``ref`` is phase 13's one-process reference and
    ``predicted`` :func:`tp_predictions`' records (each computed here
    when the phase runs alone). Returns the flash launches of the
    tensor-parallel ranks, summed over the ranks."""
    import gc
    import tempfile
    out = details.setdefault("tensor", {})
    gc.collect()
    torch.cuda.empty_cache()
    arch_id = cut_seamless()
    if ref is None:
        with tempfile.TemporaryDirectory() as tmp:
            ref = one_process_reference(torch, arch_id, tmp)
    if predicted is None:
        predicted = tp_predictions()()
    print(f"tensor: dry-run of the two runs on a fake {TP_MESH} world in "
          f"{predicted['host_s']:.1f} s (host, before the ranks): prefill "
          f"{predicted['prefill']['host_s']} s, train step "
          f"{predicted['train']['host_s']} s")
    out["predicted"] = predicted
    launches = collections.Counter()
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(tensor_run(torch, "gloo", ref, predicted, tmp, out))
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            launches.update(tensor_run(torch, "nccl", ref, predicted, tmp,
                                       out))
    else:
        print("tensor: nccl, one rank a card, not run (1 card)")
    return dict(launches)


# ---------------------------------------------------------------------------
# Phase 15: every head size and dtype the archs send
# ---------------------------------------------------------------------------

#: the fp32 kernel (``flash_attention_f32.cu``) at the pairs the smoke
#: configs send, at their launchers' shapes (serving: batch 8, prompt 64;
#: training: batch 8, seq 128, and an LM above dense_attn_max at batch 1,
#: seq 8448): seamless's encoder (non-causal) and decoder at head size 12,
#: GQA 4/2, and its decode step's cross-attention, fp32 queries over the
#: bf16 cross cache (forward only: decode takes no gradient); deepseek's
#: MLA at keys 24 over values 16, and with causal tiles across the
#: diagonal (S 100); the LMs' prefill at 16 (4/2), gemma's 32, yi's 8 at 7
#: query heads over 1, qwen2-vl's 16 at 3/1; kv_offset > 0 over a longer
#: key range; the decode form (Sq 1); an LM smoke config's training above
#: 8192 tokens. The first is the kernels line's row
F32_SHAPES = [
    FlashShape("f32_seamless_enc", 8, 128, 128, 4, 2, 12, False, 0,
               backward=True),
    FlashShape("f32_seamless_dec", 8, 128, 128, 4, 2, 12, True, 0,
               backward=True),
    FlashShape("f32_cross_decode", 8, 1, 64, 4, 2, 12, False, 0,
               kv_bf16=True),
    FlashShape("f32_mla", 8, 128, 128, 4, 4, 24, True, 0, 16,
               backward=True),
    FlashShape("f32_mla_ragged", 2, 100, 100, 4, 4, 24, True, 0, 16,
               backward=True),
    FlashShape("f32_prefill", 8, 64, 64, 4, 2, 16, True, 0),
    FlashShape("f32_gemma", 8, 64, 64, 4, 4, 32, True, 0, backward=True),
    FlashShape("f32_yi", 8, 64, 64, 7, 1, 8, True, 0, backward=True),
    FlashShape("f32_vlm", 8, 64, 64, 3, 1, 16, True, 0),
    FlashShape("f32_offset", 2, 130, 200, 4, 1, 32, True, 70,
               backward=True),
    FlashShape("f32_decode", 8, 1, 64, 4, 2, 16, True, 63),
    FlashShape("f32_lm_s8448", 1, 8448, 8448, 4, 2, 16, True, 0,
               backward=True),
]
#: fp32 kernel vs the exact function. The kernel and its plain version
#: are both fp32 and differ only in the order of their sums, so each is
#: held against the same attention in float64 (:func:`dense64`, autograd
#: for the gradients): the kernel's max |err| within F32_FACTOR times the
#: plain version's own at the same inputs (the fp32 rounding noise of
#: this shape: the kernel sums its keys and rows one after another where
#: the plain version's einsums sum in blocks, and a sequential sum of N
#: terms drifts ~sqrt(N) roundings), plus F32_FLOOR steps of 2^-24 of
#: the largest |value| (for outputs where the plain version's error is
#: near 0). A key masked or dropped moves an output by ~1e-2 of itself,
#: some 1e4 times this. fp32 queries over a bf16 cache round p to bf16,
#: as the plain version does: that row is held as the bf16 kernel is
#: (:func:`flash_tol`, :data:`FLASH_ROW_TOL`)
F32_FACTOR = 16
F32_FLOOR = 64
#: phase 15's training runs at published widths, cut in depth (the arch
#: id is filled in by :func:`cut_arch`): deepseek-v2-236b's dense first
#: layer (MLA, keys 192 over values 128, 128 heads) at batch 2 x 1024;
#: gemma-7b's first 2 layers (head size 256, 16 heads) at batch 1 x 8448,
#: just above dense_attn_max, so that its attention is the flash kernel
TRAIN_DEEPSEEK = ("deepseek-v2-236b", 1,
                  ["--batch", "2", "--seq", "1024", "--steps", "3",
                   "--seed", "0", "--log-every", "1"])
TRAIN_GEMMA = ("gemma-7b", 2,
               ["--batch", "1", "--seq", "8448", "--steps", "2", "--seed",
                "0", "--log-every", "1"])
#: the archs whose smoke configs reach the flash kernel when served
#: (every attention arch but the hybrid, whose prompt attention is
#: dense_attention below 8192 tokens), each at the launcher's default
#: request (batch 8, prompt 64) with :data:`SMOKE_NEW` new tokens
SMOKE_SERVE = ["llama3.2-1b", "qwen3-8b", "gemma-7b", "yi-34b",
               "qwen3-moe-235b-a22b", "deepseek-v2-236b", "qwen2-vl-2b",
               "seamless-m4t-large-v2"]
SMOKE_NEW = 8
#: the smoke trainings on the card: seamless and deepseek-v2 at the
#: launcher's default batch 8 x 128 (they always reach the kernels), and
#: llama3.2-1b at 8448 tokens, above dense_attn_max, one step (its CPU
#: run takes some 7 s a step on the card's host)
SMOKE_TRAIN = [
    ["--arch", "seamless-m4t-large-v2", "--smoke", "--steps", "3",
     "--batch", "8", "--seq", "128", "--seed", "0", "--log-every", "1"],
    ["--arch", "deepseek-v2-236b", "--smoke", "--steps", "3", "--batch",
     "8", "--seq", "128", "--seed", "0", "--log-every", "1"],
    ["--arch", "llama3.2-1b", "--smoke", "--steps", "1", "--batch", "1",
     "--seq", "8448", "--seed", "0", "--log-every", "1"],
]
#: the card against the CPU on the same weights (fp32 smoke configs): the
#: prefill logits within 1e-4 of the largest |logit| (both fp32; the
#: card's attention is the fp32 kernel, cuBLAS's products sum in another
#: order than the CPU's, ~1e-6 relative after 2 layers), and the greedy
#: tokens equal in every row until a step where the CPU's top two logits
#: lie within that tolerance; one train step's loss and gradient norm
#: within 1e-4 of themselves
SMOKE_LOGIT_TOL = 1e-4
SMOKE_STEP_TOL = 1e-4


def dense64(torch, q, k, v, causal: bool, kv_offset: int, scale: float):
    """Attention in float64 with a dense softmax over all keys, the
    function the fp32 kernel and its plain version round: (out [B, Sq,
    Hq, DV], lse [B, Hq, Sq]); differentiable."""
    rep = q.shape[2] // k.shape[2]
    kd = k.double().repeat_interleave(rep, dim=2)
    vd = v.double().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * scale
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None] + kv_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bhqk,bkhd->bqhd", p, vd), lse


def f32_tol(plain_err: float, ref) -> float:
    """:data:`F32_FACTOR` times the plain version's max |err| against
    float64 plus :data:`F32_FLOOR` steps of 2^-24 of max |ref|."""
    return F32_FACTOR * plain_err + F32_FLOOR * 2 ** -24 * float(
        ref.abs().max())


def f32_shapes(torch, details: dict) -> dict:
    """The fp32 kernel at :data:`F32_SHAPES`: the forward against the
    plain version and float64 (output and log-sum-exp), and where a row
    has ``backward`` the gradient through the autograd Function (one
    launch of each entry point) against the plain backward and float64,
    bitwise repeatable, the dq launch's delta against ``bwd_prep_plain``;
    each entry point timed beside the plain version, SDPA (and its
    backward) in fp32 and the fp32 bound. Returns the kernels line's rows
    for the fp32 kernel's three entry points."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _forward_kernel, \
        flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_attention_bwd import F32_ENTRY_POINTS
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = details.setdefault("f32", [])
    for shape in F32_SHAPES:
        name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
        dv = shape.v_dim
        kv_dt = torch.bfloat16 if shape.kv_bf16 else torch.float32
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dt)
                   for sh, dt in (((b, sq, hq, d), torch.float32),
                                  ((b, skv, hkv, d), kv_dt),
                                  ((b, skv, hkv, dv), kv_dt)))
        scale = d ** -0.5
        kw = dict(causal=causal, kv_offset=off)
        kern = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda: flash_attention_plain(q, k, v, **kw)  # noqa: E731
        build.LAUNCHES.clear()
        got = kern()
        torch.cuda.synchronize()
        read_window(build.LAUNCHES, {"flash_attention_f32": 1},
                    f"f32 {name} forward")
        want = plain()
        if got.shape != want.shape or got.dtype != v.dtype or \
                not torch.isfinite(got).all():
            raise AssertionError(f"f32 {name}: {tuple(got.shape)} "
                                 f"{got.dtype} output not finite or not "
                                 f"{tuple(want.shape)} {v.dtype}")
        row_err = flash_row_err(got, want)
        checks = {}
        if shape.kv_bf16:
            checks["out"] = (float((got.float() - want.float()).abs().max()),
                             flash_tol(v), None)
        else:
            ref, lse_ref = dense64(torch, q, k, v, causal, off, scale)
            lse = _forward_kernel(q, k, v, scale, causal, off,
                                  with_lse=True)[1]
            lse_p = flash_attention_plain(q, k, v, return_lse=True, **kw)[1]
            for what, g, w, r in (("out", got, want, ref),
                                  ("lse", lse, lse_p, lse_ref)):
                p_err = float((w.double() - r).abs().max())
                checks[what] = (float((g.double() - r).abs().max()),
                                f32_tol(p_err, r), p_err)
            del ref, lse_ref
        fwd_err = checks["out"][0]
        if not (all(e <= t for e, t, _ in checks.values()) and
                row_err <= FLASH_ROW_TOL):
            raise AssertionError(
                f"f32 {name}: kernel (max |err|, tol, plain's max |err|) "
                f"{checks}, row error {row_err} (tol {FLASH_ROW_TOL})")
        lib = sdpa_fn(torch, q, k.float(), v.float(), causal, off)
        fb_ms, fb_by = flash_bound_ms(b, sq, skv, hq, hkv, d, causal, off,
                                      dv, elem=4, kv_elem=k.element_size(),
                                      rate=FP32_FLOP_PER_S)
        row = {"shape": name, "b": b, "sq": sq, "skv": skv, "hq": hq,
               "hkv": hkv, "d": d, "dv": dv, "causal": causal,
               "kv_offset": off, "kv_dtype": str(kv_dt), "checks": checks,
               "row_err": row_err,
               **device_times(torch, {"ms": (kern, 10),
                                      "library_ms": (lib, 10)}),
               # the plain version's thousands of small launches at S
               # 8448 outrun the launch queue: CUDA events over
               # back-to-back calls
               "plain_ms": cuda_ms(torch, plain, iters=3, warmup=1),
               "bound_ms": fb_ms, "bound_by": fb_by}
        if shape.backward:
            row.update(f32_backward(torch, shape, q, k, v, gen))
        rows.append(row)
        print(f"f32 {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} "
              f"D={d} DV={dv} causal={causal} kv_offset={off} K/V "
              f"{str(kv_dt).split('.')[-1]}: forward (max |err|, tol, "
              f"plain's) {fmt_checks(checks)}, row error {row_err:.3g}; "
              f"device {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
              f"sdpa {row['library_ms']:.4f}, bound {fb_ms:.4f} by "
              f"{fb_by})" + (f"; backward {fmt_checks(row['bwd_checks'])}, "
                             f"delta {row['delta_err']:.3g} (tol "
                             f"{DELTA_TOL:.3g}), second call bitwise equal "
                             f"{row['bitwise_repeat']}; device ms dq "
                             f"{row['times_ms'][F32_ENTRY_POINTS[0]]:.4f} "
                             f"dkdv "
                             f"{row['times_ms'][F32_ENTRY_POINTS[1]]:.4f} "
                             f"(back to back {row['times_ms']['bwd']:.4f}; "
                             f"plain backward "
                             f"{row['times_ms']['plain_bwd']:.4f}, sdpa "
                             f"backward "
                             f"{fmt_ms(row['times_ms']['sdpa_bwd'])}; "
                             f"bound {row['bwd_bound'][0]:.4f} by "
                             f"{row['bwd_bound'][1]})"
                             if shape.backward else ""))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    for ln in ptxas_usage(torch, "flash_attention_f32"):
        print(f"f32 ptxas: {ln}")
    details["f32_ptxas"] = ptxas_usage(torch, "flash_attention_f32")
    first = rows[0]
    out = {"flash_attention_f32": {
        "max_abs_err": max(r["checks"]["out"][0] for r in rows),
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}}}
    grads = {F32_ENTRY_POINTS[0]: ("dq",), F32_ENTRY_POINTS[1]: ("dk", "dv")}
    for e in F32_ENTRY_POINTS:
        b_ms, b_by = first["entry_bounds"][e]
        out[e] = {"max_abs_err": max(r["bwd_checks"][g][0] for r in rows
                                     if "bwd_checks" in r for g in grads[e]),
                  "ms": first["times_ms"][e],
                  "plain_ms": first["times_ms"]["plain_bwd"],
                  "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": first["times_ms"]["sdpa_bwd"]}
    return out


def fmt_checks(checks: dict) -> str:
    """``{what: (max |err|, tol, plain's max |err| or None)}`` printed."""
    return ", ".join(
        f"{w} {e:.3g} ({t:.3g}" + ("" if p is None else f"; {p:.3g}") + ")"
        for w, (e, t, p) in checks.items())


def f32_backward(torch, shape, q, k, v, gen) -> dict:
    """The fp32 backward of one :data:`F32_SHAPES` row (see
    :func:`f32_shapes`); raises outside the tolerances."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _forward_kernel, \
        flash_attention
    from repro_torch.kernels.flash_attention_bwd import F32_ENTRY_POINTS, \
        bwd_prep_plain, entry_args, flash_attention_bwd_plain
    entry_names = F32_ENTRY_POINTS
    name, b, sq, skv, hq, hkv, d, causal, off = shape[:9]
    dv = shape.v_dim
    scale = d ** -0.5
    kw = dict(causal=causal, kv_offset=off)
    dout = torch.randn((b, sq, hq, dv), generator=gen, device="cuda")

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        build.LAUNCHES.clear()
        with torch.enable_grad():
            out = flash_attention(*leaves, **kw)
            got = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        read_window(build.LAUNCHES, {"flash_attention_f32": 1,
                                     **{e: 1 for e in entry_names}},
                    f"f32 {name} forward + backward")
        return got
    got, again = grads(), grads()
    bitwise = all(torch.equal(g, h) for g, h in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, dout, **kw)
    leaves = [t.double().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        ref = torch.autograd.grad(dense64(torch, *leaves, causal, off,
                                          scale)[0], leaves, dout.double())
    checks = {}
    for what, g, w, r in zip(("dq", "dk", "dv"), got, want, ref):
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"f32 {name}: {what} not finite or not "
                                 f"{tuple(w.shape)}")
        p_err = float((w.double() - r).abs().max())
        checks[what] = (float((g.double() - r).abs().max()),
                        f32_tol(p_err, r), p_err)
    del leaves, ref
    out_k, lse = _forward_kernel(q, k, v, scale, causal, off, with_lse=True)
    delta = torch.empty((b, hq, sq), device="cuda")
    bufs = [torch.empty_like(t) for t in (q, k, v)]
    args = entry_args(q, k, v, out_k, dout, lse, delta, *bufs, scale,
                      causal, off)
    build.launch(entry_names[0], q, *args[entry_names[0]])
    prod = dout * out_k
    delta_err = float(((delta - bwd_prep_plain(out_k, dout)).abs() /
                       prod.abs().sum(-1).transpose(1, 2).clamp_min(
                           1e-30)).max())
    if not (all(e <= t for e, t, _ in checks.values()) and bitwise and
            delta_err <= DELTA_TOL):
        raise AssertionError(
            f"f32 {name}: backward (max |err|, tol, plain's) {checks}, "
            f"second call bitwise equal {bitwise}, delta relative error "
            f"{delta_err} (tol {DELTA_TOL})")
    fns = {e: ((lambda e=e: build.launch(e, q, *args[e])), 10)
           for e in entry_names}
    fns["bwd"] = (lambda: [build.launch(e, q, *args[e])
                           for e in entry_names], 10)
    lib = sdpa_bwd_fn(torch, q, k, v, dout, causal, off)
    if lib is not None:
        fns["sdpa_bwd"] = (lib, 10)
    times = device_times(torch, fns)
    times.setdefault("sdpa_bwd", None)
    times["plain_bwd"] = cuda_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, dout, **kw), iters=3, warmup=1)
    bound = (b, sq, skv, hq, hkv, d, causal, off)
    return {"bwd_checks": checks, "bitwise_repeat": bitwise,
            "delta_err": delta_err, "times_ms": times,
            "bwd_bound": bwd_bound_ms(*bound, dv=dv, elem=4,
                                      rate=FP32_FLOP_PER_S),
            "entry_bounds": {e: bwd_bound_ms(*bound, e, dv=dv, elem=4,
                                             rate=FP32_FLOP_PER_S)
                             for e in entry_names}}


def cut_arch(base_id: str, n_layers: int) -> str:
    """Register ``base_id`` at published widths cut to its first
    ``n_layers`` layers under an arch id of its own, once per process;
    returns the id."""
    import dataclasses
    from repro_torch.configs import registry
    base = registry.get(base_id)
    arch_id = f"{base.arch_id}-{n_layers}L"
    if arch_id not in registry.list_archs():
        registry.register(dataclasses.replace(
            base, arch_id=arch_id, model=dataclasses.replace(
                base.model, n_layers=n_layers)))
    return arch_id


def smoke_weights(torch, arch, devices):
    """The smoke config's weights from a CPU generator (seed 0), on each
    of ``devices``: the same values on the card and on the CPU."""
    from repro_torch.models.layers import tree_map
    params = arch.model_module().init(arch.model,
                                      torch.Generator().manual_seed(0))
    return [tree_map(lambda t, dev=dev: t.to(dev), params)
            for dev in devices]


def smoke_serve(torch, arch_id: str, out: dict) -> dict:
    """``launch.serve --smoke`` on the card (its flash launches exactly
    :func:`flash_per_call`'s, on the fp32 kernel) and with ``--device
    cpu`` (none); then the engine on the same weights on both devices:
    prefill logits within :data:`SMOKE_LOGIT_TOL` and greedy tokens as it
    says. Returns the launcher's window on the card."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.serve import engine
    arch = registry.get(arch_id)
    arch = dataclasses.replace(arch, model=arch.smoke)
    cfg = arch.model
    argv = ["--arch", arch_id, "--smoke", "--new-tokens", str(SMOKE_NEW),
            "--seed", "0"]
    per_prefill, per_step = flash_per_call(arch)
    want = {"flash_attention_f32": per_prefill["flash_attention"] + (
        SMOKE_NEW - 1) * per_step.get("flash_attention", 0)}
    runs, windows = {}, {}
    for dev, extra, expect in (("cuda", [], want),
                               ("cpu", ["--device", "cpu"], {})):
        LAUNCHES.clear()
        t0 = time.perf_counter()
        runs[dev] = serve.main(argv + extra)
        torch.cuda.synchronize()
        runs[dev]["wall_s"] = time.perf_counter() - t0
        windows[dev] = read_window(LAUNCHES, expect,
                                   f"serve --smoke {arch_id} on {dev}")
    b, s0 = runs["cpu"]["prompts"].shape
    if not torch.equal(runs["cuda"]["prompts"], runs["cpu"]["prompts"]):
        raise AssertionError(f"{arch_id}: the two runs' prompts differ")
    prompts = SyntheticTokens(cfg.vocab, b, s0, seed=0).next_batch()[
        "tokens"]
    frames = (0.1 * torch.randn((b, s0, cfg.d_model),
                                generator=torch.Generator().manual_seed(1))
              if arch.module == "encdec" else None)
    logits, tokens = {}, {}
    with torch.inference_mode():
        for dev, params in zip(("cuda", "cpu"),
                               smoke_weights(torch, arch, ("cuda", "cpu"))):
            batch = {"tokens": prompts.to(dev)}
            if frames is not None:
                batch["frames"] = frames.to(dev)
            cache = engine.make_cache(arch, b, s0 + SMOKE_NEW,
                                      cfg.param_dtype, dev)
            lg, cache = engine.make_prefill_fn(arch)(params, batch, cache)
            steps, tok = [lg[:, -1]], engine.greedy_token(lg[:, -1])
            toks = [tok]
            decode = engine.make_decode_fn(arch)
            for i in range(SMOKE_NEW - 1):
                st, cache = decode(params, tok, cache, s0 + i)
                steps.append(st)
                tok = engine.greedy_token(st)
                toks.append(tok)
            logits[dev] = (lg.float().cpu(), [x.float().cpu()
                                              for x in steps])
            tokens[dev] = torch.cat(toks, 1).cpu()
            del params, cache
    ref = logits["cpu"][0]
    err = float((logits["cuda"][0] - ref).abs().max())
    tol = SMOKE_LOGIT_TOL * float(ref.abs().max())
    # each row's tokens until the CPU's top two logits lie within tol
    compared = mismatched = 0
    for r in range(b):
        for i, st in enumerate(logits["cpu"][1]):
            top2 = st[r].topk(2).values
            if float(top2[0] - top2[1]) <= tol:
                break
            compared += 1
            mismatched += int(tokens["cuda"][r, i] != tokens["cpu"][r, i])
    torch.cuda.empty_cache()
    print(f"smoke serve {arch_id}: {cfg.name} {serve.model_depth(cfg)} "
          f"layers, heads {serve.flash_heads(arch)} fp32, batch {b} prompt "
          f"{s0} new {SMOKE_NEW}: launcher on the card {windows['cuda']} "
          f"({runs['cuda']['prefill_ms']:.3f} ms prefill, "
          f"{runs['cuda']['decode_ms_per_step']:.3f} ms/step), on the CPU "
          f"no launch ({runs['cpu']['prefill_ms']:.3f} ms prefill); same "
          f"weights card vs CPU: prefill logits max |err| {err:.4g} (tol "
          f"{tol:.4g}), greedy tokens equal in {compared - mismatched} of "
          f"{compared} compared ({b * SMOKE_NEW} drawn)")
    out[f"serve {arch_id}"] = {"windows": windows, "logit_err": err,
                               "logit_tol": tol, "compared": compared,
                               "mismatched": mismatched,
                               "prefill_ms": {d: runs[d]["prefill_ms"]
                                              for d in runs}}
    if not (err <= tol and mismatched == 0):
        raise AssertionError(f"smoke serve {arch_id}: card vs CPU prefill "
                             f"logits max |err| {err} (tol {tol}), "
                             f"{mismatched} of {compared} tokens differ")
    return windows["cuda"]


def smoke_train(torch, argv: list, out: dict) -> dict:
    """``launch.train --smoke`` at ``argv`` on the card (exactly
    :func:`train_launches`, the fp32 kernels) and with ``--device cpu``
    (no launch), both with finite losses; then one train step from the
    same state and batch on both devices, loss and gradient norm within
    :data:`SMOKE_STEP_TOL`. Returns the launcher's window on the card."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch import train
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    get = lambda f: int(argv[argv.index(f) + 1])  # noqa: E731
    arch_id = argv[argv.index("--arch") + 1]
    arch = registry.get(arch_id)
    arch = dataclasses.replace(arch, model=arch.smoke)
    steps, b, seq = get("--steps"), get("--batch"), get("--seq")
    run = run_launcher(torch, argv, train_launches(arch, steps, seq),
                       f"train --smoke {arch_id} on the card")
    LAUNCHES.clear()
    t0 = time.perf_counter()
    cpu = train.main(argv + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    read_window(LAUNCHES, {}, f"train --smoke {arch_id} on the CPU")
    cpu_losses = [float(m["loss"]) for m in cpu["metrics"]]
    if not all(map(math.isfinite, cpu_losses)):
        raise AssertionError(f"{arch_id}: CPU losses {cpu_losses}")
    batch = SyntheticTokens(arch.model.vocab, b, seq, seed=0).next_batch()
    if arch.module == "encdec":
        batch["frames"] = train.step_frames(torch.Generator().manual_seed(1),
                                            b, seq, arch.model.d_model,
                                            "cpu")
    fn = make_train_step(arch, AdamWConfig(total_steps=steps))
    metrics = {}
    for dev, params in zip(("cuda", "cpu"),
                           smoke_weights(torch, arch, ("cuda", "cpu"))):
        LAUNCHES.clear()
        _, m = fn(init_train_state(params),
                  tree_map(lambda t, dev=dev: t.to(dev), batch))
        metrics[dev] = {k: float(m[k]) for k in ("loss", "grad_norm")}
        read_window(LAUNCHES, train_launches(arch, seq=seq)
                    if dev == "cuda" else {}, f"{arch_id} step on {dev}")
    errs = {k: abs(metrics["cuda"][k] - metrics["cpu"][k]) /
            abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
    print(f"smoke train {arch_id}: batch {b} x seq {seq}, {steps} steps: "
          f"launcher on the card {run['window']}, losses "
          f"{[round(x, 5) for x in run['losses']]}, host ms a step "
          f"{', '.join(f'{t:.1f}' for t in run['step_ms'])}; on the CPU "
          f"losses {[round(x, 5) for x in cpu_losses]} ({cpu_s:.1f} s); "
          f"one step from the same state, card vs CPU: loss "
          f"{metrics['cuda']['loss']:.6f} vs {metrics['cpu']['loss']:.6f}, "
          f"|g| {metrics['cuda']['grad_norm']:.6f} vs "
          f"{metrics['cpu']['grad_norm']:.6f} (relative {errs}, tol "
          f"{SMOKE_STEP_TOL})")
    out[f"train {arch_id} seq {seq}"] = {**run, "cpu_losses": cpu_losses,
                                         "step": metrics, "rel_err": errs}
    if not max(errs.values()) <= SMOKE_STEP_TOL:
        raise AssertionError(f"smoke train {arch_id}: card vs CPU step "
                             f"{metrics} outside {SMOKE_STEP_TOL}")
    return run["window"]


def phase_pairs(torch, details: dict) -> dict:
    """Phase 15. Returns the fp32 kernel's rows for the kernels line and
    the launches of the phase's main-path windows: the two published
    trainings and the smoke serving and training runs."""
    out = details.setdefault("pairs", {})
    rows = timed("pairs f32 shapes", f32_shapes, torch, out)
    launches: collections.Counter = collections.Counter()
    for base, layers, argv in (TRAIN_DEEPSEEK, TRAIN_GEMMA):
        launches.update(timed(f"pairs train {base}", train_arch, torch,
                              ["--arch", cut_arch(base, layers), *argv],
                              out))
    for arch_id in SMOKE_SERVE:
        launches.update(timed(f"pairs smoke serve {arch_id}", smoke_serve,
                              torch, arch_id, out))
    for argv in SMOKE_TRAIN:
        launches.update(timed(f"pairs smoke train {argv[1]}", smoke_train,
                              torch, argv, out))
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv", *rows):
        if not launches.get(name):
            raise AssertionError(f"{name} not launched on phase 15's paths "
                                 f"({dict(launches)})")
    return {"rows": rows, "launches": dict(launches)}


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

    # phase 14's dry-run beside the kernel build and phases 2-5 (one host
    # process: it shares the host with their recorded host times, but not
    # the card with their device times), waited for before phase 6
    predicting = tp_predictions()
    try:
        phase("card", phase_card, torch, details)
        t0 = time.time()
        prog = compile_network("resnet18")
        print(f"compile: resnet18 224 -O 0, {len(prog.layers)} layers, "
              f"fingerprint {prog.fingerprint()[:12]}, "
              f"{time.time() - t0:.2f} s")
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
        t0 = time.time()
        predicted = predicting()
        print(f"tensor: waited {time.time() - t0:.1f} s for the dry-run "
              f"after phase flash")
    except BaseException:
        predicting.kill()
        raise
    counts["flash_attention"] = phase("serve", phase_serve, torch, details)
    counts["flash_attention"] += phase("archs", phase_archs, torch, details)
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
    train = phase("train", phase_train, torch, details)
    print(f"train: launches of the seamless run {train['launches']}")
    counts["flash_attention"] += train["launches"]["flash_attention"]
    par, ref = phase("parallel", phase_parallel, torch, details)
    print(f"parallel: launches of the data-parallel ranks' runs, summed "
          f"over the ranks {par}")
    for name in train["launches"]:
        if not par.get(name):
            raise AssertionError(f"{name} not launched on the data-parallel "
                                 f"path ({par})")
    counts["flash_attention"] += par["flash_attention"]
    tensor = phase("tensor", phase_tensor, torch, details, ref, predicted)
    del ref
    print(f"tensor: launches of the tensor-parallel ranks' runs, summed "
          f"over the ranks {tensor}")
    for name in train["launches"]:
        if not tensor.get(name):
            raise AssertionError(f"{name} not launched on the "
                                 f"tensor-parallel path ({tensor})")
        par[name] += tensor[name]
    counts["flash_attention"] += tensor["flash_attention"]
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
    for name, row in train["rows"].items():
        tot[name], counts[name] = row, train["launches"][name] + par[name]
    pairs = phase("pairs", phase_pairs, torch, details)
    print(f"pairs: launches of the phase's published and smoke runs "
          f"{pairs['launches']}")
    tot.update(pairs["rows"])
    for name, n in pairs["launches"].items():
        counts[name] = counts.get(name, 0) + n
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
