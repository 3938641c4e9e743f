"""``python -m repro_torch.compiler`` — compile networks to ISA programs
and execute them on the card.

Examples::

    python -m repro_torch.compiler resnet18                   # summary
    python -m repro_torch.compiler resnet18 -O 1 --simulate   # + Fig.5 decomposition
    python -m repro_torch.compiler llama3.2-1b -O 1 --trace t.json --profile
    python -m repro_torch.compiler resnet18 --execute --backend cuda
    python -m repro_torch.compiler resnet18 --execute --backend golden
    python -m repro_torch.compiler resnet18 --in-hw 32 --width 0.25 \\
        --execute --torch-device cpu                          # plain versions
    python -m repro_torch.compiler llama3.2-1b --decode --execute
    python -m repro_torch.compiler mamba2-780m --decode --simulate
    python -m repro_torch.compiler llama3.2-1b --format asm   # text assembly
    python -m repro_torch.compiler mobilenet_v2 --format bin -o mb2.n3h
    python -m repro_torch.compiler resnet18 --devices 2 --partition filter \
        --execute                                         # multi-device bundle
    python -m repro_torch.compiler --list

The counterpart of ``repro.compiler.cli``: CNN programs, the registry
archs' fixed-sequence programs (their smoke configs at ``--seq-len``)
and their decode-step programs (``--decode``), which ``--execute``
drives through an ``ExecutorSession``; ``--devices N`` / ``--partition``
compile a multi-device bundle, executed through
``MultiDeviceExecutor`` with every simulated device on the one torch
device. ``--format asm|bin`` writes the same text and images as the
reference's CLI.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.core.scheduler import (
    DEVICES,
    DspCoreConfig,
    LutCoreConfig,
    simulate_program,
)
from repro_torch.quant.uniform import qrange
from repro_torch.compiler import asm
from repro_torch.compiler.lower import lower_network
from repro_torch.compiler.networks import decode_step_layers, \
    list_networks, network_layers
from repro_torch.compiler.partition import (
    PLAN_KINDS,
    LinkModel,
    PartitionError,
    decorate_decode_bundle,
    derive_plan,
    lower_partitioned,
)
from repro_torch.compiler.passes import OPT_LEVELS
from repro_torch.compiler.runtime import BACKENDS, ExecutorSession, \
    MultiDeviceExecutor, bind_synthetic, get_backend


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.compiler",
        description="Compile a network to unified-ISA instruction streams "
                    "and execute it with PyTorch/CUDA.")
    p.add_argument("network", nargs="?",
                   help="resnet18 | mobilenet_v2 | any registered arch id")
    p.add_argument("--list", action="store_true",
                   help="list compilable networks and exit")
    p.add_argument("--device", default="XC7Z020", choices=sorted(DEVICES),
                   help="modelled FPGA device the program is compiled for")
    p.add_argument("--bits-w", type=int, default=4,
                   help="LUT-core weight bit-width (2-8)")
    p.add_argument("--bits-a", type=int, default=4,
                   help="activation bit-width (2-8)")
    p.add_argument("--ratio", type=float, default=None,
                   help="fixed LUT filter ratio; default solves Eq. 12")
    p.add_argument("--seq-len", type=int, default=64,
                   help="token count for LM archs")
    p.add_argument("--decode", action="store_true",
                   help="compile an autoregressive decode step program "
                        "(m = --batch) with resident weights and "
                        "KV-cache/state segments instead of the "
                        "fixed-sequence program")
    p.add_argument("--batch", type=int, default=1,
                   help="sequences per decode step (--decode)")
    p.add_argument("--max-seq", type=int, default=64,
                   help="KV-cache/state depth of a decode session "
                        "(--decode)")
    p.add_argument("--in-hw", type=int, default=None,
                   help="CNN input size (default 224); reduced variants "
                        "stay geometry-consistent end to end")
    p.add_argument("--width", type=float, default=None,
                   help="CNN channel-width multiplier (default 1.0)")
    p.add_argument("--lut-m", type=int, default=8)
    p.add_argument("--lut-n", type=int, default=16)
    p.add_argument("--lut-k", type=int, default=128)
    p.add_argument("--devices", type=int, default=1,
                   help="compile for N coordinated devices (a "
                        "multi-device bundle when N > 1 or --partition "
                        "is given)")
    p.add_argument("--partition", choices=PLAN_KINDS, default=None,
                   help="partition plan kind: pipeline stages or "
                        "filter-parallel shards; default derives from "
                        "the parallel/ axis rules")
    p.add_argument("--link-latency", type=int, default=None,
                   help="cross-device link latency in cycles "
                        "(default: LinkModel default)")
    p.add_argument("--batches", type=int, default=8,
                   help="back-to-back inputs the multi-device makespan "
                        "covers under --simulate (pipeline plans "
                        "overlap them)")
    p.add_argument("-O", "--opt", type=int, default=0, choices=OPT_LEVELS,
                   help="optimization level: 0 = canonical Fig.-3 schedule, "
                        "1 = passes.py pipeline")
    p.add_argument("--backend", default="cuda", choices=sorted(BACKENDS),
                   help="executor backend for --execute")
    p.add_argument("--torch-device", default="cuda",
                   help="torch device --execute runs on (cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--format", choices=("summary", "asm", "bin"),
                   default="summary")
    p.add_argument("--simulate", action="store_true",
                   help="also run the event-driven simulator (summary "
                        "mode)")
    p.add_argument("--execute", action="store_true",
                   help="also execute the program with synthetic weights "
                        "via --backend: CNN programs end to end, decode "
                        "programs as a 4-token greedy session, other LM "
                        "programs layer by layer (summary mode)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="simulate with the repro_torch.obs tracer and "
                        "write a Chrome trace-event JSON (open in "
                        "Perfetto; summary mode)")
    p.add_argument("--profile", action="store_true",
                   help="render the per-layer/per-core utilization "
                        "report from a traced simulation (summary mode)")
    p.add_argument("-o", "--output", default=None,
                   help="write asm/bin to a file instead of stdout")
    return p


def compile_network(name: str, *, device: str = "XC7Z020", bits_w: int = 4,
                    bits_a: int = 4, ratio: float | None = None,
                    seq_len: int = 64, lut_m: int = 8, lut_n: int = 16,
                    lut_k: int = 128, opt_level: int = 0,
                    devices: int = 1, partition: str | None = None,
                    link_latency: int | None = None,
                    in_hw: int | None = None, width: float | None = None):
    """Programmatic entry point used by the CLI, the launcher and tests.

    ``devices > 1`` (or an explicit ``partition`` kind) compiles a
    multi-device ``MultiDeviceProgram`` bundle under a plan derived by
    ``partition.derive_plan``; otherwise the legacy single
    ``Program``. ``in_hw``/``width`` scale the CNN workloads to their
    reduced geometry-consistent variants (ignored for LM archs, which
    compile their smoke configs at ``seq_len`` tokens).
    """
    dev = DEVICES[device]
    lut_cfg = LutCoreConfig(m=lut_m, n=lut_n, k=lut_k)
    dsp_cfg = DspCoreConfig(n_reg_row_a=DspCoreConfig.rows_for_device(dev))
    layers = network_layers(name, seq_len=seq_len, in_hw=in_hw, width=width)
    n_luts = None
    if ratio is not None:
        n_luts = [int(round(ratio * gl.dims.n)) for gl in layers]
    if devices == 1 and partition is None:
        return lower_network(name, layers, lut_cfg, dsp_cfg, dev,
                             bits_w_lut=bits_w, bits_a=bits_a,
                             n_luts=n_luts, opt_level=opt_level)
    link = LinkModel() if link_latency is None \
        else LinkModel(latency_cycles=link_latency)
    plan = derive_plan(layers, devices, kind=partition, link=link)
    return lower_partitioned(name, layers, plan, lut_cfg, dsp_cfg, dev,
                             bits_w_lut=bits_w, bits_a=bits_a,
                             n_luts=n_luts, opt_level=opt_level)


def compile_decode_network(name: str, *, batch: int = 1, max_seq: int = 64,
                           device: str = "XC7Z020", bits_w: int = 4,
                           bits_a: int = 4, ratio: float | None = None,
                           lut_m: int = 8, lut_n: int = 16, lut_k: int = 128,
                           opt_level: int = 0, devices: int = 1,
                           partition: str | None = None,
                           link_latency: int | None = None):
    """Compile the decode-mode step program of an lm/ssm/hybrid arch
    (its smoke config).

    The emitted program runs one token position for ``batch``
    sequences: weight segments are residency-class ``weights`` (loaded
    by the warm-up invocation, reused by ``lower.steady_program``
    afterwards), attention K/V projections append to ``kv`` cache
    segments sized for ``max_seq`` positions and SSM blocks carry a
    persistent ``state`` segment. ``devices > 1`` compiles the bundle
    via ``lower_partitioned`` and decode-decorates every per-device
    program (``partition.decorate_decode_bundle``).
    """
    dev = DEVICES[device]
    lut_cfg = LutCoreConfig(m=lut_m, n=lut_n, k=lut_k)
    dsp_cfg = DspCoreConfig(n_reg_row_a=DspCoreConfig.rows_for_device(dev))
    layers, spec = decode_step_layers(name, batch=batch, max_seq=max_seq)
    n_luts = None
    if ratio is not None:
        n_luts = [int(round(ratio * gl.dims.n)) for gl in layers]
    if devices == 1 and partition is None:
        return lower_network(f"{name}.decode", layers, lut_cfg, dsp_cfg,
                             dev, bits_w_lut=bits_w, bits_a=bits_a,
                             n_luts=n_luts, opt_level=opt_level, step=spec)
    link = LinkModel() if link_latency is None \
        else LinkModel(latency_cycles=link_latency)
    plan = derive_plan(layers, devices, kind=partition, link=link)
    mdp = lower_partitioned(f"{name}.decode", layers, plan, lut_cfg,
                            dsp_cfg, dev, bits_w_lut=bits_w, bits_a=bits_a,
                            n_luts=n_luts, opt_level=opt_level)
    return decorate_decode_bundle(mdp, spec)


def summarize_bundle(mdp, simulate: bool = False, batches: int = 8) -> str:
    """Multi-device summary: plan, per-device programs, hand-offs."""
    lines = [
        f"bundle    {mdp.name}  ({mdp.plan.describe()})",
        f"devices   {mdp.n_devices}  layers {mdp.n_layers} (global)",
        f"edges     {len(mdp.edges)} cross-device channel(s), "
        f"{sum(e.nbytes for e in mdp.edges)} B/traversal over the link",
        f"link      {mdp.plan.link.latency_cycles} cycle latency, "
        f"{mdp.plan.link.bytes_per_cycle} B/cycle",
    ]
    for d, prog in enumerate(mdp.devices):
        s = prog.stats()
        lines.append(f"  dev{d}  {len(prog.layers)} layers, "
                     f"{s.n_instructions} instrs, "
                     f"{s.ddr_footprint} B ddr, "
                     f"{s.bytes_fetched / 1e6:.3f} MB fetched")
    if mdp.devices and mdp.devices[0].opt_stats:
        lines.append("passes    (per device)")
        for ps in mdp.devices[0].opt_stats:
            lines.append(f"  dev0 {ps.render()}")
    if simulate:
        t0 = time.time()
        bs = simulate_program(mdp, batches=batches)
        dt = time.time() - t0
        dev0 = mdp.devices[0].device
        lines.append(
            f"simulated {bs.total_cycles} cycles makespan for "
            f"{bs.batches} input(s) "
            f"({dev0.cycles_to_ms(bs.total_cycles):.3f} ms @ "
            f"{dev0.freq_mhz:.0f} MHz; sim wall {dt:.2f}s)")
        lines.append(f"  latency/traversal {bs.latency_cycles} cycles, "
                     f"steady-state interval {bs.interval_cycles}")
        for d, s in enumerate(bs.device_sims):
            lines.append(f"  dev{d}: {s.total_cycles} cycles")
    return "\n".join(lines)


def summarize(prog, simulate: bool = False) -> str:
    s = prog.stats()
    lines = [
        f"program   {prog.name}  (device {prog.device.name})",
        f"layers    {len(prog.layers)}",
        f"instrs    {s.n_instructions}  "
        + "  ".join(f"{k.lower()}={v}" for k, v in s.by_opcode.items()),
        f"image     {s.image_bytes} B ({s.n_instructions} x 128-bit words)",
        f"ddr map   {len(prog.memory.segments)} segments, "
        f"{s.ddr_footprint} B footprint",
        f"traffic   {s.bytes_fetched / 1e6:.3f} MB fetched, "
        f"{s.bytes_written / 1e6:.3f} MB written back",
    ]
    split = [lp.n_lut / max(lp.dims.n, 1) for lp in prog.layers]
    lines.append(f"lut ratio mean={sum(split) / max(len(split), 1):.3f} "
                 f"min={min(split):.3f} max={max(split):.3f}")
    if prog.opt_stats:
        total_before = prog.opt_stats[0].instrs_before
        total_after = prog.opt_stats[-1].instrs_after
        lines.append(f"passes    {len(prog.opt_stats)} passes, "
                     f"{total_before} -> {total_after} instrs "
                     f"(-{total_before - total_after})")
        for ps in prog.opt_stats:
            lines.append(f"  {ps.render()}")
    if getattr(prog, "step", None) is not None:
        sp = prog.step
        lines.append(f"decode    family={sp.family} batch={sp.batch} "
                     f"max_seq={sp.max_seq} (resident weights + "
                     f"persistent kv/state segments)")
    if simulate:
        t0 = time.time()
        ps = simulate_program(prog)
        dt = time.time() - t0
        lines.append(f"simulated {ps.total_cycles} cycles "
                     f"({prog.device.cycles_to_ms(ps.total_cycles):.3f} ms "
                     f"@ {prog.device.freq_mhz:.0f} MHz; sim wall {dt:.2f}s)")
        if hasattr(ps, "steady_cycles"):
            lines.append(
                f"  decode: warm-up {ps.warmup_cycles} cycles/token, "
                f"steady-state {ps.steady_cycles} cycles/token "
                f"({ps.warmup_cycles / max(ps.steady_cycles, 1):.2f}x "
                f"warm-up cost)")
        for core in ("lut", "dsp"):
            d = ps.decomposition(core)
            lines.append(f"  {core}: wait={d['l_wait']} run={d['l_run']} "
                         f"sig={d['l_sig']} rst={d['l_rst']}")
    return "\n".join(lines)


def execute_report(prog, backend: str = "cuda", seed: int = 0,
                   device="cuda") -> str:
    """Execute a program functionally with synthetic weights.

    Decode programs (a ``StepSpec`` header) run a short greedy decode
    through an ``ExecutorSession``. Conv programs (every layer carries
    an im2col geometry — the CNN workloads) run *end to end*: a
    synthetic input image is quantized to the first layer's activation
    bits and chained through the whole network (im2col staging, pooling
    glue, shortcut sources, inter-layer requantization). Other programs
    are driven layer by layer on fresh synthetic activations. The
    weights and activations come from the same numpy generators as the
    reference's report, so the checksums are comparable between the two
    packages.

    Accepts a single ``Program`` or a multi-device bundle; the bundle
    path drives the same synthetic weights and activations through
    ``MultiDeviceExecutor``, so its checksum is bit-identical to the
    single-device run of the same network.
    """
    is_bundle = hasattr(prog, "devices")
    step = getattr(prog.devices[0] if is_bundle else prog, "step", None)
    if step is not None:
        return _decode_session_report(prog, backend, seed, device)
    if is_bundle:
        ex = MultiDeviceExecutor(prog, backend=backend, device=device)
        layers = ex.layers
    else:
        ex = get_backend(backend)(prog, device=device)
        layers = prog.layers
    rng = np.random.default_rng(seed)
    what = f"{backend} backend" if not is_bundle else \
        f"{backend} backend x{prog.n_devices} devices"
    for lp in layers:
        if is_bundle:
            ex.bind_synthetic(lp.index, seed=seed + lp.index)
        else:
            bind_synthetic(ex, lp, seed=seed + lp.index)
    if layers and all(lp.geometry is not None for lp in layers):
        lp0 = layers[0]
        lo_a, hi_a = qrange(lp0.bits_a)
        x_q = rng.integers(lo_a, hi_a + 1,
                           lp0.geometry.in_shape).astype(np.int8)
        t0 = time.time()
        logits = ex.run(x_q).cpu().numpy()
        dt = time.time() - t0
        return (f"executed  {len(layers)}/{len(layers)} layers end to "
                f"end via {what} in {dt:.3f}s "
                f"(logits [{logits.shape[0]},{logits.shape[1]}], "
                f"|out| sum {float(np.abs(logits).sum()):.6e})")

    checksum = 0.0
    t0 = time.time()
    for lp in layers:
        lo_a, hi_a = qrange(lp.bits_a)
        shape = (lp.dims.m, lp.dims.k, lp.dims.n) if lp.depthwise \
            else (lp.dims.m, lp.dims.k)
        x_q = rng.integers(lo_a, hi_a + 1, shape).astype(np.int8)
        checksum += float(np.abs(ex.run_layer(lp.index, x_q).cpu().numpy())
                          .sum())
    dt = time.time() - t0
    return (f"executed  {len(layers)}/{len(layers)} layers via "
            f"{what} in {dt:.3f}s (|out| sum {checksum:.6e})")


def _decode_session_report(prog, backend: str = "cuda", seed: int = 0,
                           device="cuda", n_tokens: int = 4) -> str:
    """Drive a short greedy decode through an ``ExecutorSession``: bind
    synthetic weights once, then step token by token (warm-up program
    first, steady-state program after)."""
    sess = ExecutorSession(prog, backend=backend, device=device)
    sess.bind_synthetic_all(seed=seed if seed else None)
    token, checksum = 1, 0.0
    t0 = time.time()
    for pos in range(n_tokens):
        logits = sess.step(token, pos).cpu().numpy()
        token = int(np.argmax(logits[0]))
        checksum += float(np.abs(logits).sum())
    dt = time.time() - t0
    return (f"decoded   {n_tokens} token(s) via {backend} session in "
            f"{dt:.3f}s (1 warm-up + {n_tokens - 1} steady step(s), "
            f"|logits| sum {checksum:.6e})")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        print("\n".join(list_networks()))
        return 0
    if not args.network:
        build_parser().print_usage()
        return 2
    if args.ratio is not None and not 0.0 <= args.ratio <= 1.0:
        print(f"error: --ratio must be in [0, 1], got {args.ratio}",
              file=sys.stderr)
        return 2
    if args.devices < 1:
        print(f"error: --devices must be >= 1, got {args.devices}",
              file=sys.stderr)
        return 2
    try:
        if args.decode:
            prog = compile_decode_network(
                args.network, batch=args.batch, max_seq=args.max_seq,
                device=args.device, bits_w=args.bits_w, bits_a=args.bits_a,
                ratio=args.ratio, lut_m=args.lut_m, lut_n=args.lut_n,
                lut_k=args.lut_k, opt_level=args.opt,
                devices=args.devices, partition=args.partition,
                link_latency=args.link_latency)
        else:
            prog = compile_network(
                args.network, device=args.device, bits_w=args.bits_w,
                bits_a=args.bits_a, ratio=args.ratio, seq_len=args.seq_len,
                lut_m=args.lut_m, lut_n=args.lut_n, lut_k=args.lut_k,
                opt_level=args.opt, devices=args.devices,
                partition=args.partition, link_latency=args.link_latency,
                in_hw=args.in_hw, width=args.width)
    except (KeyError, ValueError, PartitionError) as e:
        msg = e.args[0] if e.args else e
        print(f"error: {msg}", file=sys.stderr)
        return 2

    is_bundle = hasattr(prog, "devices")
    if args.format == "summary":
        if is_bundle:
            print(summarize_bundle(prog, simulate=args.simulate,
                                   batches=args.batches))
        else:
            print(summarize(prog, simulate=args.simulate))
        if args.trace or args.profile:
            from repro_torch.obs import Tracer, profile_report
            tracer = Tracer()
            simulate_program(prog, batches=args.batches, tracer=tracer)
            errs = tracer.counters.closure_errors()
            if errs:
                print("error: cycle accounting failed to close:",
                      file=sys.stderr)
                for e in errs:
                    print(f"  {e}", file=sys.stderr)
                return 1
            if args.trace:
                tracer.save(args.trace)
                n_events = len(tracer.to_chrome()["traceEvents"])
                print(f"trace     {args.trace} ({n_events} events)")
            if args.profile:
                print(profile_report(tracer), end="")
        if args.execute:
            print(execute_report(prog, backend=args.backend,
                                 device=args.torch_device))
        return 0
    if args.format == "asm":
        text = asm.disassemble_bundle(prog) if is_bundle \
            else asm.disassemble(prog)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0
    blob = asm.to_bundle_binary(prog) if is_bundle else asm.to_binary(prog)
    if args.output:
        with open(args.output, "wb") as f:
            f.write(blob)
    else:
        sys.stdout.buffer.write(blob)
    return 0
