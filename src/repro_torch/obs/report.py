"""Profile report: human-readable utilization breakdown of a trace.

``profile_report(tracer)`` renders the counters of a traced run as the
table the FPGA-accelerator literature keeps asking for (utilization
breakdown as the primary design-feedback signal): per-core/per-engine
busy/sync/stall/idle as % of the program makespan (the roofline-style
"% of peak" — an engine busy 100% of the makespan is at its
issue-rate peak), the Eq.-12 split balance per layer, DMA traffic,
top stall causes by sync channel, and the closure check verdict.

Surfaced by ``python -m repro.compiler ... --trace out.json --profile``
and importable for benchmarks/tests.
"""
from __future__ import annotations

from .counters import CORES, ENGINES


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} GiB"


def profile_report(tracer, top_stalls: int = 5,
                   max_layer_rows: int = 24) -> str:
    """Render the utilization/profile table for a completed trace."""
    c = tracer.counters
    if c is None or not c.tracks:
        return "profile: no trace data (tracing disabled or nothing ran)\n"
    tracer.finalize()   # stall causes / queue peaks are span-derived
    makespan = c.makespan
    lines = []
    lines.append(f"== profile: makespan {makespan} cycles ==")

    # per-core / per-engine utilization (% of makespan == % of peak)
    lines.append("")
    lines.append(f"{'track':<22}{'busy%':>8}{'sync%':>8}{'stall%':>8}"
                 f"{'idle%':>8}{'busy cycles':>14}")
    devices = sorted({d for (d, _, _) in c.tracks})
    for device in devices:
        for core in CORES:
            for engine in ENGINES:
                tc = c.tracks.get((device, core, engine))
                if tc is None:
                    continue
                lines.append(
                    f"dev{device} {core}/{engine:<12}"
                    f"{tc.pct('busy', makespan):>8.1f}"
                    f"{tc.pct('sync', makespan):>8.1f}"
                    f"{tc.pct('stall', makespan):>8.1f}"
                    f"{tc.pct('idle', makespan):>8.1f}"
                    f"{tc.busy:>14}")

    # per-layer table: window, per-core cycles, Eq.-12 split balance
    if c.layers:
        lines.append("")
        lines.append(f"{'layer':<26}{'dev':>4}{'window':>10}{'lut':>10}"
                     f"{'dsp':>10}{'balance':>9}")
        shown = c.layers[:max_layer_rows]
        for row in shown:
            lines.append(
                f"{row['name'][:25]:<26}{row['device']:>4}"
                f"{row['window']:>10}{row['lut_cycles']:>10}"
                f"{row['dsp_cycles']:>10}{row['split_balance']:>9.2f}")
        if len(c.layers) > len(shown):
            lines.append(f"... ({len(c.layers) - len(shown)} more layers)")

    # DMA traffic
    if c.dma:
        lines.append("")
        lines.append("DMA bytes moved:")
        for (device, core), agg in sorted(c.dma.items()):
            lines.append(f"  dev{device} {core}: "
                         f"fetch {_fmt_bytes(agg['bytes_fetched'])}, "
                         f"write {_fmt_bytes(agg['bytes_written'])}")

    # top stall causes
    if c.wait_by_channel:
        lines.append("")
        lines.append(f"top stall causes (of {top_stalls}):")
        ranked = sorted(c.wait_by_channel.items(),
                        key=lambda kv: (-kv[1], kv[0]))[:top_stalls]
        for (device, channel), cycles in ranked:
            pct = 100.0 * cycles / makespan if makespan else 0.0
            lines.append(f"  dev{device} {channel}: {cycles} cycles "
                         f"({pct:.1f}% of makespan)")

    # buffer-slot occupancy peaks
    slot_peaks = {k: v for k, v in c.queue_peak.items()
                  if k[1].endswith(("wslot", "aslot"))}
    if slot_peaks:
        lines.append("")
        lines.append("peak buffer-slot occupancy:")
        for (device, channel), depth in sorted(slot_peaks.items()):
            lines.append(f"  dev{device} {channel}: {depth}")

    # the contract
    errors = c.closure_errors()
    lines.append("")
    if errors:
        lines.append("cycle accounting: FAILED to close")
        lines.extend(f"  {e}" for e in errors)
    else:
        lines.append("cycle accounting: closed "
                     "(busy+sync+stall+idle == makespan on every track)")
    return "\n".join(lines) + "\n"
