"""Run the paper's RL-based design-space exploration end to end.

The port of ``examples/dse_search.py``: the same flags plus
``--torch-device`` (default ``cuda``), where the DDPG agent lives.
Searches the N3H-Core configuration (hardware knobs + per-layer
bit-widths; split ratios solved analytically per Eq. 12) for a network
on an FPGA device under a latency target, then prints the
Table-3-style row and the per-layer bit-width/ratio profile (the
Fig. 9 analogue). With ``--simulate-elites`` the top ``--top-k`` elite
configurations are compiled and re-scored on the event-driven
simulator, and the analytical-vs-simulated delta and the calibration
report are printed too.

    python -m repro_torch.dse --network llama3.2-1b --seq-len 16 \\
        --target 1.0 --episodes 12 --simulate-elites --top-k 3
"""
import argparse
import sys

from repro_torch.dse.ddpg import agent_device
from repro_torch.dse.search import run_search


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.dse")
    ap.add_argument("--network", default="resnet18",
                    help="CNN workload or registry arch id")
    ap.add_argument("--device", default="XC7Z020")
    ap.add_argument("--target", type=float, default=35.0)
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=64,
                    help="token count for registry archs (perfect square)")
    ap.add_argument("--simulate-elites", action="store_true",
                    help="re-score elite configs on compiled programs "
                         "(the two-tier loop of docs/dse.md)")
    ap.add_argument("--top-k", type=int, default=4,
                    help="elite pool size for --simulate-elites")
    ap.add_argument("--sim-every", type=int, default=20,
                    help="episodes between elite re-scoring rounds")
    ap.add_argument("--calibration-csv", default=None,
                    help="write the calibration report to this CSV path")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device the DDPG agent runs on")
    args = ap.parse_args(argv)

    with agent_device(args.torch_device):
        res = run_search(network=args.network, device=args.device,
                         target_latency_ms=args.target,
                         episodes=args.episodes, seq_len=args.seq_len,
                         simulate_elites=args.simulate_elites,
                         top_k=args.top_k, sim_every=args.sim_every,
                         verbose=True)
    print(f"\nsearched configuration (Table 3 row, "
          f"reward source: {res.reward_source}):")
    for k, v in res.table3_row().items():
        print(f"  {k:14s} {v}")
    if res.simulated_latency_ms is not None:
        delta = res.analytical_latency_ms - res.simulated_latency_ms
        print("\nanalytical vs simulated latency (winning config):")
        print(f"  analytical   {res.analytical_latency_ms:.4f} ms")
        print(f"  simulated    {res.simulated_latency_ms:.4f} ms")
        print(f"  delta        {delta:+.4f} ms ({res.sim_gap_pct:+.2f}%)")
        print()
        print(res.calibration_report())
    if args.calibration_csv:
        res.write_calibration_csv(args.calibration_csv)
        print(f"\ncalibration CSV written to {args.calibration_csv}")
    info = res.best_info
    print("\nper-layer profile (Fig. 9 analogue):")
    print(f"  {'layer':>5s} {'B_w-L':>6s} {'B_a':>4s} {'ratio':>6s}")
    for i, (bw, ba, r) in enumerate(zip(info["bw_lut"], info["ba"],
                                        info["ratios"])):
        print(f"  {i:5d} {bw:6d} {ba:4d} {r:6.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
