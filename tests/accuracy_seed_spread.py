"""Agreement of the reference harness and the port's across seeds.

Trains, folds, compiles and evaluates one reduced network per seed with
either package's ``measure`` on the CPU (256 samples, batch 64, 200
steps), on a fixed number of intra-op threads, and prints one JSON line
per seed: how far the harness's agreement spreads from seed to seed,
for the reference and the port alike. Not a test (pytest collects only
``test_*.py``)::

    PYTHONPATH=src python tests/accuracy_seed_spread.py --side jax \\
        --arch mobilenet_v2 --seeds 0-6 --threads 1
    PYTHONPATH=src python tests/accuracy_seed_spread.py --side torch \\
        --arch mobilenet_v2 --seeds 0-6 --threads 4

``--threads 1`` runs the JAX side's convolutions and products without
XLA's Eigen thread pool; any other count leaves XLA its default pool
(one thread per core) and is recorded as given.
"""
import argparse
import json
import os
import sys
import time


#: the operating point of the harness on the card (``chip_smoke.py``)
HARNESS = dict(n_samples=256, batch=64, train_steps=200)


def seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", choices=("jax", "torch"), required=True)
    ap.add_argument("--arch", default="mobilenet_v2",
                    choices=("resnet18", "mobilenet_v2"))
    ap.add_argument("--seeds", type=seeds, default=seeds("0-6"),
                    help="inclusive range, e.g. 0-6")
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)

    kw = dict(HARNESS, simulate=False)
    if args.side == "jax":
        if args.threads == 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_cpu_multi_thread_eigen=false").strip()
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from repro.eval.accuracy import measure
        kw["backend"] = "pallas"
    else:
        import torch
        torch.set_num_threads(args.threads)
        from repro_torch.eval.accuracy import measure
        kw.update(backend="cuda", torch_device="cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        rep = measure(args.arch, seed=seed, **kw)
        print(json.dumps({
            "side": args.side, "arch": args.arch, "seed": seed,
            "threads": args.threads, "n_samples": rep.n_samples,
            "agreement": rep.agreement, "top1_compiled": rep.top1_compiled,
            "top1_ref": rep.top1_ref,
            "s": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
