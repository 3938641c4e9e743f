"""Serving launcher: batched prefill + greedy decode over synthetic
prompts, reporting per-phase latency and token throughput.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu

The counterpart of ``repro.launch.serve``. Weights are random, made on
the device from ``--seed``; prompts come from ``SyntheticTokens`` with
the same seed, so they are the reference's. Every prefill attention is
one flash-attention kernel launch on the card (``--device cpu`` runs
the plain versions; ``--smoke`` takes ``--device cpu``, since the
flash kernel is not built for the smoke config's head size and fp32
params). Prefill and decode times go to ``obs.METRICS`` as
``serve.request.*``; each timed region ends in
``torch.cuda.synchronize()`` on the card. Archs whose module is not
``lm`` (mamba2-780m, jamba-v0.1-52b) are refused with exit code 2: the
port has their configs but not their forwards yet. The reference's
``--quantize``, ``--fleet`` and ``--accel-*`` options come with later
slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import registry
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.obs import METRICS
from repro_torch.serve.engine import greedy_token, make_cache, \
    make_decode_fn, make_prefill_fn


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Serve one batch of requests; returns the tokens and timings."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="export the run's metrics registry (.json or "
                         ".csv) on exit")
    args = ap.parse_args(argv)

    arch = registry.get(args.arch)
    if arch.module != "lm":
        # the registry has this arch's config (the compiler and the
        # decode sessions read it) but the port has no forward for it
        print(f"error: {args.arch} is a {arch.module!r} arch; the port "
              f"has its config only (compile and decode it through a "
              f"session with python -m repro_torch.compiler {args.arch} "
              f"--decode --execute); its forward comes with ROADMAP queue "
              f"1, item 7 (the other model families)", file=sys.stderr)
        raise SystemExit(2)
    device = torch.device(args.device)
    if args.smoke and device.type == "cuda":
        # no silent fallback to plain attention: the flash kernel is
        # built for head sizes 64 and 128 in bf16 only
        print("error: --smoke serves the smoke config (head_dim 16, fp32 "
              "params), which the flash-attention kernel is not "
              "instantiated for; the smoke run takes --device cpu",
              file=sys.stderr)
        raise SystemExit(2)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available; pass --device cpu "
                         "to serve on the CPU")
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke)
    cfg = arch.model
    max_seq = args.prompt_len + args.new_tokens

    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = arch.model_module().init(cfg, gen)
        data = SyntheticTokens(cfg.vocab, args.batch, args.prompt_len,
                               seed=args.seed)
        prompts = data.next_batch()["tokens"].to(device)
        cache = make_cache(arch, args.batch, max_seq, cfg.param_dtype,
                           device)
        prefill_fn = make_prefill_fn(arch)
        decode_fn = make_decode_fn(arch)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, {"tokens": prompts}, cache)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        METRICS.observe("serve.request.prefill_ms", t_prefill * 1e3)

        tok = greedy_token(logits[:, -1])
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.new_tokens - 1):
            logits, cache = decode_fn(params, tok, cache,
                                      args.prompt_len + i)
            tok = greedy_token(logits)
            out.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
    n_steps = max(args.new_tokens - 1, 1)
    METRICS.observe("serve.request.decode_ms", t_decode * 1e3)
    METRICS.observe("serve.request.decode_ms_per_step",
                    t_decode * 1e3 / n_steps)
    total_new = args.batch * args.new_tokens
    METRICS.gauge("serve.request.decode_tok_per_s",
                  total_new / max(t_decode, 1e-9))

    tokens = torch.cat(out, dim=1).cpu()
    print(f"# arch={cfg.name} device={device}")
    print(f"prefill: {t_prefill * 1e3:8.1f} ms "
          f"({args.batch * args.prompt_len / max(t_prefill, 1e-9):.0f} "
          f"tok/s)")
    print(f"decode:  {t_decode * 1e3:8.1f} ms total, "
          f"{t_decode * 1e3 / n_steps:.1f} ms/step, "
          f"{total_new / max(t_decode, 1e-9):.0f} tok/s")
    print("sample tokens:", [int(t) for t in tokens[0, :16]])
    if args.metrics:
        METRICS.save(args.metrics)
        print(f"# metrics written to {args.metrics}")
    return {"prompts": prompts.cpu(), "tokens": tokens,
            "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
            "decode_ms_per_step": t_decode * 1e3 / n_steps}


if __name__ == "__main__":
    main()
