"""Serving launcher: batched prefill + greedy decode over synthetic
prompts, reporting per-phase latency and token throughput; optionally
the paper's hybrid quantization on every projection and the compiled
accelerator program served through decode sessions and the fleet.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b --layers 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen3-moe-235b-a22b --layers 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --layers 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --layers 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-2b
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --quantize --accel-devices 2 --accel-partition filter --fleet 2

The counterpart of ``repro.launch.serve``. Weights are random, made on
the device from ``--seed``; prompts come from ``SyntheticTokens`` with
the same seed, so they are the reference's. The LMs (llama3.2-1b,
qwen3-8b, gemma-7b, yi-34b, qwen2-vl-2b with its M-RoPE over text
positions, and qwen3-moe-235b-a22b and deepseek-v2-236b with their MoE
layers in plain torch) run every prefill attention as one
flash-attention kernel launch on the card (deepseek's MLA at key size
192 over value size 128; ``--device cpu`` runs the plain versions).
seamless-m4t-large-v2 (module ``encdec``) encodes :func:`encdec_frames`
(the stub audio frontend's 0.1 N(0, 1) frame embeddings, one per prompt
position) twice in its prefill and launches the kernel for every
encoder, decoder and cross attention, and in every decode step for each
layer's cross-attention; as in the reference its prefill leaves the
decoder's self cache empty. ``--smoke`` serves the smoke config on the
card too: its fp32 attentions (head sizes 8-32) run on the fp32 flash
kernel, the encoder-decoder's decode over its bf16 cross cache.
mamba2-780m (module ``ssm``) and jamba-v0.1-52b (module ``hybrid``)
launch no kernel of the port: jamba's prompt attention is the
full-softmax ``dense_attention`` below 8192 tokens, as in the
reference, so its ``--smoke`` runs on the card too. As in the
reference, their prefill scores the prompt and decode starts from the
empty state (and, for jamba, an empty KV cache). ``--layers N`` serves
the first N layers at the published widths: qwen3-moe-235b-a22b (467 GB
in bf16) and jamba-v0.1-52b (103 GB) take ``--layers 8`` on an 80 GB
card, deepseek-v2-236b (472 GB) ``--layers 6`` (its dense first layer
and 5 MoE layers; N must exceed the dense prefix). A hybrid's
``--layers`` must be a multiple of its 8-layer period; the
encoder-decoder, which fits whole, takes none. Prefill and decode times
go to ``obs.METRICS`` as ``serve.request.*``; each timed region ends in
``torch.cuda.synchronize()`` on the card.

``--quantize`` fake-quantizes every attention projection (the LM's
``HeteroQuantConfig``: ``--w-bits`` LUT columns at ``--ratio``, 8-bit
activations), then prints the accelerator program image for the
serving config (``N3HPROG1``, or an ``N3HBUND1`` bundle for
``--accel-devices`` > 1), the decode-step image, and a greedy decode
through a compiled session on ``--accel-backend`` (``cuda``: the
split-GEMM kernels; ``golden``: the contract-checking interpreter).
``--fleet N`` also serves the decode program through N golden thread
workers behind ``serve.fleet.FleetServer``. The compiled programs are
the registry arch's smoke config, as in the reference.

Accelerator program cache: serving hot paths that ship compiled ISA
programs to accelerator workers reuse serialized ``N3HPROG1`` /
``N3HBUND1`` images from an in-process LRU keyed by the full compile
key (arch, device, bits, ratio, opt level, seq len, partition plan)
instead of re-lowering the network per request —
:func:`compiled_program_image` is the single entry point.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import threading
import time

import torch

from repro_torch.configs import registry
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.kernels.flash_attention import kernel_route
from repro_torch.models.hybrid import PERIOD
from repro_torch.models.lm import HeteroQuantConfig
from repro_torch.obs import METRICS
from repro_torch.serve.engine import SERVED, greedy_token, make_cache, \
    make_decode_fn, make_prefill_fn


# ---------------------------------------------------------------------------
# Compiled-program LRU (serving-time N3HPROG1/N3HBUND1 reuse)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """Full compile identity of a servable accelerator program.

    ``mode="fixed"`` is the classic fixed-sequence program;
    ``mode="decode"`` is the decode-resident step program (weights
    resident across invocations, KV/state segments persistent), keyed
    additionally by ``batch`` and ``max_seq``.
    """
    arch: str
    device: str = "XC7Z020"
    bits_w: int = 4
    bits_a: int = 4
    ratio: float | None = None
    opt_level: int = 1
    seq_len: int = 64
    devices: int = 1
    partition: str | None = None
    mode: str = "fixed"
    batch: int = 1
    max_seq: int = 0


class ProgramCache:
    """Thread-safe LRU of compiled program images.

    Values are the serialized images (``N3HPROG1`` for single-device
    keys, ``N3HBUND1`` for multi-device plans) — deterministic and
    bit-exact, so they can be shipped to workers byte-for-byte. A miss
    lowers the network through ``repro_torch.compiler`` once; every
    further request under the same key is a dictionary hit.
    """

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._images: "collections.OrderedDict[ProgramKey, bytes]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: ProgramKey) -> bytes:
        with self._lock:
            image = self._images.get(key)
            if image is not None:
                self._images.move_to_end(key)
                self.hits += 1
                METRICS.incr("serve.program_cache.hit")
                return image
        t0 = time.time()
        image = self._compile(key)
        METRICS.observe("serve.program_cache.compile_ms",
                        (time.time() - t0) * 1e3)
        with self._lock:
            self.misses += 1
            METRICS.incr("serve.program_cache.miss")
            self._images[key] = image
            while len(self._images) > self.maxsize:
                self._images.popitem(last=False)
        return image

    @staticmethod
    def _compile(key: ProgramKey) -> bytes:
        from repro_torch.compiler import (asm, compile_decode_network,
                                          compile_network)
        if key.mode == "decode":
            prog = compile_decode_network(
                key.arch, batch=key.batch,
                max_seq=key.max_seq or key.seq_len, device=key.device,
                bits_w=key.bits_w, bits_a=key.bits_a, ratio=key.ratio,
                opt_level=key.opt_level, devices=key.devices,
                partition=key.partition)
        else:
            prog = compile_network(
                key.arch, device=key.device, bits_w=key.bits_w,
                bits_a=key.bits_a, ratio=key.ratio, seq_len=key.seq_len,
                opt_level=key.opt_level, devices=key.devices,
                partition=key.partition)
        if hasattr(prog, "devices"):
            return asm.to_bundle_binary(prog)
        return asm.to_binary(prog)

    def info(self) -> dict:
        with self._lock:
            return {"programs": len(self._images), "hits": self.hits,
                    "misses": self.misses, "maxsize": self.maxsize}

    def clear(self) -> None:
        with self._lock:
            self._images.clear()
            self.hits = self.misses = 0


#: process-wide cache; serving code and tests share it.
PROGRAM_CACHE = ProgramCache()


def compiled_program_image(key: ProgramKey) -> bytes:
    """Serialized accelerator program for ``key`` (LRU-cached)."""
    return PROGRAM_CACHE.get(key)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


#: the seed of the encoder-decoder's stub frames (the reference draws
#: them from ``jax.random.key(1)``, whatever ``--seed``)
FRAMES_SEED = 1


def encdec_frames(batch: int, seq: int, d_model: int,
                  device) -> torch.Tensor:
    """The stub audio frontend's frame embeddings for an encoder-decoder
    request: 0.1 N(0, 1) of shape [batch, seq, d_model] in fp32, drawn
    on ``device`` from a generator seeded with :data:`FRAMES_SEED`."""
    gen = torch.Generator(device=device).manual_seed(FRAMES_SEED)
    return 0.1 * torch.randn((batch, seq, d_model), generator=gen,
                             device=device)


def flash_heads(arch) -> tuple[int, int] | None:
    """The (key, value) head sizes of the flash launches that serving
    ``arch`` makes, None for a family that makes none (ssm; the hybrid,
    whose prompt attention is ``dense_attention``)."""
    cfg = arch.model
    if arch.module == "lm":
        return cfg.qk_dim, cfg.v_head_dim
    if arch.module == "encdec":
        return cfg.head_dim, cfg.head_dim
    return None


def model_depth(cfg) -> str:
    """Layers of a config as the launcher prints them: ``n_layers``, or
    encoder + decoder layers."""
    if hasattr(cfg, "n_enc_layers"):
        return f"{cfg.n_enc_layers}+{cfg.n_dec_layers}"
    return str(cfg.n_layers)


def main(argv=None) -> dict:
    """Serve one batch of requests; returns the tokens and timings."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--quantize", action="store_true",
                    help="enable the paper's hybrid quantization on all "
                         "projections (w: 4b LUT-path ratio 0.5, a: 8b)")
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--ratio", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None, metavar="N",
                    help="serve the first N layers of the config, at its "
                         "widths (a model whose published depth does not "
                         "fit the card)")
    ap.add_argument("--accel-devices", type=int, default=1,
                    help="accelerator count for the compiled ISA program "
                         "image shipped to workers (--quantize path)")
    ap.add_argument("--accel-partition", choices=("pipeline", "filter"),
                    default=None,
                    help="partition plan for --accel-devices > 1")
    ap.add_argument("--accel-backend", choices=("golden", "cuda"),
                    default="cuda",
                    help="executor backend for the compiled decode "
                         "session demo (--quantize path; it runs on "
                         "--device)")
    ap.add_argument("--accel-decode-tokens", type=int, default=4,
                    help="tokens to generate through the compiled "
                         "decode-resident session (--quantize path; "
                         "0 disables the session demo)")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="also serve through the distributed fleet: N "
                         "in-process golden workers behind the async "
                         "program server with continuous batching "
                         "(repro_torch.serve.fleet), on --device; fleet "
                         "request/worker counters land in the same "
                         "--metrics export")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="export the run's metrics registry (.json or "
                         ".csv) on exit")
    args = ap.parse_args(argv)

    arch = registry.get(args.arch)
    if args.quantize and arch.module != "lm":
        raise SystemExit("--quantize drives the lm family here; other "
                         "families quantize via HeteroLinear directly")
    if arch.module not in SERVED:
        print(f"error: {args.arch} is a {arch.module!r} arch; the port "
              f"serves the modules {SERVED}", file=sys.stderr)
        raise SystemExit(2)
    device = torch.device(args.device)
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke)
    heads = flash_heads(arch)
    if device.type == "cuda" and heads is not None:
        # a config whose head sizes or dtype no flash kernel takes fails
        # here, before anything is built (no fallback to plain attention)
        kernel_route(*heads, arch.model.param_dtype, needs_grad=False)
    if args.layers is not None:
        if arch.module == "encdec":
            print(f"error: --layers: {args.arch} is an encoder-decoder, "
                  f"served whole", file=sys.stderr)
            raise SystemExit(2)
        if not 0 < args.layers <= arch.model.n_layers:
            raise SystemExit(f"error: --layers must be in [1, "
                             f"{arch.model.n_layers}], got {args.layers}")
        if arch.module == "hybrid" and args.layers % PERIOD:
            print(f"error: --layers {args.layers}: a hybrid serves whole "
                  f"periods of {PERIOD} layers", file=sys.stderr)
            raise SystemExit(2)
        n_dense = getattr(arch.model, "n_dense_prefix", 0)
        if args.layers <= n_dense:
            print(f"error: --layers {args.layers}: the first {n_dense} "
                  f"layer(s) are the dense prefix; keep them and at least "
                  f"one more", file=sys.stderr)
            raise SystemExit(2)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=args.layers))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: CUDA is not available; pass --device cpu "
                         "to serve on the CPU")
    if args.quantize:
        arch = dataclasses.replace(
            arch, model=dataclasses.replace(
                arch.model, hetero_quant=HeteroQuantConfig(
                    w_bits_lut=args.w_bits, a_bits=8, ratio=args.ratio)))
    cfg = arch.model
    max_seq = args.prompt_len + args.new_tokens

    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = arch.model_module().init(cfg, gen)
        data = SyntheticTokens(cfg.vocab, args.batch, args.prompt_len,
                               seed=args.seed)
        prompts = data.next_batch()["tokens"].to(device)
        batch = {"tokens": prompts}
        if arch.module == "encdec":
            batch["frames"] = encdec_frames(args.batch, args.prompt_len,
                                            cfg.d_model, device)
        cache = make_cache(arch, args.batch, max_seq, cfg.param_dtype,
                           device)
        prefill_fn = make_prefill_fn(arch)
        decode_fn = make_decode_fn(arch)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, batch, cache)
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
    result = {"prompts": prompts.cpu(), "tokens": tokens,
              "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
              "decode_ms_per_step": t_decode * 1e3 / n_steps}
    if args.quantize:
        result.update(_accel(args, prompts.cpu(), max_seq, device))
    print(f"# arch={cfg.name} layers={model_depth(cfg)} "
          f"quantized={args.quantize} device={device}")
    print(f"prefill: {t_prefill * 1e3:8.1f} ms "
          f"({args.batch * args.prompt_len / max(t_prefill, 1e-9):.0f} "
          f"tok/s)")
    print(f"decode:  {t_decode * 1e3:8.1f} ms total, "
          f"{t_decode * 1e3 / n_steps:.1f} ms/step, "
          f"{total_new / max(t_decode, 1e-9):.0f} tok/s")
    print("sample tokens:", [int(t) for t in tokens[0, :16]])
    if args.fleet > 0:
        result["fleet_tokens"] = _fleet(args, device)
    if args.metrics:
        METRICS.save(args.metrics)
        print(f"# metrics written to {args.metrics}")
    return result


def _accel(args, prompts: torch.Tensor, max_seq: int,
           device: torch.device) -> dict:
    """The ``--quantize`` path's compiled programs: the deployable ISA
    image for this serving config, the decode-resident step image, and
    a live greedy decode through a compiled session on ``device``."""
    # the LRU means repeat requests under the same key ship the cached
    # image instead of re-lowering the network
    key = ProgramKey(
        arch=args.arch, bits_w=args.w_bits, bits_a=8,
        ratio=args.ratio, opt_level=1, seq_len=args.prompt_len,
        devices=args.accel_devices,
        partition=args.accel_partition)
    t0 = time.time()
    image = compiled_program_image(key)
    t_img = time.time() - t0
    print(f"# accel program {image[:8].decode()} "
          f"{len(image)} B in {t_img * 1e3:.1f} ms "
          f"(cache {PROGRAM_CACHE.info()})")
    # decode-resident step image for the same serving config (weights
    # resident, KV persistent) + a live session demo
    dkey = dataclasses.replace(
        key, mode="decode", batch=1,
        max_seq=min(max_seq, 16), bits_a=4)
    dimage = compiled_program_image(dkey)
    print(f"# accel decode program {dimage[:8].decode()} "
          f"{len(dimage)} B (batch={dkey.batch} "
          f"max_seq={dkey.max_seq})")
    out = {"accel_image": image, "accel_decode_image": dimage}
    if args.accel_decode_tokens > 0:
        from repro_torch.serve.engine import (greedy_generate_compiled,
                                              make_compiled_session)
        session = make_compiled_session(
            args.arch, backend=args.accel_backend, batch=1,
            max_seq=dkey.max_seq, bits_w=args.w_bits,
            seed=args.seed, torch_device=device)
        s0 = min(4, dkey.max_seq - args.accel_decode_tokens)
        t0 = time.time()
        toks = greedy_generate_compiled(
            session, prompts[:1, :s0], args.accel_decode_tokens)
        _sync(device)
        n_steps = s0 + args.accel_decode_tokens - 1
        t_sess = time.time() - t0
        warm = METRICS.snapshot()["gauges"].get(
            "serve.decode.warmup_cycles", 0)
        steady = METRICS.snapshot()["gauges"].get(
            "serve.decode.steady_cycles", 0)
        print(f"# accel decode session [{args.accel_backend}]: "
              f"{n_steps} steps in {t_sess * 1e3:.1f} ms "
              f"({n_steps / max(t_sess, 1e-9):.1f} tok/s host), "
              f"sim {warm:.0f} warm-up / {steady:.0f} steady "
              f"cycles/token, tokens "
              f"{list(map(int, toks[0, s0:]))}")
        out["accel_tokens"] = toks.cpu()
    return out


def _fleet(args, device: torch.device):
    """Distributed-fleet demo: the same decode-resident program, served
    by ``--fleet`` golden thread workers with continuous batching. Runs
    before the --metrics export so the serve.fleet.* request/worker
    counters land in the same registry file."""
    from repro_torch.serve.fleet import FleetServer
    workers = [(f"w{i}", "golden", "thread") for i in range(args.fleet)]
    n_req = 2 * args.fleet + 2
    t0 = time.time()
    with FleetServer(args.arch, workers, batch_slots=2, max_seq=8,
                     seed=args.seed, torch_device=str(device)) as fleet:
        rows = [f.result(600) for f in
                [fleet.submit([3, 11], 3) for _ in range(n_req)]]
    t_fleet = time.time() - t0
    print(f"# fleet[{args.fleet} workers]: {n_req} requests in "
          f"{t_fleet:.1f} s "
          f"({n_req / max(t_fleet, 1e-9):.2f} req/s), "
          f"{METRICS.counter('serve.fleet.steps')} fleet steps, "
          f"tokens {rows[0].tolist()}")
    return rows


if __name__ == "__main__":
    main()
