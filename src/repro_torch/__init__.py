"""PyTorch/CUDA port of the N3H-Core reproduction.

Mirrors the layout of the JAX package ``repro``: ``repro_torch.X`` is
the counterpart of ``repro.X``. It imports torch and numpy, never JAX
and nothing of ``repro``; the pure-Python modules it needs are copies,
held to their originals by ``tests/test_torch_compiler.py``.

  core      — unified ISA, event-driven scheduler, workloads, split solver,
              resource and chip cost models, the deployable HeteroLinear
  models    — CNN configurations (resnet18 / mobilenet_v2 specs); the
              dense decoder-only LM (``layers``, ``lm``)
  configs   — architecture registry (llama3.2-1b)
  compiler  — lowering to ISA programs, passes, CLI, executor backends
  kernels   — split-GEMM and flash-attention CUDA kernels for Hopper and
              their plain versions
  data      — seeded synthetic token batches
  serve     — prefill / decode factories and greedy generation
  launch    — the serving launcher (``python -m repro_torch.launch.serve``)
  quant     — uniform symmetric quantizer, filter-wise hybrid
              quantization, the straight-through fake quantizers
  dse       — the DDPG design-space search (``python -m repro_torch.dse``)
  obs       — tracer, counters, metrics

Entry points run on ``torch.device("cuda")`` unless the caller passes
another device, and raise when CUDA is absent.
"""
