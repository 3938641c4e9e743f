"""PyTorch/CUDA port of the N3H-Core reproduction.

Mirrors the layout of the JAX package ``repro``: ``repro_torch.X`` is
the counterpart of ``repro.X``. It imports torch and numpy, never JAX
and nothing of ``repro``; the pure-Python modules it needs are copies,
held to their originals by ``tests/test_torch_compiler.py``.

  core      — unified ISA, event-driven scheduler, workloads, split solver
  models    — CNN configurations (resnet18 / mobilenet_v2 specs)
  compiler  — lowering to ISA programs, passes, CLI, executor backends
  kernels   — split-GEMM CUDA kernels for Hopper and their plain versions
  quant     — uniform symmetric quantizer
  obs       — tracer, counters, metrics

Entry points run on ``torch.device("cuda")`` unless the caller passes
another device, and raise when CUDA is absent.
"""
