"""PyTorch/CUDA port of the N3H-Core reproduction.

Mirrors the layout of the JAX package ``repro``: ``repro_torch.X`` is
the counterpart of ``repro.X``. It imports torch and numpy, never JAX
and nothing of ``repro``; the pure-Python modules it needs are copies,
held to their originals by ``tests/test_torch_compiler.py``.

  core      — unified ISA, event-driven scheduler, workloads, split solver,
              resource and chip cost models, the deployable HeteroLinear
  models    — CNN configurations (resnet18 / mobilenet_v2 specs); the
              dense and MoE decoder-only LM (``layers``, ``lm``), Mamba2
              (``ssm``) and the Jamba hybrid (``hybrid``)
  configs   — architecture registry (llama3.2-1b, qwen3-8b, gemma-7b,
              yi-34b, qwen3-moe-235b-a22b, mamba2-780m, jamba-v0.1-52b)
  compiler  — lowering to ISA programs, passes, CLI, executor backends
  kernels   — split-GEMM, depthwise and flash-attention CUDA kernels for
              Hopper and their plain versions
  data      — seeded synthetic token batches
  serve     — prefill / decode factories and greedy generation
  train     — AdamW, the loss and the train-step factory
  checkpoint — checkpoints in the reference's format, the step watchdog
  parallel  — sharding rule tables, int8 gradient compression
  launch    — the serving and training launchers (``python -m
              repro_torch.launch.serve`` / ``.train``)
  quant     — uniform symmetric quantizer, filter-wise hybrid
              quantization, the straight-through fake quantizers
  dse       — the DDPG design-space search (``python -m repro_torch.dse``)
  obs       — tracer, counters, metrics, profile report

Entry points run on ``torch.device("cuda")`` unless the caller passes
another device, and raise when CUDA is absent.
"""
