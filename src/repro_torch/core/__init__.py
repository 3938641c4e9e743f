"""Heterogeneous-core GEMM co-design: the pieces the compiler needs.

  isa            — the unified 128-bit instruction set (§3.1)
  scheduler      — instruction streams + event-driven pipeline sim (Fig. 3)
  latency_model  — closed-form + simulated latency (Eqs. 6-10)
  split          — neuron-based workload split solver (Eqs. 11-12)
  workloads      — im2col GEMM lowering of ResNet-18 / MobileNet-V2

Copies of the same modules of ``repro.core``, imports rewritten.
"""
