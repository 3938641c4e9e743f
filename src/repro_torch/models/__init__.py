"""Models, in PyTorch.

  layers  — shared blocks: ParamSpec machinery, RMSNorm and LayerNorm,
            RoPE and M-RoPE, the attention forms (prefill on the
            flash-attention kernel), the gated MLPs, the MoE layer, the
            int8 KV-cache quantizer
  lm      — decoder-only LM of the dense, MoE, MLA and VLM families
            (llama3.2-1b, qwen3-8b, gemma-7b, yi-34b, qwen3-moe-235b-a22b,
            deepseek-v2-236b, qwen2-vl-2b): forward, prefill and decode
  encdec  — the encoder-decoder (seamless-m4t-large-v2): encode,
            forward, the cross cache and decode
  ssm     — Mamba2 SSD (chunked state-space duality): forward and decode
  hybrid  — the Jamba hybrid (Mamba + attention 7:1, MoE every second
            layer): forward and decode
  cnn     — ResNet-18 / MobileNet-V2: the configs the compiler scales and
            the fp32 and QAT networks the accuracy harness trains
"""
