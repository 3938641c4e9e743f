"""Network frontends: named models → GEMM layer lists for the compiler.

Two sources:

  * the CNN workload zoo (``core/workloads.py``): resnet18 /
    mobilenet_v2, lowered via im2col exactly as the latency models see
    them;
  * the LM architecture registry (``configs/registry.py``): every
    registered arch's *smoke* config is walked block by block and each
    projection GEMM (attention q/k/v/o or MLA low-rank factors, MLP or
    MoE expert mats, SSM in/out projections) becomes one layer at a
    given sequence length.

The LM walk is family-aware but intentionally coarse — it captures the
per-block GEMM shapes (what the accelerator executes), not the
softmax/norm glue. MoE layers contribute the router, the ``top_k``
routed experts and any always-on shared experts (the compute that
actually runs per token).
"""
from __future__ import annotations

from repro_torch.core.scheduler import GemmDims
from repro_torch.core.workloads import WORKLOADS
from repro_torch.compiler.program import GemmLayer


def _gl(name: str, m: int, k: int, n: int) -> GemmLayer:
    return GemmLayer(name, GemmDims(m=m, k=k, n=max(int(n), 1)))


def _attn_layers(prefix: str, cfg, m: int) -> list[GemmLayer]:
    d = cfg.d_model
    mla = getattr(cfg, "mla", None)
    if mla is not None:
        hq = cfg.n_heads
        return [
            _gl(f"{prefix}.q_lora", m, d, mla.q_lora),
            _gl(f"{prefix}.q_proj", m, mla.q_lora,
                hq * (mla.qk_nope_dim + mla.qk_rope_dim)),
            _gl(f"{prefix}.kv_lora", m, d, mla.kv_lora + mla.qk_rope_dim),
            _gl(f"{prefix}.kv_proj", m, mla.kv_lora,
                hq * (mla.qk_nope_dim + mla.v_dim)),
            _gl(f"{prefix}.o", m, hq * mla.v_dim, d),
        ]
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    return [
        _gl(f"{prefix}.q", m, d, hq * hd),
        _gl(f"{prefix}.k", m, d, hkv * hd),
        _gl(f"{prefix}.v", m, d, hkv * hd),
        _gl(f"{prefix}.o", m, hq * hd, d),
    ]


def _mlp_layers(prefix: str, d: int, d_ff: int, m: int,
                moe=None) -> list[GemmLayer]:
    if moe is None:
        return [
            _gl(f"{prefix}.gate", m, d, d_ff),
            _gl(f"{prefix}.up", m, d, d_ff),
            _gl(f"{prefix}.down", m, d_ff, d),
        ]
    # router + the top_k routed experts + any always-on shared experts
    # (models/layers.py runs the shared block as one fused d_ff*n_shared
    # MLP on every token) — together, the compute that fires per token.
    out = [_gl(f"{prefix}.router", m, d, moe.n_experts)]
    for e in range(moe.top_k):
        out += [
            _gl(f"{prefix}.e{e}.gate", m, d, moe.d_ff),
            _gl(f"{prefix}.e{e}.up", m, d, moe.d_ff),
            _gl(f"{prefix}.e{e}.down", m, moe.d_ff, d),
        ]
    if getattr(moe, "n_shared", 0):
        ff = moe.d_ff * moe.n_shared
        out += [
            _gl(f"{prefix}.shared.gate", m, d, ff),
            _gl(f"{prefix}.shared.up", m, d, ff),
            _gl(f"{prefix}.shared.down", m, ff, d),
        ]
    return out


def _ssm_layers(prefix: str, d: int, ssm, m: int) -> list[GemmLayer]:
    n_heads = ssm.d_inner // ssm.head_dim
    return [
        _gl(f"{prefix}.in_zx", m, d, 2 * ssm.d_inner),
        _gl(f"{prefix}.in_bc", m, d, 2 * ssm.n_groups * ssm.d_state),
        _gl(f"{prefix}.in_dt", m, d, n_heads),
        _gl(f"{prefix}.out", m, ssm.d_inner, d),
    ]


def _lm_layers(cfg, m: int) -> list[GemmLayer]:
    """Decoder-only LM (dense or MoE, optional MLA)."""
    layers = []
    moe = getattr(cfg, "moe", None)
    n_dense = getattr(cfg, "n_dense_prefix", 0)
    for b in range(cfg.n_layers):
        layers += _attn_layers(f"b{b}.attn", cfg, m)
        block_moe = None if (moe is None or b < n_dense) else moe
        d_ff = cfg.d_ff if block_moe is None else moe.d_ff
        if block_moe is None and b < n_dense and cfg.d_ff_dense:
            d_ff = cfg.d_ff_dense
        layers += _mlp_layers(f"b{b}.mlp", cfg.d_model, d_ff, m,
                              moe=block_moe)
    layers.append(_gl("lm_head", m, cfg.d_model, cfg.padded_vocab))
    return layers


def _ssm_lm_layers(cfg, m: int) -> list[GemmLayer]:
    layers = []
    for b in range(cfg.n_layers):
        layers += _ssm_layers(f"b{b}.ssm", cfg.d_model, cfg.ssm, m)
    layers.append(_gl("lm_head", m, cfg.d_model, cfg.padded_vocab))
    return layers


def _encdec_layers(cfg, m: int) -> list[GemmLayer]:
    layers = []
    for b in range(cfg.n_enc_layers):
        layers += _attn_layers(f"enc{b}.attn", cfg, m)
        layers += _mlp_layers(f"enc{b}.mlp", cfg.d_model, cfg.d_ff, m)
    for b in range(cfg.n_dec_layers):
        layers += _attn_layers(f"dec{b}.self", cfg, m)
        layers += _attn_layers(f"dec{b}.cross", cfg, m)
        layers += _mlp_layers(f"dec{b}.mlp", cfg.d_model, cfg.d_ff, m)
    layers.append(_gl("lm_head", m, cfg.d_model, cfg.padded_vocab))
    return layers


def _hybrid_layers(cfg, m: int) -> list[GemmLayer]:
    """Jamba-style period: alternate attention/SSM mixers, MoE MLPs on
    odd blocks (coarse view of the published 1:7 attention:SSM period)."""
    layers = []
    for b in range(cfg.n_layers):
        if b % 2 == 0:
            layers += _ssm_layers(f"b{b}.ssm", cfg.d_model, cfg.ssm, m)
        else:
            layers += _attn_layers(f"b{b}.attn", cfg, m)
        moe = cfg.moe if b % 2 == 1 else None
        layers += _mlp_layers(f"b{b}.mlp", cfg.d_model, cfg.d_ff, m, moe=moe)
    layers.append(_gl("lm_head", m, cfg.d_model, cfg.padded_vocab))
    return layers


def lm_gemm_layers(cfg, seq_len: int = 64) -> list[GemmLayer]:
    """Per-block projection GEMMs of one model config at ``seq_len``."""
    if hasattr(cfg, "n_enc_layers"):
        return _encdec_layers(cfg, seq_len)
    if hasattr(cfg, "ssm") and hasattr(cfg, "n_heads"):
        return _hybrid_layers(cfg, seq_len)
    if hasattr(cfg, "ssm"):
        return _ssm_lm_layers(cfg, seq_len)
    return _lm_layers(cfg, seq_len)


def network_layers(name: str, seq_len: int = 64, smoke: bool = True,
                   in_hw: int | None = None,
                   width: float | None = None) -> list[GemmLayer]:
    """GEMM layer list for a named network.

    ``name`` is a CNN workload (``resnet18``/``mobilenet_v2``) or any
    registered arch id; registry archs use their smoke config unless
    ``smoke=False``. CNNs accept ``in_hw``/``width`` to compile the
    geometry-consistent reduced variants of ``models/cnn.py``
    (``specs_for`` propagates spatial sizes through the layer graph,
    so the scaled programs still chain end to end).
    """
    if name in WORKLOADS:
        if in_hw is not None or width is not None:
            from repro_torch.models.cnn import CNNConfig, specs_for
            cfg = CNNConfig(arch=name, in_hw=in_hw or 224,
                            width=width if width is not None else 1.0)
            specs = specs_for(cfg)
        else:
            specs = WORKLOADS[name]()
        return [GemmLayer.from_conv(s) for s in specs]
    from repro_torch.configs import registry
    arch = registry.get(name)
    cfg = arch.smoke if (smoke and arch.smoke is not None) else arch.model
    return lm_gemm_layers(cfg, seq_len)


def decode_step_layers(name: str, batch: int = 1, max_seq: int = 64,
                       smoke: bool = True):
    """(layers, StepSpec) for one autoregressive decode step.

    The layer list is the ordinary GEMM walk at ``m = batch`` (one
    token per sequence); the :class:`~repro.compiler.program.StepSpec`
    carries the glue geometry (family, attention heads, cache depth)
    that ``lower_network(step=...)`` needs to decorate the program with
    weight residency and KV-cache/state segments.
    """
    from repro_torch.configs import registry
    from repro_torch.compiler.program import StepSpec
    if name in WORKLOADS:
        raise ValueError(f"{name}: CNN workloads have no decode mode")
    arch = registry.get(name)
    if arch.module not in ("lm", "ssm", "hybrid"):
        raise ValueError(
            f"{name}: decode mode supports lm/ssm/hybrid archs, "
            f"not {arch.module}")
    cfg = arch.smoke if (smoke and arch.smoke is not None) else arch.model
    if getattr(cfg, "mla", None) is not None:
        raise ValueError(f"{name}: decode mode does not model MLA "
                         f"latent caches")
    has_attn = hasattr(cfg, "n_heads")
    spec = StepSpec(
        family=arch.module, batch=batch, max_seq=max_seq,
        d_model=cfg.d_model,
        n_heads=cfg.n_heads if has_attn else 0,
        n_kv_heads=cfg.n_kv_heads if has_attn else 0,
        head_dim=cfg.head_dim if has_attn else 0)
    return lm_gemm_layers(cfg, batch), spec


def list_networks() -> list[str]:
    from repro_torch.configs import registry
    return sorted(WORKLOADS) + registry.list_archs()
