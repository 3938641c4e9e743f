"""DNN workload descriptions for the cost/latency models.

Each parametric layer (conv / depthwise-conv / fully-connected) is
lowered to GEMM dimensions via im2col (§3.2.1): the computation of one
layer is ``out[M_g, N_g] = act[M_g, K_g] @ wgt[K_g, N_g]`` with

    M_g = OH * OW (batch 1),  K_g = C_in * kh * kw,  N_g = C_out.

Depthwise layers have no input-channel reuse: each output channel is an
independent (OH*OW, kh*kw) x (kh*kw, 1) GEMM, which both cores execute
with only one active output column — this is what makes the LUT-core
"not efficient to compute depth-wise layers" (§6.2.2) and the model
reproduces it structurally.

Workload zoo: ResNet-18 and MobileNet-V2 at 224x224 (the paper's two
evaluation networks) plus helpers to derive layer lists for the LM
architectures (used by the TPU-side cost model).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler import GemmDims


def pooled_hw(out_hw: int, pool: str) -> int:
    """Feature-map size after a layer's pooling glue — the single
    shape rule shared by ``ConvSpec``, the compiler's ``ConvGeometry``
    and the executors' ``apply_pool`` data transform. ``"max"`` is the
    ResNet stem's 3x3 stride-2 SAME max pool; ``"gap"`` the global
    average pool; ``""`` the identity."""
    if pool == "max":
        return (out_hw + 1) // 2
    if pool == "gap":
        return 1
    return out_hw


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One parametric layer. ``depthwise`` implies groups == c_in == c_out."""
    name: str
    c_in: int
    c_out: int
    kernel: int
    stride: int
    in_hw: int                  # square input feature map size
    depthwise: bool = False
    is_first: bool = False
    is_last: bool = False
    shortcut: bool = False      # 1x1 downsample projection (ResNet)
    # Spatial glue applied to this layer's *output* before the next
    # layer reads it: "" (none), "max" (3x3 stride-2 SAME max pool, the
    # ResNet stem) or "gap" (global average pool before the classifier).
    pool: str = ""
    # Elementwise tail the layer applies to its own output: activation
    # kind ("", "relu", "relu6", "hswish") and, for residual layers,
    # the distance back to the add operand's producer (0 = no residual;
    # ResNet conv_b adds 2 back, MobileNet pw adds 3 back). These lower
    # into the program's fused elementwise stage.
    act: str = ""
    res_src: int = 0

    @property
    def out_hw(self) -> int:
        if self.kernel == 1 and self.in_hw == 1:
            return 1
        pad = self.kernel // 2
        return (self.in_hw + 2 * pad - self.kernel) // self.stride + 1

    @property
    def pooled_out_hw(self) -> int:
        """Feature-map size the *next* layer reads (after ``pool``)."""
        return pooled_hw(self.out_hw, self.pool)

    def gemm(self) -> GemmDims:
        m = self.out_hw * self.out_hw
        if self.depthwise:
            return GemmDims(m=m, k=self.kernel * self.kernel, n=self.c_out)
        return GemmDims(m=m, k=self.c_in * self.kernel * self.kernel, n=self.c_out)

    def macs(self) -> int:
        g = self.gemm()
        if self.depthwise:
            return g.m * g.k * g.n  # each column only sees its own k*k
        return g.macs()

    @property
    def n_params(self) -> int:
        if self.depthwise:
            return self.c_out * self.kernel * self.kernel
        return self.c_in * self.c_out * self.kernel * self.kernel


def resnet18_specs() -> list[ConvSpec]:
    """ResNet-18 @224. Layer indices match the paper's Fig. 9/10 numbering
    (downsample projections land at layers 8, 13, 18)."""
    specs: list[ConvSpec] = [
        ConvSpec("conv1", 3, 64, 7, 2, 224, is_first=True, pool="max",
                 act="relu"),
    ]

    def block(idx, c_in, c_out, stride, hw, ds=False):
        # conv_a applies relu; conv_b carries the residual add + relu,
        # unless a downsample projection follows the block — then the
        # projection carries them (relu(conv_b + ds(x))) and conv_b
        # writes its raw pre-activation output.
        out = [
            ConvSpec(f"conv{idx}", c_in, c_out, 3, stride, hw, act="relu"),
            ConvSpec(f"conv{idx+1}", c_out, c_out, 3, 1, hw // stride,
                     act="" if ds else "relu", res_src=0 if ds else 2),
        ]
        return out

    # layer1: 56x56, 64ch
    specs += block(2, 64, 64, 1, 56)
    specs += block(4, 64, 64, 1, 56)
    # layer2: 64 -> 128, stride 2; downsample at index 8
    specs += block(6, 64, 128, 2, 56, ds=True)
    specs.append(ConvSpec("conv8_ds", 64, 128, 1, 2, 56, shortcut=True,
                          act="relu", res_src=1))
    specs += block(9, 128, 128, 1, 28)
    # layer3: 128 -> 256; downsample at index 13
    specs += block(11, 128, 256, 2, 28, ds=True)
    specs.append(ConvSpec("conv13_ds", 128, 256, 1, 2, 28, shortcut=True,
                          act="relu", res_src=1))
    specs += block(14, 256, 256, 1, 14)
    # layer4: 256 -> 512; downsample at index 18
    specs += block(16, 256, 512, 2, 14, ds=True)
    specs.append(ConvSpec("conv18_ds", 256, 512, 1, 2, 14, shortcut=True,
                          act="relu", res_src=1))
    specs += block(19, 512, 512, 1, 7)
    # global average pool feeds the classifier, a 1x1 "conv" on a 1x1 map
    specs[-1] = dataclasses.replace(specs[-1], pool="gap")
    specs.append(ConvSpec("fc", 512, 1000, 1, 1, 1, is_last=True))
    return specs


def mobilenet_v2_specs() -> list[ConvSpec]:
    """MobileNet-V2 @224 (width 1.0): 52 convs + classifier."""
    specs: list[ConvSpec] = [ConvSpec("conv0", 3, 32, 3, 2, 224,
                                      is_first=True, act="relu")]
    hw = 112

    # t=1 bottleneck
    specs.append(ConvSpec("b0_dw", 32, 32, 3, 1, hw, depthwise=True,
                          act="relu6"))
    specs.append(ConvSpec("b0_pw", 32, 16, 1, 1, hw))

    cfg = [  # (expansion t, c_out, repeats, stride)
        (6, 24, 2, 2),
        (6, 32, 3, 2),
        (6, 64, 4, 2),
        (6, 96, 3, 1),
        (6, 160, 3, 2),
        (6, 320, 1, 1),
    ]
    c_in = 16
    bi = 1
    for t, c, n, s in cfg:
        for r in range(n):
            stride = s if r == 0 else 1
            hidden = c_in * t
            specs.append(ConvSpec(f"b{bi}_exp", c_in, hidden, 1, 1, hw,
                                  act="relu"))
            specs.append(ConvSpec(f"b{bi}_dw", hidden, hidden, 3, stride, hw,
                                  depthwise=True, act="relu6"))
            hw = hw // stride
            # Linear bottleneck: no activation after the projection; the
            # inverted residual adds the block input (3 layers back) on
            # the repeats where stride == 1 and channels match.
            specs.append(ConvSpec(f"b{bi}_pw", hidden, c, 1, 1, hw,
                                  res_src=3 if r > 0 else 0))
            c_in = c
            bi += 1

    specs.append(ConvSpec("conv_last", 320, 1280, 1, 1, hw, pool="gap",
                          act="relu"))
    specs.append(ConvSpec("fc", 1280, 1000, 1, 1, 1, is_last=True))
    return specs


WORKLOADS = {
    "resnet18": resnet18_specs,
    "mobilenet_v2": mobilenet_v2_specs,
}


def total_macs(specs: list[ConvSpec]) -> int:
    return sum(s.macs() for s in specs)


def total_gops(specs: list[ConvSpec]) -> float:
    """GOPs counting one MAC as 2 ops (the convention of Table 4)."""
    return 2.0 * total_macs(specs) / 1e9


def split_gemm(spec: ConvSpec, n_lut: int) -> tuple[GemmDims, GemmDims]:
    """Partition a layer's GEMM along output filters (Eq. 11): the first
    ``n_lut`` filters to the LUT-core, the rest to the DSP-core."""
    g = spec.gemm()
    n_lut = int(min(max(n_lut, 0), g.n))
    lut = GemmDims(m=g.m, k=g.k, n=n_lut)
    dsp = GemmDims(m=g.m, k=g.k, n=g.n - n_lut)
    return lut, dsp
