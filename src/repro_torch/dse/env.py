"""The paper's RL environment (§5.4) — and its TPU-adapted variant.

Episode = 6 hardware actions (Eq. 13: K, M, N, D_L,buf^a, D_D,buf^a,
D_D,buf^w) followed by 2N software actions (Eq. 14: per-layer B^{w-L}
then B^a). State = Eq. 17, every dimension normalized to [0, 1].
Reward = Eq. 18 at episode end, zero elsewhere (the paper's sparse
terminal reward):

    R = (L_t - L_m)/L_t - 1            if L_m > L_t   (in (-inf, -1])
    R = (acc_q - acc_b) * lambda       otherwise

Accuracy term: the paper retrains the quantized DNN for one epoch on
(sub-sampled) ImageNet. Offline we use a calibrated quantization-noise
surrogate (``AccuracyProxy``): per-layer accuracy damage proportional
to the quantization MSE ~ 4^-bits, weighted by parameter share and the
filter-wise LUT/DSP mix of §4. The surrogate is monotone in every
bit-width, which is the property the search needs; the reduced-CNN QAT
benchmark cross-checks its ranking on synthetic data.

Feasibility: hardware actions are projected onto the device's LUT/BRAM
budget (Eqs. 3-5) — shrink M, N, then buffer depths, until it fits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.cost_model import max_lut_core_mn, system_cost
from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    LutCoreConfig,
    XC7Z020,
)
from repro_torch.core.split import solve_split
from repro_torch.core.workloads import ConvSpec
from repro_torch.core.tpu_cost import TPUChip, H100_SXM


# ---------------------------------------------------------------------------
# Accuracy surrogate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccuracyProxy:
    """acc_q = acc_b - kappa * sum_i share_i * (mse_w_i + mse_a_i).

    mse_w mixes the two cores filter-wise: ratio at B^{w-L} bits, rest at
    int4 (§4). kappa calibrated so uniform 4/4 costs ~0.3-0.5 points (the
    paper's manual 4/4 ResNet-18 loses 0.11, MobileNet-V2 loses ~6.7 —
    we sit in between; the *ordering* across configs is what matters).
    """
    baseline_acc: float = 69.76
    kappa: float = 1.0          # 4/4 uniform ResNet-18 -> ~0.5pt drop
    dw_sensitivity: float = 8.0  # depthwise layers are quant-hostile
                                 # (the paper's MobileNet drops 6.7pt)

    def evaluate(self, specs: Sequence[ConvSpec], bw_lut: Sequence[int],
                 ba: Sequence[int], ratios: Sequence[float]) -> float:
        total = sum(s.n_params for s in specs)
        drop = 0.0
        for s, bw, a, r in zip(specs, bw_lut, ba, ratios):
            share = s.n_params / total
            if s.depthwise:
                share *= self.dw_sensitivity
            if s.is_first or s.is_last:
                bw_eff_mse = 4.0 ** -8
                a_mse = 4.0 ** -8
            else:
                bw_eff_mse = r * 4.0 ** -bw + (1 - r) * 4.0 ** -4
                a_mse = 4.0 ** -a
            drop += share * (bw_eff_mse + a_mse)
        return self.baseline_acc - self.kappa * drop * 100.0


# ---------------------------------------------------------------------------
# Reward shaping (Eq. 18) — shared by both environments and the
# simulator-in-the-loop elite re-scoring (dse/evaluator.py)
# ---------------------------------------------------------------------------


def shaped_reward(latency_ms: float, target_latency_ms: float, acc: float,
                  baseline_acc: float, reward_lambda: float) -> float:
    """Eq. 18: latency-infeasible configs score ``<= -1`` proportionally
    to the violation; feasible configs score the accuracy delta scaled
    by lambda. One definition, three consumers: ``N3HEnv``,
    ``TpuHeteroEnv`` and ``ProgramEvaluator`` (which re-applies it with
    the *simulated* latency of the compiled program)."""
    if latency_ms > target_latency_ms:
        return (target_latency_ms - latency_ms) / target_latency_ms - 1.0
    return (acc - baseline_acc) * reward_lambda


# ---------------------------------------------------------------------------
# Design-factor ranges (Table 2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FactorRanges:
    k_v: tuple[int, int]            # K = 64 * v
    mn: tuple[int, int]             # M, N
    d_l_a_v: tuple[int, int]        # D_L,buf^a = 1024 * v
    d_d_a_v: tuple[int, int]        # D_D,buf^a = 1024 * v
    d_d_w_v: tuple[int, int]        # D_D,buf^w = 1024 * v
    bw: tuple[int, int] = (2, 8)
    ba: tuple[int, int] = (2, 4)


RANGES = {
    "XC7Z020": FactorRanges(k_v=(1, 4), mn=(1, 50), d_l_a_v=(1, 50),
                            d_d_a_v=(1, 25), d_d_w_v=(1, 4)),
    "XC7Z045": FactorRanges(k_v=(1, 8), mn=(1, 252), d_l_a_v=(1, 252),
                            d_d_a_v=(1, 126), d_d_w_v=(1, 16)),
}


def _discretize(a: float, lo: int, hi: int) -> int:
    """Eq. 13/14: round(a * (hi - lo) + lo)."""
    return int(round(float(np.clip(a, 0.0, 1.0)) * (hi - lo) + lo))


# ---------------------------------------------------------------------------
# FPGA environment (paper-faithful)
# ---------------------------------------------------------------------------


STATE_DIM = 12  # Eq. 17


@dataclasses.dataclass(frozen=True)
class N3HEnvConfig:
    device: FPGADevice = XC7Z020
    target_latency_ms: float = 35.0
    reward_lambda: float = 0.01     # paper's lambda
    proxy: AccuracyProxy = AccuracyProxy()


class N3HEnv:
    """Sequential-decision wrapper over the cost/latency models."""

    def __init__(self, specs: Sequence[ConvSpec], cfg: N3HEnvConfig):
        self.specs = list(specs)
        self.cfg = cfg
        self.ranges = RANGES[cfg.device.name]
        self.n_layers = len(self.specs)
        self.episode_len = 6 + 2 * self.n_layers
        self._max_params = max(s.n_params for s in self.specs)
        self.reset()

    # -- episode bookkeeping ------------------------------------------------

    def reset(self) -> np.ndarray:
        self.t = 0
        self.hw: dict[str, int] = {}
        self.bw_lut: list[int] = []
        self.ba: list[int] = []
        self.last_action = 0.0
        return self._state()

    def _state(self) -> np.ndarray:
        """Eq. 17, normalized."""
        s = np.zeros(STATE_DIM, np.float32)
        if self.t < 6:
            s[0] = 0.0                                   # id_func
            s[11] = self.last_action
            s[1] = self.t / 6.0
            return s
        qt = self.t - 6
        i = min(qt // 2, self.n_layers - 1)
        spec = self.specs[i]
        s[0] = 1.0
        s[1] = i / max(self.n_layers - 1, 1)
        s[2] = spec.c_in / 2048.0
        s[3] = spec.c_out / 2048.0
        s[4] = spec.kernel / 7.0
        s[5] = spec.stride / 2.0
        s[6] = spec.in_hw / 224.0
        s[7] = spec.n_params / self._max_params
        s[8] = 1.0 if (spec.shortcut or spec.depthwise) else 0.0
        s[9] = float(qt % 2)                             # id_m/n
        s[10] = 0.0                                      # ratio (filled at end)
        s[11] = self.last_action
        return s

    # -- dynamics -----------------------------------------------------------

    def step(self, action: float) -> tuple[np.ndarray, float, bool, dict]:
        a = float(np.clip(action, 0.0, 1.0))
        self.last_action = a
        r = self.ranges
        if self.t == 0:
            self.hw["k"] = 64 * _discretize(a, *r.k_v)
        elif self.t == 1:
            self.hw["m"] = _discretize(a, *r.mn)
        elif self.t == 2:
            self.hw["n"] = _discretize(a, *r.mn)
        elif self.t == 3:
            self.hw["d_l_a"] = 1024 * _discretize(a, *r.d_l_a_v)
        elif self.t == 4:
            self.hw["d_d_a"] = 1024 * _discretize(a, *r.d_d_a_v)
        elif self.t == 5:
            self.hw["d_d_w"] = 1024 * _discretize(a, *r.d_d_w_v)
        else:
            qt = self.t - 6
            if qt % 2 == 0:
                self.bw_lut.append(_discretize(a, *r.bw))
            else:
                self.ba.append(_discretize(a, *r.ba))
        self.t += 1
        done = self.t >= self.episode_len
        if not done:
            return self._state(), 0.0, False, {}
        reward, info = self._evaluate()
        return self._state(), reward, True, info

    # -- terminal evaluation --------------------------------------------------

    def _project_feasible(self) -> tuple[LutCoreConfig, DspCoreConfig]:
        dev = self.cfg.device
        k = self.hw["k"]
        m, n = self.hw["m"], self.hw["n"]
        cap = max_lut_core_mn(dev, k)
        while m * n > cap and (m > 1 or n > 1):
            if m >= n:
                m = max(1, m - 1)
            else:
                n = max(1, n - 1)
        d_l_a, d_d_a, d_d_w = (self.hw["d_l_a"], self.hw["d_d_a"],
                               self.hw["d_d_w"])
        while True:
            lut_cfg = LutCoreConfig(m=m, n=n, k=k, d_a=d_l_a)
            dsp_cfg = DspCoreConfig(
                n_reg_row_a=DspCoreConfig.rows_for_device(dev),
                d_a=d_d_a, d_w=d_d_w)
            rep = system_cost(lut_cfg, dsp_cfg, dev)
            if rep.fits(dev):
                return lut_cfg, dsp_cfg
            # shrink the largest memory consumer first
            if d_d_a > 1024:
                d_d_a -= 1024
            elif d_l_a > 1024:
                d_l_a -= 1024
            elif d_d_w > 1024:
                d_d_w -= 1024
            elif m * n > 1:
                if m >= n:
                    m = max(1, m - 1)
                else:
                    n = max(1, n - 1)
            else:
                return lut_cfg, dsp_cfg    # smallest possible; accept

    def _evaluate(self) -> tuple[float, dict]:
        cfg = self.cfg
        lut_cfg, dsp_cfg = self._project_feasible()
        # first/last layers: 8-bit (paper §4); env actions cover the rest
        bw = list(self.bw_lut)
        ba = list(self.ba)
        for i, s in enumerate(self.specs):
            if s.is_first or s.is_last:
                bw[i] = 8
                ba[i] = 8
        return evaluate_config(self.specs, lut_cfg, dsp_cfg, cfg.device,
                               bw, ba, cfg.proxy, cfg.target_latency_ms,
                               cfg.reward_lambda)


def evaluate_config(specs: Sequence[ConvSpec], lut_cfg: LutCoreConfig,
                    dsp_cfg: DspCoreConfig, device: FPGADevice,
                    bw: Sequence[int], ba: Sequence[int],
                    proxy: AccuracyProxy, target_latency_ms: float,
                    reward_lambda: float) -> tuple[float, dict]:
    """Analytical (closed-form) scoring of one *complete* configuration.

    The terminal-evaluation half of :class:`N3HEnv` factored out so the
    benchmarks and the simulator-in-the-loop evaluator
    (``dse/evaluator.py``) can score a hand-built config without
    driving an episode. The returned ``info`` dict is the full config
    artifact the compiler needs to reproduce the design point:
    core knobs (``lut_cfg``/``dsp_cfg``), per-layer bit-widths
    (``bw_lut``/``ba``) and the exact Eq.-12 neuron splits
    (``n_luts``, with ``ratios`` as the derived fractions).
    ``reward_source`` tags which latency model priced the reward —
    ``"analytical"`` here; ``ProgramEvaluator`` re-tags corrected
    copies as ``"simulated"``.
    """
    cycles = 0.0
    ratios: list[float] = []
    n_luts: list[int] = []
    for spec, bwi, bai in zip(specs, bw, ba):
        sol = solve_split(spec, lut_cfg, dsp_cfg, device, bwi, bai)
        ratios.append(sol.ratio)
        n_luts.append(sol.n_lut)
        cycles += sol.cycles
    latency_ms = device.cycles_to_ms(cycles)
    acc = proxy.evaluate(specs, bw, ba, ratios)
    reward = shaped_reward(latency_ms, target_latency_ms, acc,
                           proxy.baseline_acc, reward_lambda)
    info = {
        "latency_ms": latency_ms,
        "acc": acc,
        "lut_cfg": lut_cfg,
        "dsp_cfg": dsp_cfg,
        "bw_lut": list(bw),
        "ba": list(ba),
        "ratios": ratios,
        "n_luts": n_luts,
        "reward_source": "analytical",
    }
    return float(reward), info


# ---------------------------------------------------------------------------
# TPU-adapted environment (hardware-adaptation of the framework)
# ---------------------------------------------------------------------------


class TpuHeteroEnv:
    """Same agent, TPU cost model: per-layer actions pick {B^{w-L}, B^a};
    the split ratio is solved per layer against the chip's roofline (the
    Eq. 12 analogue in tpu_cost). No hardware actions — the 'resource
    pool' of a fixed TPU chip is not configurable, which is exactly the
    adaptation noted in DESIGN.md §6."""

    def __init__(self, gemms: Sequence[tuple[int, int, int]],
                 target_latency_ms: float, chip: TPUChip = H100_SXM,
                 proxy: AccuracyProxy = AccuracyProxy(),
                 spatial: bool = False, reward_lambda: float = 0.01):
        self.gemms = list(gemms)          # (m_tokens, k, n) per layer
        self.chip = chip
        self.target = target_latency_ms
        self.proxy = proxy
        self.spatial = spatial
        self.reward_lambda = reward_lambda
        self.n_layers = len(self.gemms)
        self.episode_len = 2 * self.n_layers
        self.reset()

    def reset(self) -> np.ndarray:
        self.t = 0
        self.bw: list[int] = []
        self.ba: list[int] = []
        self.last_action = 0.0
        return self._state()

    def _state(self) -> np.ndarray:
        s = np.zeros(STATE_DIM, np.float32)
        i = self.t // 2
        m, k, n = self.gemms[min(i, self.n_layers - 1)]
        s[0] = 1.0
        s[1] = i / max(self.n_layers - 1, 1)
        s[2] = k / 8192.0
        s[3] = n / 8192.0
        s[6] = m / 65536.0
        s[7] = (k * n) / (8192.0 * 8192.0)
        s[9] = float(self.t % 2)
        s[11] = self.last_action
        return s

    def step(self, action: float):
        a = float(np.clip(action, 0.0, 1.0))
        self.last_action = a
        if self.t % 2 == 0:
            self.bw.append(_discretize(a, 2, 8))
        else:
            self.ba.append(_discretize(a, 2, 4))
        self.t += 1
        done = self.t >= self.episode_len
        if not done:
            return self._state(), 0.0, False, {}

        total_s = 0.0
        ratios = []
        from repro_torch.core.tpu_cost import solve_tpu_split
        for (m, k, n), bw, ba in zip(self.gemms, self.bw, self.ba):
            r, sec, _ = solve_tpu_split(m, k, n, bw, ba, self.chip,
                                        spatial=self.spatial)
            ratios.append(r)
            total_s += sec
        latency_ms = total_s * 1e3
        specs_like = [ConvSpec(f"g{i}", k, n, 1, 1, 1)
                      for i, (m, k, n) in enumerate(self.gemms)]
        acc = self.proxy.evaluate(specs_like, self.bw, self.ba, ratios)
        reward = shaped_reward(latency_ms, self.target, acc,
                               self.proxy.baseline_acc, self.reward_lambda)
        info = {"latency_ms": latency_ms, "acc": acc, "bw": self.bw,
                "ba": self.ba, "ratios": ratios,
                "reward_source": "analytical"}
        return self._state(), float(reward), True, info
