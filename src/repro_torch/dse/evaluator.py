"""Simulator-in-the-loop evaluation: score DSE configs on *compiled*
programs.

The RL agent explores with the closed-form latency model (Eqs. 9-11) —
vectorizable, microseconds per config. That model is validated against
the event-driven instruction-stream simulator at a few percent (the
Fig. 5 reproduction), but the simulator times the *actual* program the
compiler emits, including whatever the ``-O1`` pass pipeline did to
the streams. :class:`ProgramEvaluator` closes that gap inside the
search loop (the last compiler ROADMAP item): the top-K elite
configurations of a search are compiled through the full NN→ISA
toolchain — honoring the searched core knobs, per-layer bit-widths and
exact Eq.-12 neuron splits — and re-scored with
``core/scheduler.simulate_program``, so the elites are *ranked by the
program that would actually ship*.

Pieces:

  * :func:`gemm_specs` — config-to-``ConvSpec`` plumbing: any
    compilable network (the CNN workload zoo *or* a registry LM arch)
    as the spec list both the analytical env and the evaluator share;
  * :class:`ProgramEvaluator` — config → ``Program`` → simulated
    latency → corrected Eq.-18 reward, behind an LRU cache keyed by a
    config fingerprint (elite re-scoring revisits the same configs
    round after round, so hot elites cost one dict lookup);
  * :class:`EliteSet` — the top-K pool with two-tier re-ranking
    (analytical reward until corrected, simulated after);
  * :func:`sim_gap_report` — the ``dse.sim_gap.*`` benchmark rows:
    analytical-vs-simulated latency for a fixed config per
    architecture, with the documented agreement tolerance.

The documented agreement tolerance between the two tiers is
:data:`SIM_GAP_TOL_PCT` (see ``docs/dse.md`` — the closed form tracks
the canonical ``-O0`` schedule within a few percent; ``-O1`` stream
optimization widens the gap, which is exactly why elites are re-scored
on the compiled program).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import (
    DspCoreConfig,
    FPGADevice,
    LutCoreConfig,
    simulate_program,
)
from repro_torch.core.workloads import WORKLOADS, ConvSpec
from repro_torch.dse.env import AccuracyProxy, shaped_reward

#: Documented analytical-vs-simulated agreement tolerance (percent) for
#: the ``dse.sim_gap.*`` benchmark rows: |analytical - simulated| /
#: simulated * 100 must stay below this for the two-tier loop to be
#: meaningful (the correction should *refine* the ranking, not
#: contradict the model wholesale).
SIM_GAP_TOL_PCT = 25.0


# ---------------------------------------------------------------------------
# Config-to-spec plumbing
# ---------------------------------------------------------------------------


def gemm_specs(network: str, seq_len: int = 64) -> list[ConvSpec]:
    """``ConvSpec`` list for any compilable network name.

    CNN workloads come straight from the zoo. Registry LM archs are
    walked by ``compiler/networks.lm_gemm_layers`` (smoke config) and
    each projection GEMM becomes a 1x1 "conv" spec with
    ``in_hw = sqrt(seq_len)`` so that ``spec.gemm()`` reproduces the
    exact GEMM extents the compiler lowers — the analytical env and the
    program evaluator then score the *same* shapes. ``seq_len`` must be
    a perfect square for that identity to hold.
    """
    if network in WORKLOADS:
        return WORKLOADS[network]()
    from repro_torch.compiler.networks import network_layers
    hw = math.isqrt(seq_len)
    if hw * hw != seq_len:
        raise ValueError(
            f"seq_len must be a perfect square to map token rows onto a "
            f"ConvSpec feature map, got {seq_len}")
    specs = []
    for gl in network_layers(network, seq_len=seq_len):
        spec = ConvSpec(gl.name, c_in=gl.dims.k, c_out=gl.dims.n,
                        kernel=1, stride=1, in_hw=hw)
        assert spec.gemm() == gl.dims
        specs.append(spec)
    return specs


def specs_to_layers(specs: Sequence[ConvSpec]):
    """Lowerable ``GemmLayer`` list for a spec list.

    Real CNNs (any spatial kernel, depthwise, pooling or shortcut glue)
    keep their ``ConvGeometry`` so the compiled program stages im2col
    exactly like the deployed path; an all-1x1 FC chain (the
    :func:`gemm_specs` view of an LM arch) lowers as plain GEMM layers,
    matching how ``compiler/networks.py`` treats LM frontends.
    """
    from repro_torch.compiler.program import GemmLayer
    conv_like = any(s.kernel > 1 or s.depthwise or s.pool or s.shortcut
                    for s in specs)
    if conv_like:
        return [GemmLayer.from_conv(s) for s in specs]
    return [GemmLayer(s.name, s.gemm()) for s in specs]


def config_fingerprint(device: FPGADevice, lut_cfg: LutCoreConfig,
                       dsp_cfg: DspCoreConfig, bw: Sequence[int],
                       ba: Sequence[int], n_luts: Sequence[int],
                       opt_level: int) -> str:
    """Stable key over everything that determines the compiled program.

    Cheaper than ``Program.fingerprint()`` (no lowering needed), which
    is the point: the LRU is consulted *before* compiling.
    """
    h = hashlib.sha256()
    h.update(repr((device.name, lut_cfg, dsp_cfg, tuple(bw), tuple(ba),
                   tuple(n_luts), opt_level)).encode())
    return h.hexdigest()[:16]


def _info_n_luts(info: dict, specs: Sequence[ConvSpec]) -> list[int]:
    """Exact per-layer LUT filter counts from an env ``info`` dict.

    ``N3HEnv`` records them directly (``n_luts``); older callers only
    carry the ``ratios`` fractions, which round back exactly because
    every ratio is ``n_lut / c_out``.
    """
    if "n_luts" in info:
        return [int(v) for v in info["n_luts"]]
    return [int(round(r * s.gemm().n))
            for r, s in zip(info["ratios"], specs)]


# ---------------------------------------------------------------------------
# The evaluator
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvalResult:
    """One config scored by both tiers."""
    key: str                     # config fingerprint (the cache key)
    analytical_ms: float         # closed-form latency (from the env)
    simulated_ms: float          # simulate_program on the compiled stream
    sim_cycles: int
    acc: float                   # accuracy proxy (shared by both tiers)
    reward_analytical: float
    reward_simulated: float      # Eq. 18 re-applied at the simulated latency
    n_instructions: int
    cached: bool                 # served from the program LRU

    @property
    def gap_pct(self) -> float:
        """Signed model-vs-program gap: positive = the closed form
        over-estimates the compiled program's latency."""
        return 100.0 * (self.analytical_ms - self.simulated_ms) \
            / max(self.simulated_ms, 1e-12)


class ProgramEvaluator:
    """Re-score configurations on real compiled programs.

    One instance per search: it pins the workload (``specs``), device,
    latency target and reward shaping, and keeps an LRU of
    ``(Program, simulated cycles)`` keyed by config fingerprint so that
    re-scoring a returning elite costs a dict lookup instead of a
    compile + simulate.
    """

    def __init__(self, specs: Sequence[ConvSpec], device: FPGADevice,
                 target_latency_ms: float,
                 proxy: AccuracyProxy | None = None,
                 reward_lambda: float = 0.01, opt_level: int = 1,
                 cache_size: int = 32, name: str = "dse",
                 accuracy_fn=None, measured_baseline: float = 100.0):
        self.specs = list(specs)
        self.device = device
        self.target_latency_ms = target_latency_ms
        self.proxy = proxy if proxy is not None else AccuracyProxy()
        self.reward_lambda = reward_lambda
        self.opt_level = opt_level
        self.name = name
        #: optional measured-accuracy hook (``fn(program) -> percent``,
        #: e.g. ``repro.eval.accuracy.make_accuracy_fn``): elite
        #: correction then swaps the analytical AccuracyProxy term for
        #: the agreement the compiled program actually measures —
        #: against ``measured_baseline`` (100 = fp32 parity) instead of
        #: the proxy's paper baseline.
        self.accuracy_fn = accuracy_fn
        self.measured_baseline = measured_baseline
        self._layers = specs_to_layers(self.specs)
        self._cache: collections.OrderedDict[str, tuple] = \
            collections.OrderedDict()
        self._cache_size = max(int(cache_size), 1)
        self._hits = 0
        self._misses = 0

    # -- cache ---------------------------------------------------------------

    def config_key(self, info: dict) -> str:
        return config_fingerprint(
            self.device, info["lut_cfg"], info["dsp_cfg"], info["bw_lut"],
            info["ba"], _info_n_luts(info, self.specs), self.opt_level)

    def cache_info(self) -> dict:
        return {"hits": self._hits, "misses": self._misses,
                "size": len(self._cache), "maxsize": self._cache_size}

    def _entry(self, key: str, info: dict) -> tuple[list, bool]:
        """LRU entry ``[program, sim_cycles | None, measured_acc |
        None]`` for a config.

        Cycles and measured accuracy are computed lazily (``_cycles`` /
        ``_measured``): :meth:`verify` only needs the program, and a
        full-size CNN simulation is minutes-long — functional
        verification must not pay for it.
        """
        if key in self._cache:
            self._cache.move_to_end(key)
            self._hits += 1
            return self._cache[key], True
        self._misses += 1
        entry = [self.compile(info), None, None]
        self._cache[key] = entry
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return entry, False

    def _cycles(self, entry: list) -> int:
        if entry[1] is None:
            entry[1] = int(simulate_program(entry[0]).total_cycles)
        return entry[1]

    def _measured(self, entry: list) -> float:
        if entry[2] is None:
            entry[2] = float(self.accuracy_fn(entry[0]))
        return entry[2]

    # -- config -> program ---------------------------------------------------

    def compile(self, info: dict):
        """Lower the config to a :class:`~repro.compiler.Program`,
        honoring the searched core knobs, per-layer bit-widths and the
        exact Eq.-12 neuron splits (``n_luts`` — *not* re-solved, so
        the program realizes precisely the design point the agent
        scored)."""
        from repro_torch.compiler.lower import lower_network
        return lower_network(
            self.name, self._layers, info["lut_cfg"], info["dsp_cfg"],
            self.device, bits_w_lut=list(info["bw_lut"]),
            bits_a=list(info["ba"]),
            n_luts=_info_n_luts(info, self.specs),
            opt_level=self.opt_level)

    # -- scoring -------------------------------------------------------------

    def evaluate(self, info: dict) -> EvalResult:
        """Compile (or fetch) the config's program, simulate it, and
        re-apply the Eq.-18 reward at the simulated latency. The
        accuracy term is untouched — only the latency model changes
        between the tiers."""
        key = self.config_key(info)
        entry, cached = self._entry(key, info)
        cycles = self._cycles(entry)
        sim_ms = self.device.cycles_to_ms(cycles)
        acc = float(info["acc"])
        r_ana = shaped_reward(info["latency_ms"], self.target_latency_ms,
                              acc, self.proxy.baseline_acc,
                              self.reward_lambda)
        r_sim = shaped_reward(sim_ms, self.target_latency_ms, acc,
                              self.proxy.baseline_acc, self.reward_lambda)
        return EvalResult(
            key=key, analytical_ms=float(info["latency_ms"]),
            simulated_ms=sim_ms, sim_cycles=cycles, acc=acc,
            reward_analytical=float(r_ana), reward_simulated=float(r_sim),
            n_instructions=entry[0].n_instructions, cached=cached)

    def correct(self, info: dict) -> tuple[float, dict]:
        """Elite-correction entry point: returns the corrected reward
        plus a *new* info dict carrying both latency columns.

        Without an ``accuracy_fn`` the correction swaps the latency
        tier only (``reward_source="simulated"``). With one, the
        accuracy term is swapped too: the compiled program is executed
        over the validation stream and the Eq.-18 reward is re-applied
        at (simulated latency, **measured** agreement) —
        ``reward_source="measured"``, ``measured_acc`` recorded — so
        elite re-ranking trades off latency against accuracy the
        program actually delivers, not the proxy's monotone estimate.
        """
        res = self.evaluate(info)
        corrected = dict(info)
        corrected.update({
            "reward_source": "simulated",
            "analytical_latency_ms": res.analytical_ms,
            "simulated_latency_ms": res.simulated_ms,
            "sim_gap_pct": res.gap_pct,
            "sim_cycles": res.sim_cycles,
        })
        reward = res.reward_simulated
        if self.accuracy_fn is not None:
            key = self.config_key(info)
            entry, _cached = self._entry(key, info)
            acc_m = self._measured(entry)
            reward = shaped_reward(res.simulated_ms,
                                   self.target_latency_ms, acc_m,
                                   self.measured_baseline,
                                   self.reward_lambda)
            corrected.update({
                "reward_source": "measured",
                "measured_acc": acc_m,
            })
        return reward, corrected

    # -- functional verification ----------------------------------------------

    def verify(self, info: dict, seed: int = 0,
               torch_device="cuda") -> bool:
        """Execute the config's compiled program functionally and check
        golden-vs-cuda bit-exactness layer by layer (the repo's
        standing cross-check for a program that "actually runs"):
        synthetic weights, synthetic quantized activations, exact
        integer comparison of every layer output, both executors on
        ``torch_device``."""
        from repro_torch.compiler.runtime import (
            CudaExecutor,
            GoldenExecutor,
            bind_synthetic,
        )
        from repro_torch.quant.uniform import qrange
        entry, _cached = self._entry(self.config_key(info), info)
        prog = entry[0]           # no simulation — verify is functional
        golden = GoldenExecutor(prog, device=torch_device)
        cuda = CudaExecutor(prog, device=torch_device)
        rng = np.random.default_rng(seed)
        for lp in prog.layers:
            bind_synthetic(golden, lp, seed=seed + lp.index)
            bind_synthetic(cuda, lp, seed=seed + lp.index)
            lo, hi = qrange(lp.bits_a)
            shape = (lp.dims.m, lp.dims.k, lp.dims.n) if lp.depthwise \
                else (lp.dims.m, lp.dims.k)
            x_q = rng.integers(lo, hi + 1, shape).astype(np.int8)
            out_g = golden.run_layer(lp.index, x_q).cpu().numpy()
            out_c = cuda.run_layer(lp.index, x_q).cpu().numpy()
            if not (out_g == out_c).all():
                return False
        return True


# ---------------------------------------------------------------------------
# Elite pool with two-tier re-ranking
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Elite:
    reward: float                       # current ranking reward
    reward_analytical: float
    info: dict
    transitions: list | None = None     # episode, for replay correction
    key: str | None = None              # config fingerprint (dedup)
    reward_simulated: float | None = None

    @property
    def corrected(self) -> bool:
        return self.reward_simulated is not None


class EliteSet:
    """Top-K configurations of a search, ranked by the best reward
    known for each: analytical until :meth:`rerank` applies a
    simulator correction, simulated afterwards. Deduplicates on the
    config fingerprint — the agent frequently re-emits a good config,
    and re-scoring it twice would waste a cache slot *and* bias the
    replay buffer."""

    def __init__(self, k: int):
        self.k = max(int(k), 1)
        self.elites: list[Elite] = []

    def add(self, reward: float, info: dict,
            transitions: list | None = None, key: str | None = None) -> bool:
        """Offer one episode's terminal config; returns True if kept.

        Admission and eviction compare *analytical* rewards — the only
        tier a new candidate has been scored on. Comparing a fresh
        analytical reward against simulator-corrected pool rewards
        would reject exactly the near-target configs whose ranking the
        correction can flip (analytically just-infeasible, simulated
        feasible) before tier 2 ever sees them. The best
        *simulator-confirmed* elite (highest ``reward_simulated``) is
        never evicted — not even when an uncorrected elite holds a
        higher analytical reward — so a confirmed winner survives
        analytical churn until the next correction round re-ranks.
        """
        if key is not None and any(e.key == key for e in self.elites):
            return False
        if len(self.elites) >= self.k:
            corrected = [e for e in self.elites if e.corrected]
            protected = max(corrected, key=lambda e: e.reward_simulated) \
                if corrected else None
            evictable = [e for e in self.elites if e is not protected]
            if not evictable:      # k == 1 and the winner is confirmed
                return False
            floor = min(evictable, key=lambda e: e.reward_analytical)
            if reward <= floor.reward_analytical:
                return False
            self.elites.remove(floor)
        self.elites.append(Elite(reward=reward, reward_analytical=reward,
                                 info=info, transitions=transitions,
                                 key=key))
        self.rerank()
        return True

    def uncorrected(self) -> list[Elite]:
        return [e for e in self.elites if not e.corrected]

    def apply_correction(self, elite: Elite, reward_simulated: float,
                         corrected_info: dict) -> None:
        elite.reward_simulated = float(reward_simulated)
        elite.reward = float(reward_simulated)
        elite.info = corrected_info
        self.rerank()

    def rerank(self) -> None:
        self.elites.sort(key=lambda e: e.reward, reverse=True)

    @property
    def best(self) -> Elite | None:
        return self.elites[0] if self.elites else None


# ---------------------------------------------------------------------------
# Benchmark rows: the model-vs-program gap per architecture
# ---------------------------------------------------------------------------


def sim_gap_report(network: str, specs: Sequence[ConvSpec] | None = None,
                   device: FPGADevice | None = None,
                   lut_cfg: LutCoreConfig | None = None,
                   dsp_cfg: DspCoreConfig | None = None,
                   bits_w: int = 4, bits_a: int = 4,
                   target_latency_ms: float = 1e9,
                   opt_level: int = 1, seq_len: int = 64) -> dict:
    """Analytical-vs-simulated latency for one fixed configuration of
    ``network`` — the payload of the ``dse.sim_gap.*`` benchmark rows.

    Scores the uniform ``bits_w``/``bits_a`` config through both tiers
    (Eq.-12 splits solved analytically, then the identical splits
    compiled and simulated) and reports the signed gap plus whether it
    sits inside the documented :data:`SIM_GAP_TOL_PCT` tolerance.
    """
    from repro_torch.core.scheduler import XC7Z020
    from repro_torch.dse.env import evaluate_config
    device = device or XC7Z020
    lut_cfg = lut_cfg or LutCoreConfig(m=8, n=16, k=128)
    dsp_cfg = dsp_cfg or DspCoreConfig(
        n_reg_row_a=DspCoreConfig.rows_for_device(device))
    if specs is None:
        specs = gemm_specs(network, seq_len=seq_len)
    proxy = AccuracyProxy()
    _r, info = evaluate_config(specs, lut_cfg, dsp_cfg, device,
                               [bits_w] * len(specs), [bits_a] * len(specs),
                               proxy, target_latency_ms, 0.01)
    ev = ProgramEvaluator(specs, device, target_latency_ms, proxy=proxy,
                          opt_level=opt_level, name=network)
    res = ev.evaluate(info)
    return {
        "BENCH": "dse.sim_gap",
        "network": network,
        "layers": len(specs),
        "opt_level": opt_level,
        "bits_w": bits_w,
        "bits_a": bits_a,
        "analytical_ms": round(res.analytical_ms, 6),
        "simulated_ms": round(res.simulated_ms, 6),
        "sim_cycles": res.sim_cycles,
        "gap_pct": round(res.gap_pct, 3),
        "tol_pct": SIM_GAP_TOL_PCT,
        "within_tol": bool(abs(res.gap_pct) <= SIM_GAP_TOL_PCT),
        "n_instructions": res.n_instructions,
    }
