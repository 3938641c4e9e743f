"""End-to-end DSE driver — the paper's Table 3 generator, now two-tier.

``run_search(network, device, target_latency_ms, episodes)`` runs the
DDPG agent over the N3H environment and returns the best feasible
configuration found (hardware knobs + per-layer bit-widths + split
ratios), exactly the artifact the paper's framework emits.

With ``simulate_elites=True`` the loop is *two-tier*
(simulator-in-the-loop, see ``docs/dse.md``): the agent keeps
exploring on the closed-form latency model for speed, but every
``sim_every`` episodes the top-``top_k`` elite configurations are
compiled through the NN→ISA toolchain and re-scored with
``core/scheduler.simulate_program`` at ``opt_level`` — elites are
re-ranked by the corrected reward, and each corrected episode is
re-injected into the replay buffer so the critic learns from the
program that would actually ship. ``network`` may be a CNN workload
*or* any registry arch id (scored at ``seq_len`` tokens; must be a
perfect square — see ``dse.evaluator.gemm_specs``).

Passing ``accuracy_fn`` (e.g. ``repro.eval.accuracy.make_accuracy_fn``)
upgrades elite correction to a *third* signal: each elite's compiled
program is run over a held-out eval stream and its **measured** top-1
agreement replaces the ``AccuracyProxy`` term in the corrected reward
(``reward_source == "measured"``). The calibration rows then trace an
accuracy-vs-latency frontier over the elite set — see ``docs/dse.md``.

The paper explores 900 episodes; the default here is smaller so the
benchmark suite stays fast — pass ``episodes=900`` to match.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import DEVICES, FPGADevice
from repro_torch.core.workloads import ConvSpec
from repro_torch.dse.ddpg import DDPGAgent, DDPGConfig
from repro_torch.dse.env import STATE_DIM, AccuracyProxy, N3HEnv, N3HEnvConfig
from repro_torch.dse.evaluator import (
    EliteSet,
    ProgramEvaluator,
    config_fingerprint,
    gemm_specs,
)
from repro_torch.obs import MetricsRegistry


#: calibration-report columns, in CSV order
CALIBRATION_FIELDS = (
    "rank", "key", "reward_source", "reward_analytical",
    "reward_simulated", "analytical_ms", "simulated_ms", "gap_pct",
    "acc", "measured_acc", "mean_bw", "mean_ba", "mean_ratio",
)


@dataclasses.dataclass
class SearchResult:
    best_reward: float
    best_info: dict
    rewards: list[float]
    episodes: int
    wall_s: float
    # two-tier columns (None / "analytical" when simulate_elites is off)
    reward_source: str = "analytical"
    analytical_latency_ms: float | None = None
    simulated_latency_ms: float | None = None
    sim_gap_pct: float | None = None
    elites: list[dict] = dataclasses.field(default_factory=list)
    evaluator_cache: dict | None = None
    # repro.obs.MetricsRegistry snapshot of the run (per-episode
    # reward/latency series, elite sim-gap observations, cache counters)
    metrics: dict | None = None

    def table3_row(self) -> dict:
        """The paper's Table 3 columns (+ the simulated-latency column
        when the two-tier loop ran)."""
        info = self.best_info
        lut = info["lut_cfg"]
        dsp = info["dsp_cfg"]
        row = {
            "K": lut.k, "M": lut.m, "N": lut.n,
            "D_L_buf_a": lut.d_a,
            "D_D_buf_a": dsp.d_a,
            "D_D_buf_w": dsp.d_w,
            "latency_ms": round(info["latency_ms"], 2),
            "acc_proxy": round(info["acc"], 2),
        }
        if self.simulated_latency_ms is not None:
            row["sim_latency_ms"] = round(self.simulated_latency_ms, 2)
        return row

    # -- calibration report ---------------------------------------------------

    def calibration_rows(self) -> list[dict]:
        """One row per elite: analytical vs simulated latency/reward and
        the signed gap — how far the closed form was from the compiled
        program on the configs that mattered."""
        return self.elites

    def calibration_report(self) -> str:
        """Human-readable calibration table (see docs/dse.md for how to
        read it)."""
        if not self.elites:
            return "calibration: no elites recorded " \
                   "(simulate_elites was off or no episode finished)"
        lines = [
            "calibration (analytical vs simulated, per elite):",
            f"  {'rank':>4} {'ana_ms':>10} {'sim_ms':>10} {'gap%':>7} "
            f"{'r_ana':>8} {'r_sim':>8} {'acc':>7}",
        ]
        for e in self.elites:
            sim = e.get("simulated_ms")
            lines.append(
                f"  {e['rank']:>4} {e['analytical_ms']:>10.4f} "
                + (f"{sim:>10.4f}" if sim is not None else f"{'-':>10}")
                + (f" {e['gap_pct']:>6.2f}%" if e.get("gap_pct") is not None
                   else f" {'-':>7}")
                + f" {e['reward_analytical']:>+8.4f}"
                + (f" {e['reward_simulated']:>+8.4f}"
                   if e.get("reward_simulated") is not None else f" {'-':>8}")
                + f" {e['acc']:>7.2f}")
        if self.evaluator_cache:
            c = self.evaluator_cache
            lines.append(f"  program cache: {c['hits']} hits / "
                         f"{c['misses']} misses (size {c['size']})")
        return "\n".join(lines)

    def write_calibration_csv(self, path: str) -> None:
        import csv
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CALIBRATION_FIELDS,
                               extrasaction="ignore")
            w.writeheader()
            w.writerows(self.elites)


def _calibration_row(rank: int, elite) -> dict:
    info = elite.info
    return {
        "rank": rank,
        "key": elite.key,
        "reward_source": info.get("reward_source", "analytical"),
        "reward_analytical": elite.reward_analytical,
        "reward_simulated": elite.reward_simulated,
        "analytical_ms": info.get("analytical_latency_ms",
                                  info["latency_ms"]),
        "simulated_ms": info.get("simulated_latency_ms"),
        "gap_pct": info.get("sim_gap_pct"),
        "acc": info["acc"],
        "measured_acc": info.get("measured_acc"),
        "mean_bw": float(np.mean(info["bw_lut"])),
        "mean_ba": float(np.mean(info["ba"])),
        "mean_ratio": float(np.mean(info["ratios"])),
    }


def _correct_elites(elites: EliteSet, evaluator: ProgramEvaluator,
                    agent: DDPGAgent, verbose: bool = False) -> int:
    """Re-score every not-yet-corrected elite on its compiled program,
    re-rank, and feed the corrected episodes back into the replay
    buffer. Returns how many elites were corrected."""
    pending = elites.uncorrected()
    for e in pending:
        r_sim, corrected_info = evaluator.correct(e.info)
        if verbose:
            print(f"  [sim] elite {e.key}: reward "
                  f"{e.reward_analytical:+.4f} -> {r_sim:+.4f}  "
                  f"({corrected_info['analytical_latency_ms']:.3f} ms "
                  f"analytical vs "
                  f"{corrected_info['simulated_latency_ms']:.3f} ms "
                  f"simulated)")
        elites.apply_correction(e, r_sim, corrected_info)
        if e.transitions:
            agent.remember_episode(e.transitions, r_sim)
    if pending:
        agent.learn(n_updates=sum(len(e.transitions or ())
                                  for e in pending))
    return len(pending)


def run_search(network: str = "resnet18", device: str = "XC7Z020",
               target_latency_ms: float = 35.0, episodes: int = 120,
               seed: int = 0, baseline_acc: float = 69.76,
               specs: Sequence[ConvSpec] | None = None,
               verbose: bool = False,
               simulate_elites: bool = False, top_k: int = 4,
               sim_every: int = 20, opt_level: int = 1,
               cache_size: int = 32, seq_len: int = 64,
               accuracy_fn=None,
               metrics: MetricsRegistry | None = None) -> SearchResult:
    reg = metrics if metrics is not None else MetricsRegistry()
    dev: FPGADevice = DEVICES[device]
    layer_specs = list(specs) if specs is not None \
        else gemm_specs(network, seq_len=seq_len)
    proxy = AccuracyProxy(baseline_acc=baseline_acc)
    env_cfg = N3HEnvConfig(device=dev, target_latency_ms=target_latency_ms,
                           proxy=proxy)
    env = N3HEnv(layer_specs, env_cfg)
    agent = DDPGAgent(DDPGConfig(state_dim=STATE_DIM), seed=seed)
    evaluator = ProgramEvaluator(
        layer_specs, dev, target_latency_ms, proxy=proxy,
        reward_lambda=env_cfg.reward_lambda, opt_level=opt_level,
        cache_size=cache_size, name=network,
        accuracy_fn=accuracy_fn) if simulate_elites else None
    elites = EliteSet(top_k)

    best_reward = -np.inf
    best_info: dict = {}
    rewards = []
    t0 = time.time()
    for ep in range(episodes):
        s = env.reset()
        transitions = []
        done = False
        while not done:
            a = agent.act(s, explore=True)
            s2, r, done, info = env.step(float(a[0]))
            transitions.append((s, a, r, s2, done))
            s = s2
        # sparse terminal reward -> propagate to every step (the paper's
        # episode-level reward assignment)
        final_r = transitions[-1][2]
        agent.remember_episode(transitions, final_r)
        agent.learn(n_updates=len(transitions))
        agent.decay_noise()
        rewards.append(final_r)
        reg.incr("dse.episodes")
        reg.observe("dse.episode.reward", final_r)
        if "latency_ms" in info:
            reg.observe("dse.episode.latency_ms", info["latency_ms"])
        # fingerprint in both modes: the single-tier calibration rows
        # deduplicate too (a converged agent re-emits its best config)
        elites.add(final_r, info, transitions=transitions,
                   key=config_fingerprint(
                       dev, info["lut_cfg"], info["dsp_cfg"],
                       info["bw_lut"], info["ba"], info["n_luts"],
                       opt_level))
        if final_r > best_reward:
            best_reward, best_info = final_r, info
        if evaluator and (ep + 1) % max(sim_every, 1) == 0:
            reg.incr("dse.elites.corrected",
                     _correct_elites(elites, evaluator, agent,
                                     verbose=verbose))
        if verbose and (ep + 1) % 10 == 0:
            print(f"  ep {ep + 1:4d}  reward {final_r:+.4f}  "
                  f"best {best_reward:+.4f}  "
                  f"lat {info.get('latency_ms', float('nan')):.2f} ms")

    result = SearchResult(best_reward=float(best_reward),
                          best_info=best_info, rewards=rewards,
                          episodes=episodes, wall_s=time.time() - t0)
    if evaluator:
        reg.incr("dse.elites.corrected",
                 _correct_elites(elites, evaluator, agent, verbose=verbose))
        winner = elites.best
        if winner is not None:
            result.best_reward = float(winner.reward)
            result.best_info = winner.info
            result.reward_source = winner.info.get("reward_source",
                                                   "simulated")
            result.analytical_latency_ms = \
                winner.info["analytical_latency_ms"]
            result.simulated_latency_ms = \
                winner.info["simulated_latency_ms"]
            result.sim_gap_pct = winner.info["sim_gap_pct"]
        result.elites = [_calibration_row(i + 1, e)
                         for i, e in enumerate(elites.elites)]
        result.evaluator_cache = evaluator.cache_info()
        result.wall_s = time.time() - t0
    elif best_info:
        result.analytical_latency_ms = best_info["latency_ms"]
        result.elites = [_calibration_row(i + 1, e)
                         for i, e in enumerate(elites.elites)]
    reg.gauge("dse.best_reward", result.best_reward)
    if result.sim_gap_pct is not None:
        reg.gauge("dse.best.sim_gap_pct", result.sim_gap_pct)
    for row in result.elites:
        if row.get("gap_pct") is not None:
            reg.observe("dse.elite.sim_gap_pct", row["gap_pct"])
    if result.evaluator_cache:
        reg.gauge("dse.program_cache.hits",
                  result.evaluator_cache["hits"])
        reg.gauge("dse.program_cache.misses",
                  result.evaluator_cache["misses"])
    result.metrics = reg.snapshot()
    return result
