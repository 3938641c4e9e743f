"""Design-space exploration: the paper's DDPG-based co-design framework.

The counterpart of ``repro.dse``:

  ddpg      — actor/critic/targets/replay/exploration noise on torch
              (the agent lives on a torch device, ``"cuda"`` unless
              asked otherwise)
  env       — the §5 environment: 6 hardware actions + 2N quantization
              actions, Eq. 17 state, Eq. 13/14 discretization, Eq. 18
              reward (``shaped_reward``, shared by every scorer); a
              copy of the reference's with the chip record ``H100_SXM``
  evaluator — simulator-in-the-loop tier: elite configs compiled
              through the NN→ISA toolchain and re-scored on
              ``simulate_program``; ``verify`` holds the golden
              interpreter against ``CudaExecutor``
  search    — end-to-end two-tier search driver (a copy)

``python -m repro_torch.dse`` runs a search from the command line.
"""
from repro_torch.dse.ddpg import DDPGAgent, DDPGConfig, agent_device, \
    agent_from_numpy
from repro_torch.dse.env import (
    AccuracyProxy,
    N3HEnv,
    N3HEnvConfig,
    evaluate_config,
    shaped_reward,
)
from repro_torch.dse.evaluator import (
    SIM_GAP_TOL_PCT,
    EliteSet,
    EvalResult,
    ProgramEvaluator,
    gemm_specs,
    sim_gap_report,
)
from repro_torch.dse.search import SearchResult, run_search

__all__ = ["DDPGAgent", "DDPGConfig", "agent_device", "agent_from_numpy",
           "AccuracyProxy", "N3HEnv", "N3HEnvConfig", "evaluate_config",
           "shaped_reward", "SIM_GAP_TOL_PCT", "EliteSet", "EvalResult",
           "ProgramEvaluator", "gemm_specs", "sim_gap_report",
           "SearchResult", "run_search"]
