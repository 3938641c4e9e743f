"""The port's design-space search against the reference's.

``dse/env.py``, ``dse/evaluator.py`` and ``dse/search.py`` are the
reference's files (``tests/test_torch_compiler.py`` holds them to it);
the agent (``dse/ddpg.py``) is written anew on torch. What must be
equal: the environments' rewards and infos for the same actions (with
one chip record given to both), the evaluator's fingerprints, compiled
programs and rewards for the same ``info``, and the configurations a
search chooses when both agents hold the same weights. What agrees
within a stated tolerance: the agent's actions and one learning step
(float32 MLPs and Adam in two frameworks). The agents here run on the
CPU (``agent_device("cpu")``); so do the executors behind ``verify`` and
the measured-accuracy hook, whose CUDA kernels compute their plain
versions on CPU tensors.
"""
import contextlib
import dataclasses
import io
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import tpu_cost as tc_jax
from repro.core.scheduler import XC7Z020 as XC7Z020_JAX
from repro.core.scheduler import DspCoreConfig as DspCoreConfigJax
from repro.core.scheduler import LutCoreConfig as LutCoreConfigJax
from repro.core.workloads import ConvSpec as ConvSpecJax
from repro.core.workloads import resnet18_specs as resnet18_specs_jax
from repro.dse import ddpg as ddpg_jax
from repro.dse import env as env_jax
from repro.dse import evaluator as evaluator_jax
from repro.dse import search as search_jax
from repro_torch.compiler.runtime import CudaExecutor
from repro_torch.core.cost_model import system_cost
from repro_torch.core.scheduler import XC7Z020, DspCoreConfig, LutCoreConfig
from repro_torch.core.tpu_cost import H100_SXM
from repro_torch.core.workloads import ConvSpec, resnet18_specs
from repro_torch.dse import ddpg, evaluator
from repro_torch.dse import search as search_port
from repro_torch.dse.__main__ import main as dse_main
from repro_torch.dse.ddpg import DDPGAgent, DDPGConfig, agent_device, \
    agent_from_numpy
from repro_torch.dse.env import (
    STATE_DIM,
    AccuracyProxy,
    N3HEnv,
    N3HEnvConfig,
    TpuHeteroEnv,
    _discretize,
    evaluate_config,
    shaped_reward,
)
from repro_torch.dse.evaluator import (
    SIM_GAP_TOL_PCT,
    EliteSet,
    ProgramEvaluator,
    gemm_specs,
    sim_gap_report,
    specs_to_layers,
)
from repro_torch.dse.search import CALIBRATION_FIELDS, run_search
from repro_torch.eval.accuracy import make_accuracy_fn
from repro_torch.models import cnn

CPU = torch.device("cpu")
#: the actor's action, port vs reference on carried weights: max |diff|
ACT_TOL = 1e-6
#: one learning step's weights, port vs reference on carried weights and
#: the same replay contents: max |diff| within this fraction of the
#: parameter's max |value| (fp32 MLPs, gradients and Adam in two
#: frameworks; ``b ** t`` is a float32 power in each)
LEARN_RTOL = 1e-5
#: a search's rewards, port vs reference with both agents on the same
#: weights: max |diff| (the same configurations score the same closed
#: form; the rewards themselves are float64 sums of the same terms)
REWARD_TOL = 1e-6

SPECS_ENV = resnet18_specs()[:6]     # short net keeps episodes fast
DEV = XC7Z020
LUT = LutCoreConfig(m=8, n=16, k=128)
DSP = DspCoreConfig(n_reg_row_a=DspCoreConfig.rows_for_device(DEV))
PROXY = AccuracyProxy(baseline_acc=70.0)
#: small FC chain — episodes and compiles stay milliseconds
SPECS = [ConvSpec(f"g{i}", 256, 128, 1, 1, 4) for i in range(4)]
SPECS_JAX = [ConvSpecJax(f"g{i}", 256, 128, 1, 1, 4) for i in range(4)]


@pytest.fixture(autouse=True)
def _agents_on_cpu():
    with agent_device("cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the shapes here are small, and the suite's
    workers each run a file at once, so a thread per core oversubscribes
    the machine (this file took 7x as long that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _run_episode(env, actions):
    s = env.reset()
    assert s.shape == (STATE_DIM,)
    done = False
    i = 0
    while not done:
        s, r, done, info = env.step(actions(i))
        assert s.shape == (STATE_DIM,)
        assert np.all(s >= -1e-6) and np.all(s <= 1.0 + 1e-6)
        i += 1
    return r, info, i


def _same_info(a: dict, b: dict) -> None:
    """Two env ``info`` dicts equal, core configs compared field by
    field (each package has its own config classes)."""
    assert a.keys() == b.keys()
    for k in a:
        va, vb = a[k], b[k]
        if dataclasses.is_dataclass(va):
            assert dataclasses.asdict(va) == dataclasses.asdict(vb), k
        else:
            assert va == vb, k


# ---------------------------------------------------------------------------
# Environments: the reference's dynamics and rewards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", [0.001, 50.0, 1e6])
def test_n3h_env_equal_to_reference(target):
    rng = np.random.default_rng(int(target * 7) % 1000)
    actions = rng.uniform(-0.2, 1.2, 6 + 2 * len(SPECS_ENV)).tolist()
    env = N3HEnv(SPECS_ENV, N3HEnvConfig(target_latency_ms=target))
    env_j = env_jax.N3HEnv(resnet18_specs_jax()[:6],
                           env_jax.N3HEnvConfig(target_latency_ms=target))
    s, s_j = env.reset(), env_j.reset()
    for a in actions:
        assert np.array_equal(s, s_j)
        s, r, done, info = env.step(a)
        s_j, r_j, done_j, info_j = env_j.step(a)
        assert (r, done) == (r_j, done_j)
    assert done
    _same_info(info, info_j)


@pytest.mark.parametrize("spatial", [False, True])
def test_tpu_env_equal_to_reference_on_one_chip_record(spatial):
    gemms = [(4096, 2048, 8192), (16, 256, 192), (4096, 1024, 1024)]
    chip_j = tc_jax.TPUChip(**dataclasses.asdict(H100_SXM))
    env = TpuHeteroEnv(gemms, target_latency_ms=0.5, spatial=spatial)
    assert env.chip is H100_SXM
    env_j = env_jax.TpuHeteroEnv(gemms, 0.5, chip=chip_j, spatial=spatial)
    env.reset(), env_j.reset()
    for a in (0.1, 0.9, 0.5, 0.0, 1.0, 0.33):
        s, r, done, info = env.step(a)
        s_j, r_j, done_j, info_j = env_j.step(a)
        assert np.array_equal(s, s_j) and (r, done) == (r_j, done_j)
    assert done and info == info_j


def test_evaluate_config_equal_to_reference():
    bw, ba = [2, 4, 6, 8], [2, 3, 4, 2]
    r, info = evaluate_config(SPECS, LUT, DSP, DEV, bw, ba, PROXY, 0.2, 0.01)
    r_j, info_j = env_jax.evaluate_config(
        SPECS_JAX, LutCoreConfigJax(m=8, n=16, k=128),
        DspCoreConfigJax(n_reg_row_a=DspCoreConfigJax.rows_for_device(
            XC7Z020_JAX)), XC7Z020_JAX, bw, ba,
        env_jax.AccuracyProxy(baseline_acc=70.0), 0.2, 0.01)
    assert r == r_j
    _same_info(info, info_j)


# -- mirrors of tests/test_dse.py --------------------------------------------


def test_episode_length_and_state_bounds():
    env = N3HEnv(SPECS_ENV, N3HEnvConfig(target_latency_ms=50.0))
    r, info, steps = _run_episode(env, lambda i: 0.5)
    assert steps == 6 + 2 * len(SPECS_ENV)
    assert "latency_ms" in info and info["latency_ms"] > 0


def test_discretize_bounds():
    assert _discretize(0.0, 2, 8) == 2
    assert _discretize(1.0, 2, 8) == 8
    assert _discretize(0.5, 2, 8) == 5
    assert _discretize(-3.0, 1, 50) == 1      # clipped


def test_projected_config_always_feasible():
    env = N3HEnv(SPECS_ENV, N3HEnvConfig(target_latency_ms=50.0))
    _, info, _ = _run_episode(env, lambda i: 1.0)   # max everything
    rep = system_cost(info["lut_cfg"], info["dsp_cfg"], XC7Z020)
    assert rep.fits(XC7Z020)


def test_reward_regimes():
    """Eq. 18: infeasible latency -> reward <= -1; feasible -> (-1, 1)."""
    tight = N3HEnv(SPECS_ENV, N3HEnvConfig(target_latency_ms=0.001))
    r, _, _ = _run_episode(tight, lambda i: 0.5)
    assert r <= -1.0
    loose = N3HEnv(SPECS_ENV, N3HEnvConfig(target_latency_ms=1e6))
    r, _, _ = _run_episode(loose, lambda i: 0.9)
    assert -1.0 < r < 1.0


def test_first_last_layers_pinned_8bit():
    env = N3HEnv(resnet18_specs(), N3HEnvConfig(target_latency_ms=1e6))
    _, info, _ = _run_episode(env, lambda i: 0.0)   # ask for min bits
    assert info["bw_lut"][0] == 8 and info["ba"][0] == 8
    assert info["bw_lut"][-1] == 8 and info["ba"][-1] == 8
    assert all(b == 2 for b in info["bw_lut"][1:-1])


def test_accuracy_proxy_monotone_in_bits():
    proxy = AccuracyProxy(baseline_acc=70.0, kappa=1.0)
    accs = [proxy.evaluate(SPECS_ENV, [b] * 6, [4] * 6, [0.5] * 6)
            for b in (2, 4, 6, 8)]
    assert accs == sorted(accs)
    assert accs[-1] <= 70.0


def test_tpu_env_episode():
    env = TpuHeteroEnv([(4096, 1024, 1024)] * 4, target_latency_ms=1e6)
    env.reset()
    done = False
    while not done:
        s, r, done, info = env.step(0.5)
    assert "latency_ms" in info and info["latency_ms"] > 0
    assert len(info["ratios"]) == 4


# ---------------------------------------------------------------------------
# The agent
# ---------------------------------------------------------------------------


def _jax_params(agent) -> dict:
    return {name: jax.tree.map(np.asarray, getattr(agent, name))
            for name in ("actor", "critic", "actor_t", "critic_t")}


def _agent_pair(cfg, seed=0):
    """A reference agent and a port agent holding its weights."""
    agent_j = ddpg_jax.DDPGAgent(ddpg_jax.DDPGConfig(**dataclasses.asdict(
        cfg)), seed=seed)
    return agent_from_numpy(cfg, _jax_params(agent_j), seed=seed), agent_j


def test_agent_init_seeded_on_its_device():
    cfg = DDPGConfig(state_dim=STATE_DIM)
    a, b = DDPGAgent(cfg, seed=3), DDPGAgent(cfg, seed=3, device=CPU)
    assert a.device == CPU                     # from agent_device("cpu")
    for la, lb in zip(a.params_numpy()["actor"], b.params_numpy()["actor"]):
        assert np.array_equal(la["w"], lb["w"])
    pa = a.params_numpy()
    for x, y in zip(pa["critic"], pa["critic_t"]):
        assert np.array_equal(x["w"], y["w"])  # targets start as copies
    w0 = pa["actor"][0]["w"]
    assert w0.shape == (STATE_DIM, 64) and abs(w0.std() - (2 / 12) ** 0.5) \
        < 0.1
    assert not pa["actor"][0]["b"].any()
    with agent_device("cuda"):
        if not torch.cuda.is_available():     # the default is the card
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                DDPGAgent(cfg)


def test_act_matches_reference_on_carried_weights():
    cfg = DDPGConfig(state_dim=STATE_DIM)
    agent, agent_j = _agent_pair(cfg, seed=1)
    rng = np.random.default_rng(2)
    for _ in range(8):
        s = rng.uniform(0, 1, STATE_DIM).astype(np.float32)
        a, a_j = agent.act(s, explore=False), agent_j.act(s, explore=False)
        assert a.shape == a_j.shape == (1,)
        assert np.abs(a - a_j).max() <= ACT_TOL
    # exploration draws the reference's noise from the same generator
    s = np.full(STATE_DIM, 0.5, np.float32)
    assert np.abs(agent.act(s) - agent_j.act(s)).max() <= ACT_TOL


def test_learn_step_matches_reference_on_carried_weights():
    cfg = DDPGConfig(state_dim=STATE_DIM, batch_size=32, hidden=(32, 32))
    agent, agent_j = _agent_pair(cfg, seed=4)
    rng = np.random.default_rng(5)
    for _ in range(48):
        s, s2 = rng.uniform(0, 1, (2, STATE_DIM)).astype(np.float32)
        a = rng.uniform(0, 1, 1).astype(np.float32)
        r, done = float(rng.normal()), bool(rng.integers(0, 2))
        agent.remember(s, a, r, s2, done)
        agent_j.remember(s, a, r, s2, done)
    for n in (1, 3):
        agent.learn(n)
        agent_j.learn(n)
        got, want = agent.params_numpy(), _jax_params(agent_j)
        for name in want:
            for lg, lw in zip(got[name], want[name]):
                for k in ("w", "b"):
                    scale = max(float(np.abs(lw[k]).max()), 1e-6)
                    assert np.abs(lg[k] - lw[k]).max() <= LEARN_RTOL * scale
    assert int(agent._t) == 4


def test_ddpg_learns_bandit():
    """Sanity: DDPG moves toward the rewarded action on a 1-step task."""
    cfg = DDPGConfig(state_dim=STATE_DIM, noise_sigma=0.4,
                     batch_size=32, hidden=(32, 32), noise_decay=0.995)
    agent = DDPGAgent(cfg, seed=0)
    target = 0.8
    s = np.zeros(STATE_DIM, np.float32)
    for _ in range(500):
        a = agent.act(s)
        r = -abs(float(a[0]) - target)
        agent.remember(s, a, r, s, True)
        agent.learn(2)
        agent.decay_noise()
    final = float(agent.act(s, explore=False)[0])
    # starts at ~0.5; must move decisively toward the rewarded action
    assert final > 0.65, final


def test_replay_correction_reaches_buffer():
    agent = DDPGAgent(DDPGConfig(state_dim=STATE_DIM), seed=0)
    s = np.zeros(STATE_DIM, np.float32)
    a = np.zeros(1, np.float32)
    transitions = [(s, a, 0.0, s, False), (s, a, -2.0, s, True)]
    agent.remember_episode(transitions, -2.0)     # analytical
    agent.remember_episode(transitions, 0.5)      # simulator-corrected
    assert agent.buffer.n == 4
    assert agent.buffer.r[:4].tolist() == [-2.0, -2.0, 0.5, 0.5]


# ---------------------------------------------------------------------------
# The evaluator: the reference's programs and rewards
# ---------------------------------------------------------------------------


def _info(bw, ba, target_ms=1e9):
    _r, info = evaluate_config(SPECS, LUT, DSP, DEV, bw, ba, PROXY,
                               target_ms, 0.01)
    return info


def _info_jax(bw, ba, target_ms=1e9):
    _r, info = env_jax.evaluate_config(
        SPECS_JAX, LutCoreConfigJax(m=8, n=16, k=128),
        DspCoreConfigJax(n_reg_row_a=DspCoreConfigJax.rows_for_device(
            XC7Z020_JAX)), XC7Z020_JAX, bw, ba,
        env_jax.AccuracyProxy(baseline_acc=70.0), target_ms, 0.01)
    return info


def _evaluator(target_ms=1e9, **kw):
    return ProgramEvaluator(SPECS, DEV, target_ms, proxy=PROXY, **kw)


@pytest.mark.parametrize("opt_level", [0, 1])
@pytest.mark.parametrize("bw,ba", [([4] * 4, [4] * 4),
                                   ([2, 4, 6, 8], [2, 3, 4, 2])])
def test_evaluator_equal_to_reference(bw, ba, opt_level):
    target = 0.05
    ev = _evaluator(target, opt_level=opt_level)
    ev_j = evaluator_jax.ProgramEvaluator(
        SPECS_JAX, XC7Z020_JAX, target,
        proxy=env_jax.AccuracyProxy(baseline_acc=70.0), opt_level=opt_level)
    info, info_j = _info(bw, ba, target), _info_jax(bw, ba, target)
    assert ev.config_key(info) == ev_j.config_key(info_j)
    assert ev.compile(info).fingerprint() == ev_j.compile(info_j).fingerprint()
    assert dataclasses.asdict(ev.evaluate(info)) == \
        dataclasses.asdict(ev_j.evaluate(info_j))
    r, corrected = ev.correct(info)
    r_j, corrected_j = ev_j.correct(info_j)
    assert r == r_j
    _same_info(corrected, corrected_j)


@pytest.mark.parametrize("network", ["resnet18", "llama3.2-1b"])
def test_gemm_specs_equal_to_reference(network):
    got = gemm_specs(network, seq_len=16)
    want = evaluator_jax.gemm_specs(network, seq_len=16)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]


# -- mirrors of tests/test_dse_evaluator.py -----------------------------------


def test_program_honors_per_layer_bits_and_splits():
    bw = [2, 4, 6, 8]
    ba = [2, 3, 4, 2]
    info = _info(bw, ba)
    prog = _evaluator().compile(info)
    assert [lp.bits_w_lut for lp in prog.layers] == bw
    assert [lp.bits_a for lp in prog.layers] == ba
    assert [lp.n_lut for lp in prog.layers] == info["n_luts"]
    assert [lp.dims for lp in prog.layers] == [s.gemm() for s in SPECS]


def test_ratios_roundtrip_without_n_luts():
    info = _info([4] * 4, [4] * 4)
    legacy = {k: v for k, v in info.items() if k != "n_luts"}
    ev = _evaluator()
    prog = ev.compile(legacy)
    assert [lp.n_lut for lp in prog.layers] == info["n_luts"]
    assert ev.config_key(legacy) == ev.config_key(info)


def test_conv_specs_keep_geometry_lm_specs_do_not():
    conv = [ConvSpec("c0", 3, 8, 3, 1, 8)]
    assert specs_to_layers(conv)[0].geometry is not None
    assert all(gl.geometry is None for gl in specs_to_layers(SPECS))


def test_simulated_reward_deterministic_and_cached():
    ev = _evaluator(target_ms=0.05)
    info = _info([4] * 4, [4] * 4, target_ms=0.05)
    r1 = ev.evaluate(info)
    r2 = ev.evaluate(info)
    assert r1.simulated_ms == r2.simulated_ms
    assert r1.reward_simulated == r2.reward_simulated
    assert not r1.cached and r2.cached
    ci = ev.cache_info()
    assert ci["hits"] == 1 and ci["misses"] == 1 and ci["size"] == 1


def test_cache_keys_differ_per_config_and_lru_evicts():
    ev = _evaluator(cache_size=1)
    a = _info([4] * 4, [4] * 4)
    b = _info([8] * 4, [4] * 4)
    assert ev.config_key(a) != ev.config_key(b)
    ev.evaluate(a)
    ev.evaluate(b)          # evicts a (maxsize 1)
    ev.evaluate(a)          # miss again
    ci = ev.cache_info()
    assert ci["misses"] == 3 and ci["hits"] == 0 and ci["size"] == 1


def test_correct_retags_reward_source():
    ev = _evaluator()
    info = _info([4] * 4, [4] * 4)
    assert info["reward_source"] == "analytical"
    r_sim, corrected = ev.correct(info)
    assert corrected["reward_source"] == "simulated"
    assert corrected["simulated_latency_ms"] == pytest.approx(
        DEV.cycles_to_ms(ev.evaluate(info).sim_cycles))
    assert info["reward_source"] == "analytical"   # original untouched


def test_elite_rerank_changes_winner_on_crafted_case():
    probe = _evaluator()
    ana_a = _info([8] * 4, [4] * 4)
    sim_a = probe.evaluate(ana_a)
    assert sim_a.simulated_ms < ana_a["latency_ms"]
    target = 0.5 * (sim_a.simulated_ms + ana_a["latency_ms"])
    ev = _evaluator(target_ms=target)
    r_a, info_a = evaluate_config(SPECS, LUT, DSP, DEV, [8] * 4, [4] * 4,
                                  PROXY, target, 0.01)
    r_b, info_b = evaluate_config(SPECS, LUT, DSP, DEV, [2] * 4, [2] * 4,
                                  PROXY, target, 0.01)
    assert r_a <= -1.0 < r_b
    elites = EliteSet(2)
    elites.add(r_a, info_a, key=ev.config_key(info_a))
    elites.add(r_b, info_b, key=ev.config_key(info_b))
    assert elites.best.info is info_b
    for e in elites.uncorrected():
        r_sim, corrected = ev.correct(e.info)
        elites.apply_correction(e, r_sim, corrected)
    assert elites.best.info["bw_lut"] == [8] * 4
    assert elites.best.reward > -1.0
    assert elites.best.info["reward_source"] == "simulated"


def test_elite_set_dedups_on_key_and_caps_k():
    es = EliteSet(2)
    assert es.add(0.1, {"cfg": 1}, key="k1")
    assert not es.add(0.1, {"cfg": 1}, key="k1")
    assert es.add(0.3, {"cfg": 2}, key="k2")
    assert es.add(0.2, {"cfg": 3}, key="k3")
    assert len(es.elites) == 2
    assert not es.add(0.05, {"cfg": 4}, key="k4")
    assert [e.reward for e in es.elites] == [0.3, 0.2]


def test_elite_admission_floor_stays_analytical_after_correction():
    es = EliteSet(3)
    for r, k in ((0.3, "ka"), (0.2, "kc"), (-0.5, "kb")):
        es.add(r, {"k": k}, key=k)
    for e in list(es.elites):
        es.apply_correction(e, e.reward_analytical + 1.0, dict(e.info))
    assert es.add(0.25, {"k": "kd"}, key="kd")
    keys = {e.key for e in es.elites}
    assert "kb" not in keys and "kd" in keys
    assert es.best.key == "ka"


def test_elite_confirmed_best_never_evicted():
    es = EliteSet(1)
    es.add(0.0, {"k": "a"}, key="a")
    es.apply_correction(es.elites[0], 5.0, {"k": "a"})
    assert not es.add(0.1, {"k": "b"}, key="b")
    assert es.best.key == "a" and es.best.reward == 5.0
    es = EliteSet(2)
    es.add(1.0, {"k": "a"}, key="a")
    es.add(6.0, {"k": "b"}, key="b")
    a = next(e for e in es.elites if e.key == "a")
    es.apply_correction(a, 5.0, {"k": "a"})
    assert not es.add(1.5, {"k": "c"}, key="c")
    assert {e.key for e in es.elites} == {"a", "b"}
    assert es.add(6.5, {"k": "d"}, key="d")
    assert {e.key for e in es.elites} == {"a", "d"}


# ---------------------------------------------------------------------------
# verify: golden against the kernels' executor
# ---------------------------------------------------------------------------


def test_winning_program_executes_bit_exactly_golden_vs_cuda():
    ev = _evaluator()
    info = _info([5, 3, 4, 6], [4, 3, 2, 4])
    assert ev.verify(info, torch_device="cpu")


def test_verify_fails_on_a_wrong_layer(monkeypatch):
    """``verify`` compares two executors: one that is off by an ulp in
    one layer fails it."""
    ev = _evaluator()
    info = _info([5, 3, 4, 6], [4, 3, 2, 4])
    run_layer = CudaExecutor.run_layer

    def off(self, index, x_q):
        out = run_layer(self, index, x_q)
        if index == 2:
            out = torch.nextafter(out, torch.full_like(out, np.inf))
        return out
    monkeypatch.setattr(CudaExecutor, "run_layer", off)
    assert not ev.verify(info, torch_device="cpu")


def test_verify_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _evaluator().verify(_info([4] * 4, [4] * 4))


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


def _carried_agents(monkeypatch):
    """The port's search builds its agent with the reference agent's
    weights for the same config and seed (the reference's search keeps
    its own agent)."""
    def make(cfg, seed=0):
        agent_j = ddpg_jax.DDPGAgent(ddpg_jax.DDPGConfig(
            **dataclasses.asdict(cfg)), seed=seed)
        return agent_from_numpy(cfg, _jax_params(agent_j), seed=seed,
                                device=CPU)
    monkeypatch.setattr(search_port, "DDPGAgent", make)


def _configs(res) -> list:
    return [(r["key"], r["reward_source"]) for r in res.elites]


def test_search_loop_chooses_the_reference_configs(monkeypatch):
    """Three episodes of full-size resnet18's search loop, both agents on
    the same weights (the agent learns from the second episode on): the
    same configurations, rewards within :data:`REWARD_TOL`."""
    _carried_agents(monkeypatch)
    kw = dict(network="resnet18", target_latency_ms=35.0, episodes=3,
              seed=0)
    got = run_search(**kw)
    want = search_jax.run_search(**kw)
    assert np.abs(np.array(got.rewards) - np.array(want.rewards)).max() \
        <= REWARD_TOL
    assert _configs(got) == _configs(want)
    assert got.best_info["bw_lut"] == want.best_info["bw_lut"]
    assert got.best_info["ba"] == want.best_info["ba"]
    assert got.best_info["n_luts"] == want.best_info["n_luts"]
    _same_info({k: v for k, v in got.best_info.items()},
               {k: v for k, v in want.best_info.items()})


def test_two_tier_search_chooses_the_reference_configs(monkeypatch):
    _carried_agents(monkeypatch)
    kw = dict(specs=SPECS, target_latency_ms=0.2, episodes=6,
              simulate_elites=True, top_k=2, sim_every=3, baseline_acc=70.0,
              seed=0)
    got = run_search(**kw)
    want = search_jax.run_search(**{**kw, "specs": SPECS_JAX})
    assert _configs(got) == _configs(want)
    assert got.best_reward == pytest.approx(want.best_reward, abs=REWARD_TOL)
    assert got.simulated_latency_ms == want.simulated_latency_ms
    assert got.evaluator_cache == want.evaluator_cache


def test_cli_prints_the_reference_example(monkeypatch, capsys):
    """``python -m repro_torch.dse`` with the README's arguments (fewer
    episodes) prints what ``examples/dse_search.py`` prints, both agents
    on the same weights."""
    _carried_agents(monkeypatch)
    argv = ["--network", "llama3.2-1b", "--seq-len", "16", "--target", "1.0",
            "--episodes", "4", "--simulate-elites", "--top-k", "2",
            "--sim-every", "2"]
    assert dse_main(argv + ["--torch-device", "cpu"]) == 0
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["dse_search.py", *argv])
    runpy.run_path("examples/dse_search.py", run_name="__main__")
    want = capsys.readouterr().out
    assert got == want
    assert "reward source: simulated" in got and "per-layer profile" in got


# -- mirrors of tests/test_dse_evaluator.py's searches ------------------------


def test_run_search_simulate_elites_smoke(tmp_path):
    res = run_search(specs=SPECS, target_latency_ms=0.2, episodes=6,
                     simulate_elites=True, top_k=2, sim_every=3,
                     baseline_acc=70.0, seed=0)
    assert res.reward_source == "simulated"
    assert res.analytical_latency_ms > 0
    assert res.simulated_latency_ms > 0
    assert res.best_info["reward_source"] == "simulated"
    row = res.table3_row()
    assert "sim_latency_ms" in row and "latency_ms" in row
    assert res.elites and res.elites[0]["rank"] == 1
    assert abs(res.sim_gap_pct) <= SIM_GAP_TOL_PCT
    res2 = run_search(specs=SPECS, target_latency_ms=0.2, episodes=6,
                      simulate_elites=True, top_k=2, sim_every=3,
                      baseline_acc=70.0, seed=0)
    assert res2.simulated_latency_ms == res.simulated_latency_ms
    csv_path = tmp_path / "cal.csv"
    res.write_calibration_csv(str(csv_path))
    header = csv_path.read_text().splitlines()[0]
    assert header.startswith("rank,") and "simulated_ms" in header


def test_run_search_registry_network_end_to_end():
    res = run_search(network="llama3.2-1b", seq_len=16,
                     target_latency_ms=1.0, episodes=4,
                     simulate_elites=True, top_k=2, sim_every=2, seed=0)
    assert res.reward_source == "simulated"
    assert res.analytical_latency_ms > 0 and res.simulated_latency_ms > 0
    assert abs(res.sim_gap_pct) <= SIM_GAP_TOL_PCT
    ev = ProgramEvaluator(gemm_specs("llama3.2-1b", seq_len=16), DEV, 1.0)
    assert ev.verify(res.best_info, torch_device="cpu")


def test_run_search_analytical_unchanged():
    res = run_search(specs=SPECS, target_latency_ms=0.2, episodes=4,
                     baseline_acc=70.0, seed=0)
    assert res.reward_source == "analytical"
    assert res.simulated_latency_ms is None
    assert "sim_latency_ms" not in res.table3_row()


def test_sim_gap_report_within_documented_tolerance():
    rep = sim_gap_report("tiny", specs=SPECS)
    assert rep == evaluator_jax.sim_gap_report("tiny", specs=SPECS_JAX)
    assert rep["BENCH"] == "dse.sim_gap"
    assert rep["within_tol"] and abs(rep["gap_pct"]) <= SIM_GAP_TOL_PCT
    assert rep["simulated_ms"] > 0 and rep["analytical_ms"] > 0


def test_shaped_reward_regimes():
    assert shaped_reward(2.0, 1.0, 70.0, 70.0, 0.01) <= -1.0
    r = shaped_reward(0.5, 1.0, 69.0, 70.0, 0.01)
    assert r == pytest.approx(-0.01)
    assert shaped_reward(0.9, 1.0, 69.0, 70.0, 0.01) == r


# ---------------------------------------------------------------------------
# Measured accuracy: elites re-scored through the compiled program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def accuracy_fn():
    """One 15-step reduced resnet18 reference, shared by the tests that
    need an ``accuracy_fn``; its programs run on ``CudaExecutor`` (the
    kernels' plain versions on the CPU)."""
    return make_accuracy_fn(cnn.reduced_config("resnet18"), n_samples=16,
                            batch=16, train_steps=15, backend="cuda",
                            torch_device="cpu")


def test_dse_elites_rescored_with_measured_accuracy(tmp_path, accuracy_fn):
    import csv
    cfg = cnn.reduced_config("resnet18")
    res = run_search("resnet18", specs=cnn.specs_for(cfg), episodes=4,
                     sim_every=2, top_k=2, simulate_elites=True,
                     accuracy_fn=accuracy_fn, target_latency_ms=50.0, seed=0)
    assert res.reward_source == "measured"
    assert res.elites
    for row in res.elites:
        assert row["reward_source"] == "measured"
        assert row["measured_acc"] is not None
        assert 0.0 <= row["measured_acc"] <= 100.0
    assert res.best_info["measured_acc"] is not None
    assert "measured_acc" in CALIBRATION_FIELDS
    path = tmp_path / "calib.csv"
    res.write_calibration_csv(str(path))
    rows = list(csv.DictReader(path.open()))
    assert all(r["reward_source"] == "measured" and r["measured_acc"]
               for r in rows)
    ev = ProgramEvaluator(cnn.specs_for(cfg), DEV, 50.0)
    assert ev.verify(res.best_info, torch_device="cpu")


def test_search_without_accuracy_fn_keeps_simulated_source():
    cfg = cnn.reduced_config("resnet18")
    res = run_search("resnet18", specs=cnn.specs_for(cfg), episodes=2,
                     sim_every=2, top_k=1, simulate_elites=True,
                     target_latency_ms=50.0, seed=0)
    assert res.reward_source == "simulated"
    assert all(r["measured_acc"] is None for r in res.elites)


def test_package_exports():
    import repro_torch.dse as dse
    assert dse.run_search is run_search and dse.DDPGAgent is DDPGAgent
    assert ddpg.agent_device is agent_device
    assert evaluator.SIM_GAP_TOL_PCT == evaluator_jax.SIM_GAP_TOL_PCT
    with contextlib.redirect_stdout(io.StringIO()):
        assert dse_main(["--network", "resnet18", "--episodes", "1",
                         "--torch-device", "cpu"]) == 0
