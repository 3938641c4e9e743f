"""DDPG (Lillicrap et al.) on torch — the paper's §5.4 search agent.

The counterpart of ``repro.dse.ddpg``. Actor: state -> action in [0, 1]
(sigmoid head — the paper discretizes continuous actions into the
design-factor ranges, Eqs. 13-14). Critic: (state, action) -> Q. Target
networks track with soft updates. Exploration: Gaussian noise with
exponential decay (the HAQ / AMC recipe the paper builds on).

The networks are ``nn.Module`` MLPs on one torch device, initialised
from ``torch.Generator(seed)`` with the reference's law (N(0, 2/fan_in)
weights, zero biases). Adam and the soft target update are written out
as the reference writes them (bias correction in float32 from the shared
step count, epsilon outside the square root), not ``torch.optim.Adam``.
The replay buffer and the exploration noise are host-side numpy on
``np.random.default_rng(seed)``, exactly as in the reference, so sampled
batches and noise draws are the reference's. :func:`agent_from_numpy`
carries a reference agent's weights across.

An agent lives on ``device``; left out, on the device of the innermost
:func:`agent_device` block, which is ``"cuda"`` outside any (how
``python -m repro_torch.dse --torch-device`` places the agents that
``run_search`` makes).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.compiler.runtime.base import resolve_device

_DEVICE: contextvars.ContextVar = contextvars.ContextVar("agent_device",
                                                         default="cuda")


@contextlib.contextmanager
def agent_device(device):
    """Agents made inside the block without a ``device`` live on
    ``device``."""
    token = _DEVICE.set(device)
    try:
        yield
    finally:
        _DEVICE.reset(token)


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    state_dim: int
    action_dim: int = 1
    hidden: tuple[int, ...] = (64, 64)
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01              # soft target update
    buffer_size: int = 20000
    batch_size: int = 64
    noise_sigma: float = 0.5
    noise_decay: float = 0.99
    noise_min: float = 0.02


class MLP(nn.Module):
    """x @ w + b per layer, relu between layers, an optional sigmoid
    head; ``w`` is [fan_in, fan_out] as in the reference."""

    def __init__(self, sizes, generator: torch.Generator, device,
                 final_sigmoid: bool = False):
        super().__init__()
        self.final_sigmoid = final_sigmoid
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((a, b), generator=generator) * (2.0 / a) ** 0.5
            self.w.append(nn.Parameter(w.to(device)))
            self.b.append(nn.Parameter(torch.zeros(b, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.relu(x)
        return torch.sigmoid(x) if self.final_sigmoid else x

    def load_numpy(self, layers) -> None:
        """Set the weights from the reference's ``[{"w", "b"}, ...]``."""
        with torch.no_grad():
            for w, b, layer in zip(self.w, self.b, layers, strict=True):
                w.copy_(torch.from_numpy(np.array(layer["w"])))
                b.copy_(torch.from_numpy(np.array(layer["b"])))

    def to_numpy(self) -> list[dict]:
        return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                for w, b in zip(self.w, self.b)]


class ReplayBuffer:
    def __init__(self, size: int, state_dim: int, action_dim: int):
        self.size = size
        self.s = np.zeros((size, state_dim), np.float32)
        self.a = np.zeros((size, action_dim), np.float32)
        self.r = np.zeros((size,), np.float32)
        self.s2 = np.zeros((size, state_dim), np.float32)
        self.done = np.zeros((size,), np.float32)
        self.n = 0
        self.ptr = 0

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.done[i] = s2, float(done)
        self.ptr = (self.ptr + 1) % self.size
        self.n = min(self.n + 1, self.size)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.n, batch)
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.done[idx])


class DDPGAgent:
    def __init__(self, cfg: DDPGConfig, seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(_DEVICE.get() if device is None
                                     else device)
        gen = torch.Generator().manual_seed(seed)
        actor_sizes = (cfg.state_dim, *cfg.hidden, cfg.action_dim)
        critic_sizes = (cfg.state_dim + cfg.action_dim, *cfg.hidden, 1)
        self.actor = MLP(actor_sizes, gen, self.device, final_sigmoid=True)
        self.critic = MLP(critic_sizes, gen, self.device)
        self.actor_t = copy.deepcopy(self.actor).requires_grad_(False)
        self.critic_t = copy.deepcopy(self.critic).requires_grad_(False)
        self.buffer = ReplayBuffer(cfg.buffer_size, cfg.state_dim,
                                   cfg.action_dim)
        self.np_rng = np.random.default_rng(seed)
        self.sigma = cfg.noise_sigma

    # -- acting ------------------------------------------------------------

    def act(self, state: np.ndarray, explore: bool = True) -> np.ndarray:
        with torch.no_grad():
            s = torch.as_tensor(np.asarray(state, np.float32),
                                device=self.device)[None]
            a = self.actor(s)[0].cpu().numpy()
        if explore:
            a = a + self.np_rng.normal(0.0, self.sigma, a.shape)
        return np.clip(a, 0.0, 1.0)

    def decay_noise(self):
        self.sigma = max(self.cfg.noise_min,
                         self.sigma * self.cfg.noise_decay)

    # -- learning ----------------------------------------------------------

    def _adam(self, net: MLP, m: list, v: list, lr: float) -> None:
        """One Adam step in place, as the reference writes it."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        tf = self._t.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, device=self.device), tf)
        c2 = 1 - torch.pow(torch.tensor(b2, device=self.device), tf)
        with torch.no_grad():
            for p, mm, vv in zip(net.parameters(), m, v):
                g = p.grad
                mm.copy_(b1 * mm + (1 - b1) * g)
                vv.copy_(b2 * vv + (1 - b2) * g * g)
                p.copy_(p - lr * (mm / c1) / (torch.sqrt(vv / c2) + eps))
                p.grad = None

    def _soft(self, target: MLP, net: MLP) -> None:
        tau = self.cfg.tau
        with torch.no_grad():
            for tt, pp in zip(target.parameters(), net.parameters()):
                tt.copy_((1 - tau) * tt + tau * pp)

    def _update(self, batch) -> None:
        cfg = self.cfg
        s, a, r, s2, done = batch
        self._t += 1
        # critic on the targets' bootstrap
        with torch.no_grad():
            a2 = self.actor_t(s2)
            q2 = self.critic_t(torch.cat([s2, a2], -1))[:, 0]
            target = r + cfg.gamma * (1.0 - done) * q2
        q = self.critic(torch.cat([s, a], -1))[:, 0]
        torch.mean(torch.square(q - target)).backward()
        self._adam(self.critic, self._mc, self._vc, cfg.critic_lr)
        # actor through the updated critic
        self.critic.requires_grad_(False)
        try:
            a_pi = self.actor(s)
            q_pi = self.critic(torch.cat([s, a_pi], -1))[:, 0]
            (-torch.mean(q_pi)).backward()
        finally:
            self.critic.requires_grad_(True)
        self._adam(self.actor, self._ma, self._va, cfg.actor_lr)
        self._soft(self.actor_t, self.actor)
        self._soft(self.critic_t, self.critic)

    def _init_opt(self):
        zeros = lambda net: [torch.zeros_like(p) for p in net.parameters()]  # noqa: E731
        self._t = torch.zeros((), dtype=torch.int32, device=self.device)
        self._ma, self._va = zeros(self.actor), zeros(self.actor)
        self._mc, self._vc = zeros(self.critic), zeros(self.critic)

    def remember(self, s, a, r, s2, done):
        self.buffer.add(s, a, r, s2, done)

    def remember_episode(self, transitions, reward: float):
        """Store a whole episode under one terminal reward (the paper's
        episode-level sparse reward assignment): every transition gets
        ``reward``. Also the elite-correction hook of the two-tier DSE
        loop — when the simulator re-scores an elite config, its episode
        is re-injected with the corrected reward, so the critic learns
        from the compiled program's latency, not just the closed form.
        """
        for (s, a, _r, s2, done) in transitions:
            self.buffer.add(s, a, reward, s2, done)

    def learn(self, n_updates: int = 1):
        if self.buffer.n < self.cfg.batch_size:
            return
        if not hasattr(self, "_t"):
            self._init_opt()
        for _ in range(n_updates):
            batch = self.buffer.sample(self.np_rng, self.cfg.batch_size)
            self._update(tuple(torch.from_numpy(x).to(self.device)
                               for x in batch))

    # -- carrying weights --------------------------------------------------

    def params_numpy(self) -> dict:
        """Actor, critic and target weights as the reference's
        ``[{"w", "b"}, ...]`` lists of numpy arrays."""
        return {name: getattr(self, name).to_numpy()
                for name in ("actor", "critic", "actor_t", "critic_t")}


def agent_from_numpy(cfg: DDPGConfig, params: dict, seed: int = 0,
                     device=None) -> DDPGAgent:
    """An agent whose actor, critic and targets hold ``params`` (the
    reference agent's ``actor``/``critic``/``actor_t``/``critic_t``
    lists, numpy or JAX arrays), with the reference's replay and noise
    generator for ``seed``."""
    agent = DDPGAgent(cfg, seed=seed, device=device)
    for name in ("actor", "critic", "actor_t", "critic_t"):
        getattr(agent, name).load_numpy(params[name])
    return agent
