"""Masked DQN controller — paper Appendix A.3/A.4 (Algorithm 2).

The compact 2-layer MLP Q-network, masked ε-greedy behaviour policy,
uniform replay, soft target updates and AdamW (``repro_torch.optim``, the
JAX package's semantics). The Q-network stays f32 on the CPU: the
controller reads one Q vector per pruning step on the host, and a TD
update over a 64-row batch of a ~6K-parameter MLP is too small to be worth
a launch. Only the environment's GSI scoring forwards run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.optim import adamw

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    hidden: int = 64
    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01            # soft target update
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_episodes: int = 60
    buffer_size: int = 20000
    batch_size: int = 64
    train_iters_per_step: int = 1


def init_qnet(gen: torch.Generator, state_dim: int, n_actions: int,
              hidden: int) -> dict:
    """Random Q-network from a CPU ``torch.Generator``."""
    s1 = 1.0 / np.sqrt(state_dim)
    s2 = 1.0 / np.sqrt(hidden)
    return {
        "w1": torch.randn(state_dim, hidden, generator=gen) * s1,
        "b1": torch.zeros(hidden),
        "w2": torch.randn(hidden, n_actions, generator=gen) * s2,
        "b2": torch.zeros(n_actions),
    }


def q_apply(params, s):
    h = torch.tanh(s @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def n_params(params) -> int:
    return sum(int(np.prod(p.shape)) for p in params.values())


class Replay:
    def __init__(self, size: int, state_dim: int, n_actions: int):
        self.size, self.ptr, self.full = size, 0, False
        self.s = np.zeros((size, state_dim), np.float32)
        self.a = np.zeros((size,), np.int32)
        self.r = np.zeros((size,), np.float32)
        self.s2 = np.zeros((size, state_dim), np.float32)
        self.d = np.zeros((size,), np.float32)
        self.valid2 = np.zeros((size, n_actions), bool)

    def add(self, s, a, r, s2, d, valid2):
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.d[i], self.valid2[i] = s2, d, valid2
        self.ptr = (i + 1) % self.size
        self.full = self.full or self.ptr == 0

    def __len__(self):
        return self.size if self.full else self.ptr

    def sample(self, rng: np.random.Generator, n: int):
        idx = rng.integers(0, len(self), size=n)
        return (self.s[idx], self.a[idx], self.r[idx], self.s2[idx],
                self.d[idx], self.valid2[idx])


def td_update(qp: dict, tp: dict, opt_state, batch, gamma: float,
              opt_cfg_lr: float):
    """One TD step on ``batch = (s, a, r, s2, d, valid2)`` (tensors):
    the mean squared error of Q(s, a) against ``r + γ (1 − d) max_a'
    Q_target(s2, a')`` over the valid next actions, the target held
    constant, then AdamW. Returns (q_params, opt_state, loss)."""
    s, a, r, s2, d, valid2 = batch
    leaves = {k: v.detach().requires_grad_(True) for k, v in qp.items()}
    q = q_apply(leaves, s)
    qa = torch.gather(q, 1, a.long()[:, None])[:, 0]
    with torch.no_grad():
        q2 = torch.where(valid2, q_apply(tp, s2), NEG)
        target = r + gamma * (1.0 - d) * torch.max(q2, dim=1).values
    loss = torch.mean(torch.square(qa - target))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    cfg = adamw.AdamWConfig(lr=opt_cfg_lr, weight_decay=0.0, clip_norm=1.0,
                            warmup_steps=0, schedule="constant")
    qp, opt_state, _ = adamw.apply(cfg, qp, grads, opt_state)
    return qp, opt_state, loss.detach()


def soft_update(tp: dict, qp: dict, tau: float) -> dict:
    return {k: (1 - tau) * t + tau * qp[k] for k, t in tp.items()}


def select_action(qp, s, valid: np.ndarray, eps: float,
                  rng: np.random.Generator) -> int:
    if rng.random() < eps:
        return int(rng.choice(np.nonzero(valid)[0]))
    q = q_apply(qp, torch.as_tensor(s)).numpy().copy()
    q[~valid] = NEG
    return int(np.argmax(q))


@dataclasses.dataclass
class TrainResult:
    q_params: dict
    episode_rewards: List[float]
    episode_fits: List[bool]
    losses: List[float]


def train(env_factory: Callable[[], object], *, episodes: int,
          cfg: DQNConfig = DQNConfig(), seed: int = 0,
          request_sampler: Optional[Callable] = None) -> TrainResult:
    """Algorithm 2. ``env_factory() → env``; ``request_sampler(rng) →
    (bs, sql, budget_bytes)`` samples the per-episode workload."""
    rng = np.random.default_rng(seed)
    env = env_factory()
    qp = init_qnet(torch.Generator().manual_seed(seed), env.state_dim,
                   env.n_actions, cfg.hidden)
    tp = {k: v.clone() for k, v in qp.items()}
    opt_state = adamw.init(qp)
    buf = Replay(cfg.buffer_size, env.state_dim, env.n_actions)

    rewards, fits, losses = [], [], []
    for ep in range(episodes):
        eps = max(cfg.eps_end,
                  cfg.eps_start - (cfg.eps_start - cfg.eps_end)
                  * ep / max(cfg.eps_decay_episodes, 1))
        bs, sql, budget = request_sampler(rng)
        s = env.reset(bs, sql, budget)
        total, done = 0.0, False
        while not done:
            valid = env.valid_actions()
            a = select_action(qp, s, valid, eps, rng)
            s2, r, done, info = env.step(a)
            buf.add(s, a, r, s2, float(done), env.valid_actions())
            s = s2
            total += r
            if len(buf) >= cfg.batch_size:
                for _ in range(cfg.train_iters_per_step):
                    batch = buf.sample(rng, cfg.batch_size)
                    qp, opt_state, loss = td_update(
                        qp, tp, opt_state,
                        tuple(torch.from_numpy(x) for x in batch),
                        cfg.gamma, cfg.lr)
                    losses.append(float(loss))
                tp = soft_update(tp, qp, cfg.tau)
        rewards.append(total)
        fits.append(bool(info["fits"]))
    return TrainResult(qp, rewards, fits, losses)
