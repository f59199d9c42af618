"""Masked DQN controller network — paper Appendix A.3/A.4.

The compact 2-layer MLP Q-network the RAP controller acts with. Its
parameters stay f32 on the CPU: the controller reads one Q vector per
pruning step on the host. Training (``Replay``, ``td_update``, ``train``)
are ROADMAP queue 1, item 3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
