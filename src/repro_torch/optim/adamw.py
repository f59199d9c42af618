"""AdamW + global-norm clipping + schedules, as functions on dicts of
tensors.

The semantics are those of the JAX package's ``optim/adamw.py``, which
``torch.optim.AdamW`` with ``clip_grad_norm_`` does not share: ``b2``
defaults to 0.95, ``eps`` is added outside the square root, the clip
scale is ``min(1, clip / (‖g‖ + 1e-9))`` (torch's clip uses 1e-6), bias
correction takes the step as f32, and the schedule is constant, cosine or
linear with a linear warmup. Parameters are (possibly nested) dicts of
tensors; the moments are f32 dicts of the same structure, on the
parameters' device, and so is the step counter: an update on the card
reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import flatten


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"  # cosine|linear|constant
    min_lr_ratio: float = 0.1


def _tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(params) -> list:
    """The leaves in the JAX package's order (dict keys sorted)."""
    return list(flatten(params).values())


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (f32 scalar tensor)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        else:
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - t)
    return cfg.lr * warm * decay


def init(params) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    device = _leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=_tree_map(zeros, params),
                      nu=_tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in _leaves(tree)))


def apply(cfg: AdamWConfig, params, grads, state: AdamWState, *,
          grad_norm=None):
    """Returns (new_params, new_state, metrics). ``grad_norm``: the global
    norm to clip by when the caller holds only blocks of the gradients (a
    mesh: ``steps.make_sharded_train_step``); default, that of ``grads``."""
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm > 0 else 1.0)
    step = state.step + 1
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if cfg.weight_decay > 0:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = _tree_map(lambda *a: upd(*a), params, grads, state.mu, state.nu)
    pick = lambda i: _tree_map(lambda o: o[i], out)
    return (pick(0), AdamWState(step, pick(1), pick(2)),
            {"grad_norm": gnorm, "lr": lr})
