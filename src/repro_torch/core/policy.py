"""Pruning policies — the decision seam of the serving engine.

    PolicyState (what the engine observes at admission time)
        │
        ▼
    PruningPolicy.observe(state) ──► Decision (block keep-mask + peak)
        ▲                                  │
        └── PruningPolicy.feedback(result) ┘  (after the request completes)

Implementations ported so far: :class:`RLPolicy` (the paper's DQN
controller, Algorithm 3) and :class:`DensePolicy` (never prunes). The
static baselines (ShortGPT, LLMPruner, …) are ROADMAP queue 1, item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import masks as masks_lib
from repro_torch.core.controller import Decision, RAPController
from repro_torch.core.memory import MemoryModel

__all__ = ["Decision", "PolicyState", "PruningPolicy", "RLPolicy",
           "DensePolicy", "POLICIES", "available_policies", "make_policy",
           "register_policy"]


@dataclasses.dataclass(frozen=True)
class PolicyState:
    """The engine's observation at admission time. ``budget_bytes`` is the
    *effective* budget this request must fit (total minus bytes reserved by
    in-flight requests, quantized by the engine's admission grid)."""
    batch: int
    total_len: int                 # prompt + generated tokens
    budget_bytes: float
    reserved_bytes: float = 0.0    # pool bytes held by in-flight requests
    capacity_bytes: float = 0.0    # pool capacity (0 when unpooled)
    n_running: int = 0
    now: float = 0.0               # engine virtual-clock timestamp


class PruningPolicy:
    """Protocol: map a :class:`PolicyState` to a keep-mask Decision.
    Subclasses set ``name`` and ``mm`` and implement :meth:`observe`."""

    name: str = "base"
    mm: MemoryModel
    kv_dtype: Optional[str] = None

    def observe(self, state: PolicyState) -> Decision:
        raise NotImplementedError

    def feedback(self, result) -> None:
        """Called with the completed request's ``RequestResult``."""
        return None


class RLPolicy(PruningPolicy):
    """The paper's RL agent: greedy masked-argmax over Q until the peak
    fits (Algorithm 3), memoized inside the controller."""

    name = "rl"

    def __init__(self, controller: RAPController):
        self.controller = controller
        self.mm = controller.mm

    def observe(self, state: PolicyState) -> Decision:
        return self.controller.decide(state.batch, state.total_len,
                                      state.budget_bytes)


class DensePolicy(PruningPolicy):
    """Never prunes — the dense upper bound (and worst-case admission)."""

    name = "dense"

    def __init__(self, mm: MemoryModel):
        self.mm = mm

    def observe(self, state: PolicyState) -> Decision:
        mask = masks_lib.full_mask(self.mm.n_layers)
        peak = self.mm.peak_bytes(mask, state.batch, state.total_len)
        return Decision(mask=mask, steps=0, peak_bytes=peak,
                        fits=peak <= state.budget_bytes, latency_s=0.0)


# ---------------------------------------------------------------- registry
PolicyBuilder = Callable[..., PruningPolicy]
POLICIES: Dict[str, PolicyBuilder] = {}

_LATER = ("shortgpt", "mha_drop", "ffn_skip", "llmpruner", "oneshot",
          "random")


def register_policy(name: str):
    """Decorator: register a builder under ``name`` for ``make_policy``."""
    def deco(builder: PolicyBuilder) -> PolicyBuilder:
        POLICIES[name] = builder
        return builder
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(POLICIES))


def make_policy(name: str, *, controller: Optional[RAPController] = None,
                mm: Optional[MemoryModel] = None, **_) -> PruningPolicy:
    if name in _LATER:
        raise NotImplementedError(
            f"policy {name!r} is a static baseline, ported with "
            f"core/baselines.py (ROADMAP queue 1, item 10)")
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{', '.join(available_policies())}")
    return POLICIES[name](controller=controller, mm=mm)


@register_policy("rl")
def _build_rl(*, controller=None, **_):
    if controller is None:
        raise ValueError("policy 'rl' requires controller")
    return RLPolicy(controller)


@register_policy("dense")
def _build_dense(*, mm=None, **_):
    if mm is None:
        raise ValueError("policy 'dense' requires mm")
    return DensePolicy(mm)
