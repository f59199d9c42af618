"""Pruning policies — the decision seam of the serving engine.

    PolicyState (what the engine observes at admission time)
        │
        ▼
    PruningPolicy.observe(state) ──► Decision (block keep-mask + peak)
        ▲                                  │
        └── PruningPolicy.feedback(result) ┘  (after the request completes)

Implementations: :class:`RLPolicy` (the paper's DQN controller,
Algorithm 3), :class:`StaticOrderPolicy` (every static baseline of
``repro_torch.core.baselines`` — ShortGPT, LLMPruner, MHA-drop, FFN-skip,
one-shot PPL, random drop: a removal order scored once per served model,
then each observation removes blocks in that order until the analytical
peak fits the live budget) and :class:`DensePolicy` (never prunes).
``make_policy`` builds a registered policy from the serving context
(model, params, calibration batch, memory model, controller, seed).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import baselines as baselines_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core.controller import Decision, RAPController
from repro_torch.core.memory import MemoryModel

__all__ = ["Decision", "PolicyState", "PruningPolicy", "RLPolicy",
           "StaticOrderPolicy", "DensePolicy", "POLICIES", "available_policies", "make_policy",
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
    # KV storage precision this policy asks the engine to serve requests at
    # ("fp32"/"bf16"/"int8"/"fp8", or None = the pool's own); every
    # Decision carries it and the pool rejects a mismatch
    kv_dtype: Optional[str] = None

    def observe(self, state: PolicyState) -> Decision:
        raise NotImplementedError

    def _stamp(self, d: Decision) -> Decision:
        """Attach this policy's requested KV precision to a Decision."""
        if self.kv_dtype is None or d.kv_dtype == self.kv_dtype:
            return d
        return dataclasses.replace(d, kv_dtype=self.kv_dtype)

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
        return self._stamp(self.controller.decide(
            state.batch, state.total_len, state.budget_bytes))


class DensePolicy(PruningPolicy):
    """Never prunes — the dense upper bound (and worst-case admission)."""

    name = "dense"

    def __init__(self, mm: MemoryModel):
        self.mm = mm

    def observe(self, state: PolicyState) -> Decision:
        mask = masks_lib.full_mask(self.mm.n_layers)
        peak = self.mm.peak_bytes(mask, state.batch, state.total_len)
        return self._stamp(Decision(mask=mask, steps=0, peak_bytes=peak,
                                    fits=peak <= state.budget_bytes,
                                    latency_s=0.0))


class StaticOrderPolicy(PruningPolicy):
    """Prune blocks in a fixed precomputed order until the peak fits.

    The order (the expensive probe: cosine influence, Taylor saliency,
    Δppl rank, …) is computed once, before construction; each ``observe``
    is a cheap analytical loop, memoized on the (batch, total,
    budget / dense peak) grid the RL controller uses."""

    def __init__(self, mm: MemoryModel, order, name: str):
        self.mm = mm
        self.order = [int(b) for b in order]
        self.name = name
        self._memo: Dict[Tuple, Decision] = {}

    def observe(self, state: PolicyState) -> Decision:
        t0 = time.perf_counter()
        bs, sql, budget = state.batch, state.total_len, state.budget_bytes
        key = (int(bs), int(sql),
               round(budget / max(self.mm.dense_peak(bs, sql), 1.0), 3))
        if key in self._memo:
            d = self._memo[key]
            return self._stamp(dataclasses.replace(
                d, mask=d.mask.copy(), cached=True,
                fits=d.peak_bytes <= budget,
                latency_s=time.perf_counter() - t0))
        mask = baselines_lib.prune_by_order(self.order, self.mm, bs, sql,
                                            budget)
        peak = self.mm.peak_bytes(mask, bs, sql)
        d = Decision(mask=mask, steps=int(2 * self.mm.n_layers - mask.sum()),
                     peak_bytes=peak, fits=peak <= budget,
                     latency_s=time.perf_counter() - t0)
        self._memo[key] = dataclasses.replace(d, mask=mask.copy())
        return self._stamp(d)


# ---------------------------------------------------------------- registry
PolicyBuilder = Callable[..., PruningPolicy]
POLICIES: Dict[str, PolicyBuilder] = {}


def register_policy(name: str):
    """Decorator: register a builder under ``name`` for ``make_policy``."""
    def deco(builder: PolicyBuilder) -> PolicyBuilder:
        POLICIES[name] = builder
        return builder
    return deco


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(POLICIES))


def make_policy(name: str, *, model=None, params=None, calib=None,
                mm: Optional[MemoryModel] = None,
                controller: Optional[RAPController] = None,
                seed: int = 0) -> PruningPolicy:
    """Build a registered policy from the serving context: ``rl`` needs a
    ``controller``; the static baselines need (model, params, calib, mm)
    to score their removal order; ``random`` and ``dense`` need only
    (model,) mm."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; available: "
                       f"{', '.join(available_policies())}")
    return POLICIES[name](model=model, params=params, calib=calib, mm=mm,
                          controller=controller, seed=seed)


def _require(name, **kwargs):
    missing = [k for k, v in kwargs.items() if v is None]
    if missing:
        raise ValueError(f"policy {name!r} requires {', '.join(missing)}")


@register_policy("rl")
def _build_rl(*, controller=None, **_):
    _require("rl", controller=controller)
    return RLPolicy(controller)


@register_policy("dense")
def _build_dense(*, mm=None, **_):
    _require("dense", mm=mm)
    return DensePolicy(mm)


@register_policy("random")
def _build_random(*, model=None, mm=None, seed=0, **_):
    _require("random", model=model, mm=mm)
    order = baselines_lib.random_drop_order(model, mm, seed=seed)
    return StaticOrderPolicy(mm, order, "random")


def _static_builder(name: str, order_fn):
    @register_policy(name)
    def build(*, model=None, params=None, calib=None, mm=None, **_):
        _require(name, model=model, params=params, calib=calib, mm=mm)
        return StaticOrderPolicy(mm, order_fn(model, params, calib, mm), name)
    return build


_static_builder("shortgpt", baselines_lib.shortgpt_order)
_static_builder("mha_drop", baselines_lib.mha_drop_order)
_static_builder("ffn_skip", baselines_lib.ffn_skip_order)
_static_builder("llmpruner", baselines_lib.llmpruner_order)
_static_builder("oneshot",
                lambda model, params, calib, mm:
                baselines_lib.oneshot_ppl_order(model, params, calib))
