"""RAP one-shot serving — a compatibility wrapper over the batching engine.

Per request the flow is the paper's online loop: observe (batch, length,
available-memory budget); ``PruningPolicy.observe()`` → block keep-mask;
run the pruned model; report memory and quality stats. Each ``serve()``
runs a one-request trace through :class:`RAPEngine` with ``force``
admission: one decision against a private budget, executed whether it fits
or not (the pool records the overcommit instead of queueing). Slot caches
are minted per power-of-two length (``len_buckets="pow2"``), so a long
prompt gets its own long-cache group and short serves keep theirs.

Two modes: ``structural`` (the default, as in JAX) runs the request in
its mask's retained-layer bucket — a group per (gather key, cache length)
— and ``masked`` runs all L layers with the mask as per-slot 0/1 gates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.policy import PruningPolicy
from repro_torch.runtime.engine import EngineConfig, EngineRequest, RAPEngine

__all__ = ["RAPServer", "ServeResult"]


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray           # [B, generated]
    mask: np.ndarray
    peak_bytes: float
    budget_bytes: float
    fits: bool
    decide_s: float
    infer_s: float
    bucket: Tuple                # the bucket signature; () in masked mode
    compiled_new: bool           # this serve minted a new slot group (the
                                 # port's one-time cost; nothing compiles)


class RAPServer:
    def __init__(self, model, params, policy: PruningPolicy = None, *,
                 mode: str = "structural", max_new_tokens: int = 16,
                 kv_dtype=None):
        if policy is None or not isinstance(policy, PruningPolicy):
            raise TypeError(f"RAPServer requires a PruningPolicy, got "
                            f"{type(policy).__name__}")
        if mode not in ("structural", "masked"):
            raise ValueError(f"unknown mode {mode!r}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.policy = policy
        self.mode = mode
        self.max_new = max_new_tokens
        self.kv_dtype = kv_dtype
        self._engine = RAPEngine(model, params, policy, EngineConfig(
            mode=mode, max_new_tokens=max_new_tokens, max_active=1,
            max_len=max_new_tokens + 1, kv_dtype=kv_dtype,
            admission="force", len_buckets="pow2"))
        self._serial = 0

    def serve(self, prompt_tokens: np.ndarray, budget_bytes: float,
              *, greedy: bool = True) -> ServeResult:
        B, S = prompt_tokens.shape
        self._engine.ensure_capacity(B, S + self.max_new)
        self._serial += 1
        req = EngineRequest(rid=f"serve-{self._serial}",
                            prompt=np.asarray(prompt_tokens, np.int32))
        minted = self._engine.executor.groups_minted
        report = self._engine.run([req], budget_bytes=budget_bytes)
        r = report.result(req.rid)
        return ServeResult(
            tokens=r.tokens, mask=r.mask, peak_bytes=r.peak_bytes,
            budget_bytes=budget_bytes, fits=r.fits, decide_s=r.decide_s,
            infer_s=max(report.wall_s - r.decide_s, 0.0), bucket=r.bucket,
            compiled_new=self._engine.executor.groups_minted > minted)

    def stats(self) -> Dict[str, int]:
        ex = self._engine.executor
        return {"structural_buckets": ex.stats()["structural_buckets"],
                "masked_groups": sum(g.key == "masked" for g in ex.groups())}
