"""RAP online controller — paper Algorithm 3.

Given the Q-network, an incoming request (batch, seq_len) and the memory
budget, greedily removes blocks (masked argmax over Q) until the analytical
peak fits. Produces a block mask; the serving runtime turns it into gates.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dqn as dqn_lib
from repro_torch.core import gsi as gsi_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core.env import EnvConfig
from repro_torch.core.memory import MemoryModel


@dataclasses.dataclass
class Decision:
    mask: np.ndarray
    steps: int
    peak_bytes: float
    fits: bool
    latency_s: float
    cached: bool = False      # served from the (bucket, shape) memo table
    # per-request KV storage precision (None = the pool's precision),
    # stamped by the policy and checked by KVPool.check_kv_dtype
    kv_dtype: Optional[str] = None


class RAPController:
    """Holds (Q-params, GSI scorer, memory model) for one served model."""

    def __init__(self, model, params, calib_batch, mm: MemoryModel,
                 q_params: dict, env_cfg: EnvConfig = EnvConfig(),
                 chunk: int = 8, recompute_scores: bool = True):
        self.model = model
        self.params = params
        self.mm = mm
        self.q_params = q_params
        self.env_cfg = env_cfg
        self.L = model.cfg.n_layers
        self.recompute = recompute_scores
        self._scorer = gsi_lib.make_candidate_scorer(model, calib_batch,
                                                     chunk=chunk)
        self._ppl = gsi_lib.make_ppl_fn(model, calib_batch)
        self._dense_cache: Optional[np.ndarray] = None
        self._memo: Dict[Tuple, Decision] = {}

    def _importance(self, mask: np.ndarray) -> np.ndarray:
        if not self.recompute and self._dense_cache is not None:
            return self._dense_cache
        cur = self._ppl(self.params, mask)
        imp = gsi_lib.importance_scores(self._scorer(self.params, mask), cur)
        if self._dense_cache is None:
            self._dense_cache = imp
        return imp

    def _obs(self, mask, imp, bs, sql, budget) -> np.ndarray:
        peak = self.mm.peak_bytes(mask, bs, sql)
        dense = self.mm.dense_peak(bs, sql)
        c = self.env_cfg
        return np.concatenate([
            [bs / c.bs_norm, sql / c.sql_norm],
            imp[: self.L] / c.imp_norm, imp[self.L:] / c.imp_norm,
            [budget / dense, peak / dense],
        ]).astype(np.float32)

    def decide(self, bs: int, sql: int, budget_bytes: float, *,
               reserved_bytes: float = 0.0, memo: bool = True) -> Decision:
        """Algorithm 3: prune until Mem_peak ≤ B (or STOP / exhaustion),
        against ``budget_bytes - reserved_bytes``. Decisions are memoized by
        (batch, seq, effective-budget/dense-peak ratio to 0.1%)."""
        t0 = time.perf_counter()
        budget_bytes = budget_bytes - reserved_bytes
        key = (int(bs), int(sql),
               round(budget_bytes / max(self.mm.dense_peak(bs, sql), 1.0), 3))
        if memo and key in self._memo:
            d = self._memo[key]
            # fits is re-derived against THIS call's budget: the memo cell
            # quantizes to 0.1% of dense
            return dataclasses.replace(
                d, mask=d.mask.copy(), cached=True,
                fits=d.peak_bytes <= budget_bytes,
                latency_s=time.perf_counter() - t0)
        mask = masks_lib.full_mask(self.L)
        imp = self._importance(mask)
        steps = 0
        while (self.mm.peak_bytes(mask, bs, sql) > budget_bytes
               and steps < 2 * self.L):
            s = self._obs(mask, imp, bs, sql, budget_bytes)
            q = dqn_lib.q_apply(self.q_params, torch.from_numpy(s)).numpy()
            # memory-aware action mask: while over budget, STOP is invalid
            stop_ok = (not self.env_cfg.mask_stop_until_fit) or not mask.any()
            valid = np.concatenate([[stop_ok], mask])
            if not valid.any():
                break
            q[~valid] = dqn_lib.NEG
            a = int(np.argmax(q))
            if a == 0:
                break
            mask = masks_lib.remove_block(mask, a - 1)
            steps += 1
            if self.recompute:
                imp = self._importance(mask)
        peak = self.mm.peak_bytes(mask, bs, sql)
        d = Decision(mask=mask, steps=steps, peak_bytes=peak,
                     fits=peak <= budget_bytes,
                     latency_s=time.perf_counter() - t0)
        if memo:
            self._memo[key] = dataclasses.replace(d, mask=mask.copy())
        return d
