"""Pruning MDP environment — paper Appendix A.1/A.2.

State  s_t = (R_bs, R_sql) ⧺ GSI importance of every MHA/FFN block on the
current contracted model ⧺ (Sys_avail, predicted Sys_req) → ℝ^{2L+4}.
Action 0 = STOP; action 1+b removes block b. Episode ends on STOP or when
the analytical peak memory fits the budget. Reward is Eq. (2).

The scoring forwards (``gsi.make_candidate_scorer``, ``gsi.make_ppl_fn``)
run on the calibration batch's device: on the card they launch the flash
attention and fused GLU kernels (or ``ssd`` / ``rglru`` on the recurrent
layouts). ``forwards`` counts them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import gsi as gsi_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core.memory import MemoryModel


@dataclasses.dataclass
class EnvConfig:
    alpha: float = 1.0        # R_ppl weight (paper: 1.0)
    beta: float = 0.3         # R_mem weight (paper: 0.3)
    gamma: float = 0.99
    bs_norm: float = 32.0     # state normalizers
    sql_norm: float = 4096.0
    imp_norm: float = 1.0     # importance scores are Δlog-ppl; O(1) already
    fast_scores: bool = False # True → skip per-step GSI recompute (RAP^-GSI-ish
                              # env used only for speed-insensitive tests)
    mask_stop_until_fit: bool = True  # the paper's memory-aware action mask:
                              # STOP is invalid while peak memory > budget


class PruneEnv:
    """One episode = prune-to-budget for a sampled (batch, seq, budget)."""

    def __init__(self, model, params, calib_batch, mm: MemoryModel,
                 cfg: EnvConfig = EnvConfig(), chunk: int = 8):
        self.model = model
        self.params = params
        self.mm = mm
        self.cfg = cfg
        self.L = model.cfg.n_layers
        self.n_actions = 2 * self.L + 1
        self.state_dim = 2 * self.L + 4
        self.chunk = chunk
        self._scorer = gsi_lib.make_candidate_scorer(model, calib_batch,
                                                     chunk=chunk)
        self._ppl = gsi_lib.make_ppl_fn(model, calib_batch)
        self._dense_scores: Optional[np.ndarray] = None
        self.forwards = 0     # scoring forwards run (model.logits calls)

    # ------------------------------------------------------------------ state
    def _scores(self, mask: np.ndarray) -> Tuple[np.ndarray, float]:
        m = np.asarray(mask, np.float32)
        cur = float(self._ppl(self.params, m))
        self.forwards += 1
        if self.cfg.fast_scores and self._dense_scores is not None:
            raw = self._dense_scores
        else:
            raw = np.asarray(self._scorer(self.params, m))
            self.forwards += -(-int(m.sum()) // self.chunk)
            if self._dense_scores is None:
                self._dense_scores = raw
        return gsi_lib.importance_scores(raw, cur), cur

    def _obs(self) -> np.ndarray:
        imp = self._imp / self.cfg.imp_norm
        peak = self.mm.peak_bytes(self.mask, self.bs, self.sql)
        dense = self.mm.dense_peak(self.bs, self.sql)
        return np.concatenate([
            [self.bs / self.cfg.bs_norm, self.sql / self.cfg.sql_norm],
            imp[: self.L], imp[self.L:],
            [self.budget / dense, peak / dense],
        ]).astype(np.float32)

    def valid_actions(self) -> np.ndarray:
        v = np.zeros(self.n_actions, bool)
        v[0] = self.fits() if self.cfg.mask_stop_until_fit else True
        v[1:] = self.mask
        if not v.any():
            v[0] = True   # nothing left to prune — STOP must be legal
        return v

    # --------------------------------------------------------------- episode
    def reset(self, bs: int, sql: int, budget_bytes: float) -> np.ndarray:
        self.bs, self.sql, self.budget = bs, sql, float(budget_bytes)
        self.mask = masks_lib.full_mask(self.L)
        self._imp, self._cur_logppl = self._scores(self.mask)
        self.t = 0
        self._prev_pot = self._potential()
        return self._obs()

    def _potential(self) -> float:
        """Eq. (2): Σ_i kept_i (α·R_ppl_i − β·R_mem_i), normalized terms."""
        imp = self._imp / self.cfg.imp_norm
        memb = self.mm.block_bytes(self.bs, self.sql)
        dense = self.mm.dense_peak(self.bs, self.sql)
        r = self.mask @ (self.cfg.alpha * imp
                         - self.cfg.beta * memb / dense * len(memb))
        return float(r) / len(memb)

    def _reward(self) -> float:
        """Potential-based shaping of Eq. (2): the step reward is the DELTA
        of the kept-set utility, telescoping to the terminal value. The raw
        per-step form rewards episode length (an agent learns to remove
        cheap low-memory blocks to stay over budget longer and farm
        positive steps); the delta form makes 'remove high-memory,
        low-importance blocks' the locally-rewarded action, which is the
        paper's intent."""
        pot = self._potential()
        prev = getattr(self, "_prev_pot", pot)
        self._prev_pot = pot
        return pot - prev

    def fits(self) -> bool:
        return self.mm.peak_bytes(self.mask, self.bs, self.sql) <= self.budget

    def step(self, action: int):
        """Returns (obs, reward, done, info)."""
        self.t += 1
        if action == 0:
            done = True
        else:
            b = action - 1
            if not self.mask[b]:
                raise ValueError(f"block {b} already pruned")
            self.mask = masks_lib.remove_block(self.mask, b)
            self._imp, self._cur_logppl = self._scores(self.mask)
            done = self.fits() or self.t >= 2 * self.L
        reward = self._reward()
        info = {"mask": self.mask.copy(), "log_ppl": self._cur_logppl,
                "peak": self.mm.peak_bytes(self.mask, self.bs, self.sql),
                "fits": self.fits()}
        return self._obs(), reward, done, info
