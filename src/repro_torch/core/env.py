"""Pruning MDP settings — paper Appendix A.1/A.2.

Only ``EnvConfig`` is ported so far: the controller normalizes its state
with it. The training environment ``PruneEnv`` is ROADMAP queue 1,
item 3.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class EnvConfig:
    alpha: float = 1.0        # R_ppl weight (paper: 1.0)
    beta: float = 0.3         # R_mem weight (paper: 0.3)
    gamma: float = 0.99
    bs_norm: float = 32.0     # state normalizers
    sql_norm: float = 4096.0
    imp_norm: float = 1.0     # importance scores are Δlog-ppl; O(1) already
    fast_scores: bool = False
    mask_stop_until_fit: bool = True  # the paper's memory-aware action mask:
                              # STOP is invalid while peak memory > budget
