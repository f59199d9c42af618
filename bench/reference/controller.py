"""The RAP controller's arithmetic, worked out again: the analytical peak
of paper Eq. (3)–(4) (parameter bytes of the kept blocks and the
embeddings, plus the KV bytes of the kept attention blocks for batch ×
tokens) and Algorithm 3's stopping rule; and the Q-network's greedy
choice over the blocks still kept, at each step's state.

Block b < L is layer b's attention block, b ≥ L layer b − L's FFN block.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


class Peak:
    """Eq. (3)–(4) for a configuration's ``model`` section, in integers."""

    def __init__(self, cfg: Dict):
        D, H = int(cfg["d_model"]), int(cfg["n_heads"])
        K, L = int(cfg["n_kv_heads"]), int(cfg["n_layers"])
        Dh = int(cfg.get("head_dim") or D // H)
        F = int(cfg["d_ff"])
        pb = _BYTES[cfg.get("param_dtype", "bfloat16")]
        kb = _BYTES[cfg.get("dtype", "bfloat16")]
        mixer = D * (H * Dh + 2 * K * Dh) + H * Dh * D + D
        if cfg.get("qkv_bias"):
            mixer += H * Dh + 2 * K * Dh
        ffn = 3 * D * F + D
        m = int(cfg.get("vocab_round_to", 512))
        Vp = -(-int(cfg["vocab_size"]) // m) * m
        embed = Vp * D * (1 if cfg.get("tie_embeddings", True) else 2) + D
        self.L = L
        self.mixer_bytes = mixer * pb
        self.ffn_bytes = ffn * pb
        self.embed_bytes = embed * pb
        self.kv_token_bytes = 2 * K * Dh * kb

    def __call__(self, mask, batch: int, tokens: int) -> int:
        m = np.asarray(mask, bool)
        mix, ffn = int(m[:self.L].sum()), int(m[self.L:].sum())
        return (mix * self.mixer_bytes + ffn * self.ffn_bytes
                + self.embed_bytes
                + mix * self.kv_token_bytes * int(batch) * int(tokens))


def decision_faults(peak: Peak, decisions) -> List[str]:
    """What each decision's mask, peak and fit get wrong against Eq.
    (3)–(4) and Algorithm 3's stopping rule (remove blocks while the peak
    exceeds the budget): a list of findings, empty when all hold.
    ``decisions``: (batch, total_len, budget, mask, steps, peak_bytes, fits,
    cached) tuples."""
    out = []
    for i, (b, n, budget, mask, steps, pk, fits, cached) in enumerate(
            decisions):
        m = np.asarray(mask, bool)
        want = peak(m, b, n)
        if abs(float(pk) - want) > 0.5:
            out.append(f"decision {i}: peak {pk} against {want}")
        if bool(fits) != (want <= budget):
            out.append(f"decision {i}: fits {fits} at peak {want} against "
                       f"budget {budget}")
        if cached:
            continue
        removed = np.flatnonzero(~m)
        if len(removed) != int(steps):
            out.append(f"decision {i}: {steps} steps, {len(removed)} "
                       f"blocks removed")
        if want > budget and m.any() and int(steps) < 2 * peak.L:
            out.append(f"decision {i}: stopped over budget")
        if len(removed) and not any(
                peak(_with(m, r), b, n) > budget for r in removed):
            out.append(f"decision {i}: removed a block past the fit")
    return out


def _with(mask, block):
    m = np.array(mask, copy=True)
    m[block] = True
    return m


# Algorithm 3's state: batch, length, importance and budget normalised as
# the paper's environment does; STOP is invalid while the peak is over the
# budget (the memory-aware action mask)
BS_NORM, SQL_NORM, IMP_NORM = 32.0, 4096.0, 1.0
# a choice counts as another only past f32 rounding of the Q-values
Q_TOL = 1e-4


def q_values(q_params: Dict, peak: "Peak", mask, imp, batch: int,
             tokens: int, budget: float) -> np.ndarray:
    """The Q-network over Algorithm 3's state, in f64."""
    m = np.asarray(mask, bool)
    dense = float(peak(np.ones_like(m), batch, tokens))
    L = peak.L
    imp = np.asarray(imp, np.float64)
    s = np.concatenate([[batch / BS_NORM, tokens / SQL_NORM],
                        imp[:L] / IMP_NORM, imp[L:] / IMP_NORM,
                        [budget / dense, peak(m, batch, tokens) / dense]])
    w = {k: v.double().cpu().numpy() for k, v in q_params.items()}
    return np.tanh(s @ w["w1"] + w["b1"]) @ w["w2"] + w["b2"]


def choice_faults(peak: "Peak", q_params: Dict, decisions) -> List[str]:
    """Each fresh decision replayed from its recorded importance passes
    (``(mask, importance)``, one before each removal and one after it):
    the block removed at each step has to be the Q-network's best valid
    action at that step's state. ``decisions``: (batch, total_len, budget,
    final mask, steps, cached, passes) tuples."""
    out = []
    for i, (b, n, budget, final, steps, cached, passes) in enumerate(
            decisions):
        if cached:
            continue
        if len(passes) != int(steps) + 1:
            out.append(f"decision {i}: {len(passes)} importance passes for "
                       f"{steps} steps")
            continue
        masks = [np.asarray(m, bool) for m, _ in passes]
        if not masks[0].all() or not np.array_equal(masks[-1],
                                                    np.asarray(final, bool)):
            out.append(f"decision {i}: passes do not run from the dense "
                       f"mask to the decision's")
            continue
        for k in range(int(steps)):
            gone = np.flatnonzero(masks[k] & ~masks[k + 1])
            if len(gone) != 1 or (masks[k + 1] & ~masks[k]).any():
                out.append(f"decision {i} step {k}: not one removal")
                break
            q = q_values(q_params, peak, masks[k], passes[k][1], b, n, budget)
            valid = np.concatenate([[not masks[k].any()], masks[k]])
            q = np.where(valid, q, -np.inf)
            if q.max() - q[gone[0] + 1] > Q_TOL:
                out.append(f"decision {i} step {k}: removed block {gone[0]}, "
                           f"the Q-network's best is action "
                           f"{int(q.argmax())} by {q.max() - q[gone[0] + 1]:.3g}")
    return out
