"""Fig. 10 analogue: reward-coefficient (α, β) sensitivity grid.

For each (α, β) a short policy training; reported metric = mean episode
reward of the trained policy plus the quality (Δppl) and memory (peak
fraction) of its decisions at a fixed request — showing the
accuracy-vs-memory ridge the paper tunes to (α=1.0, β=0.3).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import masks


def run() -> list:
    model, params, corpus = common.subject()
    mm = common.memory_model(model.cfg)
    evals = common.eval_batches(corpus, n_batches=2)
    bs, sql = common.EVAL_REQUEST
    budget = 0.7 * mm.dense_peak(bs, sql)
    dense_ppl = common.evaluate(model, params, evals)["ppl"]

    rows = []
    for alpha in (0.2, 0.6, 1.0):
        for beta in (0.1, 0.3, 0.5):
            ctl, tr = common.trained_controller(
                model, params, corpus, episodes=4, seed=0,
                alpha=alpha, beta=beta, tag=f"a{alpha}_b{beta}")
            d = ctl.decide(bs, sql, budget)
            g = masks.mask_to_gates(d.mask, params["embed"].device)
            m = common.evaluate(model, params, evals, gates=g)
            rows.append({
                "alpha": alpha, "beta": beta,
                "mean_reward": round(float(np.mean(tr.episode_rewards[-5:])),
                                     4),
                "ppl_ratio": round(m["ppl"] / dense_ppl, 3),
                "peak_frac": round(d.peak_bytes / mm.dense_peak(bs, sql), 3),
                "kept": int(d.mask.sum())})
    common.emit("fig10_alpha_beta", rows,
                header=["alpha", "beta", "mean_reward", "ppl_ratio",
                        "peak_frac", "kept"])
    return rows
