"""Fig. 6 analogue: GSI re-evaluated scores vs one-shot scores after
successive removals — one-shot misses inter-layer dependence."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import gsi


def run() -> list:
    model, params, corpus = common.subject()
    batch = common.calib_batch(corpus)
    L = model.cfg.n_layers
    oneshot = gsi.oneshot_rank(model, params, batch, chunk=16)
    res = gsi.gsi_rank(model, params, batch, max_removals=6, chunk=16)
    rows = []
    for step, snap in enumerate(res.score_snapshots):
        for b in range(2 * L):
            if np.isfinite(snap[b]):
                rows.append({"gsi_step": step,
                             "block": f"{'MHA' if b < L else 'FFN'}{b % L}",
                             "gsi_score": round(float(snap[b]), 4),
                             "oneshot_score": round(float(oneshot[b]), 4)})
    common.emit("fig6_gsi_vs_oneshot", rows,
                header=["gsi_step", "block", "gsi_score", "oneshot_score"])
    # divergence grows with removals
    last = [r for r in rows if r["gsi_step"] == len(res.score_snapshots) - 1]
    div = float(np.mean([abs(r["gsi_score"] - r["oneshot_score"])
                         for r in last]))
    print(f"# mean |GSI − one-shot| at step {len(res.score_snapshots)-1}: "
          f"{div:.4f}")
    return rows
