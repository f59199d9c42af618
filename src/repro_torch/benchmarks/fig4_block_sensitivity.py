"""Fig. 4/12 analogue: per-block Δlog-ppl of removing each MHA/FFN block,
at two request lengths — block importance is heterogeneous across depth and
shifts with sequence length."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import gsi


def run() -> list:
    model, params, corpus = common.subject()
    rows = []
    L = model.cfg.n_layers
    for seq in (64, 256):
        batch = common.calib_batch(corpus, n=4, seq=seq)
        scores = gsi.oneshot_rank(model, params, batch, chunk=16)
        base = float(gsi.make_ppl_fn(model, batch)(
            params, np.ones(2 * L, np.float32)))
        for b in range(2 * L):
            rows.append({"seq": seq,
                         "block": f"{'MHA' if b < L else 'FFN'}{b % L}",
                         "delta_log_ppl": round(float(scores[b]) - base, 4)})
    common.emit("fig4_block_sensitivity", rows,
                header=["seq", "block", "delta_log_ppl"])
    # heterogeneity check: spread across blocks ≫ 0
    d64 = [r["delta_log_ppl"] for r in rows if r["seq"] == 64]
    print(f"# spread(seq=64): max={max(d64):.3f} min={min(d64):.3f}")
    return rows
