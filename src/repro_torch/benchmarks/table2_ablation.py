"""Table 2 / Fig. 8 analogue: component ablations.

RAP^-GSI — one-shot dense scores, no re-evaluation (static top-k drop);
RAP^-RL  — random block drops to the same budget (paper's Random-Drop);
RAP      — full system.
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import baselines, masks

BUDGETS = (0.8, 0.6)


def run() -> list:
    model, params, corpus = common.subject()
    dev = params["embed"].device
    mm = common.memory_model(model.cfg)
    calib = common.calib_batch(corpus)
    evals = common.eval_batches(corpus)
    bs, sql = common.EVAL_REQUEST
    ctl, _ = common.trained_controller(model, params, corpus)

    rows = []
    for frac in BUDGETS:
        budget = frac * mm.dense_peak(bs, sql)

        def eval_mask(name, mask):
            g = masks.mask_to_gates(mask, dev)
            m = common.evaluate(model, params, evals, gates=g)
            rows.append({"budget": frac, "scheme": name, "ppl": m["ppl"],
                         "acc": m["acc"], "kept_blocks": int(mask.sum())})

        # RAP^-RL: random drop (mean over 3 seeds)
        ppls, accs, kept = [], [], []
        for s in range(3):
            m = baselines.random_drop_mask(model, mm, bs, sql, budget, seed=s)
            g = masks.mask_to_gates(m, dev)
            r = common.evaluate(model, params, evals, gates=g)
            ppls.append(r["ppl"]); accs.append(r["acc"]); kept.append(m.sum())
        rows.append({"budget": frac, "scheme": "RAP^-RL",
                     "ppl": float(np.mean(ppls)), "acc": float(np.mean(accs)),
                     "kept_blocks": int(np.mean(kept))})
        # RAP^-GSI: one-shot scores
        eval_mask("RAP^-GSI",
                  baselines.oneshot_ppl_mask(model, params, calib, mm, bs,
                                             sql, budget, chunk=16))
        # full RAP
        d = ctl.decide(bs, sql, budget)
        eval_mask("RAP", d.mask)

    common.emit("table2_ablation", rows,
                header=["budget", "scheme", "ppl", "acc", "kept_blocks"])
    return rows
