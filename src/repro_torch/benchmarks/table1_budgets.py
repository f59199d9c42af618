"""Table 1/3 analogue: every method at equal unified memory budgets.

Protocol (paper §5.2): budget = frac × max(params + KV) of the dense model
at the evaluation request shape; each method prunes until it fits; we then
measure held-out perplexity and next-token accuracy. RAP uses the trained
DQN controller (GSI scores recomputed per removal); baselines are the
static schemes of §5.1, SliceGPT through a sliced, rebuilt model.
"""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import baselines, masks
from repro_torch.models import registry

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
    dense = common.evaluate(model, params, evals)
    rows.append({"budget": 1.0, "scheme": "Dense", "ppl": dense["ppl"],
                 "acc": dense["acc"], "kept_blocks": 2 * model.cfg.n_layers,
                 "fits": True, "param_frac": 1.0})

    for frac in BUDGETS:
        budget = frac * mm.dense_peak(bs, sql)

        def eval_mask(name, mask):
            g = masks.mask_to_gates(mask, dev)
            m = common.evaluate(model, params, evals, gates=g)
            rows.append({
                "budget": frac, "scheme": name, "ppl": m["ppl"],
                "acc": m["acc"], "kept_blocks": int(mask.sum()),
                "fits": bool(mm.peak_bytes(mask, bs, sql) <= budget),
                "param_frac": masks.mask_param_fraction(model.cfg, mask)})

        eval_mask("LLMPruner",
                  baselines.llmpruner_mask(model, params, calib, mm, bs, sql,
                                           budget))
        eval_mask("ShortGPT",
                  baselines.shortgpt_mask(model, params, calib, mm, bs, sql,
                                          budget))
        eval_mask("MHA-Drop",
                  baselines.mha_drop_mask(model, params, calib, mm, bs, sql,
                                          budget))
        eval_mask("FFN-Skip",
                  baselines.ffn_skip_mask(model, params, calib, mm, bs, sql,
                                          budget))
        # SliceGPT: width slicing → different params/cfg
        ratio = baselines.slicegpt_fit_ratio(model.cfg, mm, bs, sql, budget)
        p2, cfg2 = baselines.slicegpt_slice(model, params, ratio)
        m2 = registry.build(cfg2)
        sm = common.evaluate(m2, p2, evals)
        rows.append({"budget": frac, "scheme": "SliceGPT", "ppl": sm["ppl"],
                     "acc": sm["acc"], "kept_blocks": 2 * model.cfg.n_layers,
                     "fits": True, "param_frac": ratio})
        # RAP
        d = ctl.decide(bs, sql, budget)
        eval_mask("RAP", d.mask)

    common.emit("table1_budgets", rows,
                header=["budget", "scheme", "ppl", "acc", "kept_blocks",
                        "fits", "param_frac"])
    return rows
