"""Table 4 analogue: weight-prune ratio needed to meet each memory budget.

The paper's point: pruning *ratio* is a misleading proxy — methods that can
shed KV cache (MHA blocks) meet a unified budget with far fewer parameter
removals than FFN-only schemes.
"""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import baselines, masks


def run() -> list:
    model, params, corpus = common.subject()
    mm = common.memory_model(model.cfg)
    calib = common.calib_batch(corpus)
    bs, sql = common.EVAL_REQUEST
    ctl, _ = common.trained_controller(model, params, corpus)

    rows = []
    for frac in (0.8, 0.6):
        budget = frac * mm.dense_peak(bs, sql)
        schemes = {
            "LLMPruner": baselines.llmpruner_mask(model, params, calib, mm,
                                                  bs, sql, budget),
            "ShortGPT": baselines.shortgpt_mask(model, params, calib, mm,
                                                bs, sql, budget),
            "MHA-Drop": baselines.mha_drop_mask(model, params, calib, mm,
                                                bs, sql, budget),
            "FFN-Skip": baselines.ffn_skip_mask(model, params, calib, mm,
                                                bs, sql, budget),
            "RAP": ctl.decide(bs, sql, budget).mask,
        }
        for name, mask in schemes.items():
            rows.append({
                "budget": frac, "scheme": name,
                "weight_prune_ratio":
                    round(1.0 - masks.mask_param_fraction(model.cfg, mask), 4),
                "fits": bool(mm.peak_bytes(mask, bs, sql) <= budget)})
        ratio = baselines.slicegpt_fit_ratio(model.cfg, mm, bs, sql, budget)
        rows.append({"budget": frac, "scheme": "SliceGPT",
                     "weight_prune_ratio": round(1.0 - ratio, 4),
                     "fits": True})

    common.emit("table4_prune_ratio", rows,
                header=["budget", "scheme", "weight_prune_ratio", "fits"])
    return rows
