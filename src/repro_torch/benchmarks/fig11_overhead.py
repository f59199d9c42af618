"""Fig. 11 analogue: controller overhead vs the served model.

Paper: 18K-param controller vs 6.7B LLM (~3.7e5× reduction), policy step
0.5 s vs 52.7 s inference (<1%). Here: measured on the subject model and
extrapolated analytically to llama2-7b scale. The latencies are the
device's (``common.device_label``: on the card, its name and power
limit), each read after a synchronisation.
"""
from __future__ import annotations

import time

import torch

from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.core import dqn


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run() -> list:
    model, params, corpus = common.subject()
    dev = params["embed"].device
    mm = common.memory_model(model.cfg)
    ctl, tr = common.trained_controller(model, params, corpus)
    bs, sql = common.EVAL_REQUEST
    budget = 0.7 * mm.dense_peak(bs, sql)

    # controller decide latency (post-warmup)
    ctl.decide(bs, sql, budget)
    _sync(dev)
    t0 = time.perf_counter()
    n = 5
    for _ in range(n):
        d = ctl.decide(bs, sql, budget)
    _sync(dev)
    decide_s = (time.perf_counter() - t0) / n

    # one model inference (teacher-forced eval batch) for comparison
    evals = common.eval_batches(corpus, n_batches=1)
    common.evaluate(model, params, evals)
    _sync(dev)
    t0 = time.perf_counter()
    common.evaluate(model, params, evals)
    _sync(dev)
    infer_s = time.perf_counter() - t0

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    n_model = sum(int(x.numel()) for x in leaves(params))
    n_ctrl = dqn.n_params(ctl.q_params)
    llama = get_config("llama2-7b").total_params()
    # q-net for llama2-7b scale: state 2·32+4, actions 2·32+1, hidden 64
    n_ctrl_llama = dqn.n_params(dqn.init_qnet(
        torch.Generator().manual_seed(0), 68, 65, 64))

    rows = [{
        "quantity": "params", "controller": n_ctrl, "model": n_model,
        "ratio": round(n_model / n_ctrl, 1)},
        {"quantity": "params@llama2-7b", "controller": n_ctrl_llama,
         "model": llama, "ratio": round(llama / n_ctrl_llama, 1)},
        {"quantity": "latency_s", "controller": round(decide_s, 4),
         "model": round(infer_s, 4),
         "ratio": round(infer_s / max(decide_s, 1e-9), 2)},
    ]
    common.emit("fig11_overhead", rows,
                header=["quantity", "controller", "model", "ratio"])
    print(f"# latency_s on {common.device_label(dev)}")
    print(f"# paper: 18K vs 6.7B (3.7e5×); here @llama-scale: "
          f"{n_ctrl_llama} vs {llama} "
          f"({llama/n_ctrl_llama:.1e}×)")
    return rows
