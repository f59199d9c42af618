"""Fig. 3 analogue: parameter- vs KV-dominated memory across request shapes.

Uses the full llama2-7b config (the paper's own subject) and Eq. (3)+(4):
shows the transition from parameter-dominated (small batch/seq) to
KV-dominated (large batch/seq) — including the paper's headline point that
(batch=16, seq=4k) KV (32 GB) dwarfs the 14 GB of parameters. Analytic: no
model runs.
"""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.configs import get_config
from repro_torch.core import masks, memory


def run() -> list:
    cfg = get_config("llama2-7b")
    mm = memory.build_memory_model(cfg)   # bf16 by config
    full = masks.full_mask(cfg.n_layers)
    rows = []
    for bs in (1, 4, 16, 64):
        for seq in (512, 2048, 4096, 16384):
            p = mm.param_bytes(full)
            k = mm.state_bytes(full, bs, seq)
            rows.append({"batch": bs, "seq": seq,
                         "param_gb": round(p / 2**30, 2),
                         "kv_gb": round(k / 2**30, 2),
                         "kv_frac": round(k / (p + k), 3)})
    common.emit("fig3_memory_breakdown", rows,
                header=["batch", "seq", "param_gb", "kv_gb", "kv_frac"])
    # the paper's headline cell
    head = [r for r in rows if r["batch"] == 16 and r["seq"] == 4096][0]
    print(f"# llama2-7b @ bs=16 seq=4k: params {head['param_gb']}GB, "
          f"KV {head['kv_gb']}GB (paper: 14GB vs 32GB)")
    return rows
