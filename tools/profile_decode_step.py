#!/usr/bin/env python3
"""Where the time of one full-cache decode step goes on one GPU.

    python3 tools/profile_decode_step.py [--layers 32] [--steps 5]

Builds llama2-7b at full width (random weights from seed 0, bf16, 32
layers or ``--layers``) with ``chip_smoke.py``'s ``CARD_DECODE`` cache (8
rows, 4096 slots, every one valid), warms up, then times ``--steps``
decode steps (``steps.make_decode_step``, the step ``lower_decode``
counts) on the host clock ending in a synchronize, and as many under
``torch.profiler``. Prints one JSON line: the card's name and power limit,
wall ms a step (untraced and traced), device-busy ms a step (the union of
the kernels' intervals) and its share of the traced wall, the counted
memory and compute terms of the same step (``ShardedExecutor.lower_decode``
on a 1 x 1 mesh, counted, not measured), and the kernels with the most
device time, with their launches and achieved bytes/s where a kernel's
bytes are counted (``decode_attention``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_decode_step: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tools"))
    from chip_smoke import CARD_DECODE, card_line
    from profile_scoring import busy_us
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16,
                                         destroy_distributed, make_host_mesh)
    from repro_torch.models import registry
    from repro_torch.runtime import ShardedExecutor, steps
    build.build()
    shape = ShapeConfig(*CARD_DECODE)
    _, S, B, _ = CARD_DECODE
    cfg = get_config("llama2-7b").replace(n_layers=args.layers)
    model = registry.build(cfg)
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        rec = ShardedExecutor(model, mesh).lower_decode(shape)
    finally:
        destroy_distributed()
    params = model.init(0, "cuda")
    cache = model.init_cache(B, S, device="cuda")
    tokens = torch.zeros(B, 1, dtype=torch.int32, device="cuda")
    step = steps.make_decode_step(model)

    def run(n: int) -> float:
        nonlocal cache
        t0 = time.perf_counter()
        for _ in range(n):
            cache["pos"] = S - 1
            _, cache = step(params, cache, tokens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    run(3)
    ops.reset_launches()
    wall = run(args.steps)
    launches = ops.launch_counts()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        traced = run(args.steps)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / 1e3 / args.steps
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    dec_bytes = rec["kernels"]["decode_attention"]["bytes"]
    top = []
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        ms = t / 1e3 / args.steps
        row = {"name": name[:90], "ms_per_step": ms,
               "launches_per_step": n / args.steps}
        if name.startswith("void decode_kernel"):
            row["bytes_per_s"] = dec_bytes / (ms / 1e3)
        top.append(row)
    print(json.dumps({
        "card": card_line(), "layers": cfg.n_layers, "batch": B,
        "cache": S, "launches": launches, "wall_ms_per_step": wall,
        "traced_wall_ms_per_step": traced,
        "device_busy_ms_per_step": busy if kernels else "not measured",
        "device_busy_share": busy / traced if kernels else None,
        "counted_memory_ms": rec["cost"]["bytes_accessed"] / HBM_BW * 1e3,
        "counted_compute_ms": rec["cost"]["flops"] / PEAK_FLOPS_BF16 * 1e3,
        "top_kernels": top}))


if __name__ == "__main__":
    main()
