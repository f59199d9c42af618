#!/usr/bin/env python3
"""Where the time of a GSI scoring pass goes on one GPU.

    python3 tools/profile_scoring.py [SRC] [--arch llama2-7b] [--passes N]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); run two trees in turns in one call to compare them.

Builds ``--arch`` at full width and depth (random weights from seed 0, the
model dtype) with the serve's calibration batch (2 rows x 64 tokens), and
scores every block of the full mask (``core.gsi.make_candidate_scorer``,
8 candidates a forward, so ``2L / 8`` forwards of B=16, S=64 each), as
``decide()`` does at its first greedy step. One warm pass, then ``--passes``
passes timed on the host clock (ending in a synchronize), then as many
under ``torch.profiler``. Prints one JSON line: the card's name and power
limit; wall ms per forward, untraced and traced; device-busy ms per
forward (the union of the kernels' intervals in the trace) and its share
of the traced wall; the launch counts of the untraced passes; and the
kernels with the most device time, with their launch counts.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_scoring: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import card_line
    from repro_torch.configs import get_config
    from repro_torch.core import gsi
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    model = registry.build(cfg)
    params = model.init(0, dev)
    calib = {k: torch.from_numpy(v).to(dev) for k, v in
             SyntheticCorpus(cfg.vocab_size, seed=0).batch(
                 2, 64, split="calib").items()}
    score = gsi.make_candidate_scorer(model, calib)
    mask = np.ones(2 * cfg.n_layers, np.float32)
    def passes() -> float:
        t0 = time.perf_counter()
        for _ in range(args.passes):
            score(params, mask)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    score(params, mask)                                  # warm
    ops.reset_launches()
    wall_ms = passes()
    launches = ops.launch_counts()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        traced_ms = passes()
    forwards = args.passes * -(-len(mask) // 8)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = busy_us([(e.time_range.start, e.time_range.end)
                       for e in kernels]) / 1e3
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "card": card_line(), "src": str(Path(args.src).resolve()),
        "arch": args.arch, "layers": cfg.n_layers,
        "forwards": forwards, "batch": [16, 64],
        "launches": launches,
        "wall_ms_per_forward": wall_ms / forwards,
        "traced_wall_ms_per_forward": traced_ms / forwards,
        "device_busy_ms_per_forward": (busy_ms / forwards if kernels
                                       else "not measured"),
        "device_busy_share": busy_ms / traced_ms if kernels else None,
        "top_kernels": [{"name": name[:90], "ms_per_forward": t / 1e3 / forwards,
                         "launches": n} for name, (t, n) in top]}))


if __name__ == "__main__":
    main()
