#!/usr/bin/env python3
"""Time the port's three decode-attention bodies from one source tree, on
one NVIDIA GPU.

    python3 tools/time_decode_kernels.py [SRC] [--reps N] [--profile]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the tree
and, for each shape of ``chip_smoke.DECODE_TIMED`` (llama2-7b at B=8 and
B=1, recurrentgemma-9b) and each body (``paged``: bf16 pages, ``quant``:
int8 pages with bf16 q, ``dense``: the contiguous cache with per-row
prefix masks), ``reps`` readings of ``chip_smoke.decode_timing``: event and
device-only ms (20 launches each, L2 flushed before every launch), the
plain version's ms, the bound, and ``scaled_dot_product_attention`` beside
the dense body. Each body is held against its plain version on the timed
inputs first (those lines go to stderr).

``--profile`` adds, per shape and body, the device time of each CUDA
kernel a call launches (``torch.profiler``, mean µs over 20 calls): the
split kernel and the combine apart.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_decode_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import (DECODE_TIMED, card_line, decode_calls,
                            decode_timing)
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.models import attention
    out = {"card": card_line(), "src": str(Path(args.src).resolve()),
           "shapes": {}}
    for name, shape in DECODE_TIMED.items():
        with contextlib.redirect_stdout(sys.stderr):   # the checks' lines
            runs = [decode_timing(torch, dec, pdec, attention, *shape)
                    for _ in range(args.reps)]
        out["shapes"][name] = {
            body: {"shape": runs[0][body]["shape"],
                   "bound_ms": runs[0][body]["bound_ms"],
                   **{k: [r[body][k] for r in runs]
                      for k in ("ms", "busy_ms", "plain_ms", "library_ms",
                                "library_busy_ms") if k in runs[0][body]}}
            for body in runs[0]}
        if args.profile:
            out["shapes"][name]["kernels_us"] = profile(
                torch, decode_calls(torch, dec, pdec, attention, *shape))
    print(json.dumps(out))


def profile(torch, calls: dict) -> dict:
    """Mean device µs a call of each body spends in each CUDA kernel."""
    from torch.profiler import ProfilerActivity
    res = {}
    for body in ("paged", "quant", "dense"):
        kernel = calls[body][0]
        for _ in range(3):
            kernel()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernel()
            torch.cuda.synchronize()
        res[body] = {e.key[:60]: getattr(e, "device_time_total",
                                         getattr(e, "cuda_time_total", 0))
                     / 20 for e in prof.key_averages()
                     if getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0)) > 0}
    return res


if __name__ == "__main__":
    main()
