#!/usr/bin/env python3
"""Time the port's scan kernels from one source tree, on one NVIDIA GPU.

    python3 tools/time_scan_kernels.py [SRC] [--reps N]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the
tree, the kernels' max |Δ| against their plain versions, and ``reps``
means (ms, CUDA events, 20 launches each, L2 flushed before every launch,
as in ``chip_smoke.py``) of

  * ``ssd_cuda`` at mamba2-370m's prefill shape (B=8, T=256, H=32, P=64,
    N=128, one chunk of 256), f32;
  * ``rglru_cuda`` at recurrentgemma-9b's prefill shape (B=8, T=256,
    W=4096), f32.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_scan_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import card_line, max_err, scan_inputs, time_ms
    from repro_torch.kernels import rglru, ssd
    torch.backends.cuda.matmul.allow_tf32 = False
    xh, log_a, Bm, Cm, a, b = scan_inputs(torch)
    y, fin = ssd.ssd_cuda(xh, log_a, Bm, Cm, 256)
    y_ref, fin_ref = ssd.ssd_ref(xh, log_a, Bm, Cm, 256)
    h = rglru.rglru_cuda(a, b)
    out = {"card": card_line(), "src": str(Path(args.src).resolve()),
           "ssd_err": max(max_err(y, y_ref), max_err(fin, fin_ref)),
           "rglru_err": max_err(h, rglru.rglru_ref(a, b)),
           "ssd_ms": [time_ms(lambda: ssd.ssd_cuda(xh, log_a, Bm, Cm, 256))
                      for _ in range(args.reps)],
           "rglru_ms": [time_ms(lambda: rglru.rglru_cuda(a, b))
                        for _ in range(args.reps)]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
