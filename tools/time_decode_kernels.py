#!/usr/bin/env python3
"""Time the port's decode kernels from one source tree, on one NVIDIA GPU.

    python3 tools/time_decode_kernels.py [SRC] [--reps N]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the
tree, and ``reps`` means (ms, CUDA events, 20 launches each, L2 flushed
before every launch, as in ``chip_smoke.py``) of

  * ``paged_decode_attention_cuda`` on bf16 pages, B=8, H=K=32, D=128,
    16-token pages, the ragged lengths of ``chip_smoke.py``'s timing case
    (2398 tokens);
  * ``decode_attention_cuda`` (when the tree has it) on the same tokens as
    a contiguous bf16 cache of 512 with per-row prefix masks.
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
        sys.exit("time_decode_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import card_line, paged_inputs, time_ms
    from repro_torch.kernels import paged_decode_attention as pdec
    try:
        from repro_torch.kernels import decode_attention as dec
    except ImportError:
        dec = None
    B, H, K, D, pt, S, dt = 8, 32, 32, 128, 16, 512, torch.bfloat16
    q, kp, vp, table, lengths = paged_inputs(torch, B, H, K, D, pt, S, dt, 12)
    out = {"card": card_line(), "src": str(Path(args.src).resolve()),
           "tokens": int(lengths.sum()),
           "paged_ms": [time_ms(lambda: pdec.paged_decode_attention_cuda(
               q, kp, vp, table, lengths)) for _ in range(args.reps)],
           "decode_ms": None}
    if dec is not None:
        kd = kp[table.long()].reshape(B, S, K, D)
        vd = vp[table.long()].reshape(B, S, K, D)
        valid = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
        out["decode_ms"] = [time_ms(lambda: dec.decode_attention_cuda(
            q, kd, vd, valid)) for _ in range(args.reps)]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
