#!/usr/bin/env python3
"""Time the port's flash-attention kernel from one source tree, on one GPU.

    python3 tools/time_flash_kernel.py [SRC] [--reps N] [--ptxas]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the
tree, and, at each of ``chip_smoke.py``'s ``FLASH_TIMED`` shapes (bf16,
causal), ``reps`` means (ms, ``chip_smoke.time_ms``: CUDA events, 20
launches each, L2 flushed before every launch) of ``flash_attention_cuda``
(``kernel_ms``), its plain version (``plain_ms``) and
``scaled_dot_product_attention`` (``library_ms``), with the shape's bound.

``kernel_busy_ms`` and ``library_busy_ms`` time the same launches with the
card kept busy while the host enqueues them (``time_ms(hide_launch=True)``),
so the host's launch overhead falls outside the events: the device's own
time.

``--ptxas`` first compiles the tree's ``csrc/flash_attention.cu`` once more
with ``-Xptxas -v`` (the flags of ``kernels/build.py``) and prints each
kernel's registers, shared memory and spills.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def ptxas_report(build) -> None:
    src = build.CSRC / "flash_attention.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        out = subprocess.run(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "flash.o"), str(src)],
            capture_output=True, text=True)
    lines = (out.stdout + out.stderr).splitlines()
    if out.returncode != 0:
        sys.exit("\n".join(lines))
    for line in lines:
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_flash_kernel: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import (FLASH_TIMED, card_line, flash_bound, flash_calls,
                            max_err, time_ms)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if args.ptxas:
        ptxas_report(build)
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    out = {"card": card_line(), "src": str(Path(args.src).resolve())}
    for name, shape in FLASH_TIMED.items():
        calls = flash_calls(torch, fa, g, *shape, dt)
        bms, by = flash_bound(*shape, dt)
        out[name] = {
            "shape": list(shape), "bound_ms": bms, "bound_by": by,
            "max_abs_err": max_err(calls["kernel"](), calls["plain"]()),
            **{f"{key}_ms": [time_ms(fn) for _ in range(args.reps)]
               for key, fn in calls.items()},
            **{f"{key}_busy_ms": [time_ms(calls[key], hide_launch=True)
                                  for _ in range(args.reps)]
               for key in ("kernel", "library")}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
