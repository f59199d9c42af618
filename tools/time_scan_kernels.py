#!/usr/bin/env python3
"""Time the port's scan kernels and the fused GLU from one source tree, on
one NVIDIA GPU.

    python3 tools/time_scan_kernels.py [SRC] [--reps N] [--profile]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the
tree, and ``reps`` readings of

  * ``ssd_cuda`` at each ``chip_smoke.SSD_TIMED`` shape (mamba2-370m's
    prefill, the GSI scoring shape, batch 1, three chunks; f32), through
    ``chip_smoke.ssd_timing``: each checked against its plain version
    and launched twice for the same bits, then event and device-only ms,
    the plain version's ms and the bounds;
  * ``rglru_cuda`` at recurrentgemma-9b's prefill shape (B=8, T=256,
    W=4096; f32): event and device-only ms;
  * the fused GLU at each ``chip_smoke.GLU_TIMED`` shape (llama2-7b's
    prefill and scoring, recurrentgemma-9b's GeGLU prefill; bf16), through
    ``chip_smoke.glu_timing``, and beside it ``mul_busy_ms``: the
    device-only time of ``torch.mul`` over the same bytes (two bf16
    ``[T, F]`` inputs read, one written), a yardstick of the rate such a
    pass reaches on the card (not the same function, so not a
    ``library_ms``).

``--profile`` adds, per ``SSD_TIMED`` shape, the device time of each CUDA
kernel one ``ssd_cuda`` call launches (``torch.profiler``, mean µs over 20
calls, L2 warm).

Times are means of 20 launches with CUDA events, the L2 flushed before
every launch (``chip_smoke.time_ms``); the check lines go to stderr.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(runs: list) -> dict:
    """Per shape: the first run's fixed fields, each timed field as the
    list of its readings."""
    timed = ("ms", "busy_ms", "plain_ms")
    return {name: {**{k: v for k, v in runs[0][name].items()
                      if k not in timed},
                   **{k: [r[name][k] for r in runs] for k in timed}}
            for name in runs[0]}


def kernel_us(torch, run, calls: int = 20) -> dict:
    """Mean device µs of each CUDA kernel ``run`` launches, by name."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / calls
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_scan_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import (GLU_TIMED, SSD_TIMED, card_line, glu_timing,
                            max_err, scan_inputs, ssd_timing, time_ms)
    from repro_torch.kernels import rglru, ssd, swiglu
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(1)
    with contextlib.redirect_stdout(sys.stderr):        # the checks' lines
        ssd_runs = [{name: ssd_timing(torch, ssd, *shape)
                     for name, shape in SSD_TIMED.items()}
                    for _ in range(args.reps)]
        glu_runs = [{name: glu_timing(torch, swiglu, g, *shape)
                     for name, shape in GLU_TIMED.items()}
                    for _ in range(args.reps)]
    glu = readings(glu_runs)
    for name, (T, F, _) in GLU_TIMED.items():
        x, y = (torch.randn(T, F, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        z = torch.empty_like(x)
        glu[name]["mul_busy_ms"] = time_ms(lambda: torch.mul(x, y, out=z),
                                           hide_launch=True)
    _, _, _, _, a, b = scan_inputs(torch)
    run = lambda: rglru.rglru_cuda(a, b)
    out = {"card": card_line(), "src": str(Path(args.src).resolve()),
           "ssd": readings(ssd_runs), "glu": glu,
           "rglru": {"shape": "B=8 T=256 W=4096 f32",
                     "max_abs_err": max_err(run(), rglru.rglru_ref(a, b)),
                     "ms": [time_ms(run) for _ in range(args.reps)],
                     "busy_ms": [time_ms(run, hide_launch=True)
                                 for _ in range(args.reps)]}}
    if args.profile:
        for name, (B, T, H, P, N, Q) in SSD_TIMED.items():
            xh, log_a, Bm, Cm, _, _ = scan_inputs(torch, B, T, H, P, N, 1)
            out["ssd"][name]["kernel_us"] = kernel_us(
                torch, lambda: ssd.ssd_cuda(xh, log_a, Bm, Cm, Q))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
