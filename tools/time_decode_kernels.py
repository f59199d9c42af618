#!/usr/bin/env python3
"""Time the port's three decode-attention kernels from one source tree, on
one NVIDIA GPU.

    python3 tools/time_decode_kernels.py [SRC] [--reps N] [--profile]
                                         [--bodies] [--splits] [--ptxas]
                                         [--no-time]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the tree
and, for each shape of ``SHAPES`` (``chip_smoke.DECODE_TIMED``: llama2-7b
at B=8 and B=1, recurrentgemma-9b; and glm4-9b's G = 16 at D = 128 and
gemma-2b's G = 8 at D = 256, both at B = 8) and each kernel (``paged``:
bf16 pages, ``quant``: int8 pages with bf16 q, ``dense``: the contiguous
cache with per-row prefix masks), ``reps`` readings of
``chip_smoke.decode_timing``: event and device-only ms (20 launches each,
L2 flushed before every launch), the plain version's ms, the bound, and
``scaled_dot_product_attention`` beside the dense kernel. Each kernel is
held against its plain version on the timed inputs first (those lines go
to stderr). A tree with ``decode_attention.plan`` (this one's) also
reports the plan's body for each shape.

``--bodies`` times both bodies (``"wgmma"``, ``"fma"``) at each shape,
forced through the wrappers' private launch entries (``_decode_cuda``,
``_paged_cuda``, ``_paged_quant_cuda``; this tree only), under
``by_body``, and adds ``NARROW_SHAPES`` (G = 5, 6, 7): the timings
that choose ``decode_attention.TC_MIN_GROUP``. ``--splits`` times
llama2-7b's B = 1 and B = 4 with the split-KV cut chosen for
``split_rows`` = 8 (a slot group of 8 of which these rows step) against
``split_rows`` = B, under ``split_rows``.

``--profile`` adds, per shape and kernel, the device time of each CUDA
kernel a call launches (``torch.profiler``, mean µs over 20 calls): the
split kernel and the combine apart.

``--ptxas`` first compiles the tree's two decode sources once more with
``-Xptxas -v`` (the flags and objects of ``kernels/build.py``; a tree
whose ``build`` has no ``OBJECTS`` compiles each source whole), in
parallel, and prints each
kernel's registers, shared memory, spills and ptxas's notes (a serialised
wgmma shows as a C75xx note); ``--no-time`` stops after that.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, H, K, D, max_len) beside chip_smoke.DECODE_TIMED's
EXTRA_SHAPES = {"glm4": (8, 32, 2, 128, 512),
                "gemma": (8, 8, 1, 256, 512)}
# and, under --bodies, the groups below 8: qwen3-14b (G = 5), dbrx-132b
# (6) and internvl2-1b (7, D = 64)
NARROW_SHAPES = {"qwen3": (8, 40, 8, 128, 512), "dbrx": (8, 48, 8, 128, 512),
                 "internvl2": (8, 14, 2, 64, 512)}
SPLIT_ROWS = 8            # the slot group --splits assumes
SPLIT_BATCHES = (1, 4)


def ptxas_report(build) -> None:
    """``-Xptxas -v`` over the objects of the two decode sources (each
    source whole in a tree whose ``build`` has no ``OBJECTS``): each
    entry's registers, shared memory, spills and notes."""
    decode = ("decode_attention", "paged_decode_attention")
    objects = [o for o in getattr(build, "OBJECTS",
                                  [(n, n, ()) for n in decode])
               if o[0] in decode]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        procs = [subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / f"{obj}.o"), str(build.CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n, obj, flags in objects]
        outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        lines = out.splitlines()
        if p.returncode != 0:
            sys.exit("\n".join(lines))
        entry = ""
        for line in lines:
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "spill" in line or "Used" in line:
                print(f"ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
            elif any(w in line for w in ("Performance", "warning", "C75")):
                print(f"ptxas: {line.strip()}")


def readings(torch, dec, pdec, attention, shape, reps, **kw) -> dict:
    """``reps`` readings of ``decode_timing`` at one shape, per kernel."""
    from chip_smoke import decode_timing
    with contextlib.redirect_stdout(sys.stderr):   # the checks' lines
        runs = [decode_timing(torch, dec, pdec, attention, *shape, **kw)
                for _ in range(reps)]
    return {body: {"shape": runs[0][body]["shape"],
                   "bound_ms": runs[0][body]["bound_ms"],
                   **{k: [r[body][k] for r in runs]
                      for k in ("ms", "busy_ms", "plain_ms", "library_ms",
                                "library_busy_ms") if k in runs[0][body]}}
            for body in runs[0]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--bodies", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_decode_kernels: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import DECODE_TIMED, card_line, decode_calls
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.models import attention
    if args.ptxas:
        ptxas_report(build)
    if args.no_time:
        return
    out = {"card": card_line(), "src": str(Path(args.src).resolve()),
           "shapes": {}}
    planned = hasattr(dec, "plan")
    shapes = {**DECODE_TIMED, **EXTRA_SHAPES,
              **(NARROW_SHAPES if args.bodies else {})}
    for name, shape in shapes.items():
        res = readings(torch, dec, pdec, attention, shape, args.reps)
        if planned:
            B, H, K, D, S = shape
            res["plan_body"] = dec.plan(
                torch.bfloat16, None, H // K, D, 0, False, B, K, S,
                build.sm_count("cuda")).body
        if args.bodies:
            res["by_body"] = {
                body: readings(torch, dec, pdec, attention, shape,
                               args.reps, body=body)
                for body in ("wgmma", "fma")}
        if args.profile:
            res["kernels_us"] = profile(
                torch, decode_calls(torch, dec, pdec, attention, *shape))
        out["shapes"][name] = res
    if args.splits:
        _, H, K, D, S = DECODE_TIMED["llama"]
        out["split_rows"] = {
            f"B={B} split_rows={rows}": readings(
                torch, dec, pdec, attention, (B, H, K, D, S), args.reps,
                split_rows=rows)
            for B in SPLIT_BATCHES for rows in (SPLIT_ROWS, B)}
    print(json.dumps(out))


def profile(torch, calls: dict) -> dict:
    """Mean device µs a call of each kernel spends in each CUDA kernel."""
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
