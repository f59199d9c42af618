#!/usr/bin/env python3
"""Time the port's flash-attention kernel from one source tree, on one GPU.

    python3 tools/time_flash_kernel.py [SRC] [--reps N] [--ptxas]

``SRC`` is a ``src`` directory holding ``repro_torch`` (default: this
checkout's); its kernels are built from that tree's ``csrc``. To compare
two trees on one card, run them in turns on one machine (A, B, B, A): each
process prints one JSON line with the card's name and power limit, the
tree, and, at each of ``chip_smoke.py``'s ``FLASH_TIMED`` shapes (bf16,
causal) and ``FLASH_TIMED_NONCAUSAL`` shapes (whisper-medium's encoder),
``reps`` means (ms, ``chip_smoke.time_ms``: CUDA events, 20 launches each,
L2 flushed before every launch) of ``flash_attention_cuda``
(``kernel_ms``) and ``scaled_dot_product_attention`` (``library_ms``), one
of the plain version (``plain_ms``), and the shape's bound.

``kernel_busy_ms`` and ``library_busy_ms`` time the same launches with the
card kept busy while the host enqueues them (``time_ms(hide_launch=True)``),
so the host's launch overhead falls outside the events: the device's own
time.

``host_us`` is the wrapper's host time a call: ``reps`` means of 500 calls
of ``flash_attention_cuda`` enqueued without a synchronisation, on the host
clock, at a small shape (B=1, S=64, H=K=1, D=64, whose device time is
shorter than the host's, so the queue never fills) and at the scoring
shape; ``torch_add`` times one small ``torch.add`` the same way, a
yardstick for how fast the host ran in this process.

``--ptxas`` first compiles the tree's ``csrc/flash_attention.cu`` once more
with ``-Xptxas -v`` (the flags of ``kernels/build.py``) and prints each
kernel's registers, shared memory and spills, and ptxas's notes.
``--encode`` builds a small host program against the tree's
``csrc/hopper.cuh`` and prints the host ns of one ``encode_4d`` (the
driver's ``cuTensorMapEncodeTiled``; the wrapper encodes four a call).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
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
        if any(w in line for w in ("Compiling entry", "Used", "spill",
                                   "Performance")):
            print(f"ptxas: {line.strip()}")


ENCODE_BENCH = r"""
#include "hopper.cuh"
#include <chrono>
#include <cstdio>
int main() {
  void* p = nullptr;
  if (cudaMalloc(&p, 8 << 20) != cudaSuccess) return 1;
  CUtensorMap m;
  int rc = hopper::encode_4d(&m, p, true, 128, 32, 256, 8, 64);
  const int n = 100000;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < n; ++i)  // llama2-7b's prefill q, pointers moving
    rc |= hopper::encode_4d(&m, (char*)p + 16 * (i & 7), true, 128, 32,
                            256, 8, 64);
  auto t1 = std::chrono::steady_clock::now();
  std::printf("encode_4d: %.1f ns a call (rc %d)\n",
              std::chrono::duration<double, std::nano>(t1 - t0).count() / n,
              rc);
  return rc;
}
"""


def encode_report(build) -> None:
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        src, exe = Path(tmp) / "encode.cu", Path(tmp) / "encode"
        src.write_text(ENCODE_BENCH)
        subprocess.run([build.nvcc(), "-std=c++17", "-O2", f"-I{build.CSRC}",
                        "-o", str(exe), str(src)], check=True)
        for _ in range(3):
            print(subprocess.run([str(exe)], capture_output=True, text=True,
                                 check=True).stdout.strip())


def host_us(torch, fn, calls: int = 500) -> float:
    """Host microseconds a call of ``fn``, enqueued without a sync."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("src", nargs="?", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--encode", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_flash_kernel: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    from chip_smoke import (FLASH_TIMED, FLASH_TIMED_NONCAUSAL, bound_ms,
                            card_line, flash_calls, max_err, time_ms)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if args.ptxas:
        ptxas_report(build)
    if args.encode:
        encode_report(build)
    g = torch.Generator(device="cuda").manual_seed(3)
    dt = torch.bfloat16
    out = {"card": card_line(), "src": str(Path(args.src).resolve())}
    shapes = [(n, s, True) for n, s in FLASH_TIMED.items()] + \
        [(n, s, False) for n, s in FLASH_TIMED_NONCAUSAL.items()]
    for name, (B, S, H, K, D, window), causal in shapes:
        calls = flash_calls(torch, fa, g, B, S, H, K, D, window, dt, causal)
        meta = lambda n: torch.empty(B, S, n, D, dtype=dt, device="meta")
        bms, by = bound_ms(fa.cost(meta(H), meta(K), meta(K), causal=causal,
                                   window=window))
        out[name] = {
            "shape": [B, S, H, K, D, window], "causal": causal,
            "bound_ms": bms, "bound_by": by,
            "max_abs_err": max_err(calls["kernel"](), calls["plain"]()),
            "plain_ms": time_ms(calls["plain"]),
            **{f"{key}_ms": [time_ms(calls[key]) for _ in range(args.reps)]
               for key in ("kernel", "library")},
            **{f"{key}_busy_ms": [time_ms(calls[key], hide_launch=True)
                                  for _ in range(args.reps)]
               for key in ("kernel", "library")}}
    small = flash_calls(torch, fa, g, 1, 64, 1, 1, 64, 0, dt)["kernel"]
    scoring = flash_calls(torch, fa, g, *FLASH_TIMED["scoring"], dt)["kernel"]
    x = torch.ones(64, device="cuda")
    add = lambda: torch.add(x, x)
    out["host_us"] = {name: [host_us(torch, fn) for _ in range(args.reps)]
                      for name, fn in (("small", small), ("scoring", scoring),
                                       ("torch_add", add))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
