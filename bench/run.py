"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``src/repro_torch``. The cell's
configuration, traffic mix, limits and per-layer readers are found by name
under ``bench/`` (``benchlib/spec.py``). Everything is made from the seed;
the engine serves its traffic through a window of ``--seconds``; then the
reference judges what the window served. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit. The same numbers end
standard error.

It refuses to run without as many CUDA devices as the cell asks for, and
fails, printing no result, where the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# kernel and compile caches at fixed paths inside the checkout (the
# program builds its own library under build/kernels); no library may load
# JAX on its own
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *,
             t_start: float, fault=None):
    """Serve the cell once and judge it: the result's fields, in order,
    and the findings of the decision check."""
    import torch

    from benchlib import check, profile, result, serve, spec

    run = serve.serve(cell.config, cell.traffic, seed, seconds, trace=trace,
                      device=device, t_start=t_start,
                      profiler_factory=(profile.profiler
                                        if device.type == "cuda" else None),
                      fault=fault)
    attempted, failed = result.attempted_failed(run)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    out = {}
    if trace:
        summary = None
        if run.profiler is not None:
            w = run.window
            summary = profile.summarize(run.profiler, tuple(w.prof_span),
                                        w.prof_epoch, w.spans)
            dev.update(busy_s=summary["busy_s"],
                       window_s=summary["window_s"])
        metrics = spec.read_metrics(cell.per_layer,
                                    result.make_trace(run, cell.config,
                                                      summary))
    else:
        metrics = spec.read_metrics(cell.end_to_end, run)
    bad = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if bad:
        raise RuntimeError(f"metrics without a finite value: {bad} (the "
                           f"window's requests were not served)")
    out.update(attempted=attempted, failed=failed, metrics=metrics,
               device=dev)
    if trace and summary is not None:
        top = sorted(summary["by_kernel"].items(), key=lambda kv: -kv[1])
        idle = sorted(summary["idle"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [list(x) for x in top[:10]],
                            "idle_gaps": [list(x) for x in idle[:10]]}
    run.profiler = run.window.profiler = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks, findings = check.check(run, cell.config, cell.limits,
                                            device)
    return correct, out, checks, findings


def main(argv=None) -> int:
    args = parse(argv)
    from benchlib import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    correct, out, checks, findings = run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda", 0), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"bench: the process loaded {found}, which the port's "
              f"benchmark may not", file=sys.stderr)
        return 3
    for f in findings:
        print(f"finding: {f}", file=sys.stderr)
    for v in checks.values():
        # JSON has no infinity: a number that is not finite reads "inf"
        if not math.isfinite(v["value"]):
            v["value"] = "inf"
    line = {"correct": bool(correct), **out, "checks": checks}
    sys.stdout.flush()
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
