"""Benchmark harness: one module per paper table/figure.

  python -m repro_torch.benchmarks.run [--only table1,fig9] [--device cpu]

Each module prints a CSV block and writes
``experiments/bench_torch/<name>.json`` (``common.BENCH_DIR``). Everything
runs on the card unless ``--device cpu`` is passed. The JAX package's
``roofline`` entry parses TPU HLO; its H100 form is ROADMAP queue 1, item
17, so ``--only roofline`` raises ``NotImplementedError`` and the default
run lists only the ported experiments. Exits 1 if any experiment failed.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
import traceback

BENCHES = [
    ("table1", "repro_torch.benchmarks.table1_budgets",
     "Table 1/3 — methods at 80%/60% unified memory budgets"),
    ("table2", "repro_torch.benchmarks.table2_ablation",
     "Table 2 / Fig.8 — RAP vs RAP^-GSI vs RAP^-RL"),
    ("table4", "repro_torch.benchmarks.table4_prune_ratio",
     "Table 4 — weight-prune ratio needed per budget"),
    ("fig3", "repro_torch.benchmarks.fig3_memory_breakdown",
     "Fig. 3 — param- vs KV-dominated memory"),
    ("fig4", "repro_torch.benchmarks.fig4_block_sensitivity",
     "Fig. 4/12 — per-block sensitivity vs request length"),
    ("fig6", "repro_torch.benchmarks.fig6_gsi_vs_oneshot",
     "Fig. 6 — GSI vs one-shot block scores"),
    ("fig9", "repro_torch.benchmarks.fig9_seeds",
     "Fig. 9 — RL reward across seeds"),
    ("fig10", "repro_torch.benchmarks.fig10_alpha_beta",
     "Fig. 10 — α/β penalty sensitivity"),
    ("fig11", "repro_torch.benchmarks.fig11_overhead",
     "Fig. 11 — controller overhead"),
]
# the JAX package's one entry not ported yet
ROOFLINE = ("§Roofline parses TPU HLO; its H100 form is ROADMAP queue 1, "
            "item 17")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset, e.g. table1,fig9")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    want = set(args.only.split(",")) if args.only else None
    if want and "roofline" in want:
        raise NotImplementedError(f"--only roofline: {ROOFLINE}")
    unknown = sorted((want or set()) - {b[0] for b in BENCHES})
    if unknown:
        ap.error(f"unknown benchmarks {unknown}; available: "
                 f"{[b[0] for b in BENCHES]}")
    from repro_torch.benchmarks import common
    if args.device:
        common.DEVICE = args.device

    failures = []
    for name, module, desc in BENCHES:
        if want and name not in want:
            continue
        print(f"\n===== {name}: {desc} =====", flush=True)
        t0 = time.time()
        try:
            importlib.import_module(module).run()
            print(f"===== {name} done in {time.time()-t0:.1f}s =====",
                  flush=True)
        except Exception as e:
            failures.append(name)
            print(f"===== {name} FAILED: {type(e).__name__}: {e} =====")
            traceback.print_exc()
    if failures:
        print(f"\nFAILED: {failures}")
        sys.exit(1)
    print("\nall benchmarks complete")


if __name__ == "__main__":
    main()
