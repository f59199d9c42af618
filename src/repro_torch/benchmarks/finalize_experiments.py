"""Render the §Roofline and fit tables from whatever dry-run records exist
(``repro_torch.launch.dryrun``) into a Markdown file, idempotently: the
section after the marker is replaced, anything before it kept.

  python -m repro_torch.benchmarks.finalize_experiments \
      [--out experiments/EXPERIMENTS_torch.md]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.mesh import HBM_PER_CARD
from repro_torch.roofline import analysis, full_table, render_table

MARK = "<!-- AUTOGENERATED ROOFLINE -->"
OUT = "experiments/EXPERIMENTS_torch.md"


def _records(suffix: str):
    for p in sorted(glob.glob(os.path.join(analysis.DRYRUN_DIR,
                                           f"*_{suffix}.json"))):
        with open(p) as f:
            yield json.load(f)


def fit_table() -> str:
    gb = HBM_PER_CARD / 1e9
    rows = []
    for d in _records("pod1"):
        if d.get("error") or d.get("skipped"):
            continue
        real = d["memory"].get("real_bytes", 0) / 1e9
        rows.append((d["arch"], d["shape"], real,
                     "✓" if real <= gb else "✗", d.get("count_s", 0),
                     d.get("policy", {})))
    out = [f"| arch | shape | GB/device | ≤{gb:.0f} GB | count s | policy |",
           "|---|---|---|---|---|---|"]
    for a, s, g, fit, c, pol in rows:
        pol_s = ",".join(k for k, v in pol.items()
                         if v and k != "microbatches")
        if pol.get("microbatches", 1) > 1:
            pol_s += f",m={pol['microbatches']}"
        out.append(f"| {a} | {s} | {g:.2f} | {fit} | {c} | {pol_s} |")
    return "\n".join(out)


def pod2_summary() -> str:
    n_ok, n_total = 0, 0
    for d in _records("pod2"):
        if d.get("skipped"):
            continue
        n_total += 1
        if not d.get("error"):
            n_ok += 1
    return (f"Multi-pod (2,16,16) counted steps: {n_ok}/{n_total} cells OK "
            "in the current records.")


def refused() -> list:
    return [f"* `{d['arch']} × {d['shape']}`: {d['error']}"
            for d in _records("pod1") if d.get("error")]


def section() -> str:
    rows = full_table()
    live = [r for r in rows if not r.get("skipped")]
    text = [MARK, "", "### §Roofline table (single-pod, per device, H100; "
            "counted, not measured)", "", render_table(rows), "",
            f"*{len(live)} cells; every one counted exactly (an eager step "
            "counts every layer).*", "", "Dominant-term guidance per cell:",
            ""]
    for r in live:
        text.append(f"* `{r['arch']} × {r['shape']}` → {r['dominant']}-"
                    f"bound; {analysis.suggestion(r)}")
    text += ["", "### §Dry-run fit table (counted peak per device)", "",
             fit_table(), "", pod2_summary(), ""]
    bad = refused()
    if bad:
        text += ["Cells with no record:", ""] + bad + [""]
    return "\n".join(text)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.finalize_experiments")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    text = section()
    doc = ""
    if os.path.exists(args.out):
        with open(args.out) as f:
            doc = f.read()
        doc = doc.split(MARK)[0].rstrip()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write((doc + "\n\n" if doc else "") + text + "\n")
    n = sum(1 for r in full_table() if not r.get("skipped"))
    print(f"wrote the roofline section to {args.out}: {n} cells")


if __name__ == "__main__":
    main()
