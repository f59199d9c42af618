"""§Roofline: three-term table for every (arch × shape) from the dry run
(``repro_torch.launch.dryrun``'s records), in H100 terms."""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.launch.mesh import HBM_PER_CARD
from repro_torch.roofline import analysis, full_table, render_table


def run() -> list:
    rows = full_table()
    live = [r for r in rows if not r.get("skipped")]
    print(render_table(rows))
    for r in live:
        print(f"# {r['arch']}×{r['shape']}: {analysis.suggestion(r)}")
    common.emit("roofline", rows,
                header=["arch", "shape", "compute_s", "memory_s",
                        "collective_s", "dominant", "roofline_frac",
                        "fit_gb"])
    if live:
        n_fit = sum(1 for r in live if r.get("fits_hbm"))
        print(f"# {len(live)} cells analyzed; {n_fit} fit "
              f"{HBM_PER_CARD / 1e9:.0f}GB/card HBM")
    else:
        print(f"# no dry-run records in {analysis.DRYRUN_DIR}: run "
              f"python -m repro_torch.launch.dryrun --all")
    return rows
