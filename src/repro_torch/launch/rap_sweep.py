"""RAP-at-scale sweep: count the decode step of structurally pruned
variants of an architecture and report how the roofline terms move, in
H100 terms.

Decode is memory-bound (params + KV cache streamed once per token), so the
paper's co-pruning of MHA blocks (KV bytes) and FFN blocks (param bytes) is
*directly* a roofline lever: the dominant memory term scales with the
retained blocks. This script quantifies that at production scale — the
systems-level counterpart of the paper's Table 1. Each variant keeps
``max(2, round(L × keep))`` layers (the dominant structural-compaction
bucket) and is counted through ``ShardedExecutor.lower_decode`` on rank 0
of the production mesh (a ``launch.mesh.fake_world``); the terms divide
its counts by the card's peaks (``launch.mesh``).

  python -m repro_torch.launch.rap_sweep --arch qwen3-14b --shape decode_32k
"""
from __future__ import annotations

import argparse
import json
import os

RAP_DIR = "experiments/rap_sweep"


def roofline_terms(record) -> dict:
    """(compute_s, memory_s, collective_s) of a counted record: its FLOPs
    over the bf16 peak, its bytes over HBM's rate, its wire bytes priced
    as ``roofline.analysis.collective_seconds`` prices them."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.roofline.analysis import collective_seconds
    return {"compute_s": record["cost"]["flops"] / PEAK_FLOPS_BF16,
            "memory_s": record["cost"]["bytes_accessed"] / HBM_BW,
            "collective_s": collective_seconds(record["collectives"])}


def lower_pruned_decode(arch: str, shape, keep_frac: float,
                        out_dir: str = RAP_DIR, *, mesh=None) -> dict:
    """Count decode for a layer-bucket pruned variant (``keep_frac`` of the
    layers) through the ``ShardedExecutor``'s mesh-placement path.
    ``shape``: a ``configs.SHAPES`` name or a ``ShapeConfig``; ``mesh``:
    the mesh to count on (default the production mesh, on a fake world of
    its ranks)."""
    from repro_torch.configs import ShapeConfig, get_config, get_shape
    from repro_torch.launch.dryrun import cell_policy
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import registry
    from repro_torch.runtime.executor import ShardedExecutor

    base = get_config(arch)
    L = max(2, int(round(base.n_layers * keep_frac)))
    cfg = base.replace(n_layers=L)
    shape = shape if isinstance(shape, ShapeConfig) else get_shape(shape)
    policy = cell_policy(arch, shape)
    model = registry.build(cfg)

    def count(m):
        ex = ShardedExecutor(model, m, fsdp=policy["fsdp"],
                             shard_seq=policy["shard_seq"],
                             kv_int8=policy["kv_int8"])
        return ex.lower_decode(shape)

    if mesh is None:
        with fake_world(256):
            rec = count(make_production_mesh())
    else:
        rec = count(mesh)
    result = {
        "arch": arch, "shape": shape.name, "keep_frac": keep_frac,
        "n_layers": L, **roofline_terms(rec),
        "flops": rec["cost"]["flops"], "bytes": rec["cost"]["bytes_accessed"],
        "real_gb": rec["memory"]["real_bytes"] / 1e9,
        "kernels": rec["kernels"],
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = f"rap_{arch}_{shape.name}_keep{int(keep_frac * 100)}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def bound(r: dict) -> float:
    return max(r["memory_s"], r["compute_s"], r["collective_s"])


def sweep(arch: str, shape, fracs, out_dir: str = RAP_DIR, *,
          mesh=None) -> list:
    """Count each keep fraction and print its row; then each variant's
    step-time bound as a share of the dense one (the first fraction)."""
    print(f"{'keep':>5} {'layers':>6} {'mem_s':>9} {'comp_s':>9} "
          f"{'coll_s':>9} {'fit_GB':>7}")
    rows = []
    for frac in fracs:
        r = lower_pruned_decode(arch, shape, frac, out_dir, mesh=mesh)
        rows.append(r)
        print(f"{frac:5.2f} {r['n_layers']:6d} {r['memory_s']:9.5f} "
              f"{r['compute_s']:9.5f} {r['collective_s']:9.5f} "
              f"{r['real_gb']:7.2f}", flush=True)
    for r in rows[1:]:
        print(f"# keep={r['keep_frac']}: step-time bound "
              f"{bound(r) / bound(rows[0]):.3f}× of dense")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.rap_sweep")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--fracs", default="1.0,0.8,0.6")
    ap.add_argument("--out", default=RAP_DIR)
    args = ap.parse_args(argv)
    sweep(args.arch, args.shape, [float(x) for x in args.fracs.split(",")],
          args.out)


if __name__ == "__main__":
    main()
