"""Three-term roofline from the dry-run records, in H100 terms.

Per (arch × shape) on the single-pod mesh (``launch/dryrun.py``'s records
in ``experiments/dryrun_torch/``, counted from the port's own step):

    compute_s    = FLOPs/device ÷ 989 TF/s      (dense bf16 tensor cores)
    memory_s     = bytes/device ÷ 3.35 TB/s     (HBM3)
    collective_s = Σ wire_bytes/device ÷ 450 GB/s (NVLink) for a group
                   inside one node of 8 consecutive ranks, ÷ 50 GB/s (one
                   400 Gb/s NDR port per GPU) for any other

(``launch.mesh``'s data-sheet figures). Every record counts every layer
(an eager step), so each row is exact: there is no scan-lowered lower
bound to fall back from.

MODEL_FLOPS uses the standard accounting: train 6·N·T (fwd 2 + bwd 4),
prefill 2·N·T, decode 2·N·B — with N_active for MoE — plus attention
O(S²·H·Dh) terms. The ratio MODEL_FLOPS/counted FLOPs exposes remat
recompute, the plain backward of the kernels and dispatch waste.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                 get_shape, shape_applicable)
from repro_torch.launch.mesh import (CARDS_PER_NODE, HBM_BW, HBM_PER_CARD,
                                     NET_BW, NVLINK_BW, PEAK_FLOPS_BF16)

DRYRUN_DIR = "experiments/dryrun_torch"


def _load(tag: str) -> Optional[Dict]:
    p = os.path.join(DRYRUN_DIR, tag + ".json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        d = json.load(f)
    return None if d.get("error") or d.get("skipped") else d


def collective_seconds(coll: Dict) -> float:
    """Seconds of a record's collectives: each group's wire bytes over
    NVLink when its ranks lie within one node of ``CARDS_PER_NODE``
    consecutive ranks, else over the network. A record without groups is
    priced at the network's rate."""
    t, grouped = 0.0, 0.0
    for v in coll.values():
        if not isinstance(v, dict):
            continue
        for ranks, wire in v.get("groups", {}).items():
            nodes = {int(r) // CARDS_PER_NODE for r in ranks.split(",")}
            t += wire / (NVLINK_BW if len(nodes) == 1 else NET_BW)
            grouped += wire
    return t + (coll.get("total_wire_bytes", 0.0) - grouped) / NET_BW


def model_flops_per_device(arch: str, shape_name: str,
                           n_devices: int = 256) -> float:
    """Analytic MODEL_FLOPS per device (the 'useful compute' yardstick)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n_active = cfg.active_params()
    B, S = shape.global_batch, shape.seq_len
    window = cfg.attn_window
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        mult = 3.0   # fwd + 2×bwd for the attention term too
    elif shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        mult = 1.0
    else:  # decode: one token per sequence
        tokens = B
        flops = 2.0 * n_active * tokens
        mult = 1.0
    # attention score+combine FLOPs (not in the 6ND param accounting)
    if cfg.n_heads > 0 and shape.kind != "decode":
        for mixer in cfg.mixer_kinds():
            if mixer == "attn":
                eff = S
            elif mixer == "local_attn":
                eff = min(window, S) if window else S
            else:
                continue
            # causal: ~S·eff/2 scores; 2 matmuls (QK^T and PV), 2 FLOP/MAC
            flops += mult * B * cfg.n_heads * cfg.dh * S * eff * 2.0
    if shape.kind == "decode" and cfg.n_heads > 0:
        for mixer in cfg.mixer_kinds():
            if mixer == "attn":
                eff = S
            elif mixer == "local_attn":
                eff = min(window, S) if window else S
            else:
                continue
            flops += B * cfg.n_heads * cfg.dh * eff * 2.0 * 2.0
    return flops / n_devices


def analyze_cell(arch: str, shape_name: str) -> Optional[Dict]:
    src = _load(f"{arch}_{shape_name}_pod1")
    if src is None:
        return None
    flops = src["cost"]["flops"]
    bytes_acc = src["cost"]["bytes_accessed"]
    mf = model_flops_per_device(arch, shape_name,
                                src.get("n_devices", 256))
    compute_s = flops / PEAK_FLOPS_BF16
    memory_s = bytes_acc / HBM_BW
    coll_s = collective_seconds(src["collectives"])
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mem_fit = src["memory"].get("real_bytes",
                                src["memory"]["argument_bytes"])
    return {
        "arch": arch, "shape": shape_name,
        "kind": src["kind"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "hlo_flops": flops, "model_flops": mf,
        "useful_ratio": (mf / flops) if flops else None,
        # not capped at 1 (JAX caps it): a share above 1 is counted work
        # below the model's, i.e. a counting error, and shows as such
        "roofline_frac": (mf / PEAK_FLOPS_BF16) / bound if bound else 0.0,
        "fit_gb": mem_fit / 1e9, "fits_hbm": mem_fit <= HBM_PER_CARD,
        "unrolled": True,           # every record counts every layer
        "policy": src.get("policy", {}),
    }


_SUGGEST = {
    "compute": ("dominant term is tensor-core compute — already near the "
                "useful work floor; gains come from cutting remat recompute "
                "and the kernels' plain backward (useful_ratio < 1) or fp8 "
                "matmuls"),
    "memory": ("dominant term is HBM3 traffic — fuse/eliminate materialized "
               "intermediates (attention probs, MoE dispatch buffers, eager "
               "elementwise chains), shrink KV via int8/fp8, or re-block "
               "kernels"),
    "collective": ("dominant term is NVLink / network wire — keep tensor "
                   "parallelism inside a node of 8, reduce per-layer "
                   "all-gathers (KV heads that divide the model axis, "
                   "weights gathered once), fold reduce-scatter into matmul "
                   "consumers, or compress gradients"),
}


def suggestion(row: Dict) -> str:
    return _SUGGEST[row["dominant"]]


def full_table() -> List[Dict]:
    rows = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if not shape_applicable(cfg, shape):
                rows.append({"arch": arch, "shape": shape.name,
                             "skipped": True})
                continue
            r = analyze_cell(arch, shape.name)
            if r:
                rows.append(r)
    return rows


def render_table(rows: List[Dict]) -> str:
    out = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
           "| MODEL/HLO | roofline_frac | fit GB |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | n/a "
                       "(full-attn skips long_500k) | — | — | — |")
            continue
        ur = (f"{r['useful_ratio']:.2f}" if r["useful_ratio"] is not None
              else "—")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| {r['dominant']} | {ur} "
            f"| {r['roofline_frac']:.3f} | {r['fit_gb']:.2f} |")
    return "\n".join(out)
