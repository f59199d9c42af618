"""Where a cell's parts live, found by name.

``BENCHMARK.json`` names cells, configurations and metrics. Everything that
belongs to one of them sits in a file of its own beside this package:

* ``bench/configs/<config>.json``   the configuration as it is run;
* ``bench/traffic/<traffic>.json``  the traffic mix's parameters, read by
  the one generator in ``traffic.py``;
* ``bench/cells/<cell>.json``       the cell's comparison limits, with the
  readings each was set from;
* ``bench/metrics/<metric>.py``     the reader of one metric: a module
  with ``read(x) -> float | None``, where ``x`` is the finished run for an
  end-to-end metric and ``result.Trace`` for a per-layer one.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries, never by editing one of these modules.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, *, bench_file: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (``bench_file``; the repo
    root's by default) and its files under ``bench_dir``."""
    spec = load_json(bench_file or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        traffic_name=w["traffic"],
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "cells" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def metric_reader(name: str, *, bench_dir: Path = BENCH_DIR) -> Callable:
    """``read(trace)`` of ``bench/metrics/<name>.py``, loaded by path (a
    metric's name may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], source,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each metric its reader finds something for in ``source``; a reader
    that returns None leaves its metric out."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"], bench_dir=bench_dir)(source)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
