"""The harness without a card: what it may import, how it finds a cell's
parts, its traffic, its work counts, its window arithmetic and its last
line."""
import ast
import json
import math
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from benchlib import latency, result, spec, traffic, workcount
from conftest import BENCH, DATA

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    # whole top-level names: repro_torch is the port, repro the JAX package
    assert not FORBIDDEN & set(_imports(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "typing", "numpy",
                                   "torch", "reference"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert run.forbidden_modules() == ["repro"]


def test_discovery_by_name(tmp_path):
    """A new configuration, mix, cell and metric are found by their names
    alone, with no module edited."""
    for d in ("configs", "traffic", "cells", "metrics"):
        (tmp_path / d).mkdir()
    shutil.copy(DATA / "configs" / "tiny-dense.json",
                tmp_path / "configs" / "new-model.json")
    shutil.copy(DATA / "traffic" / "tiny_backlog.json",
                tmp_path / "traffic" / "new_mix.json")
    (tmp_path / "cells" / "new-model.new_mix.json").write_text(
        json.dumps({"limits": {"token_gap": 1.0}}))
    (tmp_path / "metrics" / "spans.count.py").write_text(
        "def read(trace):\n    return len(trace['spans']) or None\n")
    bench = {"configs": [{"name": "new-model"}],
             "workloads": [{"name": "new-model.new_mix", "config": "new-model",
                            "traffic": "new_mix", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "spans.count", "unit": "1",
                            "workloads": ["new-model.new_mix"]},
                           {"name": "other", "unit": "1",
                            "workloads": ["elsewhere"]}]}
    (tmp_path / "benchmark.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new-model.new_mix",
                          bench_file=tmp_path / "benchmark.json",
                          bench_dir=tmp_path)
    assert cell.config["model"]["n_layers"] == 2
    assert cell.traffic["loop"] == "backlog"
    assert cell.limits["limits"]["token_gap"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["spans.count"]
    got = spec.read_metrics(cell.per_layer, {"spans": [1, 2]},
                            bench_dir=tmp_path)
    assert got == {"spans.count": {"value": 2.0, "unit": "1"}}
    assert spec.read_metrics(cell.per_layer, {"spans": []},
                             bench_dir=tmp_path) == {}


def test_the_repository_cells_have_their_files():
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


MIXES = ["tiny_backlog", "tiny_walk"]


@pytest.mark.parametrize("mix", MIXES)
def test_the_work_is_the_mixs_and_the_tokens_the_seeds(mix):
    """Every seed serves the same sizes, arrivals and order (the mix's
    ``population_seed`` draws them); the seed draws the prompts' ids."""
    from benchlib import inputs
    m = spec.load_json(DATA / "traffic" / f"{mix}.json")
    kw = {"n": 64} if m["loop"] == "backlog" else {"horizon_s": 5.0}
    a = traffic.schedule(m, **kw)
    assert a == traffic.schedule(m, **kw)
    assert a != traffic.schedule(dict(m, population_seed=1), **kw)
    p1, p2 = inputs.Prompts(512, 1), inputs.Prompts(512, 2**31 + 5)
    assert (p1(3, 2, 16) == p1(3, 2, 16)).all()
    assert (p1(3, 2, 16) != p2(3, 2, 16)).any()


@pytest.mark.parametrize("mix", MIXES)
def test_each_copy_of_the_population_is_one_block(mix):
    m = spec.load_json(DATA / "traffic" / f"{mix}.json")
    P = int(m["population"])
    s = traffic.schedule(m, n=2 * P, horizon_s=1e9)
    blocks = [sorted((x.batch, x.prompt, x.output) for x in
                     s.arrivals[i * P:(i + 1) * P]) for i in (0, 1)]
    assert blocks[0] == blocks[1]
    assert all(x.prompt % m["round_to"] == 0 for x in s.arrivals)
    assert all(m["output"]["lo"] <= x.output <= m["output"]["hi"]
               for x in s.arrivals)


def test_open_loop_and_walk():
    m = spec.load_json(DATA / "traffic" / "tiny_walk.json")
    s = traffic.schedule(m, horizon_s=20.0)
    t = [a.t for a in s.arrivals]
    assert t == sorted(t) and t[-1] < 20.0
    fr = [f for _, f in s.kv_frac]
    assert len(fr) == len(t)
    assert min(fr) >= m["walk"]["floor"] and max(fr) <= 1.0
    # the walk moves the KV headroom, never the weights
    bp = traffic.budget_breakpoints(s.kv_frac, 1000.0, 200.0)
    assert all(1000.0 + m["walk"]["floor"] * 200.0 <= b <= 1200.0
               for _, b in bp)
    assert traffic.budget_breakpoints(None, 1.0, 1.0) is None


CFG = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
       "head_dim": 4, "d_ff": 16, "vocab_size": 10}


def test_workcount_by_hand():
    # per token, one layer: q 8·8, k 8·4, v 8·4, o 8·8 → 2·(64+32+32+64)
    assert workcount.mixer_token_flops(CFG) == 384.0
    assert workcount.ffn_token_flops(CFG) == 6 * 8 * 16
    assert workcount.attn_pair_flops(CFG) == 4 * 2 * 4
    full = np.ones(4, bool)
    # 3 tokens: 6 causal pairs; head at 1 position
    want = 3 * 2 * (384 + 768) + 6 * 2 * 32 + 1 * 2 * 8 * 10
    assert workcount.forward_flops(CFG, full, 1, 3, 1) == want
    # a gated-off block counts nothing
    m = np.array([True, False, True, False])
    assert workcount.forward_flops(CFG, m, 1, 3, 1) == \
        3 * (384 + 768) + 6 * 32 + 160
    assert workcount.decode_flops(CFG, full, [5, 7]) == \
        2 * (2 * (384 + 768) + 160) + 12 * 2 * 32
    # lengths 17 and 1: K and V 18 tokens · 1 head · 4 · 2 B each, q and
    # out 2 rows · 2 heads · 4 · 2 B each, 3 page ids, 2 lengths
    nb, ops = workcount.paged_decode_call(CFG, [17, 1])
    assert nb == 2 * 18 * 4 * 2 + 2 * 2 * 8 * 2 + 3 * 4 + 2 * 4
    assert ops == 18 * 32
    nb, ops = workcount.flash_call(CFG, 2, 3)
    assert nb == 6 * 4 * 2 * (2 * 2 + 2 * 1) and ops == 2 * 6 * 32
    assert workcount.least_seconds(3.35e12, 1.0) == (1.0, "bytes")
    assert workcount.least_seconds(1.0, 989e12) == (1.0, "operations")
    # a pass: the log-ppl forward and one forward per active block, the
    # head at every position but the last
    m = np.array([True, False, True, True])
    one = [workcount.forward_flops(CFG, m, 2, 3, 2)] + [
        workcount.forward_flops(CFG, m & (np.arange(4) != b), 2, 3, 2)
        for b in (0, 2, 3)]
    assert workcount.gsi_pass_flops(CFG, m, 2, 3) == sum(one)


def test_percentile_counts_the_missing():
    assert latency.percentile([1, 2, 3, 4, 5], 50) == 3
    assert latency.percentile([0.0, 10.0], 90) == 9.0
    assert latency.percentile([1.0] * 10 + [math.inf], 90) == 1.0
    assert latency.percentile([1.0] * 9 + [math.inf] * 2, 90) == math.inf
    assert math.isnan(latency.percentile([], 50))


class _S:
    def __init__(self, rid, due, first, readbacks, batch=1):
        self.rid, self.due, self.first_t = rid, due, first
        self.readbacks, self.batch = readbacks, batch


class _W:
    t_open, t_close, seconds, backlog = 10.0, 20.0, 10.0, False

    def __init__(self, served):
        self.served = {s.rid: s for s in served}


def test_window_arithmetic():
    w = _W([
        _S("a", 9.0, 9.5, [(10.5, 8), (12.5, 8), (21.0, 8)]),
        _S("b", 11.0, 12.0, [(13.0, 4)], batch=2),
        _S("c", 19.0, None, []),                  # no token by the end
        _S("d", 25.0, 25.5, []),                  # due after the window
    ])
    # a: 8 + 8 in the window; b: first token and 4 steps, 2 rows each
    assert result.tokens_per_s(w) == (16 + 2 * (1 + 4)) / 10.0
    its = result.itl_samples(w)
    assert sorted(its) == sorted([0.125] * 8 + [0.25] * 8 + [0.25] * 4)
    tt = result.ttft_samples(w, [])
    assert sorted(tt) == [1.0, math.inf]


def test_last_line_shape(tmp_path):
    """A whole run on the CPU at a tiny size: the line's keys, in order,
    and each compared number beside its limit."""
    import torch

    import run
    cell = spec.load_cell("tiny-dense.tiny_backlog",
                          bench_file=DATA / "benchmark.json", bench_dir=DATA)
    correct, out, checks, findings = run.run_cell(
        cell, 2**31 + 11, 1.0, False, torch.device("cpu"), t_start=0.0)
    line = json.loads(json.dumps({"correct": correct, **out,
                                  "checks": checks}))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and not findings
    assert set(line["metrics"]) == {"tokens_per_s", "itl_p99_ms",
                                    "peak_mem_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert {"token_gap", "decision_faults", "pool_overcommits",
            "pool_over_capacity_bytes"} <= set(line["checks"])
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", ["tiny-dense.tiny_backlog",
                                  "tiny-dense.tiny_walk"])
def test_traced_readers_on_the_cpu(name):
    """A traced run without a card: the readers of spans and counters
    read, the device's readers find nothing and leave their metric out."""
    import torch

    import run
    cell = spec.load_cell(name, bench_file=DATA / "benchmark.json",
                          bench_dir=DATA)
    correct, out, checks, _ = run.run_cell(cell, 9, 1.0, True,
                                           torch.device("cpu"), t_start=0.0)
    assert correct, checks
    got = set(out["metrics"])
    device = {"paged_decode_roofline.backlog"}
    assert got == {m["name"] for m in cell.per_layer} - device
    assert all(math.isfinite(v["value"]) and v["value"] >= 0
               for v in out["metrics"].values())
    assert "busy_s" not in out["device"] and "breakdown" not in out
