"""What decides ``correct``, at a size a test run holds (the cells' sizes
run on the card): sound runs pass, the control (the reference computed in
float8 in the program's place) and planted faults of the timed path fail.
"""
import json

import numpy as np
import pytest
import torch

from benchlib import check, serve, spec
from conftest import DATA

SEEDS = (2**31 + 3, 17, 40961)


def _cell(name):
    return spec.load_cell(name, bench_file=DATA / "benchmark.json",
                          bench_dir=DATA)


def _run(cell, seed, seconds=1.0, fault=None):
    import run
    return run.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                        t_start=0.0, fault=fault)


@pytest.mark.parametrize("name", ["tiny-dense.tiny_backlog",
                                  "tiny-dense.tiny_walk"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(name, seed):
    correct, _, checks, findings = _run(_cell(name), seed)
    assert correct, checks
    assert not findings


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed):
    """The reference in float8 e4m3 (one step below the configuration's
    bf16), read at the same prompts and served tokens, lies past the
    limit (the dense model, as the benchmark's cells)."""
    cell = _cell("tiny-dense.tiny_backlog")
    r = serve.serve(cell.config, cell.traffic, seed, 1.0, trace=False,
                    device=torch.device("cpu"), t_start=0.0)
    plan = cell.limits["check"]
    sample = check.sample_requests(r, seed, plan["tokens"], plan["requests"])
    low = check.token_gaps(r, cell.config["model"], sample,
                           torch.device("cpu"), control=True)
    assert max(low) > cell.limits["limits"]["token_gap"]


def _token_altered(executor, window, controller):
    finish = executor.decode_finish

    def altered(launch):
        out = finish(launch)
        for s, rid in zip(launch.idx, launch.occupants):
            if rid is not None:
                out[s] = (out[s] + 1) % 512
        return out
    executor.decode_finish = altered


def _state_unchanged(executor, window, controller):
    launch_ = executor.decode_launch

    def unchanged(group, horizon):
        pos = group.pos_dev.clone()
        launch = launch_(group, horizon)
        group.pos_dev = pos           # the step's cache position never moves
        return launch
    executor.decode_launch = unchanged


def _half_rows(executor, window, controller):
    finish = executor.decode_finish

    def half(launch):
        out = finish(launch)
        rows = [s for s, rid in zip(launch.idx, launch.occupants)
                if rid is not None]
        k = len(rows) // 2
        for a, b in zip(rows[:k], rows[k:2 * k]):
            out[b] = out[a]           # half of the batch left undecoded
        return out
    executor.decode_finish = half


def _choice_altered(executor, window, controller):
    # the controller's Q-network is no longer the one the run drew
    controller.q_params = dict(controller.q_params,
                               w2=-controller.q_params["w2"])


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_rows, _choice_altered],
                         ids=["token_altered", "state_unchanged",
                              "half_rows", "choice_altered"])
def test_fault_is_not_correct(fault):
    correct, _, checks, _ = _run(_cell("tiny-dense.tiny_backlog"), 5,
                                 fault=fault)
    assert not correct, checks


def test_the_tiny_cell_prunes():
    """The tiny cell's pool binds, so decisions in its window remove
    blocks and ``choice_faults`` has steps to replay."""
    cell = _cell("tiny-dense.tiny_backlog")
    r = serve.serve(cell.config, cell.traffic, 5, 1.0, trace=False,
                    device=torch.device("cpu"), t_start=0.0)
    w = r.window
    steps = [sp.info[1].steps for sp in w.spans if sp.kind == "decide"
             and w.t_open <= sp.t0 < w.t_close and not sp.info[1].cached]
    assert max(steps) > 0


def test_decision_check_finds_a_wrong_peak():
    from reference import controller as ref_ctl
    cfg = _cell("tiny-dense.tiny_backlog").config["model"]
    peak = ref_ctl.Peak(cfg)
    full = np.ones(4, bool)
    p = peak(full, 1, 32)
    ok = [(1, 32, p + 1, full, 0, p, True, False)]
    assert ref_ctl.decision_faults(peak, ok) == []
    wrong_peak = [(1, 32, p + 1, full, 0, p - 64, True, False)]
    stopped_early = [(1, 32, p - 1, full, 0, p, False, False)]
    too_far = [(1, 32, p + 1, np.array([True, False, True, True]), 1,
                peak([True, False, True, True], 1, 32), True, False)]
    for d in (wrong_peak, stopped_early, too_far):
        assert ref_ctl.decision_faults(peak, d)


@pytest.mark.cuda
def test_a_cell_on_the_card(cuda_device, capsys):
    """One short run of a real cell on the card: the last line parses and
    its outputs are correct."""
    import run
    assert run.main(["--workload", "glm4-9b.longdoc_backlog",
                     "--seed", str(2**31 + 99), "--seconds", "5",
                     "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
