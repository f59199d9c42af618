"""The four example twins on ``repro_torch`` (``examples/*_torch.py``), each
run through its ``main`` on the CPU at SMOKE size with a few steps.

Each twin does what its JAX original in ``examples/`` does, on the port,
and runs on the GPU unless ``--device cpu`` is given. The import guard of
``tests/test_torch_engine.py`` covers them: none imports JAX or the JAX
package.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

torch.set_num_threads(1)
EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = ("quickstart_torch", "serve_elastic_budget_torch", "train_e2e_torch",
         "kernels_demo_torch")


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quickstart_twin(capsys):
    out = _load("quickstart_torch").main(
        ["--device", "cpu", "--smoke", "--steps", "3", "--episodes", "1",
         "--seq", "32"])
    assert out["finite"] and out["logits_shape"][:2] == (4, 32)
    assert len(out["order"]) == 2          # 2L - 2 removals on 2 layers
    assert out["mask"].shape == (4,)
    text = capsys.readouterr().out
    assert "GSI removal order" in text and "pruned forward OK" in text


def test_serve_elastic_budget_twin(capsys):
    out = _load("serve_elastic_budget_torch").main(
        ["--device", "cpu", "--smoke", "--steps", "2", "--episodes", "1",
         "--seq", "64", "--burst", "3"])
    assert len(out["kept"]) == 7
    rep = out["burst"]
    assert [r.status for r in rep.results] == ["done"] * 3
    assert rep.pool["overcommit_events"] == 0
    assert rep.pool["peak_reserved_bytes"] <= rep.pool["capacity_bytes"]
    assert "never exceeded" in capsys.readouterr().out


def test_train_e2e_twin_resumes(tmp_path, capsys):
    module = _load("train_e2e_torch")
    argv = ["--device", "cpu", "--size", "smoke", "--batch", "2", "--seq",
            "32", "--ckpt-dir", str(tmp_path)]
    first = module.main(argv + ["--steps", "2"])
    assert not first["resumed"] and first["summary"]["final_step"] == 2
    second = module.main(argv + ["--steps", "4"])
    assert second["resumed"] and second["summary"]["final_step"] == 4
    assert np.isfinite(second["heldout_ppl"])
    assert "resuming from step 2" in capsys.readouterr().out


def test_kernels_demo_twin_runs_the_plain_versions_on_the_cpu(capsys):
    before = ops.launch_counts()
    out = _load("kernels_demo_torch").main(["--device", "cpu"])
    assert set(out) == {fn.__name__ for fn in ops.KERNELS}
    assert all(d == 0.0 for d in out.values())     # the same plain calls
    assert ops.launch_counts() == before           # no kernel launched
    assert "the plain version (CPU)" in capsys.readouterr().out


@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_without_a_gpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        _load(name).main([])
