"""The port's paper experiments against the JAX package's, on the CPU.

Each ported script (``repro_torch/benchmarks/<name>.py``) runs beside its
JAX twin (``benchmarks/<name>.py``). Both sides' ``common.subject`` return
the same weights (SMOKE llama2 at 4 layers, JAX-initialised and carried by
``repro_torch.bridge``) and corpus (seed 0), and both sides'
``common.trained_controller`` a controller over the same Q-net (hidden 64,
``init_qnet`` of ``jax.random.key(0)``; the JAX model's ``logits`` and
``loss`` under ``jax.jit``); ``BENCH_DIR`` goes under
``tmp_path`` on both sides. fig9 and fig10 run the real
``trained_controller`` at 1 episode on both sides (ε = 1: the episode's
actions come from the shared numpy stream, and no TD update runs), then
decide with the shared Q-net.

Rows are compared field by field: keys, schemes, blocks, ``kept_blocks``,
``kept``, ``fits``, ``param_frac`` and the analytic fields exactly; ``ppl``
within 1e-4 relative and ``acc`` within 1e-6 (f32 logits within 1e-4);
fields the scripts round to n decimals within one rounding unit plus 1e-4
of f32 slack. fig11's latencies are each device's own: only their row's
keys are compared.

Also here: ``trained_controller`` trains at 1 episode, caches its Q-net in
the JAX JSON layout and reloads it, a Q-net file written by either package
loads in the other, and ``python -m repro_torch.benchmarks.run``'s
selection (``--only roofline`` raises naming ROADMAP queue 1, item 17).
"""
import importlib
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:          # the JAX package's benchmarks/
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import controller as jctl, dqn as jdqn  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.data import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.benchmarks import common  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import controller, dqn, env  # noqa: E402
from repro_torch.data import SyntheticCorpus  # noqa: E402
from repro_torch.models import registry  # noqa: E402

torch.set_num_threads(1)

L = 4
PPL_RTOL, ACC_ATOL, SLACK = 1e-4, 1e-6, 1e-4
# fields each script rounds, and to how many decimals
ROUNDED = {"delta_log_ppl": 4, "gsi_score": 4, "oneshot_score": 4,
           "reward_smoothed": 4, "mean_reward": 4, "ppl_ratio": 3}


@pytest.fixture(scope="module")
def pair():
    jm = jreg.build(jax_smoke("llama2-7b").replace(n_layers=L))
    jp = jm.init(jax.random.key(0))
    # the same functions compiled once, not dispatched op by op per call
    jm = jm._replace(logits=jax.jit(jm.logits), loss=jax.jit(jm.loss))
    tm = registry.build(get_smoke_config("llama2-7b").replace(n_layers=L))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 64)
    tq = bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jq=jq, tq=tq,
                jcorpus=JaxCorpus(jm.cfg.vocab_size, seed=0),
                tcorpus=SyntheticCorpus(tm.cfg.vocab_size, seed=0))


def _jax_controller(model, params, corpus, q, alpha=1.0, beta=0.3):
    calib = jcommon.calib_batch(corpus, n=2, seq=64)
    return jctl.RAPController(model, params, calib,
                              jcommon.memory_model(model.cfg), q,
                              env_cfg=jenv.EnvConfig(alpha=alpha, beta=beta),
                              chunk=16)


def _port_controller(model, params, corpus, q, alpha=1.0, beta=0.3):
    calib = common.calib_batch(corpus, n=2, seq=64)
    return controller.RAPController(
        model, params, calib, common.memory_model(model.cfg), q,
        env_cfg=env.EnvConfig(alpha=alpha, beta=beta), chunk=16)


@pytest.fixture
def sides(pair, tmp_path, monkeypatch):
    """Both ``common`` modules substituted alike; returns a runner of one
    experiment on both sides: (JAX rows, port rows)."""
    s = pair
    monkeypatch.setattr(jcommon, "BENCH_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(common, "BENCH_DIR", str(tmp_path / "torch"))
    monkeypatch.setattr(common, "DEVICE", "cpu")
    monkeypatch.setattr(jcommon, "subject",
                        lambda: (s["jm"], s["jp"], s["jcorpus"]))
    monkeypatch.setattr(common, "subject",
                        lambda **_: (s["tm"], s["tp"], s["tcorpus"]))
    tr = dict(rewards=[0.5], fits=[True])
    monkeypatch.setattr(
        jcommon, "trained_controller",
        lambda m, p, c, **kw: (_jax_controller(m, p, c, s["jq"]),
                               jdqn.TrainResult(s["jq"], tr["rewards"],
                                                tr["fits"], [])))
    monkeypatch.setattr(
        common, "trained_controller",
        lambda m, p, c, **kw: (_port_controller(m, p, c, s["tq"]),
                               dqn.TrainResult(s["tq"], tr["rewards"],
                                               tr["fits"], [])))

    def one_episode(orig, q):
        """The real ``trained_controller`` at 1 episode, then the shared
        Q-net in its controller."""
        def wrapped(m, p, c, **kw):
            ctl, res = orig(m, p, c, **{**kw, "episodes": 1})
            ctl.q_params = q
            return ctl, res
        return wrapped

    def run(name, real_training=False):
        if real_training:
            monkeypatch.setattr(jcommon, "trained_controller",
                                one_episode(_JAX_TRAINED, s["jq"]))
            monkeypatch.setattr(common, "trained_controller",
                                one_episode(_PORT_TRAINED, s["tq"]))
        want = importlib.import_module(f"benchmarks.{name}").run()
        got = importlib.import_module(f"repro_torch.benchmarks.{name}").run()
        for side in ("jax", "torch"):
            assert (tmp_path / side / f"{name}.json").exists()
        return want, got

    return run


_JAX_TRAINED = jcommon.trained_controller
_PORT_TRAINED = common.trained_controller


def _same_rows(want, got):
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert list(g) == list(w), (g, w)
        for k, wv in w.items():
            gv = g[k]
            if k == "ppl":
                np.testing.assert_allclose(gv, wv, rtol=PPL_RTOL, err_msg=k)
            elif k == "acc":
                assert abs(gv - wv) <= ACC_ATOL, (k, gv, wv)
            elif k in ROUNDED:
                assert abs(gv - wv) <= 10.0 ** -ROUNDED[k] + SLACK, (k, g, w)
            else:           # schemes, blocks, kept, fits, param_frac, ...
                assert gv == wv, (k, gv, wv)
                assert isinstance(gv, bool) == isinstance(wv, bool), k


@pytest.mark.parametrize("name", ["fig3_memory_breakdown",
                                  "fig4_block_sensitivity",
                                  "fig6_gsi_vs_oneshot", "table1_budgets",
                                  "table2_ablation", "table4_prune_ratio"])
def test_experiment_rows_match_jax(sides, name):
    want, got = sides(name)
    _same_rows(want, got)
    if name == "table1_budgets":
        for r in got:
            if r["scheme"] not in ("FFN-Skip",):
                assert r["fits"], r
        assert {r["scheme"] for r in got} == {
            "Dense", "LLMPruner", "ShortGPT", "MHA-Drop", "FFN-Skip",
            "SliceGPT", "RAP"}
        assert all(np.isfinite(r["ppl"]) for r in got)


@pytest.mark.parametrize("name", ["fig9_seeds", "fig10_alpha_beta"])
def test_trained_experiments_match_jax(sides, name, capsys):
    want, got = sides(name, real_training=True)
    _same_rows(want, got)
    assert "training DQN policy" in capsys.readouterr().out


def test_overhead_counts_match_jax(sides):
    want, got = sides("fig11_overhead")
    assert [r["quantity"] for r in got] == [r["quantity"] for r in want]
    _same_rows(want[:2], got[:2])
    assert list(got[2]) == list(want[2])
    assert got[2]["controller"] >= 0.0 and got[2]["model"] > 0.0


def test_trained_controller_caches_in_the_jax_layout(pair, tmp_path,
                                                     capsys, monkeypatch):
    s = pair
    bench = tmp_path / "torch"
    ctl, tr = common.trained_controller(s["tm"], s["tp"], s["tcorpus"],
                                        episodes=1, tag="t",
                                        bench_dir=str(bench))
    assert "training DQN policy (t, seed 0, 1 eps)" in capsys.readouterr().out
    meta = json.loads((bench / "qnet_t_s0.json").read_text())
    assert sorted(meta) == ["fits", "q_params", "rewards"]
    assert len(meta["rewards"]) == len(meta["fits"]) == 1
    ctl2, tr2 = common.trained_controller(s["tm"], s["tp"], s["tcorpus"],
                                          episodes=1, tag="t",
                                          bench_dir=str(bench))
    assert "training" not in capsys.readouterr().out
    for k, v in tr.q_params.items():
        assert torch.equal(tr2.q_params[k], v)
    assert ctl2.decide(8, 512, 0.8 * common.memory_model(
        s["tm"].cfg).dense_peak(8, 512)).fits
    # the port's file loads in the JAX package ...
    monkeypatch.setattr(jcommon, "BENCH_DIR", str(bench))
    _, jtr = jcommon.trained_controller(s["jm"], s["jp"], s["jcorpus"],
                                        episodes=1, tag="t")
    assert "training" not in capsys.readouterr().out
    for k, v in tr.q_params.items():
        np.testing.assert_array_equal(np.asarray(jtr.q_params[k]), v.numpy())
    assert jtr.episode_rewards == tr.episode_rewards
    # ... and a JAX-written file loads in the port
    jdir = tmp_path / "jax"
    monkeypatch.setattr(jcommon, "BENCH_DIR", str(jdir))
    _, jtr = jcommon.trained_controller(s["jm"], s["jp"], s["jcorpus"],
                                        episodes=1, tag="j", seed=1)
    assert "training DQN policy (j, seed 1" in capsys.readouterr().out
    shutil.copy(jdir / "qnet_j_s1.json", bench / "qnet_j_s1.json")
    _, ttr = common.trained_controller(s["tm"], s["tp"], s["tcorpus"],
                                       episodes=1, tag="j", seed=1,
                                       bench_dir=str(bench))
    assert "training" not in capsys.readouterr().out
    for k, v in jtr.q_params.items():
        np.testing.assert_array_equal(ttr.q_params[k].numpy(), np.asarray(v))
        assert ttr.q_params[k].dtype == torch.float32
    assert ttr.episode_fits == jtr.episode_fits


def test_run_harness_selects_and_refuses(sides, capsys, tmp_path,
                                         monkeypatch):
    """The port's entries are JAX's; ``--only roofline`` renders the
    dry run's records (here one, in ``tmp_path``)."""
    from repro_torch.benchmarks import common, run
    from repro_torch.roofline import analysis
    from repro_torch.runtime import count
    names = [b[0] for b in run.BENCHES]
    jnames = [b[0] for b in importlib.import_module("benchmarks.run").BENCHES]
    assert names == jnames
    # --only roofline: the table from a dry-run record in tmp_path
    cell = count.empty_collectives()
    count.record_collective(cell, "all-reduce", 1e8, range(16))
    (tmp_path / "gemma-2b_decode_32k_pod1.json").write_text(json.dumps(
        {"arch": "gemma-2b", "shape": "decode_32k", "kind": "decode",
         "unroll": True, "n_devices": 256, "policy": {},
         "cost": {"flops": 4e13, "bytes_accessed": 2e10},
         "memory": {"argument_bytes": 5e9, "real_bytes": 5.2e9},
         "collectives": cell}))
    with monkeypatch.context() as mp:
        mp.setattr(analysis, "DRYRUN_DIR", str(tmp_path))
        mp.setattr(common, "BENCH_DIR", str(tmp_path / "bench"))
        run.main(["--only", "roofline"])
    out = capsys.readouterr().out
    assert "| gemma-2b | decode_32k |" in out and "===== roofline done" in out
    assert "1 cells analyzed; 1 fit 80GB/card HBM" in out
    assert (tmp_path / "bench" / "roofline.json").exists()
    with pytest.raises(SystemExit):
        run.main(["--only", "nothing"])
    run.main(["--only", "fig3,table4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "===== fig3 done" in out and "===== table4 done" in out
    assert "all benchmarks complete" in out and "fig9" not in out
