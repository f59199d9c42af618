"""The port's serving engine against the JAX package's, on the CPU.

The canonical trace of ``tests/test_executors.py`` (8 requests, 16/24-token
prompts, a KV pool of ~2.5 dense requests) goes through the JAX
``RAPEngine`` + ``PagedExecutor`` and through the port's, with bridged
weights and Q-network: every request is done, with equal tokens and masks
per request and an equal pool peak. Requests all arrive at t = 0, so
admission order does not depend on either framework's speed. With the
admission grid at 0.3 of the dense peak the RL controller prunes, so the
per-slot gates are exercised too.

Also here: the port's own report invariants and horizon invariance, the
``launch.serve`` entry point on the CPU, the later-slice switches that must
raise ``NotImplementedError``, and the import guard (no module of the port,
not ``chip_smoke.py`` and not the example twins ``examples/*_torch.py``
imports JAX, the JAX package or its ``benchmarks/`` scripts).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import controller as jctl, dqn as jdqn, memory as jmem
from repro.core.policy import RLPolicy as JaxRLPolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import controller, masks, memory
from repro_torch.core.policy import DensePolicy, RLPolicy, make_policy
from repro_torch.models import registry
from repro_torch.runtime import (EngineConfig, EngineRequest, KVPool,
                                 PagedExecutor, RAPEngine, chunk_widths)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
L = 4


@pytest.fixture(scope="module")
def served():
    jcfg = jax_smoke("llama2-7b").replace(n_layers=L)
    jm = jreg.build(jcfg)
    jp = jm.init(jax.random.key(0))
    calib = JaxCorpus(jcfg.vocab_size, seed=7).batch(2, 32, split="calib")
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    tm = registry.build(get_smoke_config("llama2-7b").replace(n_layers=L))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tq = bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))
    return dict(jm=jm, jp=jp, jq=jq, tm=tm, tp=tp, tq=tq, calib=calib,
                mm=memory.build_memory_model(tm.cfg))


def _trace(s):
    toks = s["calib"]["tokens"]
    full = masks.full_mask(L)
    prompts = [toks[:1, : (16 if i % 2 else 24)] for i in range(8)]
    budget = s["mm"].param_bytes(full) + 2.5 * s["mm"].state_bytes(full, 1, 26)
    return prompts, budget


def _engine_kw(budget, quantum, horizon=8):
    return dict(mode="masked", max_new_tokens=2, max_active=4, max_len=32,
                budget_bytes=budget, tokens_per_page=8,
                decode_horizon=horizon, budget_quantum_frac=quantum)


def _run_port(s, quantum, horizon=8, policy=None, max_new=2):
    prompts, budget = _trace(s)
    if policy is None:
        calib = {k: torch.from_numpy(v) for k, v in s["calib"].items()}
        policy = RLPolicy(controller.RAPController(
            s["tm"], s["tp"], calib, s["mm"], s["tq"]))
    kw = _engine_kw(budget, quantum, horizon)
    kw["max_new_tokens"] = max_new
    eng = RAPEngine(s["tm"], s["tp"], policy, EngineConfig(**kw),
                    executor=PagedExecutor(s["tm"], s["tp"], max_active=4))
    return eng, eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                         for i, p in enumerate(prompts)])


@pytest.mark.parametrize("quantum", [0.05, 0.3], ids=["grid5", "grid30"])
def test_trace_matches_jax_engine(served, quantum):
    s = served
    prompts, budget = _trace(s)
    jbatch = {k: jnp.asarray(v) for k, v in s["calib"].items()}
    jpol = JaxRLPolicy(jctl.RAPController(
        s["jm"], s["jp"], jbatch, jmem.build_memory_model(s["jm"].cfg),
        s["jq"]))
    jeng = JaxRAPEngine(s["jm"], s["jp"], jpol,
                        JaxEngineConfig(**_engine_kw(budget, quantum)),
                        executor=JaxPagedExecutor(s["jm"], s["jp"],
                                                  max_active=4))
    jrep = jeng.run([JaxEngineRequest(rid=f"r{i}", prompt=p)
                     for i, p in enumerate(prompts)])
    _, rep = _run_port(s, quantum)
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 8
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]
    n_pruned = sum(int(r.mask.sum() < 2 * L) for r in got.values())
    assert n_pruned == 0 if quantum == 0.05 else n_pruned >= 1


def test_report_invariants(served):
    eng, rep = _run_port(served, 0.3)
    _, budget = _trace(served)
    done = [r for r in rep.results if r.status == "done"]
    assert len(done) == 8 and rep.rejected == 0
    assert rep.generated_tokens == sum(r.tokens.size for r in done)
    assert rep.tokens_per_s > 0.0 and rep.decode_iters > 0
    for r in done:
        assert r.tokens.shape == (1, 2)
        assert r.ttft_s >= r.queue_delay_s - 1e-9 >= -1e-9
    assert rep.ttft["count"] == 8.0
    pool = rep.pool
    assert pool["peak_in_use_bytes"] <= pool["peak_reserved_bytes"] + 1e-6
    assert pool["peak_reserved_bytes"] <= pool["capacity_bytes"]
    assert pool["capacity_bytes"] + eng.resident_param_bytes <= budget
    assert pool["overcommit_events"] == 0
    assert pool["reserved_bytes"] == 0 and pool["in_use_bytes"] == 0
    assert set(eng.stats()["requests"]) == {r.rid for r in done}


def test_horizon_is_unobservable_in_the_engine(served):
    """decode_horizon 1, 4, 8 give equal streams; max_new=6 lands
    mid-horizon for H=4 and H=8."""
    outs = {}
    for h in (1, 4, 8):
        _, rep = _run_port(served, 0.05, horizon=h,
                           policy=DensePolicy(served["mm"]), max_new=6)
        outs[h] = {r.rid: r.tokens for r in rep.results}
        assert all(t.shape == (1, 6) for t in outs[h].values())
    for h in (4, 8):
        for rid, t in outs[1].items():
            np.testing.assert_array_equal(t, outs[h][rid])


def test_chunk_widths():
    assert chunk_widths(13, 8) == [8, 4, 1]
    assert chunk_widths(5, 64) == [4, 1]
    with pytest.raises(ValueError):
        chunk_widths(0, 8)


def test_serve_entry_point_on_cpu(capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                           "--max-prompt", "32", "--max-new", "4",
                           "--policy", "dense", "--mode", "masked"])
    assert all(r.status == "done" for r in rep.results)
    assert rep.generated_tokens == sum(r.tokens.size for r in rep.results)
    assert "tok/s" in capsys.readouterr().out


def test_serve_without_gpu_raises(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke", "--requests", "1"])


def test_later_slices_raise(served):
    """What JAX refuses, the port refuses: a static baseline without its
    probe's context, and sharded serving in structural mode. Sharded
    serving itself is ported: masked mode serves on a 1 x 1 mesh."""
    s = served
    from repro_torch.launch import serve
    # the static baselines are ported: without their probe's context they
    # refuse as JAX's do, not as a later slice
    with pytest.raises(ValueError, match="requires model, params, calib"):
        make_policy("shortgpt", mm=s["mm"])
    with pytest.raises(NotImplementedError, match="masked-mode only"):
        serve.main(["--smoke", "--device", "cpu", "--executor", "sharded"])
    engine, rep = serve.main(["--smoke", "--device", "cpu", "--executor",
                              "sharded", "--mode", "masked", "--mesh", "1x1",
                              "--requests", "2"])
    assert {r.status for r in rep.results} == {"done"}
    assert engine.executor.stats()["mesh_devices"] == 1


def test_pool_allocates_on_the_given_device():
    pool = KVPool(8 * 4096, page_bytes=4096, tokens_per_page=8)
    pool.allocate_physical(n_layers=2, n_kv_heads=2, head_dim=4,
                           dtype=torch.bfloat16, device="cpu")
    assert pool.k_pages.shape == (2, 9, 8, 2, 4)
    assert pool.k_pages.dtype == torch.bfloat16


# ------------------------------------------------------------ import guard
_GUARD = r"""
import importlib, importlib.util, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
TWINS = %r
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
for need in ("repro_torch.parallel", "repro_torch.parallel.sharding",
             "repro_torch.parallel.activation", "repro_torch.parallel.tp",
             "repro_torch.parallel.compression", "repro_torch.launch.mesh"):
    assert need in sys.modules, need
for name, path in [("chip_smoke", "chip_smoke.py")] + [
        (n, f"examples/{n}.py") for n in TWINS]:
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")]
assert not bad, bad
print("imported", len([m for m in sys.modules if m.startswith("repro_torch")]))
"""


# the example twins on the port (the JAX originals import JAX)
EXAMPLE_TWINS = ("quickstart_torch", "serve_elastic_budget_torch",
                 "train_e2e_torch", "kernels_demo_torch")


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _GUARD % (EXAMPLE_TWINS,)],
                         cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_no_import_statement_names_jax_or_repro():
    """Imports inside functions run only on the card: check the text."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|benchmarks)"
                     r"(\.|\s|$)", re.M)
    files = [ROOT / "chip_smoke.py",
             *(ROOT / "examples" / f"{n}.py" for n in EXAMPLE_TWINS),
             *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert len(files) > 20 and not hits, hits
