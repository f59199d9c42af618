"""Quantized slot caches on the recurrent layouts, against the JAX package.

recurrentgemma-9b (Griffin: rglru, rglru, local attention) and mamba2-370m
(uniform SSD) at their SMOKE sizes, f32, JAX-initialised weights carried
over by ``repro_torch.bridge``, seeded numpy inputs. An int8 or fp8
``kv_dtype`` quantizes the local-attention ring only (int8 with
per-(token, head) scales ``ks``/``vs``, fp8 a plain cast); RG-LRU and SSD
state stay f32, as in JAX (``decoder.init_cache``):

* the decoder: prefill into an int8 / fp8 ring past the window, every cache
  leaf (the codes bitwise, the int8 scales at 1e-5 relative, the f32
  states at 1e-4), the prefill logits at 1e-4, then an 8-step horizon with ``[B]`` positions
  and ``[L, B]`` gates (tokens equal);
* the engine through ``LocalExecutor(kv_dtype=...)`` against JAX's, in
  {int8, fp8} x {masked, structural} x {recurrentgemma, mamba2}: masks,
  tokens and the pool's peak bytes equal; the structural buckets' ring
  caches are quantized;
* mamba2's tokens do not depend on ``kv_dtype`` (no attention cache);
* spill/resume on the int8 ring: a budget shock that preempts mid-decode
  leaves every token stream equal to the unshocked run (DESIGN.md §11),
  and a spilled request carries the ring's scales;
* the paged executor and chunked prefill still refuse these layouts.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import controller as jctl, dqn as jdqn, memory as jmem
from repro.core.policy import RLPolicy as JaxRLPolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import decoder as jdec
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import controller, masks, memory
from repro_torch.core.policy import DensePolicy, RLPolicy
from repro_torch.models import decoder, registry
from repro_torch.runtime import (EngineConfig, EngineRequest, LocalExecutor,
                                 PagedExecutor, RAPEngine, TickStaircase)

torch.set_num_threads(1)

TOL, SCALE_TOL = 1e-4, 1e-5
ARCH = {"griffin": "recurrentgemma-9b", "mamba2": "mamba2-370m"}
JAX_KV = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TORCH_KV = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax model, jax params, port model, port params) for ``name``."""
    jm = jreg.build(jax_smoke(ARCH[name]))
    jp = jm.init(jax.random.key(0))
    tm = registry.build(get_smoke_config(ARCH[name]))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _leaves(cache):
    """{(kind, leaf): numpy array} of a cache, ``pos`` apart; float8 leaves
    as their bytes."""
    out = {}
    for kind, leaves in cache.items():
        if kind == "pos":
            continue
        for key, v in leaves.items():
            if torch.is_tensor(v):
                a = (v.view(torch.uint8) if v.dtype == torch.float8_e4m3fn
                     else v).numpy()
            else:
                a = np.asarray(v)
                if a.dtype == jnp.float8_e4m3fn:
                    a = a.view(np.uint8)
            out[(kind, key)] = a
    return out


# ------------------------------------------------------------ the decoder
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_ring_prefill_and_horizon_match_jax(kv):
    """A 21-token prompt into a 32-token slot cache wraps the SMOKE
    window-16 ring; the ring's codes equal JAX's bit for bit, its int8
    scales within 1e-5 relative, the logits and f32 states within 1e-4,
    and the horizon's tokens are equal."""
    jm, jp, tm, tp = _pair("griffin")
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (3, 21)).astype(np.int32)
    jl, jc = jdec.prefill(jp, jm.cfg, jnp.asarray(toks), 32,
                          kv_dtype=JAX_KV[kv])
    tl, tc = decoder.prefill(tp, tm.cfg, torch.from_numpy(toks), 32,
                             kv_dtype=TORCH_KV[kv])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    want = _leaves(jc)
    got = _leaves(tc)
    assert set(got) == set(want)
    assert tc["local_attn"]["k"].dtype == TORCH_KV[kv]
    assert ("ks" in tc["local_attn"]) == (kv == "int8")
    assert tc["rglru"]["h"].dtype == torch.float32
    for key, a in got.items():
        if key in (("local_attn", "k"), ("local_attn", "v")):
            np.testing.assert_array_equal(a, want[key], err_msg=str(key))
        elif key[0] == "local_attn":
            # scales: amax / 127 of K/V projections that differ by f32
            # roundings between the two packages
            np.testing.assert_allclose(a, want[key], atol=0, rtol=SCALE_TOL,
                                       err_msg=str(key))
        else:
            np.testing.assert_allclose(a, want[key], atol=TOL, rtol=TOL,
                                       err_msg=str(key))
    L = tm.cfg.n_layers
    gates = np.ones((2, L, 3), np.float32)
    gates[0, 1, 0] = gates[1, 2, 1] = 0.0
    pos = np.array([21, 17, 9], np.int32)
    jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    seed = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jt, _ = jdec.decode_horizon(jp, jm.cfg, jc, jnp.asarray(seed), 8,
                                gates={"mixer": jnp.asarray(gates[0]),
                                       "ffn": jnp.asarray(gates[1])})
    tt, _ = decoder.decode_horizon(tp, tm.cfg, tc, torch.from_numpy(seed), 8,
                                   gates={"mixer": torch.from_numpy(gates[0]),
                                          "ffn": torch.from_numpy(gates[1])})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ------------------------------------------------------------- the engine
def _trace(tm, calib):
    """The canonical trace of tests/test_torch_recurrent.py: 8 one-row
    requests of 16/24 tokens, a pool of ~2.5 dense requests."""
    mm = memory.build_memory_model(tm.cfg)
    full = masks.full_mask(tm.cfg.n_layers)
    prompts = [calib["tokens"][:1, : (16 if i % 2 else 24)]
               for i in range(8)]
    return prompts, mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)


def _setup(name, kv, mode):
    """The canonical trace's prompts, the engine config and the seeded
    Q-network (JAX's) for ``name`` through ``LocalExecutor(kv_dtype=kv)``
    in ``mode``."""
    jm, _, tm, _ = _pair(name)
    L = tm.cfg.n_layers
    calib = JaxCorpus(jm.cfg.vocab_size, seed=7).batch(2, 32, split="calib")
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    prompts, budget = _trace(tm, calib)
    kw = dict(mode=mode, max_new_tokens=2, max_active=4, max_len=32,
              budget_bytes=budget, tokens_per_page=8, decode_horizon=8,
              budget_quantum_frac=0.3, kv_dtype=kv)
    return calib, jq, prompts, kw


def _jax_report(name, kv, mode):
    jm, jp, _, _ = _pair(name)
    calib, jq, prompts, kw = _setup(name, kv, mode)
    jpol = JaxRLPolicy(jctl.RAPController(
        jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
        jmem.build_memory_model(jm.cfg), jq))
    return JaxRAPEngine(jm, jp, jpol, JaxEngineConfig(**kw),
                        executor=JaxLocalExecutor(jm, jp, mode=mode,
                                                  max_active=4,
                                                  kv_dtype=kv)).run(
        [JaxEngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])


def _port_run(name, kv, mode):
    """The port's (report, engine) on the trace of :func:`_jax_report`,
    with the Q-network carried over by ``bridge``."""
    _, _, tm, tp = _pair(name)
    calib, jq, prompts, kw = _setup(name, kv, mode)
    pol = RLPolicy(controller.RAPController(
        tm, tp, {k: torch.from_numpy(v) for k, v in calib.items()},
        memory.build_memory_model(tm.cfg),
        bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))))
    eng = RAPEngine(tm, tp, pol, EngineConfig(**kw),
                    executor=LocalExecutor(tm, tp, mode=mode, max_active=4,
                                           kv_dtype=kv))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                   for i, p in enumerate(prompts)])
    return rep, eng


@pytest.mark.parametrize("mode", ["masked", "structural"])
@pytest.mark.parametrize("kv", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["griffin", "mamba2"])
def test_quantized_trace_matches_jax_local_engine(name, kv, mode):
    jrep = _jax_report(name, kv, mode)
    rep, eng = _port_run(name, kv, mode)
    L = eng.mcfg.n_layers
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 8
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    for key in ("peak_reserved_bytes", "n_pages", "overcommit_events"):
        assert rep.pool[key] == jrep.pool[key], key
    assert rep.pool["overcommit_events"] == 0
    assert any(r.mask.sum() < 2 * L for r in got.values())
    groups = eng.executor.groups()
    assert groups
    for g in groups:
        if "local_attn" in g.cache:
            ring = g.cache["local_attn"]
            assert ring["k"].dtype == TORCH_KV[kv]
            assert ("ks" in ring and "vs" in ring) == (kv == "int8")
        for kind in ("rglru", "ssd"):
            for leaf in g.cache.get(kind, {}).values():
                assert leaf.dtype == torch.float32
    if mode == "structural":
        assert all(g.layout is not None for g in groups)
    if name == "griffin":
        assert any("local_attn" in g.cache for g in groups)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_mamba2_kv_dtype_changes_nothing(kv):
    """No attention cache: the quantized serve's tokens, masks and pool are
    the model-dtype serve's, bit for bit."""
    rep, eng = _port_run("mamba2", kv, "masked")
    base, _ = _port_run("mamba2", None, "masked")
    want = {r.rid: r for r in base.results}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid].tokens)
        np.testing.assert_array_equal(r.mask, want[r.rid].mask)
    assert rep.pool["peak_reserved_bytes"] == base.pool["peak_reserved_bytes"]
    assert all(set(g.cache) == {"pos", "ssd"} for g in eng.executor.groups())


# -------------------------------------------------------------- preemption
def _reqs(prompts, max_new, rate=1000.0, seed=0):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i, p in enumerate(prompts):
        t += float(rng.exponential(1.0 / rate))
        out.append(EngineRequest(rid=f"r{i}", prompt=np.asarray(p, np.int32),
                                 arrival_t=t, max_new=max_new))
    return out


@pytest.mark.parametrize("mode", ["masked", "structural"])
def test_int8_ring_spill_and_resume_bitwise(mode, monkeypatch):
    """recurrentgemma on an int8 ring: a tick staircase cutting 60% of the
    KV headroom between ticks 3 and 12 preempts mid-decode; every token
    stream equals the unshocked run's, and every spilled snapshot carried
    the ring's codes and scales."""
    _, _, tm, tp = _pair("griffin")
    cfg = tm.cfg
    mm = memory.build_memory_model(cfg)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 40)).astype(np.int32)
    prompts = [toks[:, : (18 if i % 2 else 24)] for i in range(6)]
    full = masks.full_mask(cfg.n_layers)
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 32)
    spilled = []
    spill = LocalExecutor.spill_state

    def watched(self, group, slots):
        state = spill(self, group, slots)
        spilled.append(state)
        return state
    monkeypatch.setattr(LocalExecutor, "spill_state", watched)
    runs = []
    for shock in (False, True):
        eng = RAPEngine(tm, tp, DensePolicy(mm), EngineConfig(
            mode=mode, max_new_tokens=6, max_active=4, max_len=32,
            budget_bytes=budget, tokens_per_page=8, kv_dtype="int8",
            decode_horizon=2), executor=LocalExecutor(
                tm, tp, mode=mode, max_active=4, kv_dtype="int8"))
        trace = None
        if shock:
            kv = budget - eng.resident_param_bytes
            low = (eng.resident_param_bytes + 0.4 * kv) / budget
            trace = TickStaircase(budget, [(3, 1.0), (9, low), (0, 1.0)])
        runs.append(eng.run(_reqs(prompts, 6), budget_trace=trace))
    ref, rep = runs
    assert rep.preempted_count > 0 and spilled
    for state in spilled:
        ring = state["cache"]["local_attn"]
        assert ring["k"].dtype == torch.int8
        assert set(ring) == {"k", "v", "ks", "vs"}
    want = {r.rid: r.tokens for r in ref.results}
    assert len(want) == 6 and {r.status for r in rep.results} == {"done"}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid], err_msg=r.rid)
    assert rep.pool["reserved_bytes"] == 0
    assert rep.pool["spilled_requests"] == 0


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("name", ["griffin", "mamba2"])
def test_paged_and_chunked_paths_still_refuse(name):
    _, _, tm, tp = _pair(name)
    for kv in (None, "int8", "fp8"):
        with pytest.raises(NotImplementedError,
                           match="uniform all-attention"):
            PagedExecutor(tm, tp, kv_dtype=kv)
    cache = decoder.init_cache(tm.cfg, 1, 16, torch.int8)
    with pytest.raises(NotImplementedError, match="uniform all-attention"):
        decoder.prefill_chunk(tp, tm.cfg, cache,
                              torch.zeros(1, 4, dtype=torch.long), 0)
    ex = LocalExecutor(tm, tp, kv_dtype="int8")
    group = ex.group_for(masks.full_mask(tm.cfg.n_layers), 16)
    assert not ex.supports_chunked_prefill(group)
