"""The port's elastic budgets, preemption and cancellation, on the CPU.

Twins of the JAX suite's tests (``tests/test_engine.py``,
``tests/test_executors.py``) on the port, with the tiny llama2 model of
``tests/test_torch_engine.py`` (JAX-initialised weights carried by
``repro_torch.bridge``):

* ``KVPool`` spill → restore round-trips pages and scale rows bitwise on
  f32, int8 and fp8 pools, with the same guards;
* a mid-serve budget shock (a tick-counting ``TickStaircase``) preempts,
  and every request's tokens and mask equal the unshocked run's, per
  executor (local, paged) and pool precision (model dtype, int8, fp8), and
  on the SMOKE mamba2 and recurrentgemma slot caches (SSD and RG-LRU
  state, conv buffers, the local-attention ring);
* the engine drains under a shock, gates admissions with preemption off,
  force-resumes when the budget never recovers, cancels at every
  lifecycle stage, survives a cancel racing a completion and a
  cancellation storm with zero live rids and zero leaked pages, and
  releases everything when a run raises;
* the port's shocked run gives JAX's shocked run's tokens, masks and
  preemption count on the same trace;
* ``launch.serve --budget-trace staircase`` preempts and serves to the
  end, with the tokens of the unshocked serve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import dqn as jdqn
from repro.core import memory as jmem
from repro.core.policy import DensePolicy as JaxDensePolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro.runtime import TickStaircase as JaxTickStaircase
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import controller, masks, memory
from repro_torch.core.policy import DensePolicy, RLPolicy
from repro_torch.data import SyntheticCorpus
from repro_torch.models import registry
from repro_torch.runtime import (EngineConfig, EngineRequest, FIFOScheduler,
                                 KVPool, LocalExecutor, PagedExecutor,
                                 PriorityScheduler, RAPEngine, TickStaircase,
                                 VictimCandidate, run_cancellation_storm)

torch.set_num_threads(1)
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
    mm = memory.build_memory_model(tm.cfg)
    c = controller.RAPController(
        tm, tp, {k: torch.from_numpy(v) for k, v in calib.items()}, mm,
        bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq)))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, calib=calib, mm=mm, c=c)


def _reqs(prompts, max_new=None, rate=1000.0, seed=0):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i, p in enumerate(prompts):
        t += float(rng.exponential(1.0 / rate))
        out.append(EngineRequest(rid=f"r{i}", prompt=np.asarray(p, np.int32),
                                 arrival_t=t, max_new=max_new))
    return out


def _staircase(eng, budget, down, up, frac):
    """Tick staircase cutting ``frac`` of the KV headroom (budget minus
    resident params) between ticks ``down`` and ``up``."""
    kv = budget - eng.resident_param_bytes
    shocked = (eng.resident_param_bytes + (1.0 - frac) * kv) / budget
    return TickStaircase(budget, [(down, 1.0), (up - down, shocked),
                                  (0, 1.0)])


def _engine(s, kind, *, budget, max_new, policy=None, kv_dtype=None,
            horizon=2, slots=4, chunk=0, scheduler=None, **cfg):
    ex = (PagedExecutor(s["tm"], s["tp"], max_active=slots,
                        kv_dtype=kv_dtype) if kind == "paged"
          else LocalExecutor(s["tm"], s["tp"], max_active=slots,
                             kv_dtype=kv_dtype))
    return RAPEngine(s["tm"], s["tp"], policy or RLPolicy(s["c"]),
                     EngineConfig(mode="masked", max_new_tokens=max_new,
                                  max_active=slots, max_len=32,
                                  budget_bytes=budget, tokens_per_page=8,
                                  kv_dtype=kv_dtype, decode_horizon=horizon,
                                  max_prefill_tokens=chunk, **cfg),
                     executor=ex, scheduler=scheduler)


def _trace(s, n=8, total=26):
    """The conformance trace: alternating 24/16-token prompts, a pool of
    ~2.5 dense requests."""
    toks = s["calib"]["tokens"]
    full = masks.full_mask(L)
    prompts = [toks[:1, : (16 if i % 2 else 24)] for i in range(n)]
    budget = (s["mm"].param_bytes(full)
              + 2.5 * s["mm"].state_bytes(full, 1, total))
    return prompts, budget


def _drained(pool):
    assert pool["live_requests"] == 0 and pool["spilled_requests"] == 0
    assert pool["reserved_bytes"] == 0
    assert pool["free_pages"] == pool["n_pages"]


# ------------------------------------------------------------- KV pool
def _phys_pool(kv_dtype):
    pt, K, D, layers = 2, 2, 4, 2
    es = 4 if kv_dtype is None else 1
    page_bytes = 2 * layers * pt * K * D * es + (
        0 if kv_dtype is None else 2 * layers * K * 4)
    pool = KVPool(8 * page_bytes, page_bytes=page_bytes, tokens_per_page=pt)
    pool.allocate_physical(n_layers=layers, n_kv_heads=K, head_dim=D,
                           dtype=torch.float32, kv_dtype=kv_dtype,
                           device="cpu")
    return pool, (layers, pt, K, D)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_kv_pool_spill_restore_roundtrip_bitwise(kv_dtype):
    from repro_torch.kernels.ref import put_pages, take_pages
    pool, (layers, pt, K, D) = _phys_pool(kv_dtype)
    pool.alloc_tokens("a", 2, 3, max_tokens=6, in_use_bytes=6.0,
                      in_use_per_token=1.0, kv_dtype=kv_dtype)
    ids = [p for row in pool.row_pages("a") for p in row]
    idx = (slice(None), torch.tensor(ids))
    g = torch.Generator().manual_seed(0)
    k_ref = torch.randn(layers, len(ids), pt, K, D, generator=g) * 50
    v_ref = torch.randn(layers, len(ids), pt, K, D, generator=g) * 50
    put_pages(pool.k_pages, idx, k_ref)
    put_pages(pool.v_pages, idx, v_ref)
    k_ref, v_ref = take_pages(pool.k_pages, idx), take_pages(pool.v_pages, idx)
    if kv_dtype is not None:
        s_ref = torch.rand(layers, len(ids), K, generator=g) + 0.1
        pool.k_scales[idx] = s_ref
        pool.v_scales[idx] = 2 * s_ref
    reserved = pool.bytes_reserved
    assert pool.spill("a") == reserved
    assert pool.bytes_reserved == 0 and pool.committed_pages == 0
    assert sorted(pool._free) == list(range(pool.n_pages))
    assert pool.spilled_requests() == ["a"]
    assert pool.stats()["spilled_requests"] == 1
    # clobber the old pages; land the restore on other pages
    put_pages(pool.k_pages, idx, torch.zeros_like(k_ref, dtype=torch.float32))
    if kv_dtype is not None:
        pool.k_scales[idx] = 0.0
    pool.alloc_tokens("b", 1, 2 * pt, max_tokens=2 * pt, in_use_bytes=1.0,
                      in_use_per_token=0.5, kv_dtype=kv_dtype)
    assert pool.can_restore("a")
    new_rows = pool.restore("a")
    assert pool.bytes_reserved == reserved + 2 * pool.page_bytes
    new_idx = (slice(None), torch.tensor([p for r in new_rows for p in r]))
    assert set(new_idx[1].tolist()) != set(ids)
    assert torch.equal(take_pages(pool.k_pages, new_idx).view(torch.uint8),
                       k_ref.view(torch.uint8))
    assert torch.equal(take_pages(pool.v_pages, new_idx).view(torch.uint8),
                       v_ref.view(torch.uint8))
    if kv_dtype is not None:
        assert torch.equal(pool.k_scales[new_idx], s_ref)
        assert torch.equal(pool.v_scales[new_idx], 2 * s_ref)
    pool.extend("a", 3)              # extends exactly as before the spill
    pool.free("a")
    pool.free("b")
    assert pool.bytes_reserved == 0
    assert sorted(pool._free) == list(range(pool.n_pages))
    assert pool.drop_spilled("a", missing_ok=True) is False
    with pytest.raises(ValueError, match="drop_spilled"):
        pool.drop_spilled("a")
    assert pool.stats()["spilled_bytes_total"] == reserved


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_kv_pool_spill_guards(kv_dtype):
    pool, _ = _phys_pool(kv_dtype)
    pool.alloc_tokens("a", 1, 2, max_tokens=4, in_use_bytes=2.0,
                      in_use_per_token=1.0, kv_dtype=kv_dtype)
    pool.spill("a")
    with pytest.raises(ValueError, match="spill"):
        pool.spill("a")                    # no longer live
    with pytest.raises(ValueError, match="already"):
        pool.alloc_tokens("a", 1, 2, max_tokens=4, in_use_bytes=2.0,
                          in_use_per_token=1.0)
    with pytest.raises(ValueError, match="restore"):
        pool.restore("zzz")
    assert pool.request_reserved_bytes("a") == 0.0
    pool.restore("a")
    assert pool.spilled_requests() == [] and pool.live_requests() == ["a"]
    pool.free("a")
    assert pool.free("a", missing_ok=True) == 0.0
    with pytest.raises(ValueError, match="unknown"):
        pool.free("a")


def test_select_victims_priority_and_aging():
    def cand(rid, prio, arr, rem):
        return VictimCandidate(rid=rid, priority=prio, arrival_t=arr,
                               remaining_tokens=rem, reserved_bytes=100.0)

    pr = PriorityScheduler(aging_s=10.0)
    order = pr.select_victims([cand("hi", 0, 0.0, 4),
                               cand("lo", 2, 0.0, 4)], now=1.0)
    assert [c.rid for c in order] == ["lo", "hi"]
    order = pr.select_victims([cand("old-lo", 2, 0.0, 4),
                               cand("new-mid", 1, 29.0, 4)], now=30.0)
    assert [c.rid for c in order] == ["new-mid", "old-lo"]
    fifo = FIFOScheduler()
    order = fifo.select_victims([cand("short", 0, 0.0, 1),
                                 cand("long", 0, 0.0, 9)], now=0.0)
    assert [c.rid for c in order] == ["long", "short"]
    order = fifo.select_victims([cand("early", 0, 0.0, 4),
                                 cand("late", 0, 5.0, 4)], now=9.0)
    assert [c.rid for c in order] == ["late", "early"]


# ------------------------------------------ shocked ≡ unshocked tokens
def _shocked_vs_ref(s, kind, kv_dtype=None, frac=0.45):
    """The conformance trace with DensePolicy (a keep-mask that cannot
    depend on the live budget), unshocked and under a shock."""
    prompts, budget = _trace(s)
    runs = []
    for shock in (False, True):
        eng = _engine(s, kind, budget=budget, max_new=6, kv_dtype=kv_dtype,
                      policy=DensePolicy(s["mm"]))
        trace = _staircase(eng, budget, 4, 14, frac) if shock else None
        runs.append(eng.run(_reqs(prompts, max_new=6), budget_trace=trace))
    return runs


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_preemption_spill_restore_bitwise(served, kind):
    ref, rep = _shocked_vs_ref(served, kind)
    assert rep.preempted_count > 0 and rep.spilled_mb > 0
    assert rep.resume_latency["count"] >= 1
    want = {r.rid: r for r in ref.results}
    assert {r.status for r in rep.results} == {"done"}
    assert {r.rid for r in rep.results} == set(want) == {
        f"r{i}" for i in range(8)}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid].tokens,
                                      err_msg=f"{kind}: {r.rid}")
        np.testing.assert_array_equal(r.mask, want[r.rid].mask)
    if kind == "paged":
        _drained(rep.pool)
    else:
        assert rep.pool["reserved_bytes"] == 0
        assert rep.pool["spilled_requests"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_paged_preemption_bitwise_fp32_and_int8(served, kv_dtype):
    """The physical spill path (page gather → host → page scatter, scale
    rows included) against the same-precision unshocked run; 1-byte pages
    reserve ~4x less, so the shock cuts deeper."""
    ref, rep = _shocked_vs_ref(served, "paged", kv_dtype,
                               frac=0.45 if kv_dtype is None else 0.8)
    assert rep.preempted_count > 0
    want = {r.rid: r.tokens for r in ref.results}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid],
                                      err_msg=f"{kv_dtype}: {r.rid}")
    _drained(rep.pool)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_recurrent_slot_caches_spill_and_resume_bitwise(arch):
    """SSD and RG-LRU states, conv buffers and the local-attention ring go
    to the host and back: shocked tokens equal unshocked ones."""
    cfg = get_smoke_config(arch)
    tm = registry.build(cfg)
    tp = tm.init(0, "cpu")
    mm = memory.build_memory_model(cfg)
    toks = SyntheticCorpus(cfg.vocab_size, seed=3).batch(1, 40)["tokens"]
    prompts = [toks[:, : (18 if i % 2 else 24)] for i in range(6)]
    full = masks.full_mask(cfg.n_layers)
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 32)
    s = dict(tm=tm, tp=tp, mm=mm)
    runs = []
    for shock in (False, True):
        eng = _engine(s, "local", budget=budget, max_new=6,
                      policy=DensePolicy(mm))
        trace = _staircase(eng, budget, 3, 12, 0.6) if shock else None
        runs.append(eng.run(_reqs(prompts, max_new=6), budget_trace=trace))
    ref, rep = runs
    assert rep.preempted_count > 0
    want = {r.rid: r.tokens for r in ref.results}
    assert len(want) == 6 and {r.status for r in rep.results} == {"done"}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid],
                                      err_msg=f"{arch}: {r.rid}")


# ------------------------------------------------------------- engine
def _shock_engine(s, *, max_new=6, **kw):
    full = masks.full_mask(L)
    budget = (s["mm"].param_bytes(full)
              + 2.5 * s["mm"].state_bytes(full, 1, 30))
    eng = _engine(s, "paged", budget=budget, max_new=max_new, **kw)
    toks = s["calib"]["tokens"]
    prompts = [toks[:1, : (16 if i % 2 else 24)] for i in range(6)]
    return eng, _reqs(prompts), budget


def test_engine_preempts_and_drains_under_shock(served):
    eng, reqs, budget = _shock_engine(served)
    ref = eng.run(reqs)
    assert all(r.status == "done" for r in ref.results)
    eng2, reqs2, _ = _shock_engine(served)
    rep = eng2.run(reqs2, budget_trace=_staircase(eng2, budget, 4, 12, 0.6))
    assert rep.preempted_count > 0 and rep.spilled_mb > 0.0
    assert rep.resume_latency["count"] >= 1
    assert len(rep.budget_events) >= 3       # full → shocked → recovered
    done = {r.rid: r for r in rep.results if r.status == "done"}
    assert len(done) == len(reqs2)
    for r in ref.results:
        np.testing.assert_array_equal(r.tokens, done[r.rid].tokens)
    _drained(eng2.pool.stats())
    assert rep.itl_preempted["count"] > 0 and rep.itl["count"] > 0


def test_engine_preemption_disabled_still_gates_admission(served):
    eng, reqs, budget = _shock_engine(served, preemption_enabled=False)
    rep = eng.run(reqs, budget_trace=_staircase(eng, budget, 4, 12, 0.6))
    assert rep.preempted_count == 0
    assert all(r.status == "done" for r in rep.results)
    assert len(rep.budget_events) >= 3


def test_engine_force_resume_drains_without_recovery(served):
    eng, reqs, budget = _shock_engine(served)
    kv = budget - eng.resident_param_bytes
    never_up = TickStaircase(budget, [
        (4, 1.0), (0, (eng.resident_param_bytes + 0.3 * kv) / budget)])
    rep = eng.run(reqs, budget_trace=never_up)
    assert rep.preempted_count > 0
    by = {}
    for r in rep.results:
        by.setdefault(r.status, []).append(r)
    assert by.get("done"), "nothing drained"
    assert set(by) <= {"done", "rejected"}
    for r in by.get("rejected", []):
        assert "budget" in r.reason or "deferred" in r.reason
    st = eng.pool.stats()
    assert st["live_requests"] == 0 and st["spilled_requests"] == 0


def test_engine_cancel_every_lifecycle_stage(served):
    s = served
    full = masks.full_mask(L)
    toks = s["calib"]["tokens"]
    budget = (s["mm"].param_bytes(full)
              + 2.0 * s["mm"].state_bytes(full, 1, 30))
    eng = _engine(s, "paged", budget=budget, max_new=8, slots=2, chunk=8)
    # r5 arrives far in the future (stays pending); 2 slots force a queue
    reqs = [EngineRequest(rid=f"r{i}", prompt=toks[:1, :24],
                          arrival_t=0.001 * i, max_new=8) for i in range(5)]
    reqs.append(EngineRequest(rid="r5", prompt=toks[:1, :16],
                              arrival_t=120.0, max_new=8))
    hit = set()

    def on_tick(e):
        assert e.cancel("nonexistent") is False
        if "pending" not in hit and any(r.rid == "r5" for r in e._pending):
            assert e.cancel("r5") is True
            assert e.cancel("r5") is False          # double-cancel no-op
            hit.add("pending")
        if "queued" not in hit and "r4" in e.scheduler:
            assert e.cancel("r4") is True
            hit.add("queued")
        if "prefilling" not in hit and e._prefilling:
            assert e.cancel(next(iter(e._prefilling))) is True
            hit.add("prefilling")
        elif "running" not in hit and e._running:
            rid = next(iter(e._running))
            assert e.cancel(rid) is True            # horizon in flight
            assert e.cancel(rid) is False
            hit.add("running")
        if "preempted" not in hit and e._preempted:
            assert e.cancel(next(iter(e._preempted))) is True
            hit.add("preempted")

    rep = eng.run(reqs, budget_trace=_staircase(eng, budget, 6, 10 ** 9, 0.7),
                  on_tick=on_tick)
    assert {"pending", "queued", "prefilling", "running",
            "preempted"} <= hit
    by = {r.rid: r for r in rep.results}
    assert by["r5"].status == "cancelled" and by["r4"].status == "cancelled"
    assert rep.cancelled == sum(1 for r in rep.results
                                if r.status == "cancelled") >= 5
    _drained(eng.pool.stats())


def test_engine_cancel_races_completion_safely(served):
    eng, reqs, _ = _shock_engine(served, max_new=4)
    finished, cancelled = set(), []

    def on_tick(e):
        for r in e._results:
            if r.status == "done" and r.rid not in finished:
                finished.add(r.rid)
                assert e.cancel(r.rid) is False     # racing a completion
        if finished and not cancelled and e._running:
            rid = next(iter(e._running))
            run = e._running[rid]
            n_before = len(run.out)
            assert e.cancel(rid) is True
            cancelled.append(rid)
            res = next(x for x in e._results if x.rid == rid)
            n_tokens = 0 if res.tokens is None else res.tokens.shape[1]
            assert n_tokens == n_before < run.max_new

    rep = eng.run(reqs, on_tick=on_tick)
    assert rep.cancelled == 1
    assert sum(r.status == "done" for r in rep.results) == len(reqs) - 1
    # fold-back never resurrects the cancelled request
    assert [r.status for r in rep.results if r.rid == cancelled[0]] == [
        "cancelled"]
    st = eng.pool.stats()
    assert st["live_requests"] == 0 and st["free_pages"] == st["n_pages"]


def test_engine_cancellation_storm_no_leaks(served):
    eng, reqs, budget = _shock_engine(served, max_new=6)
    res = run_cancellation_storm(
        eng, reqs, cancel_frac=0.34, seed=5,
        budget_trace=_staircase(eng, budget, 4, 14, 0.6))
    assert res["cancelled"] >= res["cancel_quota"] >= 2
    assert res["live_requests"] == 0 and res["leaked_pages"] == 0
    assert res["spilled_requests"] == 0
    assert res["done"] + res["cancelled"] == len(reqs)
    assert not res["deadlock"]


def test_run_exception_releases_pool(served):
    eng, reqs, budget = _shock_engine(served)

    class Boom(RuntimeError):
        pass

    def bomb(e):
        if e._running and e._preempted:
            raise Boom("fault injection")

    with pytest.raises(Boom):
        eng.run(reqs, budget_trace=_staircase(eng, budget, 3, 10 ** 9, 0.7),
                on_tick=bomb)
    _drained(eng.pool.stats())
    assert not eng._running and not eng._preempted and not eng._prefilling
    rep = eng.run(reqs)                         # the engine is reusable
    assert all(r.status == "done" for r in rep.results)
    _drained(rep.pool)


# ------------------------------------------------------- against JAX
def test_shocked_trace_matches_jax(served):
    """The same shocked trace (arrivals at t = 0, so admission does not
    depend on either framework's speed) through JAX's engine and the
    port's, paged, DensePolicy: equal tokens, masks, statuses and
    preemption count."""
    s = served
    prompts, budget = _trace(s)
    kw = dict(mode="masked", max_new_tokens=6, max_active=4, max_len=32,
              budget_bytes=budget, tokens_per_page=8, decode_horizon=2)
    jeng = JaxRAPEngine(s["jm"], s["jp"],
                        JaxDensePolicy(jmem.build_memory_model(s["jm"].cfg)),
                        JaxEngineConfig(**kw),
                        executor=JaxPagedExecutor(s["jm"], s["jp"],
                                                  max_active=4))
    kv = budget - jeng.resident_param_bytes
    frac = (jeng.resident_param_bytes + 0.4 * kv) / budget
    jrep = jeng.run([JaxEngineRequest(rid=f"r{i}", prompt=p)
                     for i, p in enumerate(prompts)],
                    budget_trace=JaxTickStaircase(
                        budget, [(2, 1.0), (10, frac), (0, 1.0)]))
    eng = RAPEngine(s["tm"], s["tp"], DensePolicy(s["mm"]),
                    EngineConfig(**kw),
                    executor=PagedExecutor(s["tm"], s["tp"], max_active=4))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                   for i, p in enumerate(prompts)],
                  budget_trace=TickStaircase(budget, [(2, 1.0), (10, frac),
                                                      (0, 1.0)]))
    assert rep.preempted_count == jrep.preempted_count > 0
    assert len(rep.budget_events) == len(jrep.budget_events)
    want = {r.rid: r for r in jrep.results}
    assert {r.rid for r in rep.results} == set(want)
    for r in rep.results:
        assert r.status == want[r.rid].status == "done"
        np.testing.assert_array_equal(r.mask, want[r.rid].mask)
        np.testing.assert_array_equal(r.tokens, want[r.rid].tokens,
                                      err_msg=r.rid)
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]


# ------------------------------------------------------------ launcher
class _TickClock:
    """A clock that advances 0.2 ms each time it is read: the staircase's
    breakpoints (on the engine's virtual clock) then fall on the same
    ticks on a fast machine and on a loaded one."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 2e-4
        return self.t


@pytest.mark.parametrize("executor", ["paged", "local"])
def test_serve_budget_trace_staircase_on_cpu(capsys, monkeypatch, executor):
    """One request whose reservation fills a pool of one request: the
    staircase halves the KV headroom while it decodes, so it is preempted,
    resumed when the budget recovers, and ends with the unshocked serve's
    tokens."""
    import time
    from repro_torch.launch import serve
    monkeypatch.setattr(time, "perf_counter", _TickClock())
    argv = ["--smoke", "--device", "cpu", "--requests", "1",
            "--pool-requests", "1.0", "--max-prompt", "64", "--max-new",
            "128", "--decode-horizon", "1", "--policy", "dense",
            "--executor", executor, "--mode", "masked"]
    _, ref = serve.main(argv)
    _, rep = serve.main(argv + ["--budget-trace", "staircase"])
    out = capsys.readouterr().out
    assert "budget trace: staircase" in out and "preemption: " in out
    assert rep.preempted_count > 0 and rep.spilled_mb > 0
    assert [r.status for r in rep.results] == ["done"]
    np.testing.assert_array_equal(rep.results[0].tokens,
                                  ref.results[0].tokens)


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_decode_splits_follow_the_slot_width(served, monkeypatch, kind):
    """The executors give the decode kernels their group's slot width as
    ``split_rows``, whatever bucket of rows steps: the split-KV cut, and
    with it a row's sums, cannot change when a shock changes who steps
    together."""
    from repro_torch.kernels import ops
    seen = []
    name = "paged_decode_attention" if kind == "paged" else "decode_attention"
    orig = getattr(ops, name)

    def spy(*a, **kw):
        seen.append((a[0].shape[0], kw["split_rows"]))
        return orig(*a, **kw)

    monkeypatch.setattr(ops, name, spy)
    prompts, budget = _trace(served, n=3)
    eng = _engine(served, kind, budget=budget, max_new=4,
                  policy=DensePolicy(served["mm"]))
    rep = eng.run(_reqs(prompts, max_new=4))
    assert {r.status for r in rep.results} == {"done"}
    assert {rows for _, rows in seen} == {4}
    assert {b for b, _ in seen} & {1, 2}      # narrower buckets stepped
