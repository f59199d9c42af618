"""Structural mode of the port (retained-layer buckets) against the JAX
package, on the CPU.

Seeded numpy masks, tokens and weights (JAX's init, bridged with
``bridge.params_from_numpy``) go through both packages:

* the mask algebra — ``compact_layout``, ``bucket_key``, ``gather_key``,
  ``keep_rows`` and ``quantize_mask`` (none / layer / pow2) — equal over
  seeded random masks on llama2, mamba2 and recurrentgemma;
* ``compact_params`` stack for stack, exactly; ``forward`` on the
  compacted stacks within 1e-4 of JAX's (the tolerance of
  ``tests/test_rap_core.py``); within the port, the gathered stacks and
  the row-indexed layout over the full stacks (what the executors run)
  give the same bits, and so do masked-mode gates;
* prefill + a decode horizon through heterogeneous retained layouts (rows
  without a mixer or an FFN, mamba2 rows without either) against JAX's
  decoder on the same layout;
* a strict-admission structural engine trace (RL policy, bucket affinity)
  on both executors: statuses, masks, buckets and tokens equal.

Then the port's own twins of JAX's structural executor contracts
(``tests/test_executors.py``, ``test_engine.py``, ``test_runtime.py``):
bucket aliasing, paged ≡ local, horizon invariance, spill/resume, bucket
quantization, the group cap, masked ≡ structural, ``RAPServer`` bucket
reuse, and the launcher's ``--mode structural``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import masks as jmasks
from repro.models import decoder as jdec, registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import masks
from repro_torch.core.policy import Decision, PruningPolicy
from repro_torch.models import decoder
from repro_torch.runtime import (EngineConfig, EngineRequest, LocalExecutor,
                                 PagedExecutor, RAPEngine, RAPServer,
                                 TickStaircase)
from test_torch_engine import L, _engine_kw, _trace, served  # noqa: F401
from test_torch_slot import _jax_policy, _port_policy

torch.set_num_threads(1)
# SMOKE widths, a few layers: recurrentgemma's pattern twice over
LAYERS = {"llama2-7b": 4, "mamba2-370m": 4, "recurrentgemma-9b": 6}
ARCHS = list(LAYERS)
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX cfg, JAX params, port cfg, port params), bridged."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_smoke(arch).replace(n_layers=LAYERS[arch])
            jp = jreg.build(jcfg).init(jax.random.key(0))
            tcfg = get_smoke_config(arch).replace(n_layers=LAYERS[arch])
            tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                          "cpu")
            cache[arch] = (jcfg, jp, tcfg, tp)
        return cache[arch]
    return get


def _random_masks(L, seed, n=24):
    rng = np.random.default_rng(seed)
    out = [rng.random(2 * L) < p for p in rng.uniform(0.2, 0.95, n)]
    return out + [np.zeros(2 * L, bool), np.ones(2 * L, bool)]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _drop_layer(L, *layers):
    m = masks.full_mask(L)
    for i in layers:
        m[i] = m[L + i] = False
    return m


# ----------------------------------------------------------- mask algebra
@pytest.mark.parametrize("quant", ["none", "layer", "pow2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mask_algebra_matches_jax(arch, quant):
    cfg = get_smoke_config(arch).replace(n_layers=LAYERS[arch])
    jcfg = jax_smoke(arch).replace(n_layers=LAYERS[arch])
    for mask in _random_masks(cfg.n_layers, seed=len(arch)):
        q = masks.quantize_mask(cfg, mask, quant)
        np.testing.assert_array_equal(q, jmasks.quantize_mask(jcfg, mask,
                                                              quant))
        lay, gather = masks.compact_layout(cfg, q)
        jlay, jgather = jmasks.compact_layout(jcfg, q)
        assert [tuple(s) for s in lay] == [tuple(s) for s in jlay]
        assert gather == jgather
        assert masks.bucket_key(cfg, q) == jmasks.bucket_key(jcfg, q)
        assert masks.gather_key(cfg, q) == jmasks.gather_key(jcfg, q)
        np.testing.assert_array_equal(masks.keep_rows(cfg, q),
                                      jmasks.keep_rows(jcfg, q))
        # the executors' layout: the same rows and kinds, original indices
        rows = masks.keep_rows(cfg, q)
        base = decoder.default_layout(cfg)
        ret = masks.retained_layout(cfg, q)
        assert [(s.mixer, s.ffn) for s in ret] == [(s.mixer, s.ffn)
                                                   for s in lay]
        assert [(s.mixer_idx, s.ffn_idx) for s in ret] == [
            (base[i].mixer_idx, base[i].ffn_idx) for i in rows]
        if quant != "none":
            assert all(q[i] and q[cfg.n_layers + i] for i in rows)
    with pytest.raises(ValueError):
        masks.quantize_mask(cfg, masks.full_mask(cfg.n_layers), "pow3")


# ------------------------------------------------------------- compaction
def _leaves(tree):
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(got, want, err_msg=path)


def _pruning_mask(arch):
    """A mask with a pruned mixer, a pruned FFN and a dropped layer."""
    L = LAYERS[arch]
    m = masks.full_mask(L)
    m[1] = False                   # layer 1 keeps only its FFN bit
    m[L + 2] = False               # layer 2 keeps only its mixer
    m[3] = m[L + 3] = False        # layer 3 is dropped
    if arch == "recurrentgemma-9b":
        m[5] = False               # a local-attention layer's mixer
    return m


@pytest.mark.parametrize("arch", ARCHS)
def test_compact_params_and_forward_match_jax(models, arch):
    jcfg, jp, cfg, tp = models(arch)
    mask = _pruning_mask(arch)
    small, lay = masks.compact_params(tp, cfg, mask)
    jsmall, jlay = jmasks.compact_params(jp, jcfg, mask)
    _assert_tree_equal(_leaves(small["stacks"]), _leaves(jsmall["stacks"]))
    assert [tuple(s) for s in lay] == [tuple(s) for s in jlay]
    toks = _tokens(cfg, 2, 20, seed=1)
    got, _ = decoder.forward(small, cfg, torch.from_numpy(toks), layout=lay)
    want, _ = jdec.forward(jsmall, jcfg, jnp.asarray(toks), layout=jlay)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # within the port: the row-indexed layout over the full stacks, and
    # masked-mode gates, give the gathered stacks' bits
    rows, _ = decoder.forward(tp, cfg, torch.from_numpy(toks),
                              layout=masks.retained_layout(cfg, mask))
    gated, _ = decoder.forward(tp, cfg, torch.from_numpy(toks),
                               gates=masks.mask_to_gates(mask))
    assert torch.equal(rows, got) and torch.equal(gated, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_heterogeneous_layout_prefill_decode_matches_jax(models, arch):
    """Prefill and a 6-token horizon through a retained layout with rows
    lacking a mixer or an FFN (mamba2: a row lacking both), the port's
    full stacks + original indices against JAX's compacted stacks; and,
    within the port, against its own gathered stacks, bit for bit."""
    jcfg, jp, cfg, tp = models(arch)
    mask = _pruning_mask(arch)
    lay = masks.retained_layout(cfg, mask)
    assert any(s.mixer is None for s in lay)
    jsmall, jlay = jmasks.compact_params(jp, jcfg, mask)
    toks = _tokens(cfg, 2, 20, seed=2)
    logits, cache = decoder.prefill(tp, cfg, torch.from_numpy(toks), 32,
                                    layout=lay)
    jlogits, jcache = jdec.prefill(jsmall, jcfg, jnp.asarray(toks), 32,
                                   layout=jlay)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    first = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks_h, _ = decoder.decode_horizon(tp, cfg, cache, first, 6, layout=lay)
    jtoks_h, _ = jdec.decode_horizon(jsmall, jcfg, jcache,
                                     jnp.asarray(first.numpy()), 6,
                                     layout=jlay)
    np.testing.assert_array_equal(toks_h.numpy(), np.asarray(jtoks_h))
    small, clay = masks.compact_params(tp, cfg, mask)
    glogits, gcache = decoder.prefill(small, cfg, torch.from_numpy(toks), 32,
                                      layout=clay)
    gtoks_h, _ = decoder.decode_horizon(small, cfg, gcache, first, 6,
                                        layout=clay)
    assert torch.equal(glogits, logits) and torch.equal(gtoks_h, toks_h)


# ------------------------------------------------- engine trace vs JAX
@pytest.mark.parametrize("kind", ["local", "paged"])
def test_structural_trace_matches_jax(served, kind):
    """The canonical 8-request trace in structural mode under strict
    admission (RL policy on the 0.3 admission grid, so masks prune and
    bucket affinity decides later admissions): statuses, masks, buckets,
    tokens and the pool peak equal JAX's."""
    s = served
    prompts, budget = _trace(s)
    kw = dict(_engine_kw(budget, 0.3), mode="structural", max_new_tokens=4)
    jex = (JaxPagedExecutor(s["jm"], s["jp"], mode="structural",
                            max_active=4) if kind == "paged" else None)
    jrep = JaxRAPEngine(s["jm"], s["jp"], _jax_policy(s),
                        JaxEngineConfig(**kw), executor=jex).run(
        [JaxEngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    ex = (PagedExecutor(s["tm"], s["tp"], mode="structural", max_active=4)
          if kind == "paged" else None)
    rep = RAPEngine(s["tm"], s["tp"], _port_policy(s), EngineConfig(**kw),
                    executor=ex).run(
        [EngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 8
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        assert got[rid].bucket == r.bucket != ()
        assert got[rid].cached_decision == r.cached_decision
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]
    assert any(r.mask.sum() < 2 * L for r in got.values())


# ------------------------------------------------ port-internal contracts
class FixedMaskPolicy(PruningPolicy):
    """Hands out a fixed sequence of masks (the last one repeating)."""
    name = "fixed"

    def __init__(self, mm, seq):
        self.mm = mm
        self._seq = [np.array(m, copy=True) for m in seq]
        self._i = 0

    def observe(self, state):
        mask = self._seq[min(self._i, len(self._seq) - 1)]
        self._i += 1
        peak = self.mm.peak_bytes(mask, state.batch, state.total_len)
        return self._stamp(Decision(mask=mask.copy(), steps=0,
                                    peak_bytes=peak,
                                    fits=peak <= state.budget_bytes,
                                    latency_s=0.0))


def _struct_engine(s, policy, kind, *, budget, max_new, slots=4, horizon=8,
                   kv_dtype=None, bucket_quant="none", max_groups=0):
    ex = None
    if kind == "paged":
        ex = PagedExecutor(s["tm"], s["tp"], mode="structural",
                           max_active=slots, kv_dtype=kv_dtype,
                           bucket_quant=bucket_quant)
    return RAPEngine(s["tm"], s["tp"], policy, EngineConfig(
        mode="structural", max_new_tokens=max_new, max_active=slots,
        max_len=32, budget_bytes=budget, tokens_per_page=8,
        kv_dtype=kv_dtype, decode_horizon=horizon,
        bucket_quant=bucket_quant, max_structural_groups=max_groups),
        executor=ex)


def _reqs(prompts, max_new):
    return [EngineRequest(rid=f"r{i}", prompt=np.asarray(p, np.int32),
                          max_new=max_new) for i, p in enumerate(prompts)]


def _budget(s, n=4.0, total=32):
    full = masks.full_mask(L)
    return s["mm"].param_bytes(full) + n * s["mm"].state_bytes(full, 1, total)


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_bucket_aliasing_serves_own_weights(served, kind):
    """Masks dropping different layers share a bucket signature but not
    their rows: two such requests on one slot each must each emit the
    tokens of their own solo serve (DESIGN.md §9)."""
    s = served
    toks = s["calib"]["tokens"]
    mA, mB = _drop_layer(L, 0), _drop_layer(L, 1)
    assert masks.bucket_key(s["tm"].cfg, mA) == masks.bucket_key(
        s["tm"].cfg, mB)
    assert masks.gather_key(s["tm"].cfg, mA) != masks.gather_key(
        s["tm"].cfg, mB)
    budget, pA, pB = _budget(s), toks[:1, :16], toks[:1, :24]

    def solo(mask, prompt):
        eng = _struct_engine(s, FixedMaskPolicy(s["mm"], [mask]), kind,
                             budget=budget, max_new=4, slots=1)
        return eng.run(_reqs([prompt], 4)).result("r0")

    ref_a, ref_b = solo(mA, pA), solo(mB, pB)
    eng = _struct_engine(s, FixedMaskPolicy(s["mm"], [mA, mB]), kind,
                         budget=budget, max_new=4, slots=1)
    rep = eng.run(_reqs([pA, pB], 4))
    ra, rb = rep.result("r0"), rep.result("r1")
    assert ra.status == rb.status == "done"
    np.testing.assert_array_equal(ra.mask, mA)
    np.testing.assert_array_equal(rb.mask, mB)
    np.testing.assert_array_equal(ra.tokens, ref_a.tokens)
    np.testing.assert_array_equal(rb.tokens, ref_b.tokens)
    st = eng.executor.stats()
    assert st["bucket_signatures"] == 1 and st["groups"] == 2
    assert st["resident_param_stacks"] == 0


def test_structural_paged_matches_local_bitwise(served):
    s = served
    prompts, budget = _trace(s)
    mask = _drop_layer(L, 1)
    outs = {}
    for kind in ("local", "paged"):
        rep = _struct_engine(s, FixedMaskPolicy(s["mm"], [mask]), kind,
                             budget=budget, max_new=4).run(_reqs(prompts, 4))
        assert [r.status for r in rep.results] == ["done"] * 8, kind
        outs[kind] = {r.rid: r.tokens for r in rep.results}
    for rid, t in outs["local"].items():
        np.testing.assert_array_equal(t, outs["paged"][rid], err_msg=rid)


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_structural_horizon_is_unobservable(served, kind):
    """H in {1, 4, 8} give equal streams; max_new=6 lands mid-horizon."""
    s = served
    toks = s["calib"]["tokens"]
    prompts = [toks[:1, :16], toks[:1, :24], toks[:1, :16]]
    outs = {}
    for h in (1, 4, 8):
        rep = _struct_engine(s, FixedMaskPolicy(s["mm"], [_drop_layer(L, 2)]),
                             kind, budget=_budget(s), max_new=6,
                             horizon=h).run(_reqs(prompts, 6))
        assert all(r.status == "done" for r in rep.results)
        outs[h] = {r.rid: r.tokens for r in rep.results}
    for h in (4, 8):
        for rid, t in outs[1].items():
            np.testing.assert_array_equal(t, outs[h][rid], err_msg=rid)


@pytest.mark.parametrize("kind,kv_dtype", [("local", None), ("paged", None),
                                           ("paged", "int8")],
                         ids=["local-fp32", "paged-fp32", "paged-int8"])
def test_structural_spill_restore_bitwise(served, kind, kv_dtype):
    """A budget shock spills residents of a compacted bucket (a slot cache
    of L-1 layers; pool layers [0, L-1) of the pages, scales included) and
    the resumed streams equal the unshocked run's."""
    s = served
    prompts, budget = _trace(s)
    mask = _drop_layer(L, 1)
    runs = []
    for shock in (False, True):
        eng = _struct_engine(s, FixedMaskPolicy(s["mm"], [mask]), kind,
                             budget=budget, max_new=6, horizon=2,
                             kv_dtype=kv_dtype)
        trace = None
        if shock:
            kv = budget - eng.resident_param_bytes
            frac = 0.45 if kv_dtype is None else 0.8
            # the shock lands while the first requests decode
            trace = TickStaircase(budget, [
                (2, 1.0), (10, (eng.resident_param_bytes
                                + (1.0 - frac) * kv) / budget), (0, 1.0)])
        runs.append(eng.run(_reqs(prompts, 6), budget_trace=trace))
    ref, rep = runs
    assert rep.preempted_count > 0
    want = {r.rid: r.tokens for r in ref.results}
    assert [r.status for r in rep.results] == ["done"] * 8
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid], err_msg=r.rid)
        assert r.bucket == (("attn", "dense"),) * (L - 1)
    assert rep.pool["reserved_bytes"] == 0
    assert rep.pool["spilled_requests"] == 0


def _serve_alone(ex, mask, prompt, rid, horizon=4):
    g = ex.group_for(mask, 32)
    first = ex.prefill_into(g, [0], rid, prompt, mask)
    toks = ex.decode_finish(ex.decode_launch(g, horizon))
    g.evict([0])
    return np.concatenate([first, toks[0]])


def test_bucket_quantization_bitwise_and_bounded(served):
    """A pow2 bucket runs the exact mask as gates over its rows: the
    tokens of the exact compaction, while the layouts collapse onto the
    ladder (here {4, 2}-layer buckets for 5 masks)."""
    s = served
    prompt = s["calib"]["tokens"][:1, :16]
    half = masks.full_mask(L)
    half[L + 2] = False                      # an FFN-only drop
    trial = [_drop_layer(L, 0), _drop_layer(L, 1), _drop_layer(L, 3),
             _drop_layer(L, 0, 1), half]
    streams, stats = {}, {}
    for quant in ("none", "pow2"):
        ex = LocalExecutor(s["tm"], s["tp"], mode="structural", max_active=2,
                           bucket_quant=quant)
        streams[quant] = [_serve_alone(ex, m, prompt, f"r{i}")
                          for i, m in enumerate(trial)]
        stats[quant] = ex.stats()
    for i in range(len(trial)):
        np.testing.assert_array_equal(streams["none"][i], streams["pow2"][i],
                                      err_msg=f"trial mask {i}")
    assert stats["pow2"]["bucket_signatures"] == 2 <= int(np.ceil(
        np.log2(L))) + 1
    assert stats["pow2"]["groups"] == 2
    assert stats["none"]["groups"] == len(trial)
    assert stats["none"]["bucket_signatures"] == 3     # 3, 2 and 4 layers


def test_all_pruned_mask_runs_no_layer(served):
    """A mask keeping no block has an empty retained layout: its group
    runs no layer and holds no cache, with the bits of masked mode's
    all-zero gates (JAX's compacted stacks have no kind left to run)."""
    s = served
    prompt = s["calib"]["tokens"][:1, :16]
    empty = np.zeros(2 * L, bool)
    out = {}
    for mode in ("structural", "masked"):
        ex = LocalExecutor(s["tm"], s["tp"], mode=mode, max_active=2)
        out[mode] = _serve_alone(ex, empty, prompt, "r")
    np.testing.assert_array_equal(out["structural"], out["masked"])
    ex = LocalExecutor(s["tm"], s["tp"], mode="structural", max_active=2)
    g = ex.group_for(empty, 32)
    assert g.layout == () and set(g.cache) == {"pos"}


def test_structural_group_cap_evicts_only_idle(served):
    s = served
    prompt = s["calib"]["tokens"][:1, :16]
    ex = LocalExecutor(s["tm"], s["tp"], mode="structural", max_active=2,
                       max_groups=2)
    for k in range(L):
        _serve_alone(ex, _drop_layer(L, k), prompt, f"r{k}", horizon=2)
    assert ex.stats()["groups"] <= 2 and ex.groups_minted == L
    g0 = ex.group_for(_drop_layer(L, 0), 32)
    ex.prefill_into(g0, [0], "busy0", prompt, _drop_layer(L, 0))
    g1 = ex.group_for(_drop_layer(L, 1), 32)
    ex.prefill_into(g1, [0], "busy1", prompt, _drop_layer(L, 1))
    ex.group_for(_drop_layer(L, 2), 32)
    assert g0.occupied() and g1.occupied()
    assert ex.stats()["groups"] == 3           # busy groups are never evicted
    assert g0 in ex.groups() and g1 in ex.groups()
    g0.evict([0])
    g1.evict([0])
    ex.group_for(_drop_layer(L, 3), 32)
    assert ex.stats()["groups"] <= 2
    # a hit touches the LRU order: the touched group outlives the other
    a = ex.group_for(_drop_layer(L, 3), 32)
    ex.group_for(_drop_layer(L, 0), 32)
    ex.group_for(_drop_layer(L, 1), 32)
    assert a not in ex.groups()
    for invalidate in (lambda e: e.set_max_active(4),
                       lambda e: e.drop_groups()):
        invalidate(ex)
        assert ex.stats()["groups"] == 0


def test_engine_masked_structural_equivalent_under_pruning(served):
    """A budget below the dense peak under force admission: both modes
    pick the same mask and decode the same tokens."""
    s = served
    prompt = s["calib"]["tokens"][:1, :16]
    budget = 0.8 * s["mm"].dense_peak(1, 20)
    res = {}
    for mode in ("masked", "structural"):
        eng = RAPEngine(s["tm"], s["tp"], _port_policy(s), EngineConfig(
            mode=mode, max_new_tokens=4, max_active=4, max_len=32,
            budget_bytes=budget, admission="force"))
        res[mode] = eng.run(_reqs([prompt], 4)).results[0]
    m, st = res["masked"], res["structural"]
    assert not m.mask.all()
    np.testing.assert_array_equal(m.mask, st.mask)
    np.testing.assert_array_equal(m.tokens, st.tokens)
    assert st.bucket != () and m.bucket == ()


def test_server_structural_by_default_and_bucket_reuse(served):
    """``RAPServer`` with its own defaults serves structural: the tokens
    and mask of a masked server, a bucket signature, and a second serve of
    the same shape reuses the group."""
    s = served
    prompt = s["calib"]["tokens"][:, :16]
    budget = 0.8 * s["mm"].dense_peak(prompt.shape[0], 20)
    srv = RAPServer(s["tm"], s["tp"], _port_policy(s), max_new_tokens=4)
    assert srv.mode == "structural"
    masked = RAPServer(s["tm"], s["tp"], _port_policy(s), mode="masked",
                       max_new_tokens=4)
    r1, r2 = srv.serve(prompt, budget), srv.serve(prompt, budget)
    rm = masked.serve(prompt, budget)
    np.testing.assert_array_equal(r1.mask, rm.mask)
    np.testing.assert_array_equal(r1.tokens, rm.tokens)
    np.testing.assert_array_equal(r2.tokens, r1.tokens)
    assert r1.bucket == masks.bucket_key(s["tm"].cfg, r1.mask) != ()
    assert rm.bucket == ()
    assert r1.compiled_new and not r2.compiled_new
    assert srv.stats() == {"structural_buckets": 1, "masked_groups": 0}
    with pytest.raises(ValueError):
        RAPServer(s["tm"], s["tp"], _port_policy(s), mode="gated")


def test_engine_refuses_mismatched_executor_and_config(served):
    s = served
    with pytest.raises(ValueError, match="mode"):
        RAPEngine(s["tm"], s["tp"], _port_policy(s),
                  EngineConfig(mode="structural"),
                  executor=PagedExecutor(s["tm"], s["tp"]))
    for bad in (dict(bucket_quant="pow3"), dict(max_structural_groups=-1),
                dict(mode="gated")):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    assert PagedExecutor(s["tm"], s["tp"],
                         mode="structural").bucket_quant == "layer"


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [["--executor", "local"],
                                  ["--executor", "paged", "--kv-dtype",
                                   "int8", "--bucket-quant", "pow2"]],
                         ids=["local", "paged-int8-pow2"])
def test_serve_entry_point_structural(argv, capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                           "--max-prompt", "32", "--max-new", "4",
                           "--budget-quantum", "0.3"] + argv)
    assert eng.cfg.mode == "structural"
    assert all(r.status == "done" and r.tokens.shape[1] == 4
               and r.bucket != () for r in rep.results)
    out = capsys.readouterr().out
    assert "tok/s" in out and "bucket stats:" in out
    st = eng.executor.stats()
    assert st["structural_buckets"] >= 1
    assert st["resident_param_stacks"] == 0
