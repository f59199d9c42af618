"""The MoE decoders (olmoe-1b-7b, dbrx-132b) of the port against the JAX
package, on the CPU, at their SMOKE sizes with JAX-initialised weights
carried by ``repro_torch.bridge`` (norm scales perturbed, so a misapplied
one shows). Tolerances: f32 logits and losses 1e-4 (``TOL``), gradients
1e-5 of each leaf's largest (``GRAD_TOL``); routing choices, capacities,
drop masks, masks and tokens exactly.

* configs field for field, the assignment numbers, and the analytic
  parameter count against the port's own pytree;
* ``_route`` (weights, chosen experts, a tie), ``_capacity`` and the drop
  masks of the capacity dispatch against JAX's stable-sort ranking, with
  drops > 0 at the inputs chosen (the calibration batch for olmoe, a
  24-token prompt for dbrx); token groups against ``jax.vmap``;
* ``moe_ffn_scatter`` against JAX's, and scatter ≡ dense where the
  capacity factor leaves nothing to drop (and dense against JAX's oracle);
* logits, loss and the gradient of every leaf against
  ``jax.value_and_grad``;
* prefill + decode horizons H ∈ {1, 4, 8} against JAX (tokens equal, and
  H unobservable in the port); chunked prefill against JAX's chunked
  prefill at the same chunks — and chunked ≢ monolithic in JAX itself,
  since a chunk's capacity follows its own token count (ROADMAP queue 3);
* engine traces (RL policy on a 0.3 grid, so it prunes) equal to JAX's:
  masked and structural, on the paged and the local executor, and on int8
  pages; ``gsi_rank`` (candidates batched into one forward as token
  groups) against JAX's ``vmap``;
* ``compact_params`` of the ``moe`` stack, a checkpoint round trip both
  ways, the bridge's f32 router, and
  ``launch.serve --arch olmoe-1b-7b / dbrx-132b --smoke --device cpu``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import controller as jctl, dqn as jdqn, gsi as jgsi
from repro.core import masks as jmasks, memory as jmem
from repro.core.policy import RLPolicy as JaxRLPolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import decoder as jdec, moe as jmoe
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import controller, gsi, masks, memory
from repro_torch.core.policy import RLPolicy
from repro_torch.models import decoder, moe, registry
from repro_torch.runtime import (EngineConfig, EngineRequest, LocalExecutor,
                                 PagedExecutor, RAPEngine, steps)

torch.set_num_threads(1)

TOL = 1e-4          # f32 logits and losses across frameworks
GRAD_TOL = 1e-5     # f32 gradients, relative to each leaf's largest
ARCHS = ("olmoe-1b-7b", "dbrx-132b")
# an input at which each SMOKE model's first MoE layer drops assignments:
# olmoe at GSI's calibration size (16 x 64 tokens: C = 320 against a mean
# load of 256), dbrx (4 experts) on a 24-token prompt (C = 16, mean 12)
DROPPING = {"olmoe-1b-7b": (16, 64, 0), "dbrx-132b": (1, 24, 124)}


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if name == "scale":
        return jnp.asarray(0.2 * rng.standard_normal(tree.shape), tree.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jm = jreg.build(jax_smoke(arch))
    jp = _perturb(jm.init(jax.random.key(0)), np.random.default_rng(1))
    tm = registry.build(get_smoke_config(arch))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _layer0(arch):
    """Layer 0's MoE params on both sides and the hidden state that
    reaches it for the ``DROPPING`` input (its embeddings, times 4)."""
    jm, jp, tm, tp = _pair(arch)
    B, S, seed = DROPPING[arch]
    toks = _tokens(tm.cfg, B, S, seed)
    jmp = jax.tree.map(lambda x: x[0], jp["stacks"]["moe"])
    tmp = decoder.tree_slice(tp["stacks"]["moe"], 0)
    x = np.asarray(jp["embed"])[toks] * 4.0
    return jm.cfg, jmp, tm.cfg, tmp, x


def _jax_keep(cfg, idx, groups=1):
    """JAX's capacity ranking (``moe_ffn_scatter``'s stable argsort and
    searchsorted), per group of tokens: the kept-assignment mask."""
    def one(idx):
        T, k = idx.shape
        C = jmoe._capacity(cfg, T)
        flat_e = idx.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        seg = jnp.searchsorted(sorted_e, jnp.arange(cfg.n_experts))
        rank = jnp.zeros((T * k,), jnp.int32).at[order].set(
            jnp.arange(T * k, dtype=jnp.int32) - seg[sorted_e])
        return rank < C
    return np.asarray(jax.vmap(one)(idx.reshape(groups, -1, idx.shape[1]))
                      ).reshape(-1)


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_for_field(arch):
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_params() == theirs.total_params()
    cfg = get_config(arch)
    spec = {"olmoe-1b-7b": (16, 2048, 16, 16, 1024, 50304, 64, 8),
            "dbrx-132b": (40, 6144, 48, 8, 10752, 100352, 16, 4)}[arch]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.moe_top_k) == spec


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_params_match_pytree(arch):
    """``total_params()`` against the port's own initialised pytree (a
    meta template: shapes only), as ``tests/test_archs.py`` holds JAX's;
    the router is f32 under bf16 params, as in JAX."""
    for cfg in (get_smoke_config(arch), get_config(arch)):
        params = registry.build(cfg).init(0, "meta")
        real = sum(v.numel() for v in _flat(params).values())
        assert abs(real - cfg.total_params()) / real < 0.05
    st = params["stacks"]["moe"]
    c = get_config(arch)
    assert st["wi"].shape == (c.n_layers, c.n_experts, c.d_model, 2 * c.d_ff)
    assert st["wo"].shape == (c.n_layers, c.n_experts, c.d_ff, c.d_model)
    assert st["router"].dtype == torch.float32
    assert st["wi"].dtype == torch.bfloat16


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("arch", ARCHS)
def test_route_capacity_and_drops_match_jax(arch):
    jcfg, jmp, cfg, tmp, x = _layer0(arch)
    xt = x.reshape(-1, cfg.d_model)
    jw, jidx = jmoe._route(jmp, jcfg, jnp.asarray(xt))
    tw, tidx = moe._route(tmp, cfg, torch.from_numpy(xt))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    for T in (1, 8, 24, 100, 1024, 1500, 4096):
        assert moe._capacity(cfg, T) == jmoe._capacity(jcfg, T), T
    slot, keep, C = moe.dispatch(cfg, tidx)
    want = _jax_keep(jcfg, jidx)
    drops = int((~keep).sum())
    print(f"{arch}: T={xt.shape[0]} C={C} drops port {drops} jax "
          f"{int((~want).sum())}")
    np.testing.assert_array_equal(keep.numpy(), want)
    assert drops > 0
    assert C == jmoe._capacity(jcfg, xt.shape[0])
    assert int(slot.max()) == C and int(slot[keep].max()) < C
    # each kept (expert, slot) is taken once
    pairs = tidx.reshape(-1)[keep] * (C + 1) + slot[keep]
    assert pairs.unique().numel() == int(keep.sum())


def test_route_ties_keep_the_lower_expert():
    """Equal probabilities: ``jax.lax.top_k`` keeps the lower index first;
    so does the port's stable sort (``torch.topk`` promises no order)."""
    jcfg, cfg = jax_smoke("olmoe-1b-7b"), get_smoke_config("olmoe-1b-7b")
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0, [1, 3, 6]] = 1.0             # experts 1, 3, 6 tie on top
    x = np.zeros((5, cfg.d_model), np.float32)
    x[:, 0] = np.arange(5)
    jw, jidx = jmoe._route({"router": jnp.asarray(router)}, jcfg,
                           jnp.asarray(x))
    tw, tidx = moe._route({"router": torch.from_numpy(router)}, cfg,
                          torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tidx[1:].tolist() == [[1, 3]] * 4
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_groups_match_jax_vmap(arch):
    """``groups`` = G: G independent calls (capacity and ranking per
    group), the twin of ``jax.vmap(moe_ffn_scatter)``; one call of all the
    rows drops otherwise."""
    jcfg, jmp, cfg, tmp, x = _layer0(arch)
    G = 4
    xs = np.concatenate([x * (1.0 + 0.1 * g) for g in range(G)])
    want = jax.vmap(lambda xb: jmoe.moe_ffn_scatter(jmp, jcfg, xb))(
        jnp.asarray(xs.reshape(G, -1, *x.shape[1:])))
    got = moe.moe_ffn_scatter(tmp, cfg, torch.from_numpy(xs), groups=G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), atol=TOL, rtol=0)
    _, idx = moe._route(tmp, cfg, torch.from_numpy(xs).reshape(
        -1, cfg.d_model))
    _, keep, _ = moe.dispatch(cfg, idx, G)
    np.testing.assert_array_equal(keep.numpy(),
                                  _jax_keep(jcfg, jnp.asarray(idx), G))
    one = moe.moe_ffn_scatter(tmp, cfg, torch.from_numpy(xs))
    assert float((one - got).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="do not divide"):
        moe.moe_ffn_scatter(tmp, cfg, torch.from_numpy(xs), groups=3)


@pytest.mark.parametrize("arch", ARCHS)
def test_scatter_and_dense_match_jax(arch):
    """Scatter (with drops) against JAX's scatter, dense against JAX's
    oracle, and scatter ≡ dense where the capacity drops nothing."""
    jcfg, jmp, cfg, tmp, x = _layer0(arch)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    got = moe.moe_ffn(tmp, cfg, xt)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jmoe.moe_ffn_scatter(jmp, jcfg, xj)),
        atol=TOL, rtol=0)
    dense = moe.moe_ffn(tmp, cfg, xt, impl="dense")
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(jmoe.moe_ffn_dense(jmp, jcfg, xj)),
        atol=TOL, rtol=0)
    assert float((got - dense).abs().max()) > 1e-4     # the drops show
    wide = cfg.replace(moe_capacity_factor=float(cfg.n_experts))
    np.testing.assert_allclose(moe.moe_ffn(tmp, wide, xt).numpy(),
                               dense.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 2, 16, seed=6)
    want = np.asarray(jm.logits(jp, {"tokens": jnp.asarray(toks)}))
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks)}).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    b = {"tokens": toks, "labels": toks}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = steps.loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(loss) - float(jl)) <= TOL
    flat, jflat = _flat(grads), _flat(jax.tree.map(np.asarray, jg))
    assert sorted(flat) == sorted(jflat)
    assert {"stacks/moe/router", "stacks/moe/wi", "stacks/moe/wo"} <= set(flat)
    for k, g in flat.items():
        want = jflat[k]
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_TOL * scale, k
        if k.startswith("stacks/moe"):
            assert float(np.abs(want).max()) > 0.0, k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_horizons_match_jax(arch):
    """Prefill logits and K/V within TOL, then decode horizons of 1, 4 and
    8 tokens: JAX's tokens, and the same 8 tokens whatever the horizon."""
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 2, 13, seed=3)
    jl, jc = jdec.prefill(jp, jm.cfg, jnp.asarray(toks), 24)
    first = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jt, _ = jdec.decode_horizon(jp, jm.cfg, jc, jnp.asarray(first), 8)
    runs = {}
    for H in (1, 4, 8):
        tl, tc = decoder.prefill(tp, tm.cfg, torch.from_numpy(toks), 24)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc["attn"][k].numpy(),
                                       np.asarray(jc["attn"][k]), atol=TOL,
                                       rtol=0)
        tok, out = torch.from_numpy(first), []
        for _ in range(8 // H):
            t, tc = decoder.decode_horizon(tp, tm.cfg, tc, tok, H)
            out.append(t)
            tok = t[:, -1:]
        runs[H] = torch.cat(out, dim=1).numpy()
        np.testing.assert_array_equal(runs[H], np.asarray(jt))
    assert np.array_equal(runs[1], runs[8])


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_jax_chunked_not_monolithic(arch):
    """A 24-token prompt in chunks of 8 (slot cache) against JAX's chunked
    prefill at the same chunks: logits within TOL. A chunk's expert
    capacity follows its own 8 tokens, so chunked ≢ monolithic for MoE —
    in JAX as in the port (ROADMAP queue 3): the monolithic pass drops an
    assignment that no chunk drops."""
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 1, 24, seed=124)
    jc = jdec.init_cache(jm.cfg, 1, 32)
    tc = decoder.init_cache(tm.cfg, 1, 32)
    for start in (0, 8, 16):
        jl, jc = jdec.prefill_chunk(jp, jm.cfg, jc,
                                    jnp.asarray(toks[:, start:start + 8]),
                                    start)
        tl = decoder.prefill_chunk(tp, tm.cfg, tc,
                                   torch.from_numpy(toks[:, start:start + 8]),
                                   start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=0)
    jmono, _ = jdec.prefill(jp, jm.cfg, jnp.asarray(toks), 32)
    tmono, _ = decoder.prefill(tp, tm.cfg, torch.from_numpy(toks), 32)
    np.testing.assert_allclose(tmono.numpy(), np.asarray(jmono), atol=TOL,
                               rtol=0)
    jgap = float(np.abs(np.asarray(jmono) - np.asarray(jl)).max())
    tgap = float((tmono - tl).abs().max())
    print(f"{arch}: chunked vs monolithic max|Δ| JAX {jgap:.3e}, port "
          f"{tgap:.3e}")
    assert jgap > 1e-3 and abs(jgap - tgap) <= TOL
    wide = tm.cfg.replace(moe_capacity_factor=float(tm.cfg.n_experts))
    tc = decoder.init_cache(wide, 1, 32)
    for start in (0, 8, 16):
        tl = decoder.prefill_chunk(tp, wide, tc, torch.from_numpy(
            toks[:, start:start + 8]), start)
    tmono, _ = decoder.prefill(tp, wide, torch.from_numpy(toks), 32)
    np.testing.assert_allclose(tl.numpy(), tmono.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- engine
def _calib(cfg):
    return JaxCorpus(cfg.vocab_size, seed=7).batch(2, 32, split="calib")


def _engines(arch, executor, mode, kv_dtype=None):
    """(JAX report, port report) of one strict engine trace with the RL
    controller on an admission grid of 0.3 (so it prunes): 6 batch-1
    prompts of 16 and 24 tokens."""
    jm, jp, tm, tp = _pair(arch)
    L = tm.cfg.n_layers
    mm = memory.build_memory_model(tm.cfg)
    calib = _calib(tm.cfg)
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    tq = bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))
    toks = calib["tokens"]
    prompts = [toks[:1, : (16 if i % 2 else 24)] for i in range(6)]
    full = masks.full_mask(L)
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
    kw = dict(mode=mode, max_new_tokens=2, max_active=4, max_len=32,
              budget_bytes=budget, tokens_per_page=8, decode_horizon=8,
              budget_quantum_frac=0.3, kv_dtype=kv_dtype)
    jx = {"paged": JaxPagedExecutor, "local": JaxLocalExecutor}[executor]
    tx = {"paged": PagedExecutor, "local": LocalExecutor}[executor]
    xkw = dict(mode=mode, max_active=4)
    if kv_dtype is not None:
        xkw["kv_dtype"] = kv_dtype
    jpol = JaxRLPolicy(jctl.RAPController(
        jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
        jmem.build_memory_model(jm.cfg), jq))
    jrep = JaxRAPEngine(jm, jp, jpol, JaxEngineConfig(**kw),
                        executor=jx(jm, jp, **xkw)).run(
        [JaxEngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    pol = RLPolicy(controller.RAPController(
        tm, tp, {k: torch.from_numpy(v) for k, v in calib.items()}, mm, tq))
    rep = RAPEngine(tm, tp, pol, EngineConfig(**kw),
                    executor=tx(tm, tp, **xkw)).run(
        [EngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    return jrep, rep


@pytest.mark.parametrize("arch,executor,mode,kv_dtype", [
    (a, x, m, None) for a in ARCHS for x in ("paged", "local")
    for m in ("masked", "structural")] + [
    (a, "paged", "masked", "int8") for a in ARCHS])
def test_engine_trace_matches_jax(arch, executor, mode, kv_dtype):
    jrep, rep = _engines(arch, executor, mode, kv_dtype)
    L = get_smoke_config(arch).n_layers
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 6
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
        assert tuple(got[rid].bucket) == tuple(r.bucket), rid
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]
    assert rep.pool["overcommit_events"] == 0
    assert any(r.mask.sum() < 2 * L for r in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_gsi_rank_matches_jax(arch):
    """Algorithm 1 on the calibration batch: the port scores each state's
    candidates in one forward (token groups), JAX under ``vmap``; the
    removal order and the score snapshots agree."""
    jm, jp, tm, tp = _pair(arch)
    calib = _calib(tm.cfg)
    jr = jgsi.gsi_rank(jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
                       max_removals=3)
    tr = gsi.gsi_rank(tm, tp, {k: torch.from_numpy(v)
                               for k, v in calib.items()}, max_removals=3)
    assert tr.order == jr.order
    for a, b in zip(tr.score_snapshots, jr.score_snapshots):
        fin = np.isfinite(np.asarray(b))
        np.testing.assert_array_equal(np.isfinite(a), fin)
        np.testing.assert_allclose(np.asarray(a)[fin], np.asarray(b)[fin],
                                   atol=TOL, rtol=0)


# ----------------------------------------------- structure, checkpoints
def test_compact_params_carries_the_moe_stack():
    jm, jp, tm, tp = _pair("olmoe-1b-7b")
    mask = masks.full_mask(tm.cfg.n_layers)
    mask[tm.cfg.n_layers] = False                 # layer 0's FFN
    small, layout = masks.compact_params(tp, tm.cfg, mask)
    jsmall, jlayout = jmasks.compact_params(jp, jm.cfg, mask)
    assert [tuple(s) for s in layout] == [tuple(s) for s in jlayout]
    flat, jflat = _flat(small), _flat(jax.tree.map(np.asarray, jsmall))
    assert sorted(flat) == sorted(jflat)
    assert flat["stacks/moe/wi"].shape[0] == tm.cfg.n_layers - 1
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    toks = _tokens(tm.cfg, 2, 12, seed=5)
    want, _ = jdec.forward(jsmall, jm.cfg, jnp.asarray(toks), layout=jlayout)
    got, _ = decoder.forward(small, tm.cfg, torch.from_numpy(toks),
                             layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_checkpoint_round_trip_both_ways(tmp_path):
    """The port writes, both packages read; JAX writes, the port reads."""
    jm, jp, tm, tp = _pair("olmoe-1b-7b")
    save_pytree(tp, str(tmp_path / "port"), 3)
    back, manifest = restore_pytree(tm.init(0, "meta"), str(tmp_path / "port"))
    assert {"stacks/moe/router", "stacks/moe/wi"} <= set(manifest["leaves"])
    flat = _flat(tp)
    for k, v in _flat(back).items():
        assert torch.equal(v, flat[k]), k
    jback, _ = jckpt.restore_pytree(jax.eval_shape(lambda: jp),
                                    str(tmp_path / "port"))
    for k, v in _flat(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(v, flat[k].numpy(), err_msg=k)
    jckpt.save_pytree(jp, str(tmp_path / "jax"), 5)
    back, _ = restore_pytree(tm.init(0, "meta"), str(tmp_path / "jax"))
    for k, v in _flat(back).items():
        assert torch.equal(v, flat[k]), k


def test_bridge_keeps_the_router_f32():
    """JAX keeps the router f32 under bf16 params; the bridge's ``dtype=``
    cast leaves it so."""
    cfg = jax_smoke("olmoe-1b-7b").replace(param_dtype="bfloat16",
                                           dtype="bfloat16")
    jp = jreg.build(cfg).init(jax.random.key(0))
    assert jp["stacks"]["moe"]["router"].dtype == jnp.float32
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                                  dtype=torch.bfloat16)
    assert tp["stacks"]["moe"]["router"].dtype == torch.float32
    assert tp["stacks"]["moe"]["wi"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["stacks"]["moe"]["router"].numpy(),
                                  np.asarray(jp["stacks"]["moe"]["router"]))


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_serves_moe(arch, capsys):
    from repro_torch.launch import serve
    assert arch in serve.ARCHS
    eng, rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--executor", "paged", "--mode", "masked",
                           "--requests", "3", "--max-prompt", "32",
                           "--max-new", "4", "--budget-quantum", "0.3"])
    assert all(r.status == "done" for r in rep.results)
    assert rep.pool["overcommit_events"] == 0
    assert f"model {arch}" in capsys.readouterr().out
