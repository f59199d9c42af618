"""The port's static pruning baselines and policies against the JAX
package's, on the CPU.

SMOKE llama2 at 4 layers and SMOKE mamba2 (no FFN blocks: ∞ scores), with
JAX-initialised weights carried by ``repro_torch.bridge`` and the JAX
suite's calibration batch (corpus seed 7, 2 × 32 tokens):

* ``block_cosines`` within 1e-5, ``taylor_saliency`` within 1e-4 relative
  (a sum of |g ⊙ w| over every weight of a block: f32 gradients summed in
  another order), ``gsi_rank`` (order equal, trace within 1e-5) and
  ``oneshot_rank`` within 1e-5;
* every ``*_order`` equal and every ``*_mask`` equal at a budget of 0.8 of
  the dense peak; an argsort tie closer than these tolerances would show
  here as an unequal order (none does: the test prints the smallest gap);
* ``slicegpt_slice``: sliced params equal, the sliced model's logits
  within 1e-5; ``slicegpt_fit_ratio`` and ``mask_param_fraction`` equal;
* every registered policy through the engine (masked mode, the JAX
  suite's trace): JAX's masks and tokens per request;
* ``make_policy``'s registry and errors, and ``launch.serve --policy P`` on
  the CPU for every registered policy.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import baselines as jbase
from repro.core import controller as jctl, dqn as jdqn, gsi as jgsi
from repro.core import masks as jmasks, memory as jmem
from repro.core import policy as jpolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import baselines, controller, gsi, masks, memory
from repro_torch.core import policy
from repro_torch.models import registry
from repro_torch.runtime import EngineConfig, EngineRequest, RAPEngine

torch.set_num_threads(1)

COS_TOL, SAL_TOL, PPL_TOL = 1e-5, 1e-4, 1e-5
MODELS = {"llama2": ("llama2-7b", {"n_layers": 4}),
          "mamba2": ("mamba2-370m", {})}
STATIC = ("shortgpt", "mha_drop", "ffn_skip", "llmpruner", "oneshot",
          "random")


@functools.lru_cache(maxsize=None)
def _ctx(name):
    arch, kw = MODELS[name]
    jm = jreg.build(jax_smoke(arch).replace(**kw))
    jp = jm.init(jax.random.key(0))
    tm = registry.build(get_smoke_config(arch).replace(**kw))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    calib = JaxCorpus(jm.cfg.vocab_size, seed=7).batch(2, 32, split="calib")
    return dict(jm=jm, jp=jp, tm=tm, tp=tp,
                jb={k: jnp.asarray(v) for k, v in calib.items()},
                tb={k: torch.from_numpy(v) for k, v in calib.items()},
                jmm=jmem.build_memory_model(jm.cfg),
                tmm=memory.build_memory_model(tm.cfg), calib=calib)


NAMES = pytest.mark.parametrize("name", list(MODELS))


@pytest.fixture(scope="module", autouse=True)
def _jax_probes_once():
    """The JAX probes run eagerly (seconds each); every JAX order, mask and
    policy of a model here shares one call of each probe."""
    memo = {}

    def once(fn):
        def cached(model, params, batch, *a, **k):
            key = (fn.__name__, id(model), id(params), id(batch), a,
                   tuple(sorted(k.items())))
            if key not in memo:
                memo[key] = fn(model, params, batch, *a, **k)
            return memo[key]
        return cached

    with pytest.MonkeyPatch.context() as mp:
        for mod, fn in ((jbase, "block_cosines"), (jbase, "taylor_saliency"),
                        (jgsi, "oneshot_rank")):
            mp.setattr(mod, fn, once(getattr(mod, fn)))
        yield


def _min_gap(scores) -> float:
    s = np.sort(np.asarray(scores)[np.isfinite(scores)])
    return float(np.min(np.diff(s))) if len(s) > 1 else np.inf


# ------------------------------------------------------------------ probes
@NAMES
def test_block_cosines_match_jax(name):
    c = _ctx(name)
    jm, jf = jbase.block_cosines(c["jm"], c["jp"], c["jb"])
    tm, tf = baselines.block_cosines(c["tm"], c["tp"], c["tb"])
    for got, want in ((tm, jm), (tf, jf)):
        assert (np.isfinite(got) == np.isfinite(want)).all()
        np.testing.assert_allclose(got[np.isfinite(got)],
                                   want[np.isfinite(want)], atol=COS_TOL,
                                   rtol=COS_TOL)
    print(f"{name}: smallest cosine gap {_min_gap(np.r_[tm, tf]):.3e}")


@NAMES
def test_taylor_saliency_matches_jax(name):
    c = _ctx(name)
    want = jbase.taylor_saliency(c["jm"], c["jp"], c["jb"])
    got = baselines.taylor_saliency(c["tm"], c["tp"], c["tb"])
    assert (np.isfinite(got) == np.isfinite(want)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=SAL_TOL)
    assert (got[fin] > 0).all()
    print(f"{name}: smallest saliency gap {_min_gap(got):.3e}")


@NAMES
def test_gsi_rank_matches_jax(name):
    c = _ctx(name)
    want = jgsi.gsi_rank(c["jm"], c["jp"], c["jb"], max_removals=3)
    got = gsi.gsi_rank(c["tm"], c["tp"], c["tb"], max_removals=3)
    assert got.order == want.order
    np.testing.assert_allclose(got.ppl_trace, want.ppl_trace, atol=PPL_TOL,
                               rtol=PPL_TOL)
    np.testing.assert_array_equal(got.final_mask, want.final_mask)
    for g, w in zip(got.score_snapshots, want.score_snapshots):
        fin = np.isfinite(w)
        assert (np.isfinite(g) == fin).all()
        np.testing.assert_allclose(g[fin], w[fin], atol=PPL_TOL,
                                   rtol=PPL_TOL)
    # a stop rule ends the ranking early, as in JAX
    stop = lambda m: m.sum() <= len(m) - 1
    assert gsi.gsi_rank(c["tm"], c["tp"], c["tb"], stop=stop).order == \
        jgsi.gsi_rank(c["jm"], c["jp"], c["jb"], stop=stop).order


def test_oneshot_rank_matches_jax():
    c = _ctx("llama2")
    want = np.asarray(jgsi.oneshot_rank(c["jm"], c["jp"], c["jb"]))
    got = gsi.oneshot_rank(c["tm"], c["tp"], c["tb"])
    np.testing.assert_allclose(got, want, atol=PPL_TOL, rtol=PPL_TOL)
    print(f"smallest one-shot gap {_min_gap(got):.3e}")


# ------------------------------------------------------- orders and masks
ORDERS = {
    "shortgpt": lambda b, c, p: b.shortgpt_order(*p),
    "mha_drop": lambda b, c, p: b.mha_drop_order(*p),
    "ffn_skip": lambda b, c, p: b.ffn_skip_order(*p),
    "llmpruner": lambda b, c, p: b.llmpruner_order(*p),
    "oneshot": lambda b, c, p: b.oneshot_ppl_order(*p[:3]),
    "random": lambda b, c, p: b.random_drop_order(p[0], p[3], seed=3),
}
MASKS = {
    "shortgpt": lambda b, p, s: b.shortgpt_mask(*p, *s),
    "mha_drop": lambda b, p, s: b.mha_drop_mask(*p, *s),
    "ffn_skip": lambda b, p, s: b.ffn_skip_mask(*p, *s),
    "llmpruner": lambda b, p, s: b.llmpruner_mask(*p, *s),
    "oneshot": lambda b, p, s: b.oneshot_ppl_mask(*p, *s),
    "random": lambda b, p, s: b.random_drop_mask(p[0], p[3], *s, seed=3),
}


def _sides(c):
    return ((jbase, (c["jm"], c["jp"], c["jb"], c["jmm"])),
            (baselines, (c["tm"], c["tp"], c["tb"], c["tmm"])))


@NAMES
@pytest.mark.parametrize("kind", list(ORDERS))
def test_orders_and_masks_match_jax(name, kind):
    c = _ctx(name)
    (jb, jargs), (tb, targs) = _sides(c)
    assert ORDERS[kind](tb, c, targs) == ORDERS[kind](jb, c, jargs)
    shape = (1, 64, 0.8 * c["tmm"].dense_peak(1, 64))
    want = MASKS[kind](jb, jargs, shape)
    got = MASKS[kind](tb, targs, shape)
    np.testing.assert_array_equal(got, want)
    if kind != "ffn_skip" or name != "mamba2":     # mamba2 has no FFN
        assert not got.all()                       # the budget prunes


def test_prune_by_order_respects_allowed():
    c = _ctx("llama2")
    L = c["tm"].cfg.n_layers
    allowed = np.r_[np.zeros(L, bool), np.ones(L, bool)]
    order = list(range(2 * L))
    args = (c["tmm"], 1, 64, 0.8 * c["tmm"].dense_peak(1, 64))
    got = baselines.prune_by_order(order, *args, allowed=allowed)
    want = jbase.prune_by_order(order, c["jmm"], *args[1:], allowed=allowed)
    np.testing.assert_array_equal(got, want)
    assert got[:L].all()


# ---------------------------------------------------------------- SliceGPT
@pytest.mark.parametrize("ratio", [0.5, 0.75])
def test_slicegpt_slice_matches_jax(ratio):
    c = _ctx("llama2")
    jp2, jcfg = jbase.slicegpt_slice(c["jm"], c["jp"], ratio)
    tp2, tcfg = baselines.slicegpt_slice(c["tm"], c["tp"], ratio)
    for f in ("d_ff", "n_kv_heads", "n_heads", "head_dim"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    flat_j = jax.tree_util.tree_flatten_with_path(jp2)[0]
    for path, leaf in flat_j:
        node = tp2
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf),
                                      err_msg=str(path))
    toks = c["calib"]["tokens"]
    want = jreg.build(jcfg).logits(jp2, {"tokens": jnp.asarray(toks)})
    got = registry.build(tcfg).logits(tp2, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_fit_ratio_and_param_fraction_match_jax():
    c = _ctx("llama2")
    for frac in (0.5, 0.8, 0.95):
        budget = frac * c["tmm"].dense_peak(2, 128)
        assert baselines.slicegpt_fit_ratio(c["tm"].cfg, c["tmm"], 2, 128,
                                            budget) == \
            jbase.slicegpt_fit_ratio(c["jm"].cfg, c["jmm"], 2, 128, budget)
    rng = np.random.default_rng(2)
    for name in MODELS:
        cc = _ctx(name)
        L = cc["tm"].cfg.n_layers
        for _ in range(3):
            m = rng.random(2 * L) < 0.6
            assert masks.mask_param_fraction(cc["tm"].cfg, m) == \
                jmasks.mask_param_fraction(cc["jm"].cfg, m)
    assert baselines.BASELINES == jbase.BASELINES


# ---------------------------------------------------------------- policies
MAX_NEW, N_REQ = 2, 5


@functools.lru_cache(maxsize=None)
def _policies(side):
    """Every registered policy of one package, built from one context."""
    c = _ctx("llama2")
    L = c["tm"].cfg.n_layers
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    if side == "jax":
        ctl = jctl.RAPController(c["jm"], c["jp"], c["jb"], c["jmm"], jq)
        return {n: jpolicy.make_policy(n, model=c["jm"], params=c["jp"],
                                       calib=c["jb"], mm=c["jmm"],
                                       controller=ctl, seed=0)
                for n in jpolicy.available_policies()}
    ctl = controller.RAPController(c["tm"], c["tp"], c["tb"], c["tmm"],
                                   bridge.qnet_from_numpy(
                                       jax.tree.map(np.asarray, jq)))
    return {n: policy.make_policy(n, model=c["tm"], params=c["tp"],
                                  calib=c["tb"], mm=c["tmm"],
                                  controller=ctl, seed=0)
            for n in policy.available_policies()}


def _engine_run(side, name):
    c = _ctx("llama2")
    toks = c["calib"]["tokens"]
    full = masks.full_mask(c["tm"].cfg.n_layers)
    budget = (c["tmm"].param_bytes(full)
              + 2.5 * 0.9 * c["tmm"].state_bytes(full, 1, 26))
    kw = dict(mode="masked", max_new_tokens=MAX_NEW, max_active=4,
              max_len=32, budget_bytes=budget)
    prompts = [np.asarray(toks[:1, : (16 if i % 2 else 24)], np.int32)
               for i in range(N_REQ)]
    if side == "jax":
        eng = JaxRAPEngine(c["jm"], c["jp"], _policies("jax")[name],
                           JaxEngineConfig(**kw))
        req = JaxEngineRequest
    else:
        eng = RAPEngine(c["tm"], c["tp"], _policies("torch")[name],
                        EngineConfig(**kw))
        req = EngineRequest
    return eng.run([req(rid=f"r{i}", prompt=p, arrival_t=0.001 * i)
                    for i, p in enumerate(prompts)])


def test_registry_matches_jax():
    assert policy.available_policies() == jpolicy.available_policies()
    for n, p in _policies("torch").items():
        assert p.name == n and p.mm is not None
        if n in STATIC:
            assert isinstance(p, policy.StaticOrderPolicy)
            assert p.order == _policies("jax")[n].order


@pytest.mark.parametrize("name", ["rl", "dense"] + list(STATIC))
def test_policy_through_engine_matches_jax(name):
    """The twin of the JAX suite's policy conformance trace: every request
    done, with JAX's mask and tokens, and the pool within its budget."""
    want = {r.rid: r for r in _engine_run("jax", name).results}
    rep = _engine_run("torch", name)
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == N_REQ
    for rid, r in want.items():
        assert got[rid].status == r.status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    pool = rep.pool
    assert pool["peak_reserved_bytes"] <= pool["capacity_bytes"] + 1e-6
    assert pool["overcommit_events"] == 0


def test_static_policy_memoizes_like_jax():
    c = _ctx("llama2")
    p = _policies("torch")["shortgpt"]
    st = policy.PolicyState(batch=1, total_len=40,
                            budget_bytes=0.85 * c["tmm"].dense_peak(1, 40))
    first, again = p.observe(st), p.observe(st)
    assert not first.cached and again.cached
    np.testing.assert_array_equal(first.mask, again.mask)
    jd = _policies("jax")["shortgpt"].observe(jpolicy.PolicyState(
        batch=1, total_len=40, budget_bytes=st.budget_bytes))
    np.testing.assert_array_equal(first.mask, jd.mask)
    assert first.steps == jd.steps and first.fits == jd.fits


def test_make_policy_errors():
    c = _ctx("llama2")
    with pytest.raises(KeyError, match="unknown policy"):
        policy.make_policy("nope", mm=c["tmm"])
    with pytest.raises(ValueError, match="requires controller"):
        policy.make_policy("rl")
    with pytest.raises(ValueError, match="requires params, calib"):
        policy.make_policy("shortgpt", model=c["tm"], mm=c["tmm"])
    with pytest.raises(ValueError, match="requires model"):
        policy.make_policy("random", mm=c["tmm"])


@pytest.mark.parametrize("name", ["rl", "dense"] + list(STATIC))
def test_serve_builds_each_policy_on_cpu(name, capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                           "--max-prompt", "32", "--max-new", "2",
                           "--mode", "masked", "--policy", name,
                           "--budget-quantum", "0.3"])
    assert all(r.status == "done" for r in rep.results)
    assert eng.policy.name == name
    out = capsys.readouterr().out
    assert (f"building static policy {name!r}" in out) == (name != "rl")
    assert f"engine[{name}/" in out
