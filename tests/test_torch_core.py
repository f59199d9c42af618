"""The port's RAP core and runtime bookkeeping against the JAX package's.

Exact where the arithmetic is host-side numpy (memory-model bytes, KV page
bookkeeping, the synthetic corpus and workload, latency summaries); GSI
candidate scores within 1e-4 (f32 forwards on both sides); and the
controller's ``decide()`` masks equal over a (batch, seq, budget) grid
when both controllers hold the same bridged Q-network.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import controller as jctl, dqn as jdqn, gsi as jgsi
from repro.core import memory as jmem, workload as jwl
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import registry as jreg
from repro.runtime import kv_pool as jpool, latency as jlat
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import controller, dqn, gsi, masks, memory, workload
from repro_torch.data import SyntheticCorpus
from repro_torch.models import registry
from repro_torch.runtime import kv_pool, latency

torch.set_num_threads(1)


def _cfg_pairs():
    yield get_config("llama2-7b"), jax_config("llama2-7b")
    yield get_smoke_config("llama2-7b"), jax_smoke("llama2-7b")
    yield (get_config("llama2-7b").replace(n_kv_heads=8, n_layers=5),
           jax_config("llama2-7b").replace(n_kv_heads=8, n_layers=5))


@pytest.mark.parametrize("i", range(3), ids=["llama2-7b", "smoke", "gqa5L"])
def test_memory_model_bytes_equal(i):
    tcfg, jcfg = list(_cfg_pairs())[i]
    assert tcfg.block_param_counts() == jcfg.block_param_counts()
    assert tcfg.embed_params() == jcfg.embed_params()
    tm, jm = memory.build_memory_model(tcfg), memory.build_memory_model(jcfg)
    rng = np.random.default_rng(i)
    for _ in range(5):
        mask = rng.random(2 * tcfg.n_layers) < 0.7
        b, s = int(rng.integers(1, 9)), int(rng.integers(0, 4096))
        assert tm.param_bytes(mask) == jm.param_bytes(mask)
        assert tm.state_bytes(mask, b, s) == jm.state_bytes(mask, b, s)
        assert tm.peak_bytes(mask, b, s) == jm.peak_bytes(mask, b, s)
        np.testing.assert_array_equal(tm.block_bytes(b, s), jm.block_bytes(b, s))


def test_kv_pool_bookkeeping_equal():
    """One random alloc/extend/free sequence through both pools: the same
    page ids, commitments and ledger at every step."""
    kw = dict(page_bytes=4096, tokens_per_page=8)
    tp, jp = kv_pool.KVPool(40 * 4096, **kw), jpool.KVPool(40 * 4096, **kw)
    rng = np.random.default_rng(0)
    live = []
    for step in range(60):
        op = rng.integers(0, 3)
        if op == 0:
            b, n = int(rng.integers(1, 3)), int(rng.integers(1, 20))
            mx = n + int(rng.integers(0, 12))
            ok = tp.can_alloc_tokens(b, mx)
            assert ok == jp.can_alloc_tokens(b, mx)
            if ok:
                rid = f"r{step}"
                for pool in (tp, jp):
                    pool.alloc_tokens(rid, b, n, max_tokens=mx,
                                      in_use_bytes=100.0 * n,
                                      in_use_per_token=100.0)
                live.append(rid)
        elif op == 1 and live:
            rid = live[int(rng.integers(len(live)))]
            n = min(int(rng.integers(1, 6)), tp.remaining_commitment(rid))
            assert tp.extend(rid, n) == jp.extend(rid, n)
        elif live:
            rid = live.pop(int(rng.integers(len(live))))
            assert tp.free(rid) == jp.free(rid)
        for rid in live:
            assert tp.row_pages(rid) == jp.row_pages(rid)
        assert tp.stats() == {k: v for k, v in jp.stats().items()
                              if not k.startswith("spilled")}


def test_resolve_kv_dtype_maps_to_torch():
    assert kv_pool.resolve_kv_dtype(None) == (None, None, False, None)
    assert kv_pool.resolve_kv_dtype("bf16")[1] is torch.bfloat16
    assert kv_pool.resolve_kv_dtype(torch.float32)[:3] == ("fp32",
                                                           torch.float32,
                                                           False)
    assert kv_pool.resolve_kv_dtype("int8") == ("int8", torch.int8, True,
                                                127.0)
    with pytest.raises(ValueError):
        kv_pool.resolve_kv_dtype("int4")


def test_host_streams_equal():
    """Corpus, workload traces and latency summaries are numpy-only
    copies: bitwise-equal streams."""
    tb = SyntheticCorpus(512, seed=3).batch(2, 40, split="calib")
    jb = JaxCorpus(512, seed=3).batch(2, 40, split="calib")
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    wl = dict(seed=1, max_batch=8, short_len=(32, 128), long_len=(128, 512))
    assert workload.generate(workload.WorkloadConfig(**wl)) == [
        workload.Request(**vars(r))
        for r in jwl.generate(jwl.WorkloadConfig(**wl))]
    xs = list(np.random.default_rng(0).random(37))
    assert latency.summarize(xs) == jlat.summarize(xs)


def test_mask_helpers():
    cfg = get_smoke_config("llama2-7b").replace(n_layers=3)
    m = masks.remove_block(masks.full_mask(3), 4)
    g = masks.mask_to_gates(m)
    assert g["mixer"].tolist() == [1, 1, 1] and g["ffn"].tolist() == [1, 0, 1]
    assert masks.active_blocks(m).tolist() == [0, 1, 2, 3, 5]
    m = masks.remove_block(masks.remove_block(m, 1), 5)
    assert masks.keep_rows(cfg, m).tolist() == [0, 2]
    assert masks.bucket_key(cfg, m) == (("attn", "dense"), ("attn", None))


# ------------------------------------------------------------ GSI + decide
@pytest.fixture(scope="module")
def served():
    """4-layer smoke model in both frameworks (bridged weights), its
    calibration batch, memory model and the same random Q-network."""
    L = 4
    jcfg = jax_smoke("llama2-7b").replace(n_layers=L)
    jm = jreg.build(jcfg)
    jp = jm.init(jax.random.key(0))
    calib = JaxCorpus(jcfg.vocab_size, seed=7).batch(2, 32, split="calib")
    jbatch = {k: jnp.asarray(v) for k, v in calib.items()}
    tm = registry.build(get_smoke_config("llama2-7b").replace(n_layers=L))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in calib.items()}
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    tq = bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))
    return (jm, jp, jbatch, jq), (tm, tp, tbatch, tq)


@pytest.mark.parametrize("removed", [(), (1,), (0, 6)],
                         ids=["full", "one", "two"])
def test_gsi_candidate_scores(served, removed):
    (jm, jp, jb, _), (tm, tp, tb, _) = served
    mask = np.ones(2 * tm.cfg.n_layers, np.float32)
    mask[list(removed)] = 0.0
    want = np.asarray(jgsi.make_candidate_scorer(jm, jb, chunk=3)(
        jp, jnp.asarray(mask)))
    got = gsi.make_candidate_scorer(tm, tb, chunk=3)(tp, mask)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-4, rtol=0)
    ppl = gsi.make_ppl_fn(tm, tb)(tp, mask)
    assert abs(ppl - float(jgsi.make_ppl_fn(jm, jb)(jp, jnp.asarray(mask)))) \
        <= 1e-4


def test_decide_masks_equal_over_grid(served):
    (jm, jp, jb, jq), (tm, tp, tb, tq) = served
    jmm = jmem.build_memory_model(jm.cfg)
    tmm = memory.build_memory_model(tm.cfg)
    jc = jctl.RAPController(jm, jp, jb, jmm, jq)
    tc = controller.RAPController(tm, tp, tb, tmm, tq)
    pruned = 0
    for bs in (1, 4):
        for sql in (64, 512):
            for frac in (1.0, 0.9, 0.75):
                budget = frac * tmm.dense_peak(bs, sql)
                want = jc.decide(bs, sql, budget)
                got = tc.decide(bs, sql, budget)
                np.testing.assert_array_equal(got.mask, want.mask)
                assert (got.steps, got.fits) == (want.steps, want.fits)
                assert got.peak_bytes == want.peak_bytes
                pruned += int(got.mask.sum() < got.mask.size)
    assert pruned >= 4
    # the memo serves a repeated shape without a rollout
    assert tc.decide(1, 64, 0.9 * tmm.dense_peak(1, 64)).cached


def test_q_apply_matches_jax(served):
    (_, _, _, jq), (_, _, _, tq) = served
    s = np.random.default_rng(0).standard_normal((3, 12)).astype(np.float32)
    np.testing.assert_allclose(dqn.q_apply(tq, torch.from_numpy(s)).numpy(),
                               np.asarray(jdqn.q_apply(jq, jnp.asarray(s))),
                               atol=1e-6, rtol=0)
