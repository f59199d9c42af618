"""The port's quantized KV pages and chunked prefill against the JAX package,
on the CPU.

Seeded numpy inputs go through both frameworks:

* ``page_quant`` / ``page_dequant`` (int8 and fp8, with and without a scale
  floor) and the code-space decode append are held **bitwise** — codes are
  compared as raw bytes. For the append and the chunk pass the projections
  are replaced in both packages by the same fixed q/k/v (and RoPE is off),
  so the quantizers see identical inputs: projected K/V differ across
  frameworks by about one ulp, which can flip a code at a .5 boundary.
* The fused-dequant plain version against the JAX Pallas kernel in
  interpret mode (both int8 and fp8 run there), tolerance 1e-5.
* ``paged_chunk_attention`` (model dtype and int8): outputs within 1e-5,
  pages and scales equal outside the scratch page (JAX writes the settled
  pages' unchanged write-back there; the port skips it).
* The canonical engine trace of ``tests/test_torch_engine.py`` with an
  int8 pool and with chunked prefill (8 and 64 tokens, f32 and int8):
  masks, tokens, pool peak and page count equal to the JAX engine's.
* The launcher on the CPU with ``--kv-dtype auto`` and with ``--kv-dtype
  int8 --max-prefill-tokens 8``, and the port's own contracts from
  ``tests/test_executors.py``: int8 keeps the model-width first token,
  ``max_new=1`` is exact, the decode horizon is unobservable under int8,
  and chunked prefill gives the monolithic prefill's streams.

On the card, monolithic prefill runs the flash kernel while chunk attention
is a plain gather, so there chunked ≡ monolithic holds to tolerance and
equal greedy tokens, not bitwise (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jatt
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import controller
from repro_torch.core.policy import DensePolicy, RLPolicy
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pdec
from repro_torch.models import attention as tatt
from repro_torch.runtime import (EngineConfig, EngineRequest, KVPool,
                                 PagedExecutor, RAPEngine)
from test_torch_cuda import PAGED_CASES, _paged_inputs
from test_torch_engine import _engine_kw, _trace, served  # noqa: F401

torch.set_num_threads(1)

DTYPES = {"int8": (jnp.int8, torch.int8),
          "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bytes(x):
    """Raw bytes of a JAX array or torch tensor (codes compared bitwise)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.uint8) if x.element_size() == 1 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _pages(seed, shape, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= scale
    x[0, ..., 0, :] = 0.0                 # an all-zero (page, head): 1e-8 floor
    return x


# ------------------------------------------------------------ page quant
@pytest.mark.parametrize("floor", [False, True], ids=["plain", "floor"])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_page_quant_and_dequant_bitwise(name, floor):
    jdt, tdt = DTYPES[name]
    x = _pages(1, (3, 8, 2, 16))
    fl = (np.random.default_rng(2).uniform(0, 0.05, (3, 2)).astype(np.float32)
          if floor else None)
    jq, js = jatt.page_quant(jnp.asarray(x), jdt,
                             None if fl is None else jnp.asarray(fl))
    tq, ts = tatt.page_quant(torch.from_numpy(x), tdt,
                             None if fl is None else torch.from_numpy(fl))
    assert tq.dtype == tdt and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if fl is None:
        assert ts.min() == torch.tensor(1e-8)    # the all-zero page's floor
    np.testing.assert_array_equal(tatt.page_dequant(tq, ts).numpy(),
                                  np.asarray(jatt.page_dequant(jq, js)))


# -------------------------------------------------- code-space append
def _fix_projections(monkeypatch, q, k, v):
    """Both packages' layers see the same q/k/v whatever x is."""
    monkeypatch.setattr(jatt, "_project_qkv", lambda p, c, x: tuple(
        jnp.asarray(a) for a in (q, k, v)))
    monkeypatch.setattr(tatt, "_project_qkv", lambda p, c, x: tuple(
        torch.from_numpy(a.copy()) for a in (q, k, v)))


def _cfgs(**kw):
    from repro.configs import get_smoke_config as jax_smoke
    return (jax_smoke("llama2-7b").replace(use_rope=False, **kw),
            get_smoke_config("llama2-7b").replace(use_rope=False, **kw))


def _quant_pool(name, n_pages, pt, K, D, seed):
    jdt, tdt = DTYPES[name]
    kq, ks = jatt.page_quant(jnp.asarray(_pages(seed, (n_pages, pt, K, D))),
                             jdt)
    vq, vs = jatt.page_quant(
        jnp.asarray(_pages(seed + 1, (n_pages, pt, K, D))), jdt)
    jkv = {"k": kq, "v": vq, "ks": ks, "vs": vs}
    tkv = {"k": torch.from_numpy(_bytes(kq).copy()).view(tdt),
           "v": torch.from_numpy(_bytes(vq).copy()).view(tdt),
           "ks": torch.from_numpy(np.asarray(ks).copy()),
           "vs": torch.from_numpy(np.asarray(vs).copy())}
    return jkv, tkv


def _assert_pools_equal(tkv, jkv, skip_page=None):
    for name in tkv:
        t, j = _bytes(tkv[name]), _bytes(jkv[name])
        if skip_page is not None:
            t, j = np.delete(t, skip_page, 0), np.delete(j, skip_page, 0)
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_decode_append_bitwise(monkeypatch, name):
    """Three rows: a fresh page (slot 0), a stable scale (small token) and
    a growing scale (large token); then a second step into the same
    pages. Codes and scales equal JAX's byte for byte."""
    jcfg, tcfg = _cfgs()
    K, D, H, pt = tcfg.n_kv_heads, tcfg.dh, tcfg.n_heads, 8
    jkv, tkv = _quant_pool(name, 7, pt, K, D, seed=3)
    s0 = tkv["ks"].clone()
    table = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    pos = np.array([8, 3, 5], np.int32)            # fresh, mid-page, mid-page
    wo = np.random.default_rng(4).standard_normal(
        (H * D, tcfg.d_model)).astype(np.float32) * 0.1
    rng = np.random.default_rng(5)
    for step in range(2):
        q = rng.standard_normal((3, 1, H, D)).astype(np.float32)
        k = rng.standard_normal((3, 1, K, D)).astype(np.float32)
        v = rng.standard_normal((3, 1, K, D)).astype(np.float32)
        k[1] *= 0.01                                 # scale stays put
        k[2] *= 40.0                                 # scale grows
        v[2] *= 40.0
        _fix_projections(monkeypatch, q, k, v)
        x = np.zeros((3, 1, tcfg.d_model), np.float32)
        jy, jkv = jatt.paged_decode_attention(
            {"wo": jnp.asarray(wo)}, jcfg, jnp.asarray(x), jkv,
            jnp.asarray(table), jnp.asarray(pos + step))
        ty = tatt.paged_decode_attention(
            {"wo": torch.from_numpy(wo)}, tcfg, torch.from_numpy(x), tkv,
            torch.from_numpy(table), torch.from_numpy(pos + step))
        _assert_pools_equal(tkv, jkv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
    assert (tkv["ks"][4] > 4 * s0[4]).all()          # the scale grew
    assert torch.equal(tkv["ks"][2], s0[2])          # ... and stayed put


# ---------------------------------------------- fused-dequant plain version
@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("B,H,K,D,pt,S,cap", PAGED_CASES)
def test_quant_plain_matches_pallas(B, H, K, D, pt, S, cap, name):
    jdt, tdt = DTYPES[name]
    q, kp, vp, table, lengths = _paged_inputs(B * 1000 + S, B, H, K, D, pt, S)
    kq, ks = jatt.page_quant(jnp.asarray(kp), jdt)
    vq, vs = jatt.page_quant(jnp.asarray(vp), jdt)
    want = jops.paged_decode_attention(
        jnp.asarray(q), kq, vq, jnp.asarray(table), jnp.asarray(lengths),
        k_scales=ks, v_scales=vs, softcap=cap)
    before = ops.launch_counts()
    got = ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(_bytes(kq).copy()).view(tdt),
        torch.from_numpy(_bytes(vq).copy()).view(tdt),
        torch.from_numpy(table), torch.from_numpy(lengths),
        k_scales=torch.from_numpy(np.asarray(ks).copy()),
        v_scales=torch.from_numpy(np.asarray(vs).copy()), softcap=cap)
    assert ops.launch_counts() == before             # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_quant_dispatch_contracts():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in
                                 _paged_inputs(0, 1, 4, 4, 16, 8, 8))
    s = torch.ones(kp.shape[0], 4)
    with pytest.raises(ValueError, match="together"):
        ops.paged_decode_attention(q, kp, vp, table, lengths, k_scales=s)
    with pytest.raises(ValueError, match="CUDA"):
        pdec.paged_decode_attention_quant_cuda(
            q, kp.to(torch.int8), vp.to(torch.int8), s, s, table, lengths)
    assert "paged_decode_attention_quant" in ops.launch_counts()


def test_pool_holds_one_precision():
    """An int8 pool has int8 pages and f32 scale rows (scratch page
    included) and refuses a request that asks for another precision."""
    pool = KVPool(8 * 4096, page_bytes=4096, tokens_per_page=8)
    pool.allocate_physical(n_layers=2, n_kv_heads=2, head_dim=4,
                           dtype=torch.float32, kv_dtype="int8", device="cpu")
    assert pool.k_pages.dtype == pool.v_pages.dtype == torch.int8
    assert pool.k_scales.shape == (2, 9, 2)
    assert pool.v_scales.dtype == torch.float32
    with pytest.raises(ValueError, match="kv_dtype"):
        pool.alloc_tokens("r0", 1, 4, max_tokens=8, kv_dtype="bf16")
    pool.alloc_tokens("r1", 1, 4, max_tokens=8, kv_dtype="int8")


# ------------------------------------------------------- chunk attention
@pytest.mark.parametrize("name", ["model", "int8"])
def test_paged_chunk_attention_matches_jax(monkeypatch, name):
    """A 12-token chunk at offset 5 straddles page 0 (scale kept as a
    floor), fills page 1 and starts page 2 (scales reset); page 3 of the
    table stays settled."""
    jcfg, tcfg = _cfgs()
    K, D, H, pt = tcfg.n_kv_heads, tcfg.dh, tcfg.n_heads, 8
    B, C, start, scratch = 2, 12, 5, 8
    table = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    if name == "int8":
        jkv, tkv = _quant_pool(name, 9, pt, K, D, seed=6)
    else:
        pools = {k: _pages(7 + i, (9, pt, K, D)) for i, k in
                 enumerate(("k", "v"))}
        jkv = {k: jnp.asarray(v) for k, v in pools.items()}
        tkv = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    rng = np.random.default_rng(8)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k = rng.standard_normal((B, C, K, D)).astype(np.float32)
    v = rng.standard_normal((B, C, K, D)).astype(np.float32)
    _fix_projections(monkeypatch, q, k, v)
    wo = rng.standard_normal((H * D, tcfg.d_model)).astype(np.float32) * 0.1
    x = np.zeros((B, C, tcfg.d_model), np.float32)
    jy, jkv = jatt.paged_chunk_attention(
        {"wo": jnp.asarray(wo)}, jcfg, jnp.asarray(x), jkv,
        jnp.asarray(table), start, scratch_page=scratch)
    ty = tatt.paged_chunk_attention(
        {"wo": torch.from_numpy(wo)}, tcfg, torch.from_numpy(x), tkv,
        torch.from_numpy(table), start, scratch_page=scratch)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    _assert_pools_equal(tkv, jkv, skip_page=scratch)


def test_prefill_chunk_matches_prefill():
    """The slot-cache chunk pass: 13 tokens as 8 + 4 + 1 give prefill's
    logits and cache."""
    from repro_torch.models import decoder, registry
    cfg = get_smoke_config("llama2-7b")
    params = registry.build(cfg).init(0, "cpu")
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32))
    want, wc = decoder.prefill(params, cfg, toks, 16)
    shape = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.dh)
    cache = {"attn": {"k": torch.zeros(shape), "v": torch.zeros(shape)}}
    start = 0
    for c in (8, 4, 1):
        got = decoder.prefill_chunk(params, cfg, cache, toks[:, start:start + c],
                                    start)
        start += c
    assert cache["pos"] == 13
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(cache["attn"]["k"], wc["attn"]["k"],
                               atol=1e-5, rtol=0)


# --------------------------------------------------------- engine traces
def _run_both(s, kv, chunk, quantum=0.3, max_new=2):
    prompts, budget = _trace(s)
    kw = dict(_engine_kw(budget, quantum), max_new_tokens=max_new,
              kv_dtype=kv, max_prefill_tokens=chunk)
    from repro.core import controller as jctl, memory as jmem
    from repro.core.policy import RLPolicy as JaxRLPolicy
    jbatch = {k: jnp.asarray(v) for k, v in s["calib"].items()}
    jpol = JaxRLPolicy(jctl.RAPController(
        s["jm"], s["jp"], jbatch, jmem.build_memory_model(s["jm"].cfg),
        s["jq"]))
    jeng = JaxRAPEngine(s["jm"], s["jp"], jpol, JaxEngineConfig(**kw),
                        executor=JaxPagedExecutor(s["jm"], s["jp"],
                                                  max_active=4, kv_dtype=kv))
    jrep = jeng.run([JaxEngineRequest(rid=f"r{i}", prompt=p)
                     for i, p in enumerate(prompts)])
    calib = {k: torch.from_numpy(v) for k, v in s["calib"].items()}
    pol = RLPolicy(controller.RAPController(s["tm"], s["tp"], calib, s["mm"],
                                            s["tq"]))
    eng = RAPEngine(s["tm"], s["tp"], pol, EngineConfig(**kw),
                    executor=PagedExecutor(s["tm"], s["tp"], max_active=4,
                                           kv_dtype=kv))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                   for i, p in enumerate(prompts)])
    return jeng, jrep, eng, rep


@pytest.mark.parametrize("kv,chunk", [("int8", 0), (None, 8), (None, 64),
                                      ("int8", 8), ("int8", 64)],
                         ids=["int8", "f32-chunk8", "f32-chunk64",
                              "int8-chunk8", "int8-chunk64"])
def test_trace_matches_jax_engine(served, kv, chunk):
    jeng, jrep, eng, rep = _run_both(served, kv, chunk)
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 8
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]
    assert rep.pool["n_pages"] == jrep.pool["n_pages"]
    assert rep.pool["overcommit_events"] == 0
    assert any(r.mask.sum() < 2 * 4 for r in got.values())
    if kv == "int8":
        assert eng.pool.kv_dtype == "int8" and rep.pool["in_use_scale"] < 1.0
        assert eng.pool.k_pages.dtype == torch.int8
        assert eng.policy.kv_dtype == "int8"


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [["--kv-dtype", "auto"],
                                  ["--kv-dtype", "int8",
                                   "--max-prefill-tokens", "8"]],
                         ids=["auto", "int8-chunk8"])
def test_serve_entry_point(argv, capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                           "--max-prompt", "32", "--max-new", "4",
                           "--policy", "dense", "--executor", "paged",
                           "--mode", "masked"] + argv)
    assert all(r.status == "done" for r in rep.results)
    assert rep.generated_tokens == sum(r.tokens.size for r in rep.results)
    out = capsys.readouterr().out
    assert "tok/s" in out
    if argv[1] == "auto":
        assert "--kv-dtype auto →" in out
    else:
        assert eng.pool.kv_dtype == "int8"


# ------------------------------------------------ port-internal contracts
def _port(s, *, kv=None, chunk=0, max_new=2, horizon=8, dense=False):
    prompts, budget = _trace(s)
    if dense:
        pol = DensePolicy(s["mm"])
    else:
        calib = {k: torch.from_numpy(v) for k, v in s["calib"].items()}
        pol = RLPolicy(controller.RAPController(s["tm"], s["tp"], calib,
                                                s["mm"], s["tq"]))
    kw = dict(_engine_kw(budget, 0.05, horizon), max_new_tokens=max_new,
              kv_dtype=kv, max_prefill_tokens=chunk)
    eng = RAPEngine(s["tm"], s["tp"], pol, EngineConfig(**kw),
                    executor=PagedExecutor(s["tm"], s["tp"], max_active=4,
                                           kv_dtype=kv))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p, max_new=max_new)
                   for i, p in enumerate(prompts)])
    assert all(r.status == "done" for r in rep.results) and rep.rejected == 0
    return eng, {r.rid: r for r in rep.results}


def test_int8_keeps_first_tokens_and_buys_pages(served):
    """The prefill logits are computed at model width before the write
    quantizes, so every first token is exact; the int8 pool holds >= 1.8x
    the pages under the same budget."""
    ef, ref = _port(served, max_new=4, dense=True)
    eq, got = _port(served, kv="int8", max_new=4, dense=True)
    for rid, r in ref.items():
        assert got[rid].tokens[0, 0] == r.tokens[0, 0], rid
    assert eq.pool.n_pages >= 1.8 * ef.pool.n_pages


def test_int8_greedy_stability_is_exact(served):
    """max_new=1 never reads quantized K/V back: int8 == model width."""
    _, ref = _port(served, max_new=1)
    _, got = _port(served, kv="int8", max_new=1)
    for rid, r in ref.items():
        np.testing.assert_array_equal(got[rid].mask, r.mask)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens)


def test_int8_horizon_is_unobservable(served):
    outs = {h: _port(served, kv="int8", max_new=6, horizon=h, dense=True)[1]
            for h in (1, 4, 8)}
    for h in (4, 8):
        for rid, r in outs[1].items():
            np.testing.assert_array_equal(outs[h][rid].tokens, r.tokens)


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_chunked_prefill_matches_monolithic(served, chunk):
    _, ref = _port(served, max_new=4)
    _, got = _port(served, chunk=chunk, max_new=4)
    for rid, r in ref.items():
        np.testing.assert_array_equal(got[rid].mask, r.mask)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
