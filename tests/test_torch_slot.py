"""The port's slot-cache serving path against the JAX package, on the CPU.

Seeded numpy inputs (and weights bridged with ``bridge.params_from_numpy``)
go through both frameworks:

* the dense decode kernel's plain version against JAX's Pallas
  ``decode_attention`` in interpret mode (the four cases of
  ``tests/test_kernels.py`` plus softcap and a ring mask; f32, 2e-5), and
  its per-row ``[B, S]`` mask form against ``repro.kernels.ref`` row by row;
* ``attention.decode_attention`` for scalar and ``[B]`` positions, model
  dtype and int8 caches, and a ring buffer (``window > 0``): outputs within
  1e-5 and caches equal (int8 codes bytewise). The projections are fixed to
  the same q/k/v in both packages, so the quantizer sees identical inputs;
* ``decoder.decode_horizon`` with ``[L, B]`` gates and ``[B]`` positions
  (tokens equal, a row running past its cache dropping its writes), and
  the port's own contract that the horizon length is unobservable;
* ``model.prefill`` + ``model.decode`` with a scalar position against JAX
  with ``impl="pallas"`` (the path where JAX itself runs the kernel);
* the canonical engine trace of ``tests/test_torch_engine.py`` through
  ``LocalExecutor`` in both packages (model dtype and int8, monolithic and
  chunked): statuses, masks, tokens and pool peak equal;
* ``RAPServer.serve`` (masked, force admission, pow2 length groups) on
  four requests: tokens, masks and ``fits`` equal;
* the byte-granular pool accounting (overcommit, overflow pages) and the
  launcher's ``--executor local`` and ``--serial`` paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as jctl, memory as jmem
from repro.core.policy import RLPolicy as JaxRLPolicy
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro.models import decoder as jdec
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro.runtime import RAPServer as JaxRAPServer
from repro.runtime.kv_pool import KVPool as JaxKVPool
from repro_torch.core import controller
from repro_torch.core.policy import DensePolicy, RLPolicy
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models import decoder as tdec
from repro_torch.runtime import (EngineConfig, EngineRequest, KVPool,
                                 LocalExecutor, RAPEngine, RAPServer, steps)
from test_torch_engine import L, _engine_kw, _trace, served  # noqa: F401
from test_torch_quant import _bytes, _cfgs, _fix_projections

torch.set_num_threads(1)

# B, H, K, D, S, valid tokens (the cases of tests/test_kernels.py)
DECODE_CASES = [(2, 8, 2, 64, 256, 100), (1, 4, 4, 32, 130, 130),
                (2, 8, 1, 128, 512, 1), (1, 16, 2, 64, 96, 33)]


def _dec_inputs(seed, B, H, K, D, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32),
            rng.standard_normal((B, S, K, D)).astype(np.float32))


def _ring_mask(S, pos, window):
    """The valid slots of a ring buffer of S at position ``pos`` (not a
    prefix once the ring has wrapped)."""
    age = np.mod(pos - np.arange(S), S)
    return age < min(pos + 1, window)


# ------------------------------------------------------------- the kernel
@pytest.mark.parametrize(
    "B,H,K,D,S,nvalid,cap,ring",
    [c + (0.0, False) for c in DECODE_CASES]
    + [(2, 8, 2, 64, 96, 70, 30.0, False),        # softcap
       (2, 8, 2, 32, 80, 0, 0.0, True)],          # wrapped ring mask
    ids=["case0", "case1", "case2", "case3", "softcap", "ring"])
def test_plain_matches_pallas(B, H, K, D, S, nvalid, cap, ring):
    q, k, v = _dec_inputs(B * 1000 + S, B, H, K, D, S)
    valid = _ring_mask(S, 130, 50) if ring else np.arange(S) < nvalid
    assert not ring or not valid[0] and valid.sum() == 50
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(valid),
                                 softcap=cap, block_k=64)
    before = ops.launch_counts()
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(valid),
                               softcap=cap)
    assert ops.launch_counts() == before             # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_per_row_mask_is_the_function_row_by_row():
    B, H, K, D, S = 3, 8, 2, 32, 70
    q, k, v = _dec_inputs(5, B, H, K, D, S)
    valid = np.stack([np.arange(S) < 20, _ring_mask(S, 100, 30),
                      np.arange(S) < S])
    got = dec.decode_attention_ref(*(torch.from_numpy(a) for a in
                                     (q, k, v, valid)), softcap=30.0)
    for b in range(B):
        want = jref.decode_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), jnp.asarray(valid[b]), softcap=30.0)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)


def test_cuda_wrapper_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _dec_inputs(0, 1, 4, 4, 16, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention_cuda(*args, torch.ones(8, dtype=torch.bool))
    assert "decode_attention" in ops.launch_counts()


# ------------------------------------------------------ attention layer
def _slot_cache(name, B, S, K, D, seed):
    """A random one-layer slot cache in both packages (int8: kv_quant)."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, S, K, D)).astype(np.float32)
            for _ in range(2))
    if name == "model":
        return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                {"k": torch.from_numpy(k.copy()),
                 "v": torch.from_numpy(v.copy())})
    jkv = {}
    for key, x in (("k", k), ("v", v)):
        codes, sc = jatt.kv_quant(jnp.asarray(x))
        jkv[key], jkv[key + "s"] = codes, sc
    tkv = {key: torch.from_numpy(np.asarray(a).copy())
           for key, a in jkv.items()}
    return jkv, tkv


def test_kv_quant_and_load_bitwise():
    x = np.random.default_rng(1).standard_normal((3, 5, 2, 16)).astype(
        np.float32) * 4
    x[0, 0, 1] = 0.0                                 # the 1e-8 addend
    jq, js = jatt.kv_quant(jnp.asarray(x))
    tq, ts = tatt.kv_quant(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jk, _ = jatt.load_kv({"k": jq, "v": jq, "ks": js, "vs": js}, jnp.float32)
    tk, _ = tatt.load_kv({"k": tq, "v": tq, "ks": ts, "vs": ts},
                         torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("window", [0, 6], ids=["full", "ring"])
@pytest.mark.parametrize("pos", [5, 18, [3, 11, 15], [4, 16, 23]],
                         ids=["scalar", "scalar-past", "rows", "rows-past"])
@pytest.mark.parametrize("name", ["model", "int8"])
def test_decode_attention_matches_jax(monkeypatch, name, pos, window):
    """Two steps at ``pos`` then ``pos + 1``: scalar writes clamp into the
    cache, a row past the cache drops its write, a ring buffer wraps."""
    jcfg, tcfg = _cfgs()
    K, D, H = tcfg.n_kv_heads, tcfg.dh, tcfg.n_heads
    B, S = 3, 16
    jkv, tkv = _slot_cache(name, B, S, K, D, seed=2)
    rng = np.random.default_rng(3)
    wo = rng.standard_normal((H * D, tcfg.d_model)).astype(np.float32) * 0.1
    x = np.zeros((B, 1, tcfg.d_model), np.float32)
    for step in range(2):
        q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
        k = rng.standard_normal((B, 1, K, D)).astype(np.float32)
        v = rng.standard_normal((B, 1, K, D)).astype(np.float32)
        _fix_projections(monkeypatch, q, k, v)
        if isinstance(pos, int):
            jp, tp = pos + step, pos + step
        else:
            p = np.asarray(pos, np.int32) + step
            jp, tp = jnp.asarray(p), torch.from_numpy(p)
        jy, jkv = jatt.decode_attention({"wo": jnp.asarray(wo)}, jcfg,
                                        jnp.asarray(x), jkv, jp,
                                        window=window)
        ty = tatt.decode_attention({"wo": torch.from_numpy(wo)}, tcfg,
                                   torch.from_numpy(x), tkv, tp,
                                   window=window)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=0)
        for key in tkv:
            np.testing.assert_array_equal(_bytes(tkv[key]),
                                          _bytes(jkv[key]), err_msg=key)


# ------------------------------------------------------------ the decoder
def _bridged(s):
    return s["jm"], s["jp"], s["tm"], s["tp"]


def _prefilled(s, kv=None):
    """Both packages' caches after a 10-token prefill of 3 rows into a
    14-token slot cache, with per-row positions and [L, B] gates."""
    jm, jp, tm, tp = _bridged(s)
    toks = s["calib"]["tokens"][:1, :10].repeat(3, 0)
    toks[1, 3] = 7
    toks[2, 5] = 11
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 14,
                        kv_dtype=None if kv is None else jnp.int8)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 14,
                        kv_dtype=None if kv is None else torch.int8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    pos = np.array([10, 7, 4], np.int32)
    gates = np.ones((2, L, 3), np.float32)
    gates[0, 1, 0] = gates[1, 2, 1] = gates[0, 3, 2] = 0.0
    seed = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos)
    return ((jc, {"mixer": jnp.asarray(gates[0]),
                  "ffn": jnp.asarray(gates[1])}),
            (tc, {"mixer": torch.from_numpy(gates[0]),
                  "ffn": torch.from_numpy(gates[1])}), seed)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["model", "int8"])
def test_decode_horizon_matches_jax(served, kv):
    """Row 0 reaches its cache end at step 4 and keeps decoding with its
    writes dropped, as JAX's scatter drops them."""
    jm, jp, tm, tp = _bridged(served)
    (jc, jg), (tc, tg), seed = _prefilled(served, kv)
    jt, jc = jdec.decode_horizon(jp, jm.cfg, jc, jnp.asarray(seed), 6,
                                 gates=jg)
    tt, tc = tdec.decode_horizon(tp, tm.cfg, tc, torch.from_numpy(seed), 6,
                                 gates=tg)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if kv is None:
        np.testing.assert_allclose(tc["attn"]["k"].numpy(),
                                   np.asarray(jc["attn"]["k"]), atol=1e-4)


def test_decode_horizon_length_is_unobservable(served):
    jm, jp, tm, tp = _bridged(served)
    outs = {}
    for h in (1, 4, 8):
        _, (tc, tg), seed = _prefilled(served)
        tok, toks = torch.from_numpy(seed), []
        for _ in range(8 // h):
            t, tc = tdec.decode_horizon(tp, tm.cfg, tc, tok, h, gates=tg)
            toks.append(t)
            tok = t[:, -1:]
        outs[h] = (torch.cat(toks, 1), tc)
    for h in (4, 8):
        assert torch.equal(outs[h][0], outs[1][0])
        for key in ("k", "v"):
            assert torch.equal(outs[h][1]["attn"][key],
                               outs[1][1]["attn"][key])


def test_one_shot_decode_matches_jax_pallas(served):
    """Scalar position, the whole batch in step: JAX's ``impl="pallas"``
    runs its Pallas decode kernel (interpret mode); the port's steps run
    ``ops.decode_attention`` with a ``[S]`` mask."""
    jm, jp, tm, tp = _bridged(served)
    toks = served["calib"]["tokens"][:2, :12]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 20,
                        impl="pallas")
    prefill = steps.make_prefill_step(tm, 20)
    decode = steps.make_decode_step(tm)
    tl, tc = prefill(tp, {"tokens": torch.from_numpy(toks)})
    for _ in range(4):
        np.testing.assert_allclose(tl.reshape(2, -1).numpy(),
                                   np.asarray(jl).reshape(2, -1), atol=1e-4)
        nxt = np.array(jnp.argmax(jl.reshape(2, -1), -1), np.int32)
        np.testing.assert_array_equal(
            torch.argmax(tl.reshape(2, -1), -1).numpy(), nxt)
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt)[:, None], impl="pallas")
        tl, tc = decode(tp, tc, torch.from_numpy(nxt)[:, None])
    assert tc["pos"] == 16 and int(jc["pos"]) == 16


# ------------------------------------------------------------- the engine
def _jax_policy(s):
    jbatch = {k: jnp.asarray(v) for k, v in s["calib"].items()}
    return JaxRLPolicy(jctl.RAPController(
        s["jm"], s["jp"], jbatch, jmem.build_memory_model(s["jm"].cfg),
        s["jq"]))


def _port_policy(s):
    calib = {k: torch.from_numpy(v) for k, v in s["calib"].items()}
    return RLPolicy(controller.RAPController(s["tm"], s["tp"], calib,
                                             s["mm"], s["tq"]))


@pytest.mark.parametrize("kv,chunk", [(None, 0), ("int8", 0), (None, 8),
                                      ("int8", 8)],
                         ids=["f32", "int8", "f32-chunk8", "int8-chunk8"])
def test_trace_matches_jax_local_engine(served, kv, chunk):
    s = served
    prompts, budget = _trace(s)
    kw = dict(_engine_kw(budget, 0.3), kv_dtype=kv, max_prefill_tokens=chunk)
    jeng = JaxRAPEngine(s["jm"], s["jp"], _jax_policy(s),
                        JaxEngineConfig(**kw),
                        executor=JaxLocalExecutor(s["jm"], s["jp"],
                                                  max_active=4, kv_dtype=kv))
    jrep = jeng.run([JaxEngineRequest(rid=f"r{i}", prompt=p)
                     for i, p in enumerate(prompts)])
    eng = RAPEngine(s["tm"], s["tp"], _port_policy(s), EngineConfig(**kw),
                    executor=LocalExecutor(s["tm"], s["tp"], max_active=4,
                                           kv_dtype=kv))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                   for i, p in enumerate(prompts)])
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
    want_dtype = torch.int8 if kv == "int8" else torch.float32
    assert all(g.cache["attn"]["k"].dtype == want_dtype for g in
               eng.executor.groups())


def test_default_executor_is_local(served):
    s = served
    eng = RAPEngine(s["tm"], s["tp"], DensePolicy(s["mm"]),
                    EngineConfig(**_engine_kw(_trace(s)[1], 0.05)))
    assert isinstance(eng.executor, LocalExecutor)
    with pytest.raises(ValueError, match="strict"):
        from repro_torch.runtime import PagedExecutor
        RAPEngine(s["tm"], s["tp"], DensePolicy(s["mm"]),
                  EngineConfig(admission="force"),
                  executor=PagedExecutor(s["tm"], s["tp"]))


def test_server_matches_jax(served):
    """One-shot serves under force admission: an oversize batch grows the
    slots, a long prompt mints a longer pow2 group, a short one a shorter
    group, and a tight budget overcommits instead of queueing."""
    s = served
    toks = s["calib"]["tokens"]
    reqs = [(toks[:1, :16], 0.9), (toks[:2, :24], 0.5), (toks[:1, :40], 1.2),
            (toks[:1, :8], 1.0)]
    jsrv = JaxRAPServer(s["jm"], s["jp"], _jax_policy(s), mode="masked",
                        max_new_tokens=4)
    srv = RAPServer(s["tm"], s["tp"], _port_policy(s), mode="masked",
                    max_new_tokens=4)
    mm = s["mm"]
    for prompt, frac in reqs:
        budget = frac * mm.dense_peak(prompt.shape[0], prompt.shape[1] + 4)
        want = jsrv.serve(prompt, budget)
        got = srv.serve(prompt, budget)
        assert got.tokens.shape == (prompt.shape[0], 4)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        np.testing.assert_array_equal(got.mask, want.mask)
        assert got.fits == want.fits and got.bucket == want.bucket == ()
    eng = srv._engine
    assert eng.cfg.max_active == 2 and eng.cfg.max_len == 64
    assert sorted(g.cache_len for g in eng.executor.groups()) == [16, 32, 64]
    assert srv.stats() == {"structural_buckets": 0, "masked_groups": 3}


# ----------------------------------------------------------------- the pool
def test_byte_pool_matches_jax():
    """Byte allocations, an overcommit past capacity and the frees: the
    same pages, ledger and stats as JAX's pool; overflow pages evaporate."""
    jp, tp = (cls(10 * 100, page_bytes=100) for cls in (JaxKVPool, KVPool))
    for pool in (jp, tp):
        pool.alloc("a", 350)
        assert not pool.can_alloc(800) and pool.fits_capacity(800)
        pool.alloc("b", 800, allow_overcommit=True)
        with pytest.raises(Exception, match="needs"):
            pool.alloc("c", 50)
    assert tp.stats() == {k: v for k, v in jp.stats().items()
                          if k in tp.stats()}
    assert tp.stats()["overcommit_events"] == 1
    for rid in ("a", "b"):
        assert tp.free(rid) == jp.free(rid)
    assert tp.free_pages == jp.free_pages == 10
    assert tp.stats()["reserved_bytes"] == 0 and tp.available_bytes == 1000
    with pytest.raises(ValueError, match="unknown"):
        tp.free("a")


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("argv", [["--executor", "local"],
                                  ["--executor", "local", "--kv-dtype", "int8",
                                   "--max-prefill-tokens", "8"]],
                         ids=["local", "local-int8-chunk8"])
def test_serve_entry_point_local(argv, capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                           "--max-prompt", "32", "--max-new", "4",
                           "--policy", "dense", "--mode", "masked"] + argv)
    assert isinstance(eng.executor, LocalExecutor)
    assert all(r.status == "done" for r in rep.results)
    assert all(r.tokens.shape[1] == 4 for r in rep.results)
    out = capsys.readouterr().out
    assert "tok/s" in out and "accounting" in out


def test_serve_entry_point_serial(capsys):
    from repro_torch.launch import serve
    server, results = serve.main(["--smoke", "--device", "cpu", "--requests",
                                  "2", "--max-prompt", "32", "--max-new", "4",
                                  "--serial", "--mode", "masked"])
    assert isinstance(server, RAPServer) and len(results) == 2
    for r in results:
        assert r.tokens.shape[1] == 4
        assert ((r.tokens >= 0) & (r.tokens < server.cfg.vocab_padded)).all()
    assert "server stats" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--serial", "--executor",
                    "paged"])
