"""The port's recurrent architectures against the JAX package, on the CPU.

mamba2-370m (uniform SSD, no FFN) and recurrentgemma-9b (Griffin:
rglru, rglru, local attention, repeating) at their SMOKE sizes, f32, with
JAX-initialised weights carried over by ``repro_torch.bridge`` and seeded
numpy inputs:

* the scan kernels' plain versions against JAX's Pallas kernels in
  interpret mode and their references (``ssd`` at 3e-4, the JAX suite's
  tolerance for two f32 chunked sums taken in another order; ``rglru`` at
  2e-5), and against JAX's model scans ``_ssd_scan`` / ``blocked_scan``;
* both mixers and both decode steps (1e-5);
* ``decoder.forward`` against ``model.logits`` with ``impl="xla"`` and
  ``impl="pallas"`` for mamba2, recurrentgemma at 3 layers (JAX unrolls)
  and at 6 (JAX's pattern-group scan), with ``[L, B]`` gates against JAX
  row by row (1e-5);
* prefill logits and every cache leaf for prompts shorter and longer than
  the SMOKE window (16) and chunk (8), then decode horizons with ``[B]``
  positions and ``[L, B]`` gates (tokens equal); the horizon length is
  unobservable in the port;
* prompts of 1 and 2 tokens: the port's prefill then decode equals its own
  full forward (JAX's reference differs there: ROADMAP queue 3);
* the canonical engine trace of ``tests/test_torch_engine.py`` through
  ``LocalExecutor`` (masks, tokens, pool peak, statuses equal), one with
  ``max_prefill_tokens`` > 0, which both packages prefill monolithically;
* the memory model, the paths that refuse these layouts (paged
  executor, chunked prefill), quantized slot caches that serve them
  (``tests/test_torch_recurrent_quant.py`` holds those to JAX), and the
  launcher.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decoder as jdec
from repro.models import registry as jreg
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import controller, masks, memory
from repro_torch.core.policy import RLPolicy
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels import ssd as kssd
from repro_torch.models import decoder, registry
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from repro_torch.runtime import (EngineConfig, EngineRequest, LocalExecutor,
                                 PagedExecutor, RAPEngine)

torch.set_num_threads(1)

SSD_TOL, RGLRU_TOL, TOL = 3e-4, 2e-5, 1e-5
# id → (arch, SMOKE overrides)
MODELS = {"mamba2": ("mamba2-370m", {}),
          "griffin3L": ("recurrentgemma-9b", {}),
          "griffin6L": ("recurrentgemma-9b", {"n_layers": 6})}
ARCHS = pytest.mark.parametrize("name", list(MODELS))


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(jax model, jax params, port model, port params) for ``name``."""
    arch, kw = MODELS[name]
    jm = jreg.build(jax_smoke(arch).replace(**kw))
    jp = jm.init(jax.random.key(0))
    tm = registry.build(get_smoke_config(arch).replace(**kw))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _rnd(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(got, want, tol=TOL, msg=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


# ------------------------------------------------------------ the kernels
def _ssd_inputs(seed, B, T, H, P, N):
    """The recipe of tests/test_kernels.py::test_ssd_kernel."""
    return (_rnd(seed, B, T, H, P, scale=0.5),
            -np.abs(_rnd(seed + 1, B, T, H, scale=0.1)),
            _rnd(seed + 2, B, T, N, scale=0.3),
            _rnd(seed + 3, B, T, N, scale=0.3))


@pytest.mark.parametrize("B,T,H,P,N,Q", [
    (1, 64, 2, 16, 16, 16), (2, 100, 4, 32, 64, 32), (1, 48, 3, 16, 32, 16)])
def test_ssd_plain_matches_pallas(B, T, H, P, N, Q):
    """Ragged T (100 = 3 chunks of 32 + 4) included."""
    args = _ssd_inputs(B * 100 + T, B, T, H, P, N)
    jy, jfin = jops.ssd(*map(jnp.asarray, args), chunk=Q)
    ry, rfin = jref.ssd_ref(*map(jnp.asarray, args))
    before = ops.launch_counts()
    y, fin = ops.ssd(*map(torch.from_numpy, args), Q)
    assert ops.launch_counts() == before             # CPU: plain version
    for got, want in ((y, jy), (fin, jfin), (y, ry), (fin, rfin)):
        _close(got, want, SSD_TOL)


@pytest.mark.parametrize("T,Q", [(96, 32), (20, 32)], ids=["3chunks",
                                                          "T<chunk"])
def test_ssd_plain_matches_model_scan(T, Q):
    args = _ssd_inputs(7, 2, T, 4, 16, 32)
    jy, jfin = jssm._ssd_scan(*map(jnp.asarray, args), Q)
    y, fin = kssd.ssd_ref(*map(torch.from_numpy, args), Q)
    _close(y, jy, SSD_TOL)
    _close(fin, jfin, SSD_TOL)


def _rglru_inputs(seed, B, T, W):
    return (np.exp(-np.abs(_rnd(seed, B, T, W, scale=0.5))),
            _rnd(seed + 1, B, T, W, scale=0.5))


@pytest.mark.parametrize("B,T,W,bt", [(2, 64, 128, 16), (1, 100, 64, 32),
                                      (3, 33, 96, 8)])
def test_rglru_plain_matches_pallas(B, T, W, bt):
    """T = 100 and 33 are no multiple of the Pallas time block."""
    a, b = _rglru_inputs(B * 100 + T, B, T, W)
    want = jops.rglru(jnp.asarray(a), jnp.asarray(b), block_t=bt, block_w=64)
    before = ops.launch_counts()
    got = ops.rglru(torch.from_numpy(a), torch.from_numpy(b))
    assert ops.launch_counts() == before
    _close(got, want, RGLRU_TOL)
    _close(got, jref.rglru_ref(jnp.asarray(a), jnp.asarray(b)), RGLRU_TOL)


def test_rglru_plain_matches_blocked_scan():
    """Two 256-step blocks joined by JAX's carry."""
    a, b = _rglru_inputs(3, 1, 512, 16)
    want = jrglru.blocked_scan(jnp.asarray(a), jnp.asarray(b))
    _close(krglru.rglru_ref(torch.from_numpy(a), torch.from_numpy(b)), want,
           RGLRU_TOL)


def test_scan_wrappers_refuse_what_the_kernels_do_not_take():
    args = [torch.from_numpy(x) for x in _ssd_inputs(0, 1, 8, 2, 4, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        kssd.ssd_cuda(*args, 8)
    with pytest.raises(ValueError, match="CUDA"):
        krglru.rglru_cuda(torch.ones(1, 4, 8), torch.ones(1, 4, 8))
    assert {"ssd", "rglru"} <= set(ops.launch_counts())


# ------------------------------------------------------------- the mixers
def _layer0(name, kind):
    jm, jp, tm, tp = _pair(name)
    return (jm.cfg, jdec.tree_slice(jp["stacks"][kind], 0),
            tm.cfg, decoder.tree_slice(tp["stacks"][kind], 0))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssd_mixer_matches_jax(impl):
    jcfg, jpm, tcfg, tpm = _layer0("mamba2", "ssd")
    x = _rnd(1, 2, 20, tcfg.d_model)
    want = jax.jit(lambda p, x: jssm.ssd_mixer(p, jcfg, x, impl=impl))(
        jpm, jnp.asarray(x))
    out, state, conv = tssm.ssd_sequence(tpm, tcfg, torch.from_numpy(x))
    _close(out, want)
    _, jstate, jconv = jax.jit(lambda p, x: jdec._ssd_prefill(p, jcfg, x))(
        jpm, jnp.asarray(x))
    _close(state, jstate)
    _close(conv, jconv)


def test_ssd_decode_step_matches_jax():
    jcfg, jpm, tcfg, tpm = _layer0("mamba2", "ssd")
    B = 3
    x = _rnd(2, B, 1, tcfg.d_model)
    st = _rnd(3, B, tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state)
    cb = _rnd(4, B, tcfg.ssm_conv_width - 1,
              tcfg.ssm_inner + 2 * tcfg.ssm_state)
    want = jax.jit(lambda p, *a: jssm.ssd_decode_step(p, jcfg, *a))(
        jpm, *map(jnp.asarray, (x, st, cb)))
    got = tssm.ssd_decode_step(tpm, tcfg, *map(torch.from_numpy, (x, st, cb)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rglru_mixer_matches_jax(impl):
    jcfg, jpm, tcfg, tpm = _layer0("griffin3L", "rglru")
    x = _rnd(5, 2, 20, tcfg.d_model)
    want = jax.jit(lambda p, x: jrglru.rglru_mixer(p, jcfg, x, impl=impl))(
        jpm, jnp.asarray(x))
    out, h, conv = trglru.rglru_sequence(tpm, tcfg, torch.from_numpy(x))
    _close(out, want)
    _, jh, jconv = jax.jit(lambda p, x: jdec._rglru_prefill(p, jcfg, x))(
        jpm, jnp.asarray(x))
    _close(h, jh)
    _close(conv, jconv)


def test_rglru_decode_step_matches_jax():
    jcfg, jpm, tcfg, tpm = _layer0("griffin3L", "rglru")
    B, W = 3, tcfg.rnn_width
    x = _rnd(6, B, 1, tcfg.d_model)
    h = _rnd(7, B, W)
    cb = _rnd(8, B, 3, W)
    want = jax.jit(lambda p, *a: jrglru.rglru_decode_step(p, jcfg, *a))(
        jpm, *map(jnp.asarray, (x, h, cb)))
    got = trglru.rglru_decode_step(tpm, tcfg, *map(torch.from_numpy,
                                                   (x, h, cb)))
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------ the decoder
@ARCHS
def test_init_params_has_the_jax_layout(name):
    """The port's own initialiser builds JAX's pytree: same leaves, shapes
    and dtypes, so either side's weights carry to the other."""
    _, jp, tm, _ = _pair(name)
    tp = tm.init(1, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(
        jax.tree.map(np.asarray, tp)))
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).replace("torch.", "") == str(leaf.dtype), path


@ARCHS
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_matches_jax(name, impl):
    jm, jp, tm, tp = _pair(name)
    toks = _tokens(tm.cfg, 2, 24)
    want = jm.logits(jp, {"tokens": jnp.asarray(toks)}, impl=impl)
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 24, tm.cfg.vocab_padded)
    _close(got, want)


@ARCHS
def test_per_row_gates_match_jax_rows(name):
    """[L, B] gates: each row equals JAX's forward under that row's [L]
    gates; a row with every gate on equals the ungated forward exactly,
    and a 0 gate changes only its own row."""
    jm, jp, tm, tp = _pair(name)
    L = tm.cfg.n_layers
    toks = _tokens(tm.cfg, 3, 12, seed=2)
    g = np.ones((2, L, 3), np.float32)
    g[0, 1, 1] = 0.0
    g[0, L - 1, 2] = g[1, 0, 2] = 0.0
    got = decoder.forward(tp, tm.cfg, torch.from_numpy(toks),
                          gates={"mixer": torch.from_numpy(g[0]),
                                 "ffn": torch.from_numpy(g[1])})[0]
    dense = decoder.forward(tp, tm.cfg, torch.from_numpy(toks))[0]
    assert torch.equal(got[0], dense[0])
    for b in (1, 2):
        assert (got[b] - dense[b]).abs().max() > 1e-3
        want = jm.logits(jp, {"tokens": jnp.asarray(toks[b:b + 1])},
                         gates={"mixer": jnp.asarray(g[0, :, b]),
                                "ffn": jnp.asarray(g[1, :, b])})
        _close(got[b:b + 1], want)


def _cache_leaves(cache):
    return {(kind, key): leaf for kind, leaves in cache.items()
            if kind != "pos" for key, leaf in leaves.items()}


@pytest.mark.parametrize("name", ["mamba2", "griffin3L"])
@pytest.mark.parametrize("S", [13, 30])
def test_prefill_matches_jax(name, S):
    """S = 13 lies between the SMOKE chunk (8) and window (16), 30 past
    both (a rolled ring; four chunks with a ragged last one). The SSD and
    RG-LRU stacks hold two layers each; a second local-attention layer is
    held by ``test_decode_horizon_matches_jax[griffin6L]``."""
    jm, jp, tm, tp = _pair(name)
    toks = _tokens(tm.cfg, 2, S, seed=S)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 40)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 40)
    _close(tl, jl)
    assert tc["pos"] == int(jc["pos"]) == S
    got, want = _cache_leaves(tc), _cache_leaves(jc)
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert leaf.dtype == torch.float32, key
        _close(leaf, want[key], msg=str(key))


def _gates(L, torch_or_jnp):
    """[L, 2] gates: row 0 all on, row 1 with its last mixer and its first
    FFN off."""
    g = np.ones((2, L, 2), np.float32)
    g[0, L - 1, 1] = g[1, 0, 1] = 0.0
    to = torch.from_numpy if torch_or_jnp is torch else jnp.asarray
    return {"mixer": to(g[0]), "ffn": to(g[1])}


def _prefilled(name, pkg):
    """``pkg``'s (torch or jax) cache after a 13-token prefill of 2 rows
    into a 40-token slot cache, with [B] positions, and the seed tokens."""
    jm, jp, tm, tp = _pair(name)
    toks = _tokens(tm.cfg, 2, 13, seed=4)
    if pkg is torch:
        logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                                   40)
        cache["pos"] = torch.full((2,), 13, dtype=torch.int32)
        return cache, torch.argmax(logits, -1).to(torch.int32)[:, None]
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 40)
    cache["pos"] = jnp.full((2,), 13, jnp.int32)
    return cache, jnp.argmax(logits, -1).astype(jnp.int32)[:, None]


@ARCHS
def test_decode_horizon_matches_jax(name):
    """8 steps from position 13 with [B] positions and [L, B] gates: the
    window-16 ring wraps."""
    jm, jp, tm, tp = _pair(name)
    L = tm.cfg.n_layers
    jc, jseed = _prefilled(name, jnp)
    tc, seed = _prefilled(name, torch)
    np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed))
    jt, jc = jdec.decode_horizon(jp, jm.cfg, jc, jseed, 8,
                                 gates=_gates(L, jnp))
    tt, tc = decoder.decode_horizon(tp, tm.cfg, tc, seed, 8,
                                    gates=_gates(L, torch))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    want = _cache_leaves(jc)
    for key, leaf in _cache_leaves(tc).items():
        _close(leaf, want[key], 1e-4, msg=str(key))


@ARCHS
def test_decode_horizon_length_is_unobservable(name):
    _, _, tm, tp = _pair(name)
    outs = {}
    for h in (1, 4, 8):
        tc, tok = _prefilled(name, torch)
        toks = []
        for _ in range(8 // h):
            t, tc = decoder.decode_horizon(tp, tm.cfg, tc, tok, h,
                                           gates=_gates(tm.cfg.n_layers,
                                                        torch))
            toks.append(t)
            tok = t[:, -1:]
        outs[h] = (torch.cat(toks, 1), _cache_leaves(tc))
    for h in (4, 8):
        assert torch.equal(outs[h][0], outs[1][0])
        for key, leaf in outs[h][1].items():
            assert torch.equal(leaf, outs[1][1][key]), key


# ---------------------------------------------------------- short prompts
@ARCHS
@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_prefill_then_decode_is_forward(name, S):
    """A prompt shorter than the conv's K-1 = 3 taps: the conv buffer is
    the conv's own zero left-padding, so prefill + teacher-forced decode
    steps give the full forward's logits at every position."""
    _, _, tm, tp = _pair(name)
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 8, seed=9))
    full = tm.logits(tp, {"tokens": toks})
    logits, cache = tm.prefill(tp, {"tokens": toks[:, :S]}, 16)
    _close(logits, full[:, S - 1])
    for t in range(S, 8):
        step, cache = tm.decode(tp, cache, toks[:, t:t + 1])
        _close(step[:, 0], full[:, t], msg=f"position {t}")


def test_jax_short_prompt_fault_is_recorded():
    """The reference's recurrent prefill keeps ``x[:, -(K-1):]`` as the
    conv buffer, which has only S rows for S < 3 (ROADMAP queue 3): for
    recurrentgemma at S = 1 the row is broadcast over the three slots and
    the next decode step is wrong; at S = 2 prefill raises; mamba2's
    decode step raises at S = 1 and 2 (both raise while tracing, so
    ``eval_shape`` shows them without compiling). The port is correct there
    (``test_short_prompt_prefill_then_decode_is_forward``)."""
    jm, jp, tm, tp = _pair("griffin3L")
    toks = _tokens(tm.cfg, 2, 8, seed=9)
    # the port's forward is JAX's within 1e-5 (test_forward_matches_jax)
    full = tm.logits(tp, {"tokens": torch.from_numpy(toks)}).numpy()
    _, c = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :1])}, 16)
    step, _ = jm.decode(jp, c, jnp.asarray(toks[:, 1:2]))
    assert np.abs(np.asarray(step[:, 0]) - full[:, 1]).max() > 1e-2

    def prefill_then_decode(name, S):
        jm, jp, _, _ = _pair(name)

        def run(p):
            _, cache = jdec.prefill(p, jm.cfg, toks[:, :S], 16)
            return jdec.decode_step(p, jm.cfg, cache, toks[:, S:S + 1])
        return jax.eval_shape(run, jp)

    for name, S in (("griffin3L", 2), ("mamba2", 1), ("mamba2", 2)):
        with pytest.raises(ValueError):
            prefill_then_decode(name, S)


# ------------------------------------------------------------- the engine
def _trace(tm, calib):
    """The canonical trace of tests/test_torch_engine.py: 8 one-row
    requests of 16/24 tokens, a pool of ~2.5 dense requests."""
    mm = memory.build_memory_model(tm.cfg)
    full = masks.full_mask(tm.cfg.n_layers)
    prompts = [calib["tokens"][:1, : (16 if i % 2 else 24)]
               for i in range(8)]
    return prompts, mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)


@pytest.mark.parametrize("name,chunk", [("mamba2", 0), ("griffin3L", 8)],
                         ids=["mamba2", "griffin3L-chunk8"])
def test_trace_matches_jax_local_engine(name, chunk, monkeypatch):
    jm, jp, tm, tp = _pair(name)
    L = tm.cfg.n_layers
    calib = JaxCorpus(jm.cfg.vocab_size, seed=7).batch(2, 32, split="calib")
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    prompts, budget = _trace(tm, calib)
    kw = dict(mode="masked", max_new_tokens=2, max_active=4, max_len=32,
              budget_bytes=budget, tokens_per_page=8, decode_horizon=8,
              budget_quantum_frac=0.3, max_prefill_tokens=chunk)
    jpol = JaxRLPolicy(jctl.RAPController(
        jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
        jmem.build_memory_model(jm.cfg), jq))
    jrep = JaxRAPEngine(jm, jp, jpol, JaxEngineConfig(**kw),
                        executor=JaxLocalExecutor(jm, jp, max_active=4)).run(
        [JaxEngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    # both packages prefill these layouts monolithically
    monkeypatch.setattr(LocalExecutor, "prefill_begin", None)
    pol = RLPolicy(controller.RAPController(
        tm, tp, {k: torch.from_numpy(v) for k, v in calib.items()},
        memory.build_memory_model(tm.cfg),
        bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))))
    eng = RAPEngine(tm, tp, pol, EngineConfig(**kw),
                    executor=LocalExecutor(tm, tp, max_active=4))
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
    (group,) = eng.executor.groups()
    assert not eng.executor.supports_chunked_prefill(group)
    assert set(group.cache) - {"pos"} == (
        {"ssd"} if name == "mamba2" else {"local_attn", "rglru"})


# ------------------------------------------------------ refusals, plumbing
@ARCHS
def test_memory_model_matches_jax(name):
    jm, _, tm, _ = _pair(name)
    want = jmem.build_memory_model(jm.cfg)
    got = memory.build_memory_model(tm.cfg)
    for field in ("mixer_param_bytes", "ffn_param_bytes",
                  "mixer_state_unit", "mixer_state_fixed"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.embed_bytes == want.embed_bytes
    assert not got.mixer_state_unit.any()          # fixed-size state only
    mask = masks.full_mask(tm.cfg.n_layers)
    mask[1] = False
    for b, s in ((1, 26), (4, 300)):
        assert got.state_bytes(mask, b, s) == want.state_bytes(mask, b, s)
        assert got.peak_bytes(mask, b, s) == want.peak_bytes(mask, b, s)


@ARCHS
def test_attention_only_paths_refuse_the_layout(name):
    _, _, tm, tp = _pair(name)
    with pytest.raises(NotImplementedError, match="uniform all-attention"):
        PagedExecutor(tm, tp)
    for kv in ("int8", "fp8"):
        # a quantized slot cache serves these layouts (the ring quantized,
        # the recurrent state f32), as JAX's LocalExecutor does
        ex = LocalExecutor(tm, tp, kv_dtype=kv)
        group = ex.group_for(masks.full_mask(tm.cfg.n_layers), 16)
        assert not ex.supports_chunked_prefill(group)
        if "local_attn" in group.cache:
            assert group.cache["local_attn"]["k"].dtype == ex.kv_dtype
    cache = decoder.init_cache(tm.cfg, 1, 16)
    with pytest.raises(NotImplementedError, match="uniform all-attention"):
        decoder.prefill_chunk(tp, tm.cfg, cache,
                              torch.zeros(1, 4, dtype=torch.long), 0)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_serve_entry_point_recurrent(arch, capsys):
    from repro_torch.launch import serve
    argv = ["--smoke", "--device", "cpu", "--arch", arch, "--requests", "3",
            "--max-prompt", "32", "--max-new", "4", "--policy", "dense",
            "--mode", "masked"]
    eng, rep = serve.main(argv)
    assert isinstance(eng.executor, LocalExecutor)
    assert all(r.status == "done" and r.tokens.shape[1] == 4
               for r in rep.results)
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="uniform all-attention"):
        serve.main(argv + ["--executor", "paged"])
    eng, rep = serve.main(argv + ["--kv-dtype", "int8"])
    assert eng.executor.kv_dtype == torch.int8
    assert all(r.status == "done" and r.tokens.shape[1] == 4
               for r in rep.results)
    assert rep.pool["overcommit_events"] == 0
