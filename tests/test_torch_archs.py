"""The dense decoder's remaining architectures against the JAX package, on
the CPU: gemma-2b (GeGLU, ``embed_scale``, tied embeddings, MQA at head_dim
32 in SMOKE), glm4-9b (GQA, K = 2), qwen3-14b (``qk_norm``), qwen1.5-32b
(``qkv_bias``, full MHA KV) and internvl2-1b (``vlm``: patch embeddings
prepended to the tokens), each at its SMOKE size with JAX-initialised
weights carried by ``repro_torch.bridge``. The zero-initialised leaves
(norm scales, q/k/v biases, q/k norms) get random values first, so a
misapplied one shows.

Per architecture: config fields equal to JAX's (CONFIG and SMOKE); logits
and loss within ``TOL`` (1e-4); prefill logits within ``TOL`` and the
greedy tokens of a decode horizon equal; a paged masked engine trace
(masks and tokens per request) equal to JAX's (internvl2 text-only, as the
JAX engine serves it); the memory model of the full config equal. Also:
internvl2's logits, loss (both CE branches), prefill and decode with
``vision_embeds``; ``compact_params``, a checkpoint round trip (both
packages' readers) and the gradients carrying ``bq``, ``bk``, ``bv``,
``q_norm`` and ``k_norm``; an fp8 slot-cache engine trace on llama2 equal
to JAX's; what the fp8 cast does past ±448 in torch against ml_dtypes;
``launch.serve --arch`` for the five on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import controller as jctl, dqn as jdqn, masks as jmasks
from repro.core import memory as jmem
from repro.core.policy import RLPolicy as JaxRLPolicy
from repro.data import SyntheticCorpus as JaxCorpus
from repro.models import decoder as jdec
from repro.models import registry as jreg
from repro.runtime import EngineConfig as JaxEngineConfig
from repro.runtime import EngineRequest as JaxEngineRequest
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro.runtime import RAPEngine as JaxRAPEngine
from repro_torch import bridge
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import controller, masks, memory
from repro_torch.core.policy import RLPolicy
from repro_torch.models import decoder, registry
from repro_torch.runtime import (EngineConfig, EngineRequest, LocalExecutor,
                                 PagedExecutor, RAPEngine, steps)

torch.set_num_threads(1)

TOL = 1e-4          # f32 logits and losses across frameworks
GRAD_TOL = 1e-5     # f32 gradients, relative to each leaf's largest
ARCHS = ("gemma-2b", "glm4-9b", "qwen3-14b", "qwen1.5-32b", "internvl2-1b")
NEW_LEAVES = ("bq", "bk", "bv", "q_norm", "k_norm")
_ZERO_INIT = ("scale",) + NEW_LEAVES


def _perturb(tree, rng, name=""):
    """Random values in the leaves JAX initialises to zeros."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if name in _ZERO_INIT:
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


def _vision(cfg, B, seed=2):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model))).astype(np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax_field_for_field(arch):
    for mine, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_params() == theirs.total_params()


def test_moe_and_encdec_remain_later_slices():
    """Since the slice that ported them, MoE and encoder-decoder configs
    are registered; the decoder-only entry points take an MoE config and
    refuse an encoder-decoder one (``registry.build`` gives it
    ``models/encdec.py``)."""
    for arch in ("olmoe-1b-7b", "dbrx-132b", "whisper-medium"):
        assert get_config(arch).name == arch
    cfg = dataclasses.replace(get_smoke_config("llama2-7b"), n_experts=4,
                              moe_top_k=2)
    decoder.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="registry.build"):
        decoder.check_supported(dataclasses.replace(
            get_smoke_config("llama2-7b"), is_encoder_decoder=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_model_equals_jax(arch):
    jm = jmem.build_memory_model(jax_config(arch))
    tm = memory.build_memory_model(get_config(arch))
    L = get_config(arch).n_layers
    full = masks.full_mask(L)
    half = full.copy()
    half[::3] = False
    for m in (full, half):
        for bs, sql in ((1, 512), (8, 2048)):
            assert tm.peak_bytes(m, bs, sql) == jm.peak_bytes(m, bs, sql)
    np.testing.assert_array_equal(tm.block_bytes(8, 2048),
                                  jm.block_bytes(8, 2048))


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 2, 16)
    want = np.asarray(jm.logits(jp, {"tokens": jnp.asarray(toks)}))
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks)}).numpy()
    assert got.shape == want.shape == (2, 16, tm.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(toks)})
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_horizon_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 2, 13, seed=3)
    jl, jc = jdec.prefill(jp, jm.cfg, jnp.asarray(toks), 24)
    tl, tc = decoder.prefill(tp, tm.cfg, torch.from_numpy(toks), 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][k].numpy(),
                                   np.asarray(jc["attn"][k]), atol=TOL,
                                   rtol=0)
    first = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jt, _ = jdec.decode_horizon(jp, jm.cfg, jc, jnp.asarray(first), 8)
    tt, _ = decoder.decode_horizon(tp, tm.cfg, tc, torch.from_numpy(first), 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_vision_embeds_match_jax(monkeypatch):
    """internvl2 with patch embeddings: logits over P + S positions, the
    loss on the text positions in the plain and the chunked-CE branch,
    prefill (S counts the prefix) and the decode horizon after it."""
    jm, jp, tm, tp = _pair("internvl2-1b")
    P = tm.cfg.n_vision_tokens
    toks, vis = _tokens(tm.cfg, 2, 16, seed=4), _vision(tm.cfg, 2)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "vision_embeds": jnp.asarray(vis)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "vision_embeds": torch.from_numpy(vis)}
    want, got = np.asarray(jm.logits(jp, jb)), tm.logits(tp, tb).numpy()
    assert got.shape == want.shape == (2, P + 16, tm.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    text_only = tm.logits(tp, {"tokens": tb["tokens"]}).numpy()
    assert np.abs(got[:, P:] - text_only).max() > 1e-3
    losses = []
    for min_seq in (2048, 8):                 # plain CE, then chunked CE
        monkeypatch.setattr(jreg, "CHUNKED_CE_MIN_SEQ", min_seq)
        monkeypatch.setattr(registry, "CHUNKED_CE_MIN_SEQ", min_seq)
        jl, _ = jm.loss(jp, jb)
        tl, _ = tm.loss(tp, tb)
        assert abs(float(tl) - float(jl)) <= TOL, min_seq
        losses.append(float(tl))
    assert abs(losses[0] - losses[1]) <= 1e-5
    jl, jc = jm.prefill(jp, jb, P + 24)
    tl, tc = tm.prefill(tp, tb, P + 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert tc["pos"] == int(jc["pos"]) == P + 16
    first = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    jt, _ = jdec.decode_horizon(jp, jm.cfg, jc, jnp.asarray(first), 6)
    tt, _ = decoder.decode_horizon(tp, tm.cfg, tc, torch.from_numpy(first), 6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# ---------------------------------------------------------------- engine
def _calib(cfg):
    return JaxCorpus(cfg.vocab_size, seed=7).batch(2, 32, split="calib")


def _trace(cfg, mm, n=6):
    toks = _calib(cfg)["tokens"]
    full = masks.full_mask(cfg.n_layers)
    prompts = [toks[:1, : (16 if i % 2 else 24)] for i in range(n)]
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
    return prompts, budget


def _engines(arch, executor, kv_dtype=None):
    """(JAX report, port report, port engine) of one masked engine trace
    with the RL controller on an admission grid of 0.3 (so it prunes)."""
    jm, jp, tm, tp = _pair(arch)
    L = tm.cfg.n_layers
    mm = memory.build_memory_model(tm.cfg)
    calib = _calib(tm.cfg)
    jq = jdqn.init_qnet(jax.random.key(0), 2 * L + 4, 2 * L + 1, 32)
    tq = bridge.qnet_from_numpy(jax.tree.map(np.asarray, jq))
    prompts, budget = _trace(tm.cfg, mm)
    kw = dict(mode="masked", max_new_tokens=2, max_active=4, max_len=32,
              budget_bytes=budget, tokens_per_page=8, decode_horizon=8,
              budget_quantum_frac=0.3, kv_dtype=kv_dtype)
    jx = {"paged": JaxPagedExecutor, "local": JaxLocalExecutor}[executor]
    tx = {"paged": PagedExecutor, "local": LocalExecutor}[executor]
    xkw = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    jpol = JaxRLPolicy(jctl.RAPController(
        jm, jp, {k: jnp.asarray(v) for k, v in calib.items()},
        jmem.build_memory_model(jm.cfg), jq))
    jrep = JaxRAPEngine(jm, jp, jpol, JaxEngineConfig(**kw),
                        executor=jx(jm, jp, max_active=4, **xkw)).run(
        [JaxEngineRequest(rid=f"r{i}", prompt=p)
         for i, p in enumerate(prompts)])
    pol = RLPolicy(controller.RAPController(
        tm, tp, {k: torch.from_numpy(v) for k, v in calib.items()}, mm, tq))
    eng = RAPEngine(tm, tp, pol, EngineConfig(**kw),
                    executor=tx(tm, tp, max_active=4, **xkw))
    rep = eng.run([EngineRequest(rid=f"r{i}", prompt=p)
                   for i, p in enumerate(prompts)])
    return jrep, rep, eng


def _same_trace(jrep, rep, L):
    want = {r.rid: r for r in jrep.results}
    got = {r.rid: r for r in rep.results}
    assert set(got) == set(want) and len(got) == 6
    for rid, r in want.items():
        assert r.status == got[rid].status == "done"
        np.testing.assert_array_equal(got[rid].mask, r.mask, err_msg=rid)
        np.testing.assert_array_equal(got[rid].tokens, r.tokens, err_msg=rid)
    assert rep.pool["peak_reserved_bytes"] == jrep.pool["peak_reserved_bytes"]
    assert rep.pool["overcommit_events"] == 0
    assert any(r.mask.sum() < 2 * L for r in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_masked_engine_trace_matches_jax(arch):
    jrep, rep, _ = _engines(arch, "paged")
    _same_trace(jrep, rep, get_smoke_config(arch).n_layers)


def test_fp8_slot_cache_engine_trace_matches_jax():
    """llama2 on fp8 slot caches: a plain cast on store and on load in
    both packages."""
    jrep, rep, eng = _engines("llama2-7b", "local", kv_dtype="fp8")
    _same_trace(jrep, rep, get_smoke_config("llama2-7b").n_layers)
    groups = eng.executor.groups()
    assert groups and all(g.cache["attn"]["k"].dtype == torch.float8_e4m3fn
                          for g in groups)


def test_fp8_cast_past_448_against_ml_dtypes():
    """float8_e4m3fn's largest finite value is 448. Within ±464 (values
    that round to ±448) torch's cast and ml_dtypes' (JAX's) give the same
    bits. Past it ml_dtypes gives NaN, and torch depends on its version:
    2.13.0+cpu saturates at ±448, 2.11.0+cu128 (CPU and CUDA casts alike)
    gives NaN as ml_dtypes does (ROADMAP queue 3). The slot
    cache casts without clipping, as JAX does."""
    x = np.array([0.0, 1.5, -3.25, 440.0, 448.0, 455.0, 460.0, 464.0,
                  -464.0, 465.0, 480.0, 500.0, -500.0, 1e4], np.float32)
    theirs = x.astype(ml_dtypes.float8_e4m3fn)
    mine = torch.from_numpy(x).to(torch.float8_e4m3fn)
    inside = np.abs(x) <= 464.0
    np.testing.assert_array_equal(
        mine.view(torch.uint8).numpy()[inside],
        theirs.view(np.uint8)[inside])
    assert np.isnan(theirs[~inside].astype(np.float32)).all()
    past = mine.float().numpy()[~inside]
    saturates = bool(np.isfinite(past).any())
    print(f"torch {torch.__version__} past ±464: "
          f"{'saturates at ±448' if saturates else 'NaN, as ml_dtypes'}")
    if saturates:
        np.testing.assert_array_equal(past, np.sign(x[~inside]) * 448.0)
    else:
        assert np.isnan(past).all()
    # the slot cache's store is that cast, unclipped
    from repro_torch.models import attention
    entry = attention.init_kv_cache(get_smoke_config("llama2-7b"), 1, 4, 1,
                                    torch.float8_e4m3fn)
    k = torch.full((1, 1, 4, 16), 500.0)
    stored = attention.store_kv({"k": entry["k"][0], "v": entry["v"][0]},
                                k, k)["k"]
    assert torch.equal(stored.view(torch.uint8),
                       k.to(torch.float8_e4m3fn).view(torch.uint8))


# ------------------------------------------------- the new attention leaves
@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen1.5-32b"])
def test_compact_params_carries_the_new_leaves(arch):
    jm, jp, tm, tp = _pair(arch)
    L = tm.cfg.n_layers
    mask = masks.full_mask(L)
    mask[0] = False                         # layer 0's mixer
    small, layout = masks.compact_params(tp, tm.cfg, mask)
    jsmall, jlayout = jmasks.compact_params(jp, jm.cfg, mask)
    assert [tuple(s) for s in layout] == [tuple(s) for s in jlayout]
    leaves = set(small["stacks"]["attn"])
    assert set(NEW_LEAVES) & leaves == set(NEW_LEAVES) & set(
        jsmall["stacks"]["attn"]) != set()
    flat, jflat = _flat(small), _flat(jax.tree.map(np.asarray, jsmall))
    assert sorted(flat) == sorted(jflat)
    for k, v in flat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    toks = _tokens(tm.cfg, 2, 12, seed=5)
    want, _ = jdec.forward(jsmall, jm.cfg, jnp.asarray(toks), layout=jlayout)
    got, _ = decoder.forward(small, tm.cfg, torch.from_numpy(toks),
                             layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen1.5-32b"])
def test_checkpoint_round_trip_carries_the_new_leaves(arch, tmp_path):
    jm, jp, tm, tp = _pair(arch)
    save_pytree(tp, str(tmp_path), 3)
    back, manifest = restore_pytree(tm.init(0, "meta"), str(tmp_path))
    names = set(manifest["leaves"])
    for leaf in NEW_LEAVES:
        if leaf in tp["stacks"]["attn"]:
            assert f"stacks/attn/{leaf}" in names
    flat = _flat(tp)
    for k, v in _flat(back).items():
        assert torch.equal(v, flat[k]), k
    jback, _ = jckpt.restore_pytree(jax.eval_shape(lambda: jp),
                                    str(tmp_path))
    for k, v in _flat(jax.tree.map(np.asarray, jback)).items():
        np.testing.assert_array_equal(v, flat[k].numpy(), err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-14b", "qwen1.5-32b"])
def test_grads_of_the_new_leaves_match_jax(arch):
    jm, jp, tm, tp = _pair(arch)
    toks = _tokens(tm.cfg, 2, 16, seed=6)
    b = {"tokens": toks, "labels": toks}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _, grads = steps.loss_and_grads(
        tm, tp, {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    flat, jflat = _flat(grads), _flat(jax.tree.map(np.asarray, jg))
    assert sorted(flat) == sorted(jflat)
    seen = [k for k in flat if k.split("/")[-1] in NEW_LEAVES]
    assert seen
    for k, g in flat.items():
        want = jflat[k]
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_TOL * scale, k
        if k in seen:
            assert float(np.abs(want).max()) > 0.0, k


# ------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_serves_the_new_archs(arch, capsys):
    from repro_torch.launch import serve
    assert arch in serve.ARCHS
    eng, rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--executor", "paged", "--mode", "masked",
                           "--requests", "2", "--max-prompt", "32",
                           "--max-new", "4", "--budget-quantum", "0.3"])
    assert all(r.status == "done" for r in rep.results)
    assert rep.pool["overcommit_events"] == 0
    assert f"model {arch}" in capsys.readouterr().out


def test_serve_entry_point_fp8_slot_cache(capsys):
    from repro_torch.launch import serve
    eng, rep = serve.main(["--smoke", "--device", "cpu", "--executor",
                           "local", "--kv-dtype", "fp8", "--mode", "masked",
                           "--requests", "2", "--max-prompt", "32",
                           "--max-new", "4"])
    assert all(r.status == "done" for r in rep.results)
    assert all(g.cache["attn"]["k"].dtype == torch.float8_e4m3fn
               for g in eng.executor.groups())
