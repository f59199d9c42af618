"""The encoder-decoder whisper-medium of the port against the JAX package,
on the CPU, at its SMOKE size (2 + 2 layers, 16 audio frames) with
JAX-initialised weights carried by ``repro_torch.bridge`` (the layernorm
scales and biases perturbed, so a misapplied one shows). Tolerances: f32
logits and losses 1e-4 (``TOL``), layers 1e-5, gradients 1e-5 of each
leaf's largest, train-step params and metrics 1e-5 (``STEP_TOL``, as in
``tests/test_torch_train.py``); greedy tokens exactly.

* the config field for field and its parameter counts (the
  cross-attention term of ``total_params``);
* ``layer_norm``, the plain tanh-gelu FFN, ``_sinusoid`` and ``encode``;
* ``forward`` and the loss in both CE branches, with ``[L]`` and per-row
  ``[L, B]`` gates;
* prefill + 6 greedy decode steps on the model-dtype, a bf16 and an int8
  self cache (the cross K/V in the activation dtype), tokens equal;
* gradients of every leaf and three AdamW train steps against JAX's;
* ``gsi_rank`` on a frames batch against JAX's order;
* the engine's refusal (``RAPEngine`` and ``launch.serve --arch
  whisper-medium``), JAX's own message;
* ``launch.train --arch whisper-medium --smoke --device cpu``, and the
  launcher's extra inputs: internvl2-1b trains on the vision prefix with
  JAX's launcher's first-step loss, where the launcher without extras
  (the earlier one) trained text-only.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import gsi as jgsi
from repro.models import encdec as jenc, ffn as jffn, layers as jlayers
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import gsi, memory
from repro_torch.core.policy import DensePolicy
from repro_torch.models import encdec, ffn, layers, registry
from repro_torch.optim import adamw
from repro_torch.runtime import RAPEngine, steps

torch.set_num_threads(1)

ARCH = "whisper-medium"
# the data iterators the launchers call, by side (True: JAX's)
_BATCH_ITERATOR = {True: __import__("repro.data").data.batch_iterator,
                   False: __import__("repro_torch.data").data.batch_iterator}
TOL = 1e-4          # f32 logits and losses across frameworks
LAYER_TOL = 1e-5    # one f32 layer
GRAD_TOL = 1e-5     # f32 gradients, relative to each leaf's largest
STEP_TOL = 1e-5     # params and metrics after AdamW steps


def _perturb(tree, rng, name=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, k) for k, v in tree.items()}
    if name in ("scale", "bias"):
        return jnp.asarray(0.2 * rng.standard_normal(tree.shape), tree.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def _pair(arch=ARCH):
    jm = jreg.build(jax_smoke(arch))
    jp = _perturb(jm.init(jax.random.key(0)), np.random.default_rng(1))
    tm = registry.build(get_smoke_config(arch))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)
                                ).astype(np.float32)
    return {"tokens": toks, "labels": toks.copy(), "frames": frames}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# ---------------------------------------------------------------- config
def test_config_equals_jax_and_counts_cross_attention():
    for mine, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.total_params() == theirs.total_params()
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (24, 1024, 16, 16, 4096, 51865)
    cross = cfg.n_layers * (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                            + cfg.q_dim * cfg.d_model + cfg.d_model)
    m, f = cfg.block_param_counts()
    assert cfg.total_params() == sum(m) + sum(f) + cfg.embed_params() + cross
    # the port's own pytree (a meta template) against the analytic count
    for c in (get_smoke_config(ARCH), cfg):
        params = registry.build(c).init(0, "meta")
        real = sum(v.numel() for v in _flat(params).values())
        assert abs(real - c.total_params()) / real < 0.05
    assert set(params["stacks"]) == {"enc_attn", "enc_ffn", "attn", "cross",
                                     "ffn"}
    assert set(params["final_norm"]) == {"scale", "bias"}


# ---------------------------------------------------------------- layers
def test_layer_norm_gelu_ffn_and_sinusoid_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s, b = (0.3 * rng.standard_normal(64).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        layers.layer_norm(*map(torch.from_numpy, (x, s, b))).numpy(),
        np.asarray(jlayers.layer_norm(*map(jnp.asarray, (x, s, b)))),
        atol=LAYER_TOL, rtol=0)
    jm, jp, tm, tp = _pair()
    jf = jax.tree.map(lambda t: t[0], jp["stacks"]["ffn"])
    tf = {k: v[0] for k, v in tp["stacks"]["ffn"].items()
          if k != "norm"}
    assert tf["wi"].shape == (64, tm.cfg.d_ff)           # no GLU halves
    np.testing.assert_allclose(
        ffn.ffn(tf, tm.cfg, torch.from_numpy(x)).numpy(),
        np.asarray(jffn.ffn(jf, jm.cfg, jnp.asarray(x))), atol=LAYER_TOL,
        rtol=0)
    pos = np.arange(0, 40, 3)
    np.testing.assert_allclose(
        encdec._sinusoid(torch.from_numpy(pos), 64).numpy(),
        np.asarray(jenc._sinusoid(jnp.asarray(pos), 64)), atol=LAYER_TOL,
        rtol=0)


def test_encode_matches_jax():
    jm, jp, tm, tp = _pair()
    fr = _batch(tm.cfg, 2, 4)["frames"]
    np.testing.assert_allclose(
        encdec.encode(tp, tm.cfg, torch.from_numpy(fr)).numpy(),
        np.asarray(jenc.encode(jp, jm.cfg, jnp.asarray(fr))), atol=TOL,
        rtol=0)


# ---------------------------------------------------------------- forward
def test_forward_and_loss_both_ce_branches_match_jax(monkeypatch):
    jm, jp, tm, tp = _pair()
    b = _batch(tm.cfg, 2, 16, seed=4)
    L = tm.cfg.n_layers
    want = np.asarray(jm.logits(jp, _j(b)))
    got = tm.logits(tp, _t(b)).numpy()
    assert got.shape == (2, 16, tm.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    g = np.array([0.0, 1.0], np.float32)         # layer 0's mixer pair off
    jg = {"mixer": jnp.asarray(g), "ffn": jnp.ones(L)}
    gated = tm.logits(tp, _t(b), gates={"mixer": torch.from_numpy(g),
                                        "ffn": torch.ones(L)}).numpy()
    np.testing.assert_allclose(gated, np.asarray(jm.logits(jp, _j(b), jg)),
                               atol=TOL, rtol=0)
    assert np.abs(gated - got).max() > 1e-3
    # per-row [L, B] gates: each row as its own [L] gate vector
    rows = tm.logits(tp, _t(b), gates={
        "mixer": torch.tensor([[1.0, 0.0], [1.0, 1.0]]),
        "ffn": torch.ones(L, 2)}).numpy()
    np.testing.assert_allclose(rows[0], got[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(rows[1], gated[1], atol=1e-5, rtol=0)
    losses = []
    for min_seq in (2048, 8):                   # plain CE, then chunked CE
        monkeypatch.setattr(jreg, "CHUNKED_CE_MIN_SEQ", min_seq)
        monkeypatch.setattr(registry, "CHUNKED_CE_MIN_SEQ", min_seq)
        jl, _ = jm.loss(jp, _j(b))
        tl, aux = tm.loss(tp, _t(b))
        assert abs(float(tl) - float(jl)) <= TOL, min_seq
        losses.append(float(tl))
    assert abs(losses[0] - losses[1]) <= 1e-5


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_prefill_then_decode_match_jax(kv_dtype):
    """Prefill (encode, cross K/V, the prompt's self K/V) and 6 greedy
    decode steps: logits within TOL, tokens equal; the self cache in the
    model dtype, bf16 or int8 (per-(token, head) scales), the cross K/V in
    the activation dtype."""
    jm, jp, tm, tp = _pair()
    b = _batch(tm.cfg, 2, 7, seed=5)
    jdt = {None: None, "bf16": jnp.bfloat16, "int8": jnp.int8}[kv_dtype]
    tdt = {None: None, "bf16": torch.bfloat16, "int8": torch.int8}[kv_dtype]
    jl, jc = jm.prefill(jp, _j(b), 16, kv_dtype=jdt)
    tl, tc = tm.prefill(tp, _t(b), 16, kv_dtype=tdt)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert tc["pos"] == int(jc["pos"]) == 7
    empty = tm.init_cache(2, 16, kv_dtype=tdt, device="cpu")
    assert ({k: (v.shape, v.dtype) for k, v in _flat(empty).items()
             if k != "pos"}
            == {k: (v.shape, v.dtype) for k, v in _flat(tc).items()
                if k != "pos"})
    assert tc["cross"]["k"].dtype == torch.float32
    assert tc["attn"]["k"].dtype == (tdt or torch.float32)
    assert ("ks" in tc["attn"]) == (kv_dtype == "int8")
    np.testing.assert_allclose(tc["cross"]["k"].numpy(),
                               np.asarray(jc["cross"]["k"]), atol=TOL, rtol=0)
    jt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    tt = jt.copy()
    jtoks, ttoks = [], []
    for _ in range(6):
        jlg, jc = jm.decode(jp, jc, jnp.asarray(jt))
        tlg, tc = tm.decode(tp, tc, torch.from_numpy(tt))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=0)
        jt = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
        tt = torch.argmax(tlg[:, -1], -1).to(torch.int32)[:, None].numpy()
        jtoks.append(jt)
        ttoks.append(tt)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    assert tc["pos"] == 13


def test_decode_continues_the_forward():
    """Within the port: prefill on a prompt, then one decode step, gives
    the teacher-forced forward's logits at the next position."""
    jm, jp, tm, tp = _pair()
    b = _t(_batch(tm.cfg, 2, 9, seed=6))
    full = tm.logits(tp, b)
    pre = dict(b, tokens=b["tokens"][:, :8])
    last, cache = tm.prefill(tp, pre, 12)
    np.testing.assert_allclose(last.numpy(), full[:, 7].numpy(), atol=1e-5,
                               rtol=0)
    step, _ = tm.decode(tp, cache, b["tokens"][:, 8:9])
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 8].numpy(),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------- training
def test_grads_of_every_leaf_match_jax():
    jm, jp, tm, tp = _pair()
    b = _batch(tm.cfg, 2, 12, seed=7)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, _j(b))
    for remat in (False, True):
        loss, _, grads = steps.loss_and_grads(tm, tp, _t(b), remat=remat)
        assert abs(float(loss) - float(jl)) <= TOL
        flat, jflat = _flat(grads), _flat(jax.tree.map(np.asarray, jg))
        assert sorted(flat) == sorted(jflat)
        for k, g in flat.items():
            want = jflat[k]
            scale = max(float(np.abs(want).max()), 1e-12)
            assert float(np.abs(g.numpy() - want).max()) <= (
                GRAD_TOL * scale), (remat, k)
            assert float(np.abs(want).max()) > 0.0, k


def test_train_steps_match_jax():
    """Three AdamW steps: metrics within STEP_TOL, params within STEP_TOL
    — except where the first step's gradient is within 10 · eps (1e-7) of
    zero on both sides. Adam's first step is g / (|g| + eps) · lr:
    sign(g) · lr where |g| ≫ eps, but any fraction of lr near eps, where
    the gradient's f32 rounding (≈ 1e-7 of its leaf's largest, rounded
    differently by the two frameworks) moves it by up to a few per cent of
    lr. Those elements are held to the most three steps can move them,
    3 · lr, and must stay under 1% of every leaf."""
    jm, jp, tm, tp = _pair()
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jstep = jax.jit(jsteps.make_train_step(jm, jadamw.AdamWConfig(**kw),
                                           remat=False))
    tstep = steps.make_train_step(tm, adamw.AdamWConfig(**kw), remat=True)
    js, ts = jadamw.init(jp), adamw.init(tp)
    g0 = None
    for i in range(3):
        b = _batch(tm.cfg, 2, 12, seed=10 + i)
        if g0 is None:
            g0 = _flat(steps.loss_and_grads(tm, tp, _t(b))[2])
            jg0 = _flat(jax.tree.map(np.asarray, jax.grad(
                lambda p: jm.loss(p, _j(b))[0])(jp)))
        jp, js, jmet = jstep(jp, js, _j(b))
        tp, ts, tmet = tstep(tp, ts, _t(b))
        for k in ("loss", "ppl", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=STEP_TOL, err_msg=f"{i} {k}")
    want = _flat(jax.tree.map(np.asarray, jp))
    noise = 0
    for k, v in _flat(tp).items():
        tiny = 10 * adamw.AdamWConfig().eps
        quiet = (g0[k].abs().numpy() < tiny) & (np.abs(jg0[k]) < tiny)
        noise += int(quiet.sum())
        assert quiet.mean() < 0.01, (k, float(quiet.mean()))
        err = np.abs(v.numpy() - want[k])
        bound = np.where(quiet, 3 * kw["lr"], STEP_TOL + STEP_TOL
                         * np.abs(want[k]))
        assert (err <= bound).all(), (k, float(err[~quiet].max(initial=0)))
    print(f"{noise} elements stepped on a first gradient within 10 eps "
          f"of zero on both sides")


def test_gsi_rank_on_frames_matches_jax():
    """Algorithm 1 on a calibration batch with frames: the port repeats
    the frames with the tokens per candidate and scores all candidates in
    one forward ([L, n·B] gates), JAX under ``vmap``."""
    jm, jp, tm, tp = _pair()
    b = _batch(tm.cfg, 2, 16, seed=8)
    jr = jgsi.gsi_rank(jm, jp, _j(b))
    tr = gsi.gsi_rank(tm, tp, _t(b))
    assert tr.order == jr.order and len(tr.order) == 2 * tm.cfg.n_layers - 2
    for a, w in zip(tr.score_snapshots, jr.score_snapshots):
        fin = np.isfinite(np.asarray(w))
        np.testing.assert_array_equal(np.isfinite(a), fin)
        np.testing.assert_allclose(np.asarray(a)[fin], np.asarray(w)[fin],
                                   atol=TOL, rtol=0)


# ---------------------------------------------------------------- engine
def test_engine_refuses_encoder_decoder_models():
    jm, jp, tm, tp = _pair()
    mm = memory.build_memory_model(tm.cfg)
    with pytest.raises(NotImplementedError,
                       match="^engine serves decoder-only models$"):
        RAPEngine(tm, tp, DensePolicy(mm))


@pytest.mark.parametrize("policy", ["rl", "shortgpt", "dense"])
@pytest.mark.parametrize("serial", [False, True])
def test_serve_refuses_before_building(policy, serial, monkeypatch):
    """``launch.serve --arch whisper-medium`` raises the engine's refusal
    first, whatever the policy and the path: no model, calibration batch
    or policy is built for a model the engine would refuse."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    def no_build(cfg):
        raise AssertionError("a model was built before the refusal")
    monkeypatch.setattr(registry, "build", no_build)
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "1",
            "--max-prompt", "16", "--policy", policy] + (
                ["--serial", "--executor", "local"] if serial else [])
    with pytest.raises(NotImplementedError,
                       match="^engine serves decoder-only models$"):
        serve.main(argv)


# ---------------------------------------------------------------- launcher
def test_train_launcher_trains_whisper(capsys):
    from repro_torch.launch import train
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16"])
    assert out["final_step"] == 3
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    extra = train.extra_inputs(get_smoke_config(ARCH), 2, "cpu")
    assert extra["frames"].shape == (2, 16, 64)
    assert "done at step 3" in capsys.readouterr().out


def _first_step(monkeypatch, launcher, argv, seen):
    """Run ``launcher`` (``repro.launch.train`` reads ``sys.argv``) for one
    step; record the first batch it draws and return its first-step
    loss."""
    jax_side = launcher.__name__.startswith("repro.")
    import repro.data
    import repro_torch.data
    mod = repro.data if jax_side else repro_torch.data
    orig = _BATCH_ITERATOR[jax_side]

    def spy(*a, **kw):
        it = orig(*a, **kw)
        seen.append(next(it))
        yield seen[-1]
        yield from it
    monkeypatch.setattr(mod, "batch_iterator", spy)
    if not jax_side:
        return float(launcher.main(argv + ["--device", "cpu"])
                     ["history"][0]["loss"])
    import repro.runtime
    runs = []

    class Recording(repro.runtime.Trainer):
        def run(self, *a, **kw):
            runs.append(super().run(*a, **kw))
            return runs[-1]
    monkeypatch.setattr(repro.runtime, "Trainer", Recording)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    launcher.main()
    return float(runs[0]["history"][0]["loss"])


def test_train_launcher_trains_on_the_vision_prefix(monkeypatch):
    """internvl2-1b: JAX's launcher prepends zero ``vision_embeds`` to every
    batch. The port's launcher, given JAX's initial weights (bridged), now
    does too and its first-step loss equals JAX's within STEP_TOL; the
    launcher without those extras (the earlier one) trained text-only and
    its loss differs."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    arch = "internvl2-1b"
    argv = ["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    jseen, tseen = [], []
    want = _first_step(monkeypatch, jtrain, argv, jseen)
    jp = jreg.build(jax_smoke(arch)).init(jax.random.key(0))
    build = registry.build
    monkeypatch.setattr(registry, "build", lambda cfg: build(cfg)._replace(
        init=lambda seed, device: bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), device)))
    got = _first_step(monkeypatch, train, argv, tseen)
    P = get_smoke_config(arch).n_vision_tokens
    assert jseen[0]["vision_embeds"].shape == (2, P, 64)
    assert tseen[0]["vision_embeds"].shape == (2, P, 64)
    assert not tseen[0]["vision_embeds"].any()
    np.testing.assert_array_equal(tseen[0]["tokens"], jseen[0]["tokens"])
    np.testing.assert_allclose(got, want, rtol=STEP_TOL)
    # the earlier launcher: no extra inputs, a text-only model
    monkeypatch.setattr(train, "extra_inputs", lambda *a: None)
    old_seen = []
    old = _first_step(monkeypatch, train, argv, old_seen)
    assert "vision_embeds" not in old_seen[0]
    assert abs(old - want) > 1e-3
