"""The port's gradients and training steps against the JAX package's, on
the CPU.

Seeded numpy inputs and JAX-initialised weights (carried by
``repro_torch.bridge``) go through both packages:

* ``kernels.ops.KernelGrad`` with each of the four forward kernels' plain
  versions in the kernel's place (flash attention with GQA, a window and a
  softcap; the GLU in swiglu and geglu; ``ssd`` over two chunks, its final
  state's gradient absent or present; ``rglru``) gives the gradients of
  native autograd through the plain version, bitwise: the backward *is*
  that autograd;
* the loss and the gradient of every parameter leaf against
  ``jax.value_and_grad(model.loss)`` for SMOKE llama2, mamba2 and
  recurrentgemma (within 1e-5; f32, summed in other orders), and
  ``remat=True`` against ``remat=False`` (1e-6);
* ``chunked_cross_entropy`` against JAX's (S = 16, chunk 4, with a mask)
  and against the full cross-entropy (1e-6), and the loss's chunked path
  at ``CHUNKED_CE_MIN_SEQ`` tokens;
* three ``make_train_step`` steps (and with ``microbatches=2``): params
  within 1e-5, ``loss``/``ppl``/``grad_norm``/``lr`` within 1e-5 relative;
  ``make_eval_step`` within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, rglru, ssd, swiglu
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import steps

torch.set_num_threads(1)

GRAD_TOL = 1e-5     # f32 gradients across frameworks (other sum orders)
STEP_TOL = 1e-5     # params and metrics after three AdamW steps
ARCHS = {"llama2": "llama2-7b", "mamba2": "mamba2-370m",
         "griffin": "recurrentgemma-9b"}


def _rnd(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _pair(arch, **kw):
    jm = jreg.build(jax_smoke(arch).replace(**kw))
    jp = jm.init(jax.random.key(0))
    tm = registry.build(get_smoke_config(arch).replace(**kw))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _batch(cfg, B, S, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": toks.copy()}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close_trees(got, want, tol, what=""):
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, atol=tol,
                                   rtol=tol, err_msg=f"{what}{k}")


# ------------------------------------------------------- KernelGrad wiring
def _flash_case(rng, window, softcap):
    q = _rnd(rng, 2, 12, 4, 8)
    k, v = _rnd(rng, 2, 12, 2, 8), _rnd(rng, 2, 12, 2, 8)
    return fa.attention_ref, (q, k, v), dict(causal=True, window=window,
                                            softcap=softcap)


CASES = {
    "flash_gqa": lambda rng: _flash_case(rng, 0, 0.0),
    "flash_window": lambda rng: _flash_case(rng, 5, 0.0),
    "flash_softcap": lambda rng: _flash_case(rng, 0, 20.0),
    "swiglu": lambda rng: (swiglu.glu_ref, (_rnd(rng, 3, 5, 14),),
                           dict(activation="swiglu")),
    "geglu": lambda rng: (swiglu.glu_ref, (_rnd(rng, 3, 5, 14),),
                          dict(activation="geglu")),
    "ssd": lambda rng: (ssd.ssd_ref, (
        _rnd(rng, 2, 12, 3, 4), -torch.rand(2, 12, 3, generator=torch
                                            .Generator().manual_seed(1)),
        _rnd(rng, 2, 12, 5), _rnd(rng, 2, 12, 5)), dict(chunk=8)),
    "rglru": lambda rng: (rglru.rglru_ref, (
        torch.rand(2, 9, 6, generator=torch.Generator().manual_seed(2)),
        _rnd(rng, 2, 9, 6)), {}),
}


def _loss_of(out, rng_out, with_state):
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((w * o).sum() + 0.5 * (o ** 2).sum()
               for o, w in zip(outs[:1], rng_out))
    if with_state and len(outs) > 1:
        loss = loss + (outs[1] * rng_out[1]).sum()
    return loss


@pytest.mark.parametrize("case", list(CASES) + ["ssd_state"])
def test_kernel_grad_is_the_plain_versions_autograd(case):
    """The Function's wiring on the CPU, the plain version standing in for
    the kernel: the same gradients as autograd through the plain version,
    for every input; ``ssd``'s final state is left out of the loss (its
    gradient arrives as None) or, in ``ssd_state``, put in."""
    with_state = case == "ssd_state"
    rng = np.random.default_rng(5)
    plain, inputs, kw = CASES["ssd" if with_state else case](rng)
    ref_out = plain(*inputs, **kw)
    outs = ref_out if isinstance(ref_out, tuple) else (ref_out,)
    ws = [_rnd(rng, *o.shape) for o in outs]

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in inputs]
        loss = _loss_of(fn(xs), ws, with_state)
        return torch.autograd.grad(loss, xs)

    want = grads(lambda xs: plain(*xs, **kw))
    got = grads(lambda xs: ops.KernelGrad.apply(plain, plain, kw, *xs))
    for g, w in zip(got, want):
        assert g is not None
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_grad_skips_inputs_that_need_none():
    """Only the inputs that require grad get one; the kernel runs once."""
    calls = []

    def kernel(a, b):
        calls.append(1)
        return rglru.rglru_ref(a, b)

    a = torch.rand(1, 4, 3)
    b = torch.randn(1, 4, 3, requires_grad=True)
    out = ops.KernelGrad.apply(kernel, rglru.rglru_ref, {}, a, b)
    (gb,) = torch.autograd.grad(out.sum(), [b])
    want = torch.autograd.grad(rglru.rglru_ref(a, b).sum(), [b])[0]
    torch.testing.assert_close(gb, want, rtol=0, atol=0)
    assert len(calls) == 1


# --------------------------------------------------------- loss and grads
@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    return request.param, _pair(ARCHS[request.param])


def test_loss_and_grads_match_jax(pair):
    name, (jm, jp, tm, tp) = pair
    b = _batch(tm.cfg, 2, 20, seed=3)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, _j(b))
    loss, aux, grads = steps.loss_and_grads(tm, tp, _t(b))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(aux["ppl"]), float(jaux["ppl"]),
                               rtol=1e-5)
    _close_trees(grads, jg, GRAD_TOL, f"{name} grad ")


def test_remat_gives_the_same_grads(pair):
    name, (_, _, tm, tp) = pair
    b = _t(_batch(tm.cfg, 2, 20, seed=4))
    l0, _, g0 = steps.loss_and_grads(tm, tp, b, remat=False)
    l1, _, g1 = steps.loss_and_grads(tm, tp, b, remat=True)
    assert float(l0) == float(l1)
    f0, f1 = _flat(g0), _flat(g1)
    for k in f0:
        torch.testing.assert_close(f1[k], f0[k], rtol=1e-6, atol=1e-6,
                                   msg=f"{name} {k}")


# ------------------------------------------------------------- chunked CE
def test_chunked_cross_entropy_matches_jax_and_full_ce():
    rng = np.random.default_rng(7)
    B, S, D, V, Vp = 2, 16, 8, 20, 24
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, Vp)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = jreg.chunked_cross_entropy(lambda hc: hc @ jw, jnp.asarray(h),
                                      jnp.asarray(labels), V,
                                      jnp.asarray(mask), chunk=4)
    th = torch.from_numpy(h).requires_grad_(True)
    got = registry.chunked_cross_entropy(
        lambda hc: hc @ tw, th, torch.from_numpy(labels), V,
        torch.from_numpy(mask), chunk=4)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    full = registry.cross_entropy((th @ tw)[:, :-1],
                                  torch.from_numpy(labels)[:, 1:], V,
                                  torch.from_numpy(mask)[:, 1:])
    np.testing.assert_allclose(float(got.detach()), float(full.detach()),
                               rtol=1e-6)
    # and the gradient through the rematerialised chunks
    g_chunk = torch.autograd.grad(got, th)[0]
    g_full = torch.autograd.grad(full, th)[0]
    torch.testing.assert_close(g_chunk, g_full, rtol=1e-6, atol=1e-7)


def test_long_sequences_take_the_chunked_loss(monkeypatch):
    """At ``CHUNKED_CE_MIN_SEQ`` tokens the loss goes through the chunked
    CE (lowered here to 16 tokens), with the same value."""
    _, _, tm, tp = _pair("llama2-7b")
    b = _t(_batch(tm.cfg, 2, 16, seed=8, mask=True))
    full = tm.loss(tp, b)[0]
    seen = []
    orig = registry.chunked_cross_entropy
    monkeypatch.setattr(registry, "CHUNKED_CE_MIN_SEQ", 16)
    monkeypatch.setattr(registry, "chunked_cross_entropy",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    chunked = tm.loss(tp, b)[0]
    assert seen
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-6)


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_jax(microbatches):
    jm, jp, tm, tp = _pair("llama2-7b")
    cfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jstep = jax.jit(jsteps.make_train_step(
        jm, jadamw.AdamWConfig(**cfg_kw), remat=False,
        microbatches=microbatches))
    tstep = steps.make_train_step(tm, adamw.AdamWConfig(**cfg_kw),
                                  remat=True, microbatches=microbatches)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for i in range(3):
        b = _batch(tm.cfg, 4, 16, seed=10 + i)
        jp, js, jmet = jstep(jp, js, _j(b))
        tp, ts, tmet = tstep(tp, ts, _t(b))
        for k in ("loss", "ppl", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=STEP_TOL, err_msg=f"step {i} {k}")
    _close_trees(tp, jp, STEP_TOL, "params ")
    _close_trees(ts.mu, js.mu, STEP_TOL, "mu ")
    assert int(ts.step) == int(js.step) == 3


def test_eval_step_matches_jax():
    jm, jp, tm, tp = _pair("llama2-7b")
    b = _batch(tm.cfg, 2, 16, seed=20)
    L = tm.cfg.n_layers
    g = np.array([1.0, 0.0] + [1.0] * (2 * L - 2), np.float32)
    for gates in (None, g):
        jg = None if gates is None else {"mixer": jnp.asarray(gates[:L]),
                                         "ffn": jnp.asarray(gates[L:])}
        tg = None if gates is None else {
            "mixer": torch.from_numpy(gates[:L]),
            "ffn": torch.from_numpy(gates[L:])}
        want = jax.jit(jsteps.make_eval_step(jm))(jp, _j(b), jg)
        got = steps.make_eval_step(tm)(tp, _t(b), tg)
        for k in ("loss", "ppl"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=STEP_TOL)
            assert not got[k].requires_grad
