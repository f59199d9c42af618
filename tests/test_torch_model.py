"""The port's decoder against the JAX package's, at f32 on the CPU.

The same JAX-initialised weights (carried over with ``repro_torch.bridge``)
and the same numpy tokens go through both: full-sequence logits, prefill
logits and cache, the teacher-forced loss (max |Δ| ≤ 1e-4), the logits of
one paged decode step under per-row ``[L, B]`` gates holding zeros, and the
greedy tokens of a paged decode horizon (equal). Within the port, horizons
of 1, 4 and 8 steps emit the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import decoder as jdec
from repro.models import registry as jreg
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import decoder, registry

torch.set_num_threads(1)

TOL = 1e-4
PT = 8            # tokens per page


@pytest.fixture(scope="module", params=[2, 4], ids=["smoke2L", "smoke4L"])
def pair(request):
    """(jax model, jax params, port model, port params) at n_layers."""
    L = request.param
    jcfg = jax_smoke("llama2-7b").replace(n_layers=L)
    jm = jreg.build(jcfg)
    jp = jm.init(jax.random.key(L))
    tm = registry.build(get_smoke_config("llama2-7b").replace(n_layers=L))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _gates(L, B, seed):
    """[L, B] gates with zeros in every column but the first."""
    g = np.ones((2, L, B), np.float32)
    rng = np.random.default_rng(seed)
    for b in range(1, B):
        g[rng.integers(0, 2), rng.integers(0, L), b] = 0.0
    return g


def test_bridge_keeps_the_jax_layout(pair):
    jm, jp, _, tp = pair
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_forward_logits(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 2, 24)
    want = np.asarray(jm.logits(jp, {"tokens": jnp.asarray(toks)}))
    got = tm.logits(tp, {"tokens": torch.from_numpy(toks)}).numpy()
    assert got.shape == want.shape == (2, 24, tm.cfg.vocab_padded)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_prefill_logits_and_cache(pair):
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 2, 20, seed=1)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 24)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][k].numpy(),
                                   np.asarray(jc["attn"][k]), atol=TOL,
                                   rtol=0)


@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_loss(pair, gated):
    jm, jp, tm, tp = pair
    L = tm.cfg.n_layers
    toks = _tokens(tm.cfg, 2, 16, seed=2)
    mask = np.ones(2 * L, np.float32)
    if gated:
        mask[[0, L + L - 1]] = 0.0
    jl, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(toks)},
                    gates={"mixer": jnp.asarray(mask[:L]),
                           "ffn": jnp.asarray(mask[L:])})
    tl, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(toks)},
                    gates={"mixer": torch.from_numpy(mask[:L]),
                           "ffn": torch.from_numpy(mask[L:])})
    assert abs(float(tl) - float(jl)) <= TOL


def _paged_state(jm, jp, toks, n_pages):
    """Prefill ``toks`` with JAX and lay its KV into a shuffled page pool:
    (pools, table, pos, first tokens) as numpy."""
    B, S = toks.shape
    cfg = jm.cfg
    npg = -(-(S + 8) // PT)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, npg * PT)
    table = np.random.default_rng(3).permutation(n_pages)[: B * npg]
    table = table.reshape(B, npg).astype(np.int32)
    shape = (cfg.n_layers, n_pages, PT, cfg.n_kv_heads, cfg.dh)
    pools = {}
    for k in ("k", "v"):
        pool = np.random.default_rng(4).standard_normal(shape).astype(
            np.float32)
        kv = np.asarray(cache["attn"][k]).reshape(
            cfg.n_layers, B, npg, PT, cfg.n_kv_heads, cfg.dh)
        pool[:, table] = kv
        pools[k] = pool
    pos = np.full((B,), S, np.int32)
    first = np.array(jnp.argmax(logits, -1), np.int32)[:, None]
    return pools, table, pos, first


def test_paged_decode_step_logits_under_gates(pair):
    jm, jp, tm, tp = pair
    L = tm.cfg.n_layers
    toks = _tokens(tm.cfg, 3, 13, seed=5)
    pools, table, pos, first = _paged_state(jm, jp, toks, 3 * 4 + 2)
    g = _gates(L, 3, seed=6)
    jl, jpools = jdec.paged_decode_step(
        jp, jm.cfg, {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(first),
        gates={"mixer": jnp.asarray(g[0]), "ffn": jnp.asarray(g[1])})
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    tl = decoder.paged_decode_step(
        tp, tm.cfg, tpools, torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(first),
        gates={"mixer": torch.from_numpy(g[0]), "ffn": torch.from_numpy(g[1])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    for k in ("k", "v"):      # the appended token landed in place
        np.testing.assert_allclose(tpools[k].numpy(), np.asarray(jpools[k]),
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("H", [6, 16], ids=["within", "past_table"])
def test_paged_decode_horizon_tokens_match_jax(pair, H):
    """H=16 runs 3 positions past the 24-token table width: the write
    clamps to the row's last page and attention stops at the table width,
    as JAX's gather does."""
    jm, jp, tm, tp = pair
    L = tm.cfg.n_layers
    toks = _tokens(tm.cfg, 2, 11, seed=7)
    pools, table, pos, first = _paged_state(jm, jp, toks, 2 * 3 + 1)
    g = _gates(L, 2, seed=8)
    jt, _, jpos = jdec.paged_decode_horizon(
        jp, jm.cfg, {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(table), jnp.asarray(pos), jnp.asarray(first), H,
        gates={"mixer": jnp.asarray(g[0]), "ffn": jnp.asarray(g[1])})
    tt, _, tpos = decoder.paged_decode_horizon(
        tp, tm.cfg, {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(first), H,
        gates={"mixer": torch.from_numpy(g[0]), "ffn": torch.from_numpy(g[1])})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("H", [1, 4])
def test_horizon_length_is_unobservable(pair, H):
    """8 tokens as 8/H horizons of H steps == one horizon of 8."""
    jm, jp, tm, tp = pair
    toks = _tokens(tm.cfg, 2, 9, seed=9)
    pools, table, pos, first = _paged_state(jm, jp, toks, 2 * 3 + 1)
    args = (torch.from_numpy(table),)

    def run(h):
        tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
        p, tok, out = torch.from_numpy(pos), torch.from_numpy(first), []
        for _ in range(8 // h):
            t, tpools, p = decoder.paged_decode_horizon(tp, tm.cfg, tpools,
                                                        *args, p, tok, h)
            out.append(t)
            tok = t[:, -1:]
        return torch.cat(out, dim=1)

    np.testing.assert_array_equal(run(H).numpy(), run(8).numpy())


def test_gate_zero_drops_the_block(pair):
    """A 0 gate leaves the residual stream exactly as if the block were
    skipped: gating layer 0's mixer off for row 1 only changes row 1."""
    _, _, tm, tp = pair
    L = tm.cfg.n_layers
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 12, seed=10))
    g = torch.ones(2, L, 2)
    dense, _ = decoder.forward(tp, tm.cfg, toks)
    g[0, 0, 1] = 0.0
    gated, _ = decoder.forward(tp, tm.cfg, toks,
                               gates={"mixer": g[0], "ffn": g[1]})
    torch.testing.assert_close(gated[0], dense[0], atol=0, rtol=0)
    assert (gated[1] - dense[1]).abs().max() > 1e-3


def test_other_architectures_are_later_slices():
    """Every architecture is ported (the MoE and encoder-decoder ones
    last), and so is multi-GPU serving: ``--executor sharded`` serves in
    masked mode on a mesh ('auto': 1 x 1 in a world of one), and in
    structural mode it refuses naming the ROADMAP, as JAX's does."""
    from repro_torch.launch import serve
    assert get_smoke_config("olmoe-1b-7b").n_experts == 8
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--smoke", "--device", "cpu", "--executor", "sharded"])
    engine, rep = serve.main(["--smoke", "--device", "cpu", "--executor",
                              "sharded", "--mode", "masked", "--mesh", "auto",
                              "--requests", "2", "--arch", "olmoe-1b-7b"])
    assert {r.status for r in rep.results} == {"done"}
    assert engine.executor.mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(KeyError):
        get_smoke_config("no-such-arch")