"""The executors' one-call decode surfaces, and ``serve --chunked-prefill``,
against the JAX package on the CPU.

``ModelExecutor.decode_horizon(group, H)`` / ``decode(group)`` on both
executors and ``SlotGroup.decode_horizon(H, buckets)`` /
``decode_once(buckets)`` have JAX's names, arguments and ``(tokens, new)``
pair; the port compiles no per-bucket executable, so ``new`` is False. The
tiny llama2 model of ``tests/conftest.py`` (4 layers, JAX-initialised
weights carried over by ``repro_torch.bridge``):

* twins of ``tests/test_horizon.py``'s warm-horizon tests and of
  ``tests/test_executors.py::test_bucket_quantization_bitwise_and_bounded``,
  driving the port's executors through ``decode_horizon`` against JAX's
  (tokens equal);
* ``decode(g)`` is ``decode_horizon(g, 1)[0][:, 0]``, and
  ``decode_horizon(g, H)`` is ``decode_finish(decode_launch(g, H))``;
* H in {1, 4, 8} is unobservable through ``decode_horizon`` on both
  executors (DESIGN.md §5);
* ``launch.serve --chunked-prefill`` caps chunks at 64 tokens unless
  ``--max-prefill-tokens`` is given: the same tokens and stats as
  ``--max-prefill-tokens 64``, and the same masks, tokens and pool peak as
  JAX's ``repro.launch.serve --chunked-prefill`` on the same arguments.
"""
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.runtime import KVPool as JaxKVPool
from repro.runtime import LocalExecutor as JaxLocalExecutor
from repro.runtime import PagedExecutor as JaxPagedExecutor
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core import masks
from repro_torch.models import registry
from repro_torch.runtime import KVPool, LocalExecutor, PagedExecutor

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair(tiny_model):
    """(jax model, jax params, port model, port params, prompt [1, 16])."""
    jm, jp, batch = tiny_model
    tm = registry.build(get_smoke_config("llama2-7b").replace(
        n_layers=jm.cfg.n_layers))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp, np.array(batch["tokens"])[:1, :16]


def _paged(ex, pool_cls, rid="r0", max_tokens=64):
    """Bind a 16-page pool of 8-token pages and admit ``rid`` (16 prompt
    tokens, up to ``max_tokens``)."""
    page_bytes = ex.page_phys_bytes(8)
    pool = pool_cls(16 * page_bytes, page_bytes=page_bytes,
                    tokens_per_page=8)
    ex.bind_pool(pool, max_len=64)
    pool.alloc_tokens(rid, 1, 16, max_tokens=max_tokens)
    return pool


def _executors(pair, kind, **kw):
    """JAX's and the port's executor of ``kind``, each with a bound pool
    when paged; returns (jax executor, port executor)."""
    jm, jp, tm, tp, _ = pair
    if kind == "local":
        return (JaxLocalExecutor(jm, jp, max_active=4, **kw),
                LocalExecutor(tm, tp, max_active=4, **kw))
    jex = JaxPagedExecutor(jm, jp, max_active=4, **kw)
    tex = PagedExecutor(tm, tp, max_active=4, **kw)
    _paged(jex, JaxKVPool)
    _paged(tex, KVPool)
    return jex, tex


# ------------------------------------------ twins of tests/test_horizon.py
@pytest.mark.parametrize("kind", ["local", "paged"])
def test_warm_horizon_matches_jax(pair, kind):
    """``tests/test_horizon.py::test_{local,paged}_horizon_zero_transfers
    _when_warm`` on the port: a warming ``decode_horizon(group, 4)``, then a
    second launch of the bucket of width 1 (slot 0 alone); both give JAX's
    tokens, and ``new`` is False."""
    jm, jp, tm, tp, prompt = pair
    full = masks.full_mask(tm.cfg.n_layers)
    jex, tex = _executors(pair, kind)
    outs = []
    for ex in (jex, tex):
        g = ex.group_for(full, 32)
        first = ex.prefill_into(g, [0], "r0", prompt, full)
        warm, new = ex.decode_horizon(g, 4)
        if ex is tex:
            assert new is False
        if kind == "local":
            toks_dev, idx = (g.launch_horizon(4, ex.decode_buckets)[:2])
        else:
            ex.pre_extend_horizon(g, 4)
            toks_dev, idx = ex.launch_horizon(g, 4)[:2]
        assert idx == [0]
        toks = np.asarray(toks_dev)
        assert toks.shape == (1, 4)
        outs.append(np.concatenate([first, warm[0], toks[0]]))
    np.testing.assert_array_equal(outs[1], outs[0])


# -------------------------------------- twin of tests/test_executors.py:763
def _drop_layer(cfg, *layers):
    m = masks.full_mask(cfg.n_layers)
    for i in layers:
        m[i] = m[cfg.n_layers + i] = False
    return m


def test_bucket_quantization_bitwise_and_bounded_matches_jax(pair):
    """Every trial mask served through a pow2-quantized bucket through
    ``decode_horizon`` emits the stream of its exact structural bucket and
    JAX's stream for the same mask; the signatures collapse onto the pow2
    ladder ({4, 2}-layer buckets for 5 masks), as in JAX."""
    jm, jp, tm, tp, prompt = pair
    L = tm.cfg.n_layers
    trial = [_drop_layer(tm.cfg, 0), _drop_layer(tm.cfg, 1),
             _drop_layer(tm.cfg, 3), _drop_layer(tm.cfg, 0, 1)]
    half = masks.full_mask(L)
    half[L + 2] = False                      # ffn-only drop: gated in both
    trial.append(half)
    streams, stats = {}, {}
    for pkg, make in (("jax", lambda q: JaxLocalExecutor(
            jm, jp, mode="structural", max_active=2, bucket_quant=q)),
                      ("port", lambda q: LocalExecutor(
            tm, tp, mode="structural", max_active=2, bucket_quant=q))):
        for quant in ("none", "pow2"):
            ex = make(quant)
            out = []
            for i, m in enumerate(trial):
                g = ex.group_for(m, 32)
                first = ex.prefill_into(g, [0], f"r{i}", prompt, m)
                toks, new = ex.decode_horizon(g, 4)
                g.evict([0])
                out.append(np.concatenate([first, toks[0]]))
            streams[pkg, quant] = out
            stats[pkg, quant] = ex.stats()
    for i in range(len(trial)):
        for key in (("port", "pow2"), ("jax", "none"), ("jax", "pow2")):
            np.testing.assert_array_equal(
                streams["port", "none"][i], streams[key][i],
                err_msg=f"trial mask {i}: {key}")
    bound = int(np.ceil(np.log2(L))) + 1
    for field in ("bucket_signatures", "groups", "structural_buckets"):
        for quant in ("none", "pow2"):
            assert (stats["port", quant][field]
                    == stats["jax", quant][field]), (field, quant)
    assert stats["port", "pow2"]["bucket_signatures"] <= bound
    assert stats["port", "pow2"]["bucket_signatures"] == 2
    assert stats["port", "pow2"]["groups"] == 2
    assert stats["port", "none"]["groups"] == len(trial)


# ------------------------------------------------------- the one-call pair
def _seated(pair, kind, n=2):
    """The port's executor of ``kind`` with ``n`` requests seated in slots
    0..n-1 of the full-mask group (prompt rows varied per request)."""
    _, _, tm, tp, prompt = pair
    full = masks.full_mask(tm.cfg.n_layers)
    ex = (LocalExecutor(tm, tp, max_active=4) if kind == "local"
          else PagedExecutor(tm, tp, max_active=4))
    if kind == "paged":
        pool = _paged(ex, KVPool, "r0")
        for i in range(1, n):
            pool.alloc_tokens(f"r{i}", 1, 16, max_tokens=64)
    g = ex.group_for(full, 48)
    for i in range(n):
        p = prompt.copy()
        p[0, 3] = 5 + i
        ex.prefill_into(g, [i], f"r{i}", p, full)
    return ex, g


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_decode_is_decode_horizon_of_one(pair, kind):
    ex_a, g_a = _seated(pair, kind)
    ex_b, g_b = _seated(pair, kind)
    for _ in range(3):
        one, new = ex_a.decode(g_a)
        toks, _ = ex_b.decode_horizon(g_b, 1)
        assert new is False and one.shape == (4,)
        np.testing.assert_array_equal(one, toks[:, 0])
    assert list(g_a.pos[:2]) == list(g_b.pos[:2]) == [19, 19]


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_decode_horizon_is_launch_then_finish(pair, kind):
    ex_a, g_a = _seated(pair, kind)
    ex_b, g_b = _seated(pair, kind)
    for h in (4, 2):
        got, new = ex_a.decode_horizon(g_a, h)
        want = ex_b.decode_finish(ex_b.decode_launch(g_b, h))
        assert new is False and got.shape == (4, h)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g_a.pos, g_b.pos)


@pytest.mark.parametrize("kind", ["local", "paged"])
def test_horizon_length_is_unobservable_through_decode_horizon(pair, kind):
    """8 tokens as 8 x 1, 2 x 4 and 1 x 8 through ``decode_horizon``: the
    same tokens on both seated rows (DESIGN.md §5)."""
    outs = {}
    for h in (1, 4, 8):
        ex, g = _seated(pair, kind)
        outs[h] = np.concatenate([ex.decode_horizon(g, h)[0][:2]
                                  for _ in range(8 // h)], axis=1)
    for h in (4, 8):
        np.testing.assert_array_equal(outs[h], outs[1], err_msg=f"H={h}")


def test_slot_group_decode_horizon_and_once_match_jax(pair):
    """``SlotGroup.decode_horizon(H, buckets)`` / ``decode_once(buckets)``:
    JAX's tokens on the occupied slots, unstepped rows zero, the host
    positions moved, ``new`` False; ``decode_once`` is the horizon of
    one."""
    jm, jp, tm, tp, prompt = pair
    full = masks.full_mask(tm.cfg.n_layers)
    jfull = jmasks.full_mask(jm.cfg.n_layers)
    jex, tex = _executors(pair, "local")
    jg, tg = jex.group_for(jfull, 32), tex.group_for(full, 32)
    for ex, g, m in ((jex, jg, jfull), (tex, tg, full)):
        ex.prefill_into(g, [1], "r1", prompt, m)
    for buckets in ((), (1, 2)):
        jt, _ = jg.decode_horizon(3, buckets)
        tt, new = tg.decode_horizon(3, buckets)
        assert new is False and tt.shape == (4, 3)
        np.testing.assert_array_equal(tt[1], np.asarray(jt)[1])
        if buckets:
            assert not tt[[0, 2, 3]].any()
        jo, _ = jg.decode_once(buckets)
        to, new = tg.decode_once(buckets)
        assert new is False and to.shape == (4,)
        assert to[1] == np.asarray(jo)[1]
    assert tg.pos[1] == 16 + 2 * (3 + 1)
    assert tg.pos[0] == 0


# ------------------------------------------------- serve --chunked-prefill
SERVE_ARGV = ["--smoke", "--requests", "3", "--max-new", "4", "--policy",
              "dense", "--mode", "masked", "--executor", "paged"]


def _port_serve(argv):
    from repro_torch.launch import serve
    return serve.main(argv + ["--device", "cpu"])


def test_chunked_prefill_caps_chunks_at_64(monkeypatch):
    """``--chunked-prefill`` is ``--max-prefill-tokens 64``: the same
    engine cap, tokens and stats; ``--max-prefill-tokens`` overrides the
    cap."""
    chunks = []
    step = PagedExecutor.prefill_step

    def counted(self, task):
        chunks.append(task.widths[task.step])
        return step(self, task)
    monkeypatch.setattr(PagedExecutor, "prefill_step", counted)
    eng, rep = _port_serve(SERVE_ARGV + ["--chunked-prefill"])
    assert max(chunks) == 64 and len(chunks) > len(rep.results)
    eng64, rep64 = _port_serve(SERVE_ARGV + ["--max-prefill-tokens", "64"])
    eng16, _ = _port_serve(SERVE_ARGV + ["--chunked-prefill",
                                         "--max-prefill-tokens", "16"])
    assert eng.cfg.max_prefill_tokens == eng64.cfg.max_prefill_tokens == 64
    assert eng16.cfg.max_prefill_tokens == 16
    want = {r.rid: r for r in rep64.results}
    assert {r.status for r in rep.results} == {"done"}
    for r in rep.results:
        np.testing.assert_array_equal(r.tokens, want[r.rid].tokens)
        np.testing.assert_array_equal(r.mask, want[r.rid].mask)
    for key in ("peak_reserved_bytes", "n_pages", "overcommit_events"):
        assert rep.pool[key] == rep64.pool[key], key
    assert rep.decode_iters == rep64.decode_iters
    assert rep.generated_tokens == rep64.generated_tokens


def test_chunked_prefill_serve_matches_jax(monkeypatch):
    """JAX's ``repro.launch.serve --chunked-prefill`` and the port's on the
    same arguments and weights (JAX's seed-0 init, carried over by
    ``bridge`` into the port's model): the same requests, masks, tokens and
    pool peak (JAX's report read off its ``RAPEngine.run``)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import serve as jserve
    from repro.models import registry as jreg
    from repro.runtime import RAPEngine as JaxRAPEngine
    jp = jreg.build(jax_smoke("llama2-7b")).init(jax.random.key(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    build = registry.build
    monkeypatch.setattr(registry, "build", lambda cfg: build(cfg)._replace(
        init=lambda seed=0, device="cuda": tp))
    got = {}
    run = JaxRAPEngine.run

    def recorded(self, *a, **kw):
        got["rep"] = run(self, *a, **kw)
        got["cap"] = self.cfg.max_prefill_tokens
        return got["rep"]
    monkeypatch.setattr(JaxRAPEngine, "run", recorded)
    monkeypatch.setattr(sys, "argv", ["serve"] + SERVE_ARGV
                        + ["--chunked-prefill"])
    jserve.main()
    jrep = got["rep"]
    eng, rep = _port_serve(SERVE_ARGV + ["--chunked-prefill"])
    assert got["cap"] == eng.cfg.max_prefill_tokens == 64
    want = {r.rid: r for r in jrep.results}
    assert set(want) == {r.rid for r in rep.results}
    for r in rep.results:
        assert r.status == want[r.rid].status == "done"
        np.testing.assert_array_equal(r.mask, want[r.rid].mask)
        np.testing.assert_array_equal(r.tokens, want[r.rid].tokens)
    for key in ("peak_reserved_bytes", "n_pages", "overcommit_events"):
        assert rep.pool[key] == jrep.pool[key], key
