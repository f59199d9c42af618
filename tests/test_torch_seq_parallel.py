"""Sequence parallelism of the PyTorch port on gloo worlds on the CPU.

Worlds are ``test_torch_mesh_model.run_world``'s (spawned, a ``FileStore``
under the test's temporary directory, 60 s collective timeouts, a 90 s
deadline, one thread a child); the JAX references run in this process on
the same (bridged) SMOKE weights, in f32.

* The decode step on a cache in the layout of ``cache_pspecs`` (every KV
  head on each rank, the sequence cut over "model"), on (1, 2) and (1, 4)
  worlds: decode logits within 1e-5 of JAX's ``make_decode_step`` and of
  the single process on the same cache, with the position in the first
  block (the others empty) and in the last; the written cache equal to the
  single process's; every rank's logits bitwise alike. llama2-7b,
  qwen3-14b (K < m on four ranks), qwen1.5-32b on an int8 cache, gemma-2b
  (one KV head), recurrentgemma-9b (its whole-width RG-LRU state beside
  weights cut over "model").
* ``shard_seq`` on a (2, 1) world: recurrentgemma-9b's local-attention
  ring and RG-LRU width, and mamba2-370m's SSD heads, over the data axis,
  one row decoded for three steps against JAX's ``decode_step``.
* Megatron sequence parallelism on the (1, 2) world at S = 2048: logits,
  loss and every gradient leaf (gathered whole) of llama2-7b,
  recurrentgemma-9b, olmoe-1b-7b and whisper-medium (its decoder's stream)
  against the single process (1e-5) and JAX's logits (1e-5; olmoe and
  whisper 1e-4, ``tests/test_torch_moe.py``'s and
  ``test_torch_encdec.py``'s tolerance for their logits across
  frameworks); the stream really cut (reduce-scatters counted); at S = 2040
  the path is the old one, bit for bit.
* ``decode_attention(..., return_lse=True)``: the plain version against
  the Pallas kernel (interpret mode) and a numpy log-sum-exp; the CUDA
  kernel against the plain version (``cuda``-marked: skips here).
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_mesh_model import run_world

TOL = 1e-5
MAX_LEN = 256                 # 2 blocks of 128 on (1, 2), 4 of 64 on (1, 4)
LONG = 250                    # a prompt whose next position is in the last
FIRST = 5                     # ... and one in the first block
PART_A = ("llama2-7b", "qwen3-14b", "qwen1.5-32b", "gemma-2b",
          "recurrentgemma-9b")
PART_A4 = ("llama2-7b", "qwen3-14b", "qwen1.5-32b", "gemma-2b")
INT8 = ("qwen1.5-32b",)
PART_B = ("recurrentgemma-9b", "mamba2-370m")
PART_C = ("llama2-7b", "recurrentgemma-9b", "olmoe-1b-7b",
          "whisper-medium")
SP_LEN, NO_SP_LEN = 2048, 2040
# f32 logits across frameworks at 2048 positions: test_torch_moe.py's and
# test_torch_encdec.py's tolerance
JAX_TOL = {"olmoe-1b-7b": 1e-4, "whisper-medium": 1e-4}

torch.set_num_threads(1)


# ---------------------------------------------------------------- JAX side
@functools.lru_cache(maxsize=None)
def _jax(arch):
    """(JAX model, JAX params, the params as numpy) of ``arch``'s SMOKE."""
    import jax

    from repro.configs import get_smoke_config
    from repro.models import registry as jreg
    jm = jreg.build(get_smoke_config(arch))
    jp = jax.jit(jm.init)(jax.random.key(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _tokens(n, B, S, seed):
    return np.random.default_rng(seed).integers(0, n, (B, S)).astype(
        np.int32)


def _batch(cfg, S):
    """The Part C batch as numpy: tokens (labels the same) and, for an
    encoder-decoder, random frames."""
    toks = _tokens(cfg.vocab_size, 1, S, 5)
    out = {"tokens": toks, "labels": toks}
    if cfg.is_encoder_decoder:
        out["frames"] = np.random.default_rng(6).standard_normal(
            (1, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def _truncated(cache, pos):
    """A prefilled attention cache cut back to ``pos`` tokens: the slots
    past it zeroed (causal: the first ``pos`` slots are what a prompt of
    ``pos`` tokens leaves)."""
    out = {k: ({n: v.copy() for n, v in c.items()} if isinstance(c, dict)
               else c) for k, c in cache.items()}
    out["attn"] = {n: v.copy() for n, v in cache["attn"].items()}
    for v in out["attn"].values():
        v[:, :, pos:] = 0
    out["pos"] = np.asarray(pos, np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _part_a_cases(arch):
    """[(cache as numpy, token [B,1], JAX decode logits)] at a position in
    the first block and one in the last."""
    import jax
    import jax.numpy as jnp

    from repro.runtime import steps as jsteps
    jm, jp, _ = _jax(arch)
    cfg = jm.cfg
    toks = _tokens(cfg.vocab_size, 2, LONG, 3)
    kv = jnp.int8 if arch in INT8 else None
    logits, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, MAX_LEN, kv_dtype=kv))(jp, {"tokens": jnp.asarray(toks)})
    cache = _np_tree(cache)
    tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
    step = jax.jit(jsteps.make_decode_step(jm))
    cases = [cache]
    if arch != "recurrentgemma-9b":   # its state is not a prefix
        cases.insert(0, _truncated(cache, FIRST))
    out = []
    for c in cases:
        lg, _ = step(jp, jax_tree(c), jnp.asarray(tok))
        out.append((c, tok, np.asarray(lg)))
    return out


def jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------ Part A: the worlds
def _torch_cache(c):
    from repro_torch.tree import flatten, unflatten
    return unflatten(c, {k: (int(v) if k == "pos" else
                             torch.from_numpy(np.array(v)))
                         for k, v in flatten(c).items()})


def _part_a_body(rank, world, cases):
    """Each (arch, case): the decode step on this rank's block of the cache
    vs the single process on the whole cache."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import decoder
    from repro_torch.parallel import activation as act
    from repro_torch.parallel import sharding, tp
    from repro_torch.tree import flatten
    mesh = Mesh((1, world), ("data", "model"), "cpu")
    out = {}
    for arch, (params_np, items) in cases.items():
        cfg = get_smoke_config(arch)
        params = params_from_numpy(params_np, "cpu")
        local = sharding.shard_params(params, sharding.param_pspecs(
            params, mesh), mesh, mesh.coords, cfg)
        res = []
        for cache_np, tok in items:
            whole = _torch_cache(cache_np)
            cspecs = sharding.cache_pspecs(whole, mesh, batch=2)
            mine = decoder.local_cache(_torch_cache(cache_np), cspecs, mesh)
            tok = torch.from_numpy(tok)
            with torch.no_grad():
                ref, ref_cache = decoder.decode_step(params, cfg, whole, tok)
                with act.use(mesh, cache_specs=cspecs):
                    lg, new = decoder.decode_step(local, cfg, mine, tok)
            new = flatten(tp.gather_tree(new, cspecs, mesh, cfg))
            cut = sharding.spec_at(cspecs, "attn/k" if "attn" in whole
                                   else "local_attn/k")
            res.append(dict(
                logits=lg.numpy(), err=float((lg - ref).abs().max()),
                cache_err=max(float((new[k].float() - v.float()).abs().max())
                              for k, v in flatten(ref_cache).items()
                              if torch.is_tensor(v)),
                seq_cut=cut[2] if len(cut) > 2 else None))
        out[arch] = res
    return out


def _part_a_inputs(archs):
    return {a: (_jax(a)[2], [(c, t) for c, t, _ in _part_a_cases(a)])
            for a in archs}


def _check_part_a(out, archs, world):
    for arch in archs:
        want = [lg for _, _, lg in _part_a_cases(arch)]
        for rank in out:
            for r, w in zip(rank[arch], want):
                assert r["err"] <= TOL and r["cache_err"] <= TOL, (arch, r)
                np.testing.assert_allclose(r["logits"], w, atol=TOL,
                                           rtol=TOL, err_msg=arch)
                if arch != "recurrentgemma-9b":   # a ring of 16 stays whole
                    assert r["seq_cut"] == "model"
            for r, r0 in zip(rank[arch], out[0][arch]):
                np.testing.assert_array_equal(r["logits"], r0["logits"])
    assert len(out) == world


def _world_12_body(rank, world, cases, weights):
    return (_part_a_body(rank, world, cases),
            _part_c_body(rank, world, weights))


@pytest.fixture(scope="module")
def world_12(tmp_path_factory):
    """The (1, 2) world: Part A, then Part C, in one world."""
    out = run_world(_world_12_body, 2, tmp_path_factory.mktemp("w12"),
                    _part_a_inputs(PART_A), {x: _jax(x)[2] for x in PART_C})
    return [o[0] for o in out], [o[1] for o in out]


@pytest.mark.parametrize("arch", PART_A)
def test_seq_cut_decode_matches_jax_on_two_ranks(world_12, arch):
    _check_part_a(world_12[0], (arch,), 2)


def test_seq_cut_decode_matches_jax_on_four_ranks(tmp_path):
    out = run_world(_part_a_body, 4, tmp_path, _part_a_inputs(PART_A4))
    _check_part_a(out, PART_A4, 4)


# ----------------------------------------------------- Part B: shard_seq
def _part_b_body(rank, world, cases):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import decoder
    from repro_torch.parallel import activation as act
    from repro_torch.parallel import sharding
    mesh = Mesh((world, 1), ("data", "model"), "cpu")
    out = {}
    for arch, (params_np, cache_np, toks) in cases.items():
        cfg = get_smoke_config(arch)
        params = params_from_numpy(params_np, "cpu")
        whole = _torch_cache(cache_np)
        cspecs = sharding.cache_pspecs(whole, mesh, batch=1, shard_seq=True)
        cache = decoder.local_cache(whole, cspecs, mesh)
        logits = []
        with torch.no_grad(), act.use(mesh, shard_seq=True,
                                      cache_specs=cspecs):
            for t in toks:
                lg, cache = decoder.decode_step(params, cfg, cache,
                                                torch.from_numpy(t))
                logits.append(lg.numpy())
        out[arch] = dict(logits=logits, specs={
            k: tuple(sharding.spec_at(cspecs, k)) for k in
            ("rglru/h", "local_attn/k", "ssd/state", "ssd/conv")
            if k.split("/")[0] in whole})
    return out


@functools.lru_cache(maxsize=None)
def _part_b_case(arch):
    """A one-row prompt of 20 (past recurrentgemma's window of 16), then
    three JAX decode steps: (cache, the fed tokens, their logits)."""
    import jax
    import jax.numpy as jnp

    from repro.runtime import steps as jsteps
    jm, jp, _ = _jax(arch)
    toks = _tokens(jm.cfg.vocab_size, 1, 20, 11)
    logits, cache = jax.jit(lambda p, b: jm.prefill(p, b, 64))(
        jp, {"tokens": jnp.asarray(toks)})
    cache0 = _np_tree(cache)
    step = jax.jit(jsteps.make_decode_step(jm))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    fed, want = [], []
    for _ in range(3):
        fed.append(np.asarray(tok))
        lg, cache = step(jp, cache, tok)
        want.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
    return cache0, fed, want


def test_shard_seq_decode_matches_jax(tmp_path):
    cases = {a: (_jax(a)[2],) + _part_b_case(a)[:2] for a in PART_B}
    out = run_world(_part_b_body, 2, tmp_path, cases)
    assert out[0]["recurrentgemma-9b"]["specs"]["rglru/h"] == (
        None, None, "data")
    assert out[0]["recurrentgemma-9b"]["specs"]["local_attn/k"] == (
        None, None, "data", None, None)
    assert out[0]["mamba2-370m"]["specs"]["ssd/state"] == (
        None, None, "data", None, None)
    assert out[0]["mamba2-370m"]["specs"]["ssd/conv"] == ()   # 3 taps
    for arch in PART_B:
        want = _part_b_case(arch)[2]
        for rank in out:
            for got, w in zip(rank[arch]["logits"], want):
                np.testing.assert_allclose(got, w, atol=TOL, rtol=TOL,
                                           err_msg=arch)
            for got, g0 in zip(rank[arch]["logits"], out[0][arch]["logits"]):
                np.testing.assert_array_equal(got, g0)


# -------------------------------------------- Part C: Megatron SP, S >= 2048
def _part_c_body(rank, world, weights):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import registry
    from repro_torch.parallel import activation as act
    from repro_torch.parallel import sharding, tp
    from repro_torch.runtime import steps
    from repro_torch.tree import flatten
    mesh = Mesh((1, world), ("data", "model"), "cpu")
    calls = [0]
    rs = tp._reduce_scatter

    def counted(*a):
        calls[0] += 1
        return rs(*a)
    tp._reduce_scatter = counted
    out = {}
    for arch, params_np in weights.items():
        cfg = get_smoke_config(arch)
        model = registry.build(cfg)
        params = params_from_numpy(params_np, "cpu")
        specs = sharding.param_pspecs(params, mesh)
        local = sharding.shard_params(params, specs, mesh, mesh.coords, cfg)
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg,
                                                            SP_LEN).items()}
        with torch.no_grad():
            ref = model.logits(params, batch)
        ref_loss, _, ref_g = steps.loss_and_grads(model, params, batch)
        calls[0] = 0
        with act.use(mesh):
            with torch.no_grad():
                lg = model.logits(local, batch)
            loss, _, grads = steps.loss_and_grads(model, local, batch)
        scatters = calls[0]
        whole = flatten(tp.gather_tree(grads, specs, mesh, cfg))
        short = {k: v[:, :NO_SP_LEN] if k == "tokens" else v
                 for k, v in batch.items() if k != "labels"}
        with torch.no_grad(), act.use(mesh):
            a = model.logits(local, short)
            floor, act.SEQ_SHARD_MIN = act.SEQ_SHARD_MIN, 10 ** 9
            try:
                b = model.logits(local, short)
            finally:
                act.SEQ_SHARD_MIN = floor
        out[arch] = dict(
            logits=lg.numpy(), err=float((lg - ref).abs().max()),
            loss_err=abs(float(loss - ref_loss)),
            grad_err={k: float((whole[k].float() - v.float()).abs().max())
                      for k, v in flatten(ref_g).items()},
            scatters=scatters, short_bitwise=bool(torch.equal(a, b)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_logits(arch):
    import jax
    import jax.numpy as jnp
    jm, jp, _ = _jax(arch)
    batch = _batch(jm.cfg, SP_LEN)
    del batch["labels"]
    return np.asarray(jax.jit(jm.logits)(jp, {k: jnp.asarray(v)
                                             for k, v in batch.items()}))


@pytest.mark.parametrize("arch", PART_C)
def test_megatron_sp_forward_and_grads(world_12, arch):
    out = world_12[1]
    for rank in out:
        r = rank[arch]
        assert r["scatters"] > 0            # the stream was cut along S
        assert r["err"] <= TOL and r["loss_err"] <= TOL, r
        bad = {k: e for k, e in r["grad_err"].items() if e > TOL}
        assert not bad, bad
        tol = JAX_TOL.get(arch, TOL)
        np.testing.assert_allclose(r["logits"], _jax_logits(arch),
                                   atol=tol, rtol=tol)
        np.testing.assert_array_equal(r["logits"], out[0][arch]["logits"])
        assert r["short_bitwise"]           # below 2048: the old path


def test_seq_sharded_rule():
    from repro_torch.parallel import activation as act

    class M:
        shape = {"data": 2, "model": 4}
    with act.use(M()):
        assert act.seq_sharded(2048) and act.seq_sharded(4096)
        assert not act.seq_sharded(2040) and not act.seq_sharded(2046)
    assert not act.seq_sharded(4096)         # no policy
    M.shape = {"data": 8, "model": 1}
    with act.use(M()):
        assert not act.seq_sharded(4096)     # no model axis


# ----------------------------------------------------------- the LSE output
LSE_CASES = [  # B, H, K, D, S, valid tokens (0: none), softcap
    (2, 8, 2, 32, 80, 50, 0.0), (1, 4, 4, 16, 64, 64, 30.0),
    (2, 4, 1, 64, 96, 0, 0.0)]


def _lse_inputs(B, H, K, D, S, nvalid):
    rng = np.random.default_rng(B * 100 + S)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v, np.arange(S) < nvalid


@pytest.mark.parametrize("B,H,K,D,S,nvalid,cap", LSE_CASES)
def test_plain_lse_matches_pallas_and_numpy(B, H, K, D, S, nvalid, cap):
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro_torch.kernels import decode_attention as dec
    q, k, v, valid = _lse_inputs(B, H, K, D, S, nvalid)
    out, lse = dec.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, valid)), softcap=cap,
        return_lse=True)
    assert lse.shape == (B, H) and lse.dtype == torch.float32
    plain = dec.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v, valid)), softcap=cap)
    if nvalid:
        want = jops.decode_attention(*(jnp.asarray(a) for a in
                                       (q, k, v, valid)), softcap=cap,
                                     block_k=64)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)
        assert torch.equal(out, plain)
    else:
        assert not out.abs().any()
    s = np.einsum("bkgd,bskd->bkgs", q.reshape(B, K, H // K, D)
                  .astype(np.float64), k) / np.sqrt(D)
    if cap:
        s = cap * np.tanh(s / cap)
    s = np.where(valid, s, -np.inf).reshape(B, H, S)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want_lse = (m[..., 0] + np.log(np.exp(s - m).sum(-1))
                    if nvalid else np.full((B, H), -np.inf))
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=2e-5)


def test_combine_partials_is_attention_over_the_whole():
    """Blocks of a cache attended apart and joined equal the whole, an
    empty block included."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.parallel import tp
    q, k, v, _ = _lse_inputs(2, 8, 2, 32, 128, 0)
    valid = np.arange(128) < 40                  # blocks 2, 3 empty
    whole = dec.decode_attention_ref(*(torch.from_numpy(a)
                                       for a in (q, k, v, valid)))
    outs, lses = [], []
    for j in range(4):
        sl = slice(32 * j, 32 * (j + 1))
        o, l = dec.decode_attention_ref(
            torch.from_numpy(q), torch.from_numpy(k[:, sl]),
            torch.from_numpy(v[:, sl]), torch.from_numpy(valid[sl]),
            return_lse=True)
        outs.append(o[:, 0])
        lses.append(l)
    got = tp.combine_partials(torch.stack(outs), torch.stack(lses))
    np.testing.assert_allclose(got.numpy(), whole[:, 0].numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,D,S,nvalid,cap", LSE_CASES)
def test_cuda_lse_matches_plain(cuda, B, H, K, D, S, nvalid, cap, dtype):
    """The kernel's (out f32, lse) against the plain version's, at one
    split and at several; out rounded to the input dtype is the kernel's
    output without the lse, bit for bit."""
    from repro_torch.kernels import decode_attention as dec
    dt = getattr(torch, dtype)
    q, k, v, valid = _lse_inputs(B, H, K, D, S, nvalid)
    args = [torch.from_numpy(a).to(cuda, dt) for a in (q, k, v)] + [
        torch.from_numpy(valid).to(cuda)]
    want, want_lse = dec.decode_attention_ref(*args, softcap=cap,
                                              return_lse=True)
    for split_rows in (0, 64):
        out, lse = dec.decode_attention_cuda(*args, softcap=cap,
                                             split_rows=split_rows,
                                             return_lse=True)
        assert out.dtype == lse.dtype == torch.float32
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=2e-5)
        assert torch.equal(out.to(dt), dec.decode_attention_cuda(
            *args, softcap=cap, split_rows=split_rows))
