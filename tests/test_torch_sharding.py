"""The port's sharding rules, placement, expert-parallel dispatch and int8
quantizer against the JAX package, with no process group.

* ``param_pspecs`` (fsdp off and on), ``cache_pspecs``,
  ``serve_state_pspecs`` and ``serve_slot_pspec`` equal JAX's leaf by
  leaf, for every registered config at full width (shapes only: the
  port's ``init(seed, "meta")``, JAX's ``jax.eval_shape``), on the meshes
  (1, 1), (2, 1), (1, 2), (2, 2), (16, 16) and (2, 16, 16). JAX's rules
  read only ``mesh.shape``, so both sides get a stand-in mesh;
* ``gather_leaf(shard_leaf(x))`` gives ``x`` back bitwise for every leaf
  of every SMOKE model, the fused GLU cut included, and a 1 x 1 mesh
  places without a copy;
* each model rank's ``moe._local_dispatch`` equals JAX's on the same
  expert slice, and the slices' sum equals ``moe_ffn_scatter`` (with
  capacity drops), at olmoe and dbrx SMOKE widths;
* ``compression._quantize`` equals JAX's;
* ``make_production_mesh`` needs 256 / 512 ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.parallel import compression as jcomp
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe, registry
from repro_torch.parallel import compression, sharding
from repro_torch.tree import flatten

torch.set_num_threads(1)

ARCHS = ("llama2-7b", "gemma-2b", "glm4-9b", "qwen3-14b", "qwen1.5-32b",
         "internvl2-1b", "olmoe-1b-7b", "dbrx-132b", "whisper-medium",
         "mamba2-370m", "recurrentgemma-9b")
MESHES = ({"data": 1, "model": 1}, {"data": 2, "model": 1},
          {"data": 1, "model": 2}, {"data": 2, "model": 2},
          {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class _Mesh:
    """What the rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


def _same_specs(jtree, ttree, tshapes, what):
    """JAX's spec tree vs the port's (``tshapes``: the port's leaves, whose
    paths the spec tree shares; a spec is a tuple, so it is read with
    ``spec_at``, not flattened)."""
    jf = _jax_flat(jtree)
    assert set(jf) == set(flatten(tshapes)), what
    for k, js in jf.items():
        assert tuple(js) == tuple(sharding.spec_at(ttree, k)), (what, k)


_SHAPES = {}


def _shapes(arch):
    """(JAX shapes, port meta tensors) of the full config: params, caches
    at the model dtype and int8 (8 slots of 1024 tokens)."""
    if arch not in _SHAPES:
        jm, tm = jreg.build(jax_config(arch)), registry.build(get_config(arch))
        jp = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
        tp = tm.init(0, "meta")
        caches = []
        for jdt, tdt in ((None, None), (jnp.int8, torch.int8)):
            jc = jax.eval_shape(lambda: jm.init_cache(8, 1024, kv_dtype=jdt))
            tc = tm.init_cache(8, 1024, kv_dtype=tdt, device="meta")
            caches.append((jc, tc))
        _SHAPES[arch] = (jp, tp, caches)
    return _SHAPES[arch]


@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_jax(arch, mesh):
    jp, tp, caches = _shapes(arch)
    m = _Mesh(mesh)
    for fsdp in (False, True):
        _same_specs(jsh.param_pspecs(jp, m, fsdp=fsdp),
                    sharding.param_pspecs(tp, m, fsdp=fsdp), tp,
                    f"param_pspecs fsdp={fsdp}")
    for jc, tc in caches:
        for seq in (False, True):
            _same_specs(jsh.cache_pspecs(jc, m, batch=8, shard_seq=seq),
                        sharding.cache_pspecs(tc, m, batch=8, shard_seq=seq),
                        tc, f"cache_pspecs shard_seq={seq}")
        # the slot group's state: per-slot positions instead of the scalar
        jc = dict(jc, pos=jax.ShapeDtypeStruct((8,), jnp.int32))
        tc = dict(tc, pos=torch.empty(8, dtype=torch.int32, device="meta"))
        _same_specs(jsh.serve_state_pspecs(jc, m, n_slots=8),
                    sharding.serve_state_pspecs(tc, m, n_slots=8), tc,
                    "serve_state_pspecs")
    for shape in ((8, 1), (6, 1), (8,)):
        assert tuple(jsh.serve_slot_pspec(shape, m)) == tuple(
            sharding.serve_slot_pspec(shape, m))
    jb = {"tokens": jax.ShapeDtypeStruct((8, 64), jnp.int32),
          "labels": jax.ShapeDtypeStruct((1, 64), jnp.int32)}
    tb = {"tokens": torch.empty(8, 64, device="meta"),
          "labels": torch.empty(1, 64, device="meta")}
    for seq in (False, True):
        _same_specs(jsh.batch_pspecs(jb, m, shard_seq=seq),
                    sharding.batch_pspecs(tb, m, shard_seq=seq), tb,
                    "batch_pspecs")


# --------------------------------------------------------------- placement
def _coords(mesh):
    names = list(mesh)
    out = [()]
    for a in names:
        out = [c + (i,) for c in out for i in range(mesh[a])]
    return names, out


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_gather_round_trip(arch):
    cfg = get_smoke_config(arch)
    params = registry.build(cfg).init(0, "cpu")
    for mesh in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                 {"pod": 2, "data": 2, "model": 2}):
        m = _Mesh(mesh)
        names, coords = _coords(mesh)
        for fsdp in (False, True):
            specs = sharding.param_pspecs(params, m, fsdp=fsdp)
            for key, x in flatten(params).items():
                spec = sharding.spec_at(specs, key)
                glu = sharding.is_glu_leaf(key, cfg)
                parts = {c: sharding.shard_leaf(x, spec, m, dict(zip(names, c)),
                                                glu=glu) for c in coords}
                for p in parts.values():
                    assert p.shape == sharding.local_shape(x.shape, spec, m)
                back = sharding.gather_leaf(parts, spec, m, glu=glu)
                assert torch.equal(back, x), (arch, mesh, key)
    one = _Mesh({"data": 1, "model": 1})
    specs = sharding.param_pspecs(params, one)
    placed = sharding.shard_params(params, specs, one,
                                   {"data": 0, "model": 0}, cfg)
    for key, x in flatten(placed).items():
        assert x.data_ptr() == flatten(params)[key].data_ptr(), key


def test_glu_cut_pairs_gate_and_up():
    """Rank r's fused wi block is [gate_r | up_r]: its GLU sees the gate and
    up columns of the same features (where F divides the ranks)."""
    F = 6
    wi = torch.arange(2 * F, dtype=torch.float32).reshape(1, 1, 2 * F)
    m = _Mesh({"data": 1, "model": 2})
    spec = sharding.P(None, None, "model")
    r0 = sharding.shard_leaf(wi, spec, m, {"model": 0}, glu=True)
    r1 = sharding.shard_leaf(wi, spec, m, {"model": 1}, glu=True)
    assert r0.flatten().tolist() == [0, 1, 2, 6, 7, 8]
    assert r1.flatten().tolist() == [3, 4, 5, 9, 10, 11]
    plain = sharding.shard_leaf(wi, spec, m, {"model": 1})
    assert plain.flatten().tolist() == [6, 7, 8, 9, 10, 11]
    # F = 3 does not divide 2 ranks (2F does): the cut stays contiguous
    odd = torch.arange(6, dtype=torch.float32).reshape(1, 1, 6)
    parts = {(0, r): sharding.shard_leaf(odd, spec, m, {"model": r},
                                         glu=True) for r in range(2)}
    assert [p.flatten().tolist() for p in parts.values()] == [[0, 1, 2],
                                                             [3, 4, 5]]
    assert torch.equal(sharding.gather_leaf(parts, spec, m, glu=True), odd)


# ---------------------------------------------------------------- experts
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "dbrx-132b"])
def test_local_dispatch_matches_jax(arch):
    jcfg = jax_smoke(arch).replace(dtype="float32", param_dtype="float32")
    cfg = get_smoke_config(arch).replace(dtype="float32",
                                         param_dtype="float32")
    rng = np.random.default_rng(0)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    T = 96
    xt = rng.standard_normal((T, D)).astype(np.float32)
    wi = (rng.standard_normal((E, D, 2 * F)) / np.sqrt(D)).astype(np.float32)
    wo = (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32)
    # skew the routing so that expert 0 overflows its capacity
    xt += 0.5
    router[:, 0] += 0.2
    weights, idx = moe._route({"router": torch.from_numpy(router)}, cfg,
                              torch.from_numpy(xt))
    _, keep, _ = moe.dispatch(cfg, idx)
    assert int((~keep).sum()) > 0                       # drops happen
    p = {"wi": torch.from_numpy(wi), "wo": torch.from_numpy(wo),
         "router": torch.from_numpy(router)}
    whole = moe.moe_ffn_scatter(p, cfg, torch.from_numpy(xt)[None])[0]
    for m in (2, 4):
        E_loc = E // m
        total = torch.zeros(T, D)
        for r in range(m):
            lo = r * E_loc
            mine = moe._local_dispatch(cfg, torch.from_numpy(xt), weights,
                                       idx, p["wi"][lo:lo + E_loc],
                                       p["wo"][lo:lo + E_loc], lo, E_loc)
            theirs = jmoe._local_dispatch(
                jcfg, jnp.asarray(xt), jnp.asarray(weights.numpy()),
                jnp.asarray(idx.numpy()), jnp.asarray(wi[lo:lo + E_loc]),
                jnp.asarray(wo[lo:lo + E_loc]), lo, E_loc)
            np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                       atol=1e-5, rtol=0)
            total += mine
        torch.testing.assert_close(total, whole, atol=1e-5, rtol=0)


# ------------------------------------------------------------ compression
def test_quantize_matches_jax():
    rng = np.random.default_rng(0)
    for shape, s in (((64,), 1.0), ((8, 16), 1e-3), ((3, 5, 7), 40.0)):
        x = (rng.standard_normal(shape) * s).astype(np.float32)
        q, scale = compression._quantize(torch.from_numpy(x))
        jq, jscale = jcomp._quantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
    g = {"w": torch.ones(3, 4, dtype=torch.bfloat16), "b": torch.zeros(2)}
    r = compression.init_residuals(g)
    assert all(v.dtype == torch.float32 and not v.any()
               for v in flatten(r).values())


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True)
