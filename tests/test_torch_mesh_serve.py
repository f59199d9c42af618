"""``ShardedExecutor`` on multi-process gloo worlds on the CPU: the twins of
JAX's sharded conformance cases (``tests/test_executors.py``,
``tests/test_engine.py``), with the JAX package's SMOKE weights and
Q-network carried in by ``repro_torch.bridge`` (computed once in the
test process, passed to every rank). Worlds are built as in
``test_torch_mesh_model.py`` (spawned, ``FileStore``, deadlines).

Every rank runs the same engine on the same requests (all arriving at
t = 0, budget shocks counted in ticks, so no trace depends on timing):

* (1, 1), in this process: parameters placed without a copy, a trace bitwise the
  ``LocalExecutor``'s, ``mesh_devices`` 1, JAX's refusals (structural
  mode, no ``params=``, a bucketed horizon) and ``shard_seq``'s;
  ``kv_int8=True`` accepted (``lower_decode`` alone reads it);
* (2, 1), data parallel: RL-policy traces at H ∈ {1, 4, 8} bitwise the
  local one (masks and tokens; the local path's own H-invariance is
  ``test_torch_slot.py``'s); int8
  and fp8 slot caches; chunked prefill; ZeRO-3 (``fsdp=True``); a budget
  shock whose preempted
  requests resume bitwise, at least one in slots of the other DP rank
  (llama2-7b and recurrentgemma-9b state); every rank's report rank 0's;
* (1, 2), tensor parallel, for llama2-7b (also on an int8 slot cache),
  gemma-2b (one KV head), olmoe-1b-7b (expert-parallel FFN) and
  recurrentgemma-9b (the RG-LRU width and its state cut, one KV head on
  the ring): the local tokens, two runs bitwise;
(The (2, 2) trace is in ``test_torch_mesh_model.py``, which has the room.)
"""
import numpy as np
import pytest
import torch

from test_torch_mesh_model import run_world

L = 4


def _weights(arch, n_layers):
    """The JAX package's SMOKE params (numpy), calib batch and Q-net."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.core import dqn as jdqn
    from repro.data import SyntheticCorpus as JaxCorpus
    from repro.models import registry as jreg
    jcfg = jax_smoke(arch).replace(n_layers=n_layers)
    jp = jreg.build(jcfg).init(jax.random.key(0))
    calib = JaxCorpus(jcfg.vocab_size, seed=7).batch(2, 32, split="calib")
    jq = jdqn.init_qnet(jax.random.key(0), 2 * n_layers + 4,
                        2 * n_layers + 1, 32)
    as_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(arch=arch, n_layers=n_layers, params=as_np(jp),
                calib=dict(calib), qnet=as_np(jq))


class _Serve:
    """One rank's model, policy pieces and engines."""

    def __init__(self, w):
        from repro_torch import bridge
        from repro_torch.configs import get_smoke_config
        from repro_torch.core import controller, memory
        from repro_torch.models import registry
        self.model = registry.build(get_smoke_config(w["arch"]).replace(
            n_layers=w["n_layers"]))
        self.params = bridge.params_from_numpy(w["params"], "cpu")
        self.calib = {k: torch.from_numpy(v) for k, v in w["calib"].items()}
        self.mm = memory.build_memory_model(self.model.cfg)
        self.ctl = controller.RAPController(
            self.model, self.params, self.calib, self.mm,
            bridge.qnet_from_numpy(w["qnet"]))

    def budget(self, total=26, n=2.5):
        from repro_torch.core import masks
        full = masks.full_mask(self.model.cfg.n_layers)
        return (self.mm.param_bytes(full)
                + n * self.mm.state_bytes(full, 1, total))

    def executor(self, mesh, slots=4, kv_dtype=None, **kw):
        from repro_torch.runtime import LocalExecutor, ShardedExecutor
        if mesh is None:
            return LocalExecutor(self.model, self.params, max_active=slots,
                                 kv_dtype=kv_dtype, **kw)
        return ShardedExecutor(self.model, mesh, params=self.params,
                               max_active=slots, kv_dtype=kv_dtype, **kw)

    def run(self, mesh, *, policy="rl", horizon=2, kv_dtype=None, chunk=0,
            shock=None, n=8, max_new=6, log=None, pool=2.5, fsdp=False):
        """A masked-mode trace: (results {rid: (status, tokens, mask)},
        preempted count, the executor's stats)."""
        from repro_torch.core.policy import DensePolicy, RLPolicy
        from repro_torch.runtime import (EngineConfig, EngineRequest,
                                         RAPEngine, TickStaircase)
        ex = self.executor(mesh, kv_dtype=kv_dtype,
                           **({"fsdp": True} if fsdp else {}))
        if log is not None:
            _log_moves(ex, log)
        budget = self.budget(n=pool)
        eng = RAPEngine(
            self.model, self.params,
            RLPolicy(self.ctl) if policy == "rl" else DensePolicy(self.mm),
            EngineConfig(mode="masked", max_new_tokens=max_new,
                         max_active=4, max_len=32, budget_bytes=budget,
                         tokens_per_page=8, kv_dtype=kv_dtype,
                         decode_horizon=horizon, max_prefill_tokens=chunk),
            executor=ex)
        toks = self.calib["tokens"].numpy()
        reqs = [EngineRequest(rid=f"r{i}", arrival_t=0.0, max_new=max_new,
                              prompt=np.asarray(
                                  toks[:1, :(16 if i % 2 else 24)],
                                  np.int32)) for i in range(n)]
        trace = None
        if shock is not None:
            down, up, frac = shock
            kv = budget - eng.resident_param_bytes
            cut = (eng.resident_param_bytes + (1.0 - frac) * kv) / budget
            trace = TickStaircase(budget, [(down, 1.0), (up - down, cut),
                                           (0, 1.0)])
        rep = eng.run(reqs, budget_trace=trace)
        res = {r.rid: (r.status,
                       None if r.tokens is None else r.tokens.tolist(),
                       None if r.mask is None else r.mask.tolist())
               for r in rep.results}
        return res, rep.preempted_count, eng.stats()


def _log_moves(ex, log):
    """Record, per request, the data ranks holding its slots when spilled
    and when restored: {rid: [("spill", ranks), ("restore", ranks), ...]}."""
    spill, restore = ex.spill_state, ex.restore_state

    def spilled(group, slots):
        log.setdefault(group.occupants[slots[0]], []).append(
            ("spill", sorted({group.owner(s) for s in slots})))
        return spill(group, slots)

    def restored(group, slots, rid, state, mask, rows=None):
        log.setdefault(rid, []).append(
            ("restore", sorted({group.owner(s) for s in slots})))
        return restore(group, slots, rid, state, mask, rows)

    ex.spill_state, ex.restore_state = spilled, restored


def _mesh(rank, world, shape):
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape, ("data", "model"), "cpu")


# ------------------------------------------------------------------- 1 x 1
def _body_11(rank, world, w):
    from repro_torch.core import masks
    from repro_torch.runtime import ShardedExecutor
    from repro_torch.tree import flatten
    s = _Serve(w)
    mesh = _mesh(rank, world, (1, 1))
    ex = s.executor(mesh)
    same = all(v.data_ptr() == flatten(s.params)[k].data_ptr()
               and torch.equal(v, flatten(s.params)[k])
               for k, v in flatten(ex.params).items())
    out = dict(placed_without_copy=same, no_groups=ex.groups() == [])
    out["local"], _, _ = s.run(None)
    out["sharded"], _, stats = s.run(mesh)
    out["mesh_devices"] = stats["mesh_devices"]
    # the one-call surfaces: one request, a horizon of 4, both executors
    full = masks.full_mask(L)
    prompt = s.calib["tokens"].numpy()[:1, :16].astype(np.int32)
    got = []
    for e in (s.executor(None), s.executor(mesh)):
        g = e.group_for(full, 32)
        e.prefill_into(g, [0], "r0", prompt, full)
        toks, new = e.decode_horizon(g, 4)
        got.append((toks.tolist(), new))
    out["one_call"] = got
    refusals = {}
    for name, fn in (
            ("structural", lambda: ShardedExecutor(
                s.model, mesh, params=s.params, mode="structural")),
            ("params", lambda: ShardedExecutor(s.model, mesh).group_for(
                full, 32)),
            ("shard_seq", lambda: ShardedExecutor(
                s.model, mesh, params=s.params, shard_seq=True)),
            ("kv_int8", lambda: ShardedExecutor(
                s.model, mesh, params=s.params, kv_int8=True)),
            ("bucketed", lambda: ex.group_for(full, 32).launch_horizon(
                2, (1, 2)))):
        try:
            fn()
            refusals[name] = None
        except Exception as e:          # the type and message are checked
            refusals[name] = (type(e).__name__, str(e))
    out["refusals"] = refusals
    return out


@pytest.fixture(scope="module")
def world_11():
    """In this process: a world of one cannot hang on a collective."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    w = _weights("llama2-7b", L)
    started = not dist.is_initialized()
    mesh_mod.init_distributed("cpu")
    store = mesh_mod._STORE_DIR
    try:
        out = _body_11(0, 1, w)
    finally:
        if started:
            mesh_mod.destroy_distributed()
    out["store_removed"] = (not started or store is not None
                            and not os.path.exists(store))
    return out


def test_one_by_one_places_params_and_serves_bitwise(world_11):
    w = world_11
    assert w["placed_without_copy"] and w["no_groups"]
    assert w["mesh_devices"] == 1
    assert w["store_removed"]       # the world of one's FileStore dir
    assert w["sharded"] == w["local"]
    assert {v[0] for v in w["local"].values()} == {"done"}
    (lt, lnew), (st, snew) = w["one_call"]
    assert lt == st and not lnew and not snew


def test_one_by_one_refusals(world_11):
    r = world_11["refusals"]
    assert r["structural"][0] == "NotImplementedError"
    assert "ROADMAP" in r["structural"][1]
    assert r["params"][0] == "RuntimeError" and "params" in r["params"][1]
    assert r["shard_seq"][0] == "NotImplementedError"
    assert "16b" in r["shard_seq"][1]
    assert r["kv_int8"] is None         # accepted: lower_decode reads it
    assert r["bucketed"][0] == "NotImplementedError"
    assert "full width" in r["bucketed"][1]


# ------------------------------------------------------------ 2 x 1 (DP)
def _body_21(rank, world, w, w_rg):
    mesh = _mesh(rank, world, (2, 1))
    s = _Serve(w)
    out = {}
    local = s.run(None, horizon=1)[0]   # the horizon is unobservable there
    for h in (1, 4, 8):
        out[f"h{h}"] = (local, s.run(mesh, horizon=h)[0])
    for kv in ("int8", "fp8"):
        out[kv] = (s.run(None, kv_dtype=kv)[0], s.run(mesh, kv_dtype=kv)[0])
    out["chunked"] = (s.run(None, chunk=8)[0], s.run(mesh, chunk=8)[0])
    out["fsdp"] = (out["h4"][0], s.run(mesh, horizon=4, fsdp=True)[0])
    shock = (2, 12, 0.7)
    for name, srv in (("llama", s), ("rg", _Serve(w_rg))):
        log = {}
        ref = srv.run(None, policy="dense", pool=3.5)[0]
        calm = srv.run(mesh, policy="dense", pool=3.5)[0]
        shocked, n_pre, _ = srv.run(mesh, policy="dense", shock=shock,
                                    log=log, pool=3.5)
        out[f"shock_{name}"] = dict(ref=ref, calm=calm, shocked=shocked,
                                    preempted=n_pre, log=log)
    return out


@pytest.fixture(scope="module")
def world_21(tmp_path_factory):
    return run_world(_body_21, 2, tmp_path_factory.mktemp("w21"),
                     _weights("llama2-7b", L),
                     _weights("recurrentgemma-9b", 3))


def _done(res):
    return {v[0] for v in res.values()} == {"done"}


@pytest.mark.parametrize("h", [1, 4, 8])
def test_dp_trace_bitwise_local_at_every_horizon(world_21, h):
    for rank in world_21:
        local, sharded = rank[f"h{h}"]         # local: at H = 1
        assert _done(local) and sharded == local
    assert world_21[1][f"h{h}"] == world_21[0][f"h{h}"]


@pytest.mark.parametrize("kv", ["int8", "fp8", "chunked", "fsdp"])
def test_dp_quantized_and_chunked_bitwise_local(world_21, kv):
    for rank in world_21:
        local, sharded = rank[kv]
        assert _done(local) and sharded == local
    assert world_21[1][kv] == world_21[0][kv]


@pytest.mark.parametrize("arch", ["llama", "rg"])
def test_dp_spill_resume_bitwise_across_ranks(world_21, arch):
    for rank in world_21:
        r = rank[f"shock_{arch}"]
        assert r["preempted"] > 0
        assert _done(r["ref"]) and r["calm"] == r["ref"]
        assert r["shocked"] == r["ref"]
    r = world_21[0][f"shock_{arch}"]
    moves = [m for m in r["log"].values() if len(m) >= 2]
    assert moves and all(m[0][0] == "spill" and m[1][0] == "restore"
                         for m in moves)
    # a request spilled from one DP rank's slots resumed in the other's
    assert any(m[0][1] != m[1][1] for m in moves), r["log"]
    assert world_21[1][f"shock_{arch}"] == r


# ------------------------------------------------------------ 1 x 2 (TP)
TP_ARCHS = ("llama2-7b", "gemma-2b", "olmoe-1b-7b", "recurrentgemma-9b")


def _body_12(rank, world, ws):
    mesh = _mesh(rank, world, (1, 2))
    out = {}
    for w in ws:
        s = _Serve(w)
        local = s.run(None)[0]
        a, b = s.run(mesh)[0], s.run(mesh)[0]
        out[w["arch"]] = dict(local=local, a=a, b=b)
        if w["arch"] == "llama2-7b":
            out["llama2-7b int8"] = dict(local=s.run(None, kv_dtype="int8")[0],
                                         a=s.run(mesh, kv_dtype="int8")[0],
                                         b=s.run(mesh, kv_dtype="int8")[0])
    return out


@pytest.fixture(scope="module")
def world_12(tmp_path_factory):
    return run_world(_body_12, 2, tmp_path_factory.mktemp("w12"),
                     [_weights(a, 3 if a == "recurrentgemma-9b" else 2)
                      for a in TP_ARCHS])


@pytest.mark.parametrize("arch", TP_ARCHS + ("llama2-7b int8",))
def test_tp_trace_gives_local_tokens_deterministically(world_12, arch):
    for rank in world_12:
        r = rank[arch]
        assert _done(r["a"]) and r["a"] == r["b"]
        assert r["a"] == r["local"]
    assert world_12[1][arch] == world_12[0][arch]
