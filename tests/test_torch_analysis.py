"""The port's analysis tools (the dry run, ``ShardedExecutor.lower_decode``,
the RAP sweep, the roofline) against the JAX package's, with no card.

* ``SHAPES``, ``get_shape``, ``ASSIGNED_ARCHS``, ``shape_applicable``,
  ``active_params``, ``n_attn_layers``, ``sub_quadratic`` equal JAX's for
  every config; ``input_specs`` gives JAX's shapes for every (arch ×
  shape), with JAX's int32 / bfloat16 / float32 as torch's;
* ``cell_policy`` and ``model_flops_per_device`` equal JAX's for every
  (arch × shape) at 256 and 512 devices;
* each collective's wire bytes at group sizes 1, 2 and 16 equal JAX's
  ``parse_collectives`` on an HLO line of the same op, shape and group
  (the port's issued through ``torch.distributed`` on a fake world);
* with the port's constants patched to JAX's, ``analyze_cell`` and
  ``render_table`` give JAX's rows from the same record;
  ``finalize_experiments`` rewrites only its marked section;
* a SMOKE llama2-7b prefill counts 2 × (matmul parameters) × tokens plus
  the unembedding and the kernels' ``cost()`` exactly: the plain versions
  add nothing; a SMOKE decode step counts one decode and one GLU call per
  layer;
* a full-width cell on the 16 x 16 fake world has the per-rank argument
  bytes JAX's rules give (computed as ``test_torch_sharding.py`` does);
* ``lower_decode(kv_int8=True)`` counts an int8 cache; the sweep's memory
  term falls with ``keep``; a ``long_500k`` cell records an error naming
  item 16b;
* ``fake_world`` leaves no process group and refuses to nest;
  ``ops.analysis`` raises on a real tensor and leaves ``launch_counts()``;
* each kernel's ``cost()`` gives PERF.md's bound column at the timed
  shapes.
"""
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro import configs as jcfg
from repro.models import registry as jreg
from repro.parallel import sharding as jsh
from repro_torch import configs as tcfg
from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, fake_world
from repro_torch.models import registry
from repro_torch.runtime import count
from repro_torch.tree import flatten

torch.set_num_threads(1)

ARCHS = tuple(jcfg.all_configs())
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


@pytest.fixture
def jdry(monkeypatch):
    """JAX's dry-run module; importing it sets XLA_FLAGS, restored after."""
    import os
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    import repro.launch.dryrun as jd
    return jd


class _Mesh:
    """What JAX's rules read of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


# ------------------------------------------------------------- configs
def test_configs_and_shapes_match_jax():
    assert tcfg.SHAPES == tuple(ShapeConfig(s.name, s.seq_len, s.global_batch,
                                            s.kind) for s in jcfg.SHAPES)
    for s in jcfg.SHAPES:
        assert tcfg.get_shape(s.name) == tcfg.SHAPES[jcfg.SHAPES.index(s)]
    with pytest.raises(KeyError):
        tcfg.get_shape("nothing")
    assert tcfg.ASSIGNED_ARCHS == jcfg.ASSIGNED_ARCHS
    assert set(tcfg.all_configs()) == set(jcfg.all_configs())
    for arch in ARCHS:
        j, t = jcfg.get_config(arch), get_config(arch)
        assert t.active_params() == j.active_params(), arch
        assert t.n_attn_layers() == j.n_attn_layers(), arch
        assert t.sub_quadratic() == j.sub_quadratic(), arch
        for js, ts in zip(jcfg.SHAPES, tcfg.SHAPES):
            assert (tcfg.shape_applicable(t, ts)
                    == jcfg.shape_applicable(j, js)), (arch, js.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    jm = jreg.build(jcfg.get_config(arch))
    tm = registry.build(get_config(arch))
    for js, ts in zip(jcfg.SHAPES, tcfg.SHAPES):
        want = jm.input_specs(js)
        got = tm.input_specs(ts)
        assert set(got) == set(want), (arch, js.name)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, js.name, k)
            assert got[k].dtype == DTYPES[jnp.dtype(v.dtype)]
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("n_devices", [256, 512])
def test_policy_and_model_flops_match_jax(jdry, n_devices):
    from repro.roofline import analysis as jana
    from repro_torch.roofline import analysis as tana
    for arch in ARCHS:
        for js, ts in zip(jcfg.SHAPES, tcfg.SHAPES):
            assert dryrun.cell_policy(arch, ts) == jdry.cell_policy(arch, js)
            assert (tana.model_flops_per_device(arch, ts.name, n_devices)
                    == jana.model_flops_per_device(arch, js.name,
                                                   n_devices)), arch


# --------------------------------------------------------- collectives
_HLO = {  # op: (result shape, operand shape) for 16 x 128 per device
    "all-gather": ("{g16},128", "16,128"),
    "all-reduce": ("16,128", "16,128"),
    "reduce-scatter": ("16,128", "{g16},128"),
    "all-to-all": ("16,128", "16,128"),
    "collective-permute": ("16,128", "16,128"),
}


def _port_wire(op, g):
    """Wire bytes of one collective of a 16 x 128 f32 block over ``g``
    ranks, issued through ``torch.distributed`` on a fake world of 16 under
    the counter (the port has no point-to-point op: a permute is recorded
    directly)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_world(16):
        grp = dist.new_group(list(range(g)))
        counter = count.StepCounter()
        with FakeTensorMode(), counter:
            x = torch.empty(16, 128)
            if op == "all-gather":
                dist.all_gather([torch.empty_like(x) for _ in range(g)], x,
                                group=grp)
            elif op == "all-reduce":
                dist.all_reduce(x, group=grp)
            elif op == "reduce-scatter":
                dist.reduce_scatter(x, [torch.empty_like(x)
                                        for _ in range(g)], group=grp)
            elif op == "all-to-all":
                dist.all_to_all_single(torch.empty_like(x), x, group=grp)
            else:
                count.record_collective(counter.collectives, op,
                                         x.numel() * 4, range(g))
    c = counter.collectives
    assert c[op]["count"] == 1
    assert sum(v["count"] for k, v in c.items() if isinstance(v, dict)) == 1
    return c[op]["wire_bytes"], c["total_wire_bytes"]


@pytest.mark.parametrize("g", [1, 2, 16])
@pytest.mark.parametrize("op", list(_HLO))
def test_collective_wire_bytes_match_jax(jdry, op, g):
    res, opd = (s.replace("{g16}", str(16 * g)) for s in _HLO[op])
    groups = "{{" + ",".join(map(str, range(g))) + "}}"
    attr = (f"source_target_pairs={{{{0,{min(1, g - 1)}}}}}"
            if op == "collective-permute" else f"replica_groups={groups}")
    line = (f"  %x.1 = f32[{res}]{{1,0}} {op}(f32[{opd}]{{1,0}} %p.0), "
            f"{attr}")
    want = jdry.parse_collectives(line)
    assert want[op]["count"] == 1
    wire, total = _port_wire(op, g)
    assert wire == pytest.approx(want[op]["wire_bytes"], rel=1e-12)
    assert total == pytest.approx(want["total_wire_bytes"], rel=1e-12)


# ----------------------------------------------------------- roofline
def _record(arch, shape, kind):
    """A dry-run record as the port writes it (its ``groups`` included)."""
    coll = count.empty_collectives()
    count.record_collective(coll, "all-reduce", 3.0e8, range(16))
    count.record_collective(coll, "all-gather", 1.0e8, range(0, 256, 16))
    return {"arch": arch, "shape": shape, "kind": kind, "unroll": True,
            "n_devices": 256, "policy": {"fsdp": False}, "skipped": False,
            "cost": {"flops": 4.0e15, "bytes_accessed": 2.0e12},
            "memory": {"argument_bytes": 9e9, "real_bytes": 12.5e9},
            "collectives": coll}


def test_roofline_matches_jax_with_its_constants(jdry, tmp_path,
                                                 monkeypatch):
    from repro.roofline import analysis as jana
    from repro_torch.roofline import analysis as tana
    cells = [("gemma-2b", "decode_32k", "decode"),
             ("qwen3-14b", "train_4k", "train"),
             ("mamba2-370m", "prefill_32k", "prefill")]
    for arch, shape, kind in cells:
        with open(tmp_path / f"{arch}_{shape}_pod1.json", "w") as f:
            json.dump(_record(arch, shape, kind), f)
    monkeypatch.setattr(jana, "DRYRUN_DIR", str(tmp_path))
    monkeypatch.setattr(tana, "DRYRUN_DIR", str(tmp_path))
    for name, v in (("PEAK_FLOPS_BF16", jana.PEAK_FLOPS_BF16),
                    ("HBM_BW", jana.HBM_BW), ("NVLINK_BW", jana.ICI_BW),
                    ("NET_BW", jana.ICI_BW),
                    ("HBM_PER_CARD", jana.HBM_PER_CHIP)):
        monkeypatch.setattr(tana, name, v)
    for arch, shape, _ in cells:
        want, got = jana.analyze_cell(arch, shape), tana.analyze_cell(
            arch, shape)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (arch, k)
        assert tana.suggestion(got) != jana.suggestion(want)   # H100 terms
    assert tana.render_table(tana.full_table()) == jana.render_table(
        jana.full_table())
    # counted FLOPs below the model's: JAX caps the share at 1, the port
    # shows the impossible share
    low = _record("gemma-2b", "decode_32k", "decode")
    low["cost"] = {"flops": 1.0e9, "bytes_accessed": 1.0e3}
    low["collectives"] = count.empty_collectives()
    with open(tmp_path / "gemma-2b_decode_32k_pod1.json", "w") as f:
        json.dump(low, f)
    assert jana.analyze_cell("gemma-2b", "decode_32k")["roofline_frac"] == 1.0
    assert tana.analyze_cell("gemma-2b", "decode_32k")["roofline_frac"] > 1.05
    # and in H100 terms: the data group spans nodes (network), the model
    # group of 16 too; a group of 8 consecutive ranks rides NVLink
    monkeypatch.undo()
    coll = _record("gemma-2b", "decode_32k", "decode")["collectives"]
    from repro_torch.launch import mesh
    t = tana.collective_seconds(coll)
    assert t == pytest.approx(coll["total_wire_bytes"] / mesh.NET_BW)
    one = count.empty_collectives()
    count.record_collective(one, "all-reduce", 1e9, range(8, 16))
    assert tana.collective_seconds(one) == pytest.approx(
        one["total_wire_bytes"] / mesh.NVLINK_BW)


def test_finalize_writes_its_section_idempotently(tmp_path, monkeypatch):
    from repro_torch.benchmarks import finalize_experiments as fin
    from repro_torch.roofline import analysis as tana
    rec = tmp_path / "records"
    rec.mkdir()
    (rec / "gemma-2b_decode_32k_pod1.json").write_text(
        json.dumps(_record("gemma-2b", "decode_32k", "decode")))
    (rec / "mamba2-370m_long_500k_pod1.json").write_text(json.dumps(
        {"arch": "mamba2-370m", "shape": "long_500k", "error": "x 16b"}))
    monkeypatch.setattr(tana, "DRYRUN_DIR", str(rec))
    out = tmp_path / "E.md"
    out.write_text("# Kept\n\nprose\n")
    fin.main(["--out", str(out)])
    once = out.read_text()
    fin.main(["--out", str(out)])
    assert out.read_text() == once
    assert once.startswith("# Kept\n\nprose\n\n" + fin.MARK)
    assert once.count(fin.MARK) == 1
    assert "| gemma-2b | decode_32k |" in once and "≤80 GB" in once
    assert "`mamba2-370m × long_500k`: x 16b" in once


# ------------------------------------------------------------ counting
def _fake(meta_tree):
    return {k: torch.empty(tuple(v.shape), dtype=v.dtype)
            for k, v in flatten(meta_tree).items()}


def _smoke_counted(kind, B=2, S=32):
    """A meshless SMOKE llama2-7b step counted on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.runtime import steps
    from repro_torch.tree import unflatten
    cfg = get_smoke_config("llama2-7b")
    model = registry.build(cfg)
    meta = model.init(0, "meta")
    with FakeTensorMode():
        params = unflatten(meta, _fake(meta))
        if kind == "prefill":
            tokens = torch.zeros(B, S, dtype=torch.int32)
            rec = count.count_step(steps.make_prefill_step(model, S),
                                    params, {"tokens": tokens})
        else:
            cache = model.init_cache(B, S, device="cpu")
            cache["pos"] = S - 1
            rec = count.count_step(steps.make_decode_step(model), params,
                                    cache, torch.zeros(B, 1,
                                                       dtype=torch.int32))
    return cfg, meta, rec


def test_prefill_counts_matmuls_and_kernel_costs_exactly():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swiglu
    B, S = 2, 32
    cfg, meta, rec = _smoke_counted("prefill", B, S)
    weights = sum(v.numel() for k, v in flatten(meta).items()
                  if k.startswith("stacks/") and v.ndim == 3)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    q = torch.empty(B, S, cfg.n_heads, cfg.dh, device="meta")
    kv = torch.empty(B, S, cfg.n_kv_heads, cfg.dh, device="meta")
    kernel = L * (fa.cost(q, kv, kv).flops
                  + swiglu.cost(torch.empty(B, S, 2 * F,
                                            device="meta")).flops)
    want = 2 * weights * B * S + 2 * D * cfg.vocab_padded * B + kernel
    assert rec["cost"]["flops"] == want
    assert rec["kernels"]["flash_attention"]["calls"] == L
    assert rec["kernels"]["fused_glu"]["calls"] == L
    assert set(rec["kernels"]) == {"flash_attention", "fused_glu"}
    # the cache (the outputs) and the weights (the arguments) are live at
    # the peak; the plain version's S x S scores never are
    m = rec["memory"]
    assert m["real_bytes"] >= m["argument_bytes"] + m["output_bytes"]
    assert m["argument_bytes"] == 4 * sum(v.numel() for v in
                                          flatten(meta).values()) + 4 * B * S


def test_decode_kernel_calls_follow_the_layout():
    cfg, _, rec = _smoke_counted("decode")
    L = cfg.n_layers
    assert {k: v["calls"] for k, v in rec["kernels"].items()} == {
        "decode_attention": L, "fused_glu": L}
    assert rec["memory"]["alias_bytes"] > 0          # the cache, in place
    assert rec["collectives"]["total_wire_bytes"] == 0


def _jax_local_bytes(tree, specs, mesh):
    n = 0
    for k, leaf in _flat_specs(tree).items():
        spec = tuple(specs[k])
        elems = 1
        for d, dim in enumerate(leaf.shape):
            axis = spec[d] if d < len(spec) else None
            axes = axis if isinstance(axis, tuple) else (axis,)
            div = math.prod(mesh.shape[a] for a in axes if a is not None)
            elems *= dim // div
        n += elems * jnp.dtype(leaf.dtype).itemsize
    return n


def _flat_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen1.5-32b"])
def test_full_width_argument_bytes_follow_jax_rules(jdry, arch):
    """A prefill cell's arguments are this rank's parameter blocks and
    batch rows; qwen1.5-32b runs ZeRO-3 (fsdp)."""
    rec = dryrun.lower_cell(arch, "prefill_32k")
    jm = jreg.build(jcfg.get_config(arch))
    mesh = _Mesh({"data": 16, "model": 16})
    pol = jdry.cell_policy(arch, jcfg.get_shape("prefill_32k"))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    pspec = _flat_specs(jsh.param_pspecs(shapes, mesh, fsdp=pol["fsdp"]))
    specs = jm.input_specs(jcfg.get_shape("prefill_32k"))
    bspec = _flat_specs(jsh.batch_pspecs(specs, mesh))
    want = (_jax_local_bytes(shapes, pspec, mesh)
            + _jax_local_bytes(specs, bspec, mesh))
    assert rec["memory"]["argument_bytes"] == want
    jkeys = {"arch", "shape", "kind", "unroll", "multi_pod", "n_devices",
             "mesh", "policy", "skipped", "lower_s", "compile_s", "memory",
             "cost", "collectives", "model_params", "model_params_active"}
    assert jkeys <= set(rec) and "kernels" in rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes",
                                  "alias_bytes", "real_bytes"}
    assert set(jdry._COLLECTIVES) <= set(rec["collectives"])
    assert rec["policy"]["fsdp"] == pol["fsdp"]
    assert rec["unroll"] and rec["n_devices"] == 256
    assert rec["mesh"] == {"data": 16, "model": 16}
    assert rec["kernels"]["flash_attention"]["calls"] == \
        get_config(arch).n_layers


def test_lower_decode_counts_an_int8_cache():
    from repro_torch.runtime.executor import ShardedExecutor
    cfg = get_smoke_config("llama2-7b").replace(dtype="bfloat16")
    model = registry.build(cfg)
    shape = ShapeConfig("t", 64, 4, "decode")
    recs = {}
    with fake_world(1):
        mesh = Mesh((1, 1), ("data", "model"))
        for kv_int8 in (False, True):
            recs[kv_int8] = ShardedExecutor(
                model, mesh, kv_int8=kv_int8).lower_decode(shape)
    assert not dist.is_initialized()
    params = sum(v.numel() * v.element_size()
                 for v in flatten(model.init(0, "meta")).values())
    kv = 2 * cfg.n_layers * 4 * 64 * cfg.n_kv_heads * cfg.dh
    scales = 2 * cfg.n_layers * 4 * 64 * cfg.n_kv_heads * 4
    tokens = 4 * 4
    assert recs[True]["memory"]["argument_bytes"] == (params + kv + scales
                                                      + tokens)
    assert recs[False]["memory"]["argument_bytes"] == params + 2 * kv + tokens
    assert recs[True]["policy"]["kv_int8"]
    for r in recs.values():
        assert {k: v["calls"] for k, v in r["kernels"].items()} == {
            "decode_attention": cfg.n_layers, "fused_glu": cfg.n_layers}
    # the int8 codes are read to dequantize them: more ops, other bytes
    assert recs[True]["cost"]["bytes_accessed"] != \
        recs[False]["cost"]["bytes_accessed"]


def test_sweep_memory_term_falls_with_keep(tmp_path, capsys):
    from repro_torch.launch import rap_sweep
    rows = rap_sweep.sweep("gemma-2b", ShapeConfig("t", 1024, 16, "decode"),
                           [1.0, 0.5], str(tmp_path))
    assert [r["n_layers"] for r in rows] == [18, 9]
    assert rows[1]["memory_s"] < rows[0]["memory_s"]
    assert rows[1]["kernels"]["decode_attention"]["calls"] == 9
    out = capsys.readouterr().out
    assert "keep=0.5: step-time bound" in out
    assert len(list(tmp_path.glob("rap_gemma-2b_t_keep*.json"))) == 2
    assert not dist.is_initialized()


def test_long_context_cell_names_sequence_parallelism(tmp_path):
    r = dryrun.run_cell("mamba2-370m", "long_500k", False, str(tmp_path))
    assert "NotImplementedError" in r["error"] and "16b" in r["error"]
    assert json.loads((tmp_path / "mamba2-370m_long_500k_pod1.json")
                      .read_text())["error"] == r["error"]
    skip = dryrun.run_cell("gemma-2b", "long_500k", False, str(tmp_path))
    assert skip["skipped"]


def test_fake_world_leaves_no_group_and_refuses_to_nest():
    with fake_world(4):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        mesh = Mesh((2, 2), ("data", "model"), "cuda")
        assert mesh.device.type == "cpu"        # no card touched
        with pytest.raises(RuntimeError, match="already running"):
            with fake_world(2):
                pass
    assert not dist.is_initialized()


def test_analysis_refuses_real_tensors_and_keeps_launch_counts():
    from torch._subclasses.fake_tensor import FakeTensorMode
    ops.reset_launches()
    before = ops.launch_counts()
    counter = count.StepCounter()
    with ops.analysis(counter):
        with pytest.raises(RuntimeError, match="fake tensors only"):
            ops.fused_glu(torch.randn(4, 8))
        with FakeTensorMode():
            out = ops.fused_glu(torch.empty(4, 8))
            y, state = ops.ssd(torch.empty(1, 8, 2, 4), torch.empty(1, 8, 2),
                               torch.empty(1, 8, 3), torch.empty(1, 8, 3))
    assert tuple(out.shape) == (4, 4)
    assert tuple(y.shape) == (1, 8, 2, 4) and tuple(state.shape) == (1, 2,
                                                                     4, 3)
    assert counter.kernels["fused_glu"]["calls"] == 1
    assert counter.kernels["ssd"]["calls"] == 1
    assert ops.launch_counts() == before
    # outside the route a CPU tensor still takes the plain version
    x = torch.randn(4, 8)
    from repro_torch.kernels import swiglu
    assert torch.equal(ops.fused_glu(x), swiglu.glu_ref(x))


# ------------------------------------------------------- kernel bounds
def _bound_ms(c):
    from repro_torch.launch.mesh import HBM_BW, peak_flops
    return max(c.bytes / HBM_BW, c.flops / peak_flops(c.op_dtype)) * 1e3


def test_kernel_costs_give_the_perf_bounds():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru, ssd, swiglu
    bf = torch.bfloat16
    m = lambda *s, dt=torch.float32: torch.empty(*s, dtype=dt, device="meta")
    q = m(8, 256, 32, 128, dt=bf)
    assert round(_bound_ms(fa.cost(q, q, q)), 4) == 0.0200
    assert round(_bound_ms(ssd.cost(m(8, 256, 32, 64), m(8, 256, 32),
                                    m(8, 256, 128), m(8, 256, 128), 256)),
                 4) == 0.0331
    assert round(_bound_ms(rglru.cost(m(8, 256, 4096), m(8, 256, 4096))),
                 4) == 0.0300
    assert round(_bound_ms(swiglu.cost(m(2048, 22016, dt=bf))), 4) == 0.0404
    # the dense decode body at B = 8: chip_smoke.py's ragged lengths
    # (paged_inputs, seed 12: 2398 tokens of a 512-slot cache)
    g = torch.Generator(device="cpu").manual_seed(12)
    lengths = torch.randint(1, 513, (8,), generator=g, dtype=torch.int32)
    lengths[0] = 512
    valid = torch.arange(512)[None, :] < lengths[:, None]
    assert int(lengths.sum()) == 2398
    kv = m(8, 512, 32, 128, dt=bf)
    c = dec.cost(m(8, 1, 32, 128, dt=bf), kv, kv, valid)
    assert round(_bound_ms(c), 4) == 0.0118
