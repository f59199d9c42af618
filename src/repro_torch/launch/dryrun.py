"""Dry run of the port at the production mesh: count one rank's step of
every (arch × shape) on a fake world, with no card.

The JAX package lowers and compiles each cell for 512 placeholder devices
and reads XLA's memory and cost analyses and the partitioned HLO. The port
compiles nothing: it runs its own explicit-SPMD step once, as rank 0 of a
``launch.mesh.fake_world`` of 256 (512 multi-pod) ranks on the production
mesh, on fake CPU tensors of this rank's blocks
(``parallel.sharding.param_pspecs``), under ``runtime.count``'s
``StepCounter`` and ``kernels.ops.analysis``: FLOPs, bytes accessed, the
peak of live tensor bytes and the collectives, the kernels' ``cost()`` in
place of their plain versions. An eager step counts every layer, so every
record is exact (``"unroll": true``; JAX's ``--unroll`` exists only
because XLA counts a ``scan`` body once).

One JSON per cell lands in ``experiments/dryrun_torch/`` and feeds
``repro_torch.roofline`` / ``repro_torch.benchmarks.roofline``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

import torch

from repro_torch.runtime import count

DRYRUN_DIR = "experiments/dryrun_torch"


# --------------------------------------------------------------- policies
def cell_policy(arch: str, shape) -> Dict[str, Any]:
    """Per-cell sharding/numerics choices (recorded in the cell JSON).

    * fsdp      — ZeRO-3 weight sharding over "data"; required where params
                  + optimizer exceed per-device HBM (all train shapes, and
                  the 132B/32B archs everywhere).
    * kv_int8   — quantized KV cache; required where the bf16 cache exceeds
                  pod HBM (qwen1.5-32b decode_32k: 5.5 TB bf16 > 4 TB pod).
    * shard_seq — batch=1 long-context: shard sequence/state dims over the
                  batch axes instead (sequence parallelism).
    """
    fsdp = (shape.kind == "train") or arch in ("dbrx-132b", "qwen1.5-32b")
    kv_int8 = arch == "qwen1.5-32b" and shape.kind == "decode"
    shard_seq = shape.global_batch == 1
    micro = {"dbrx-132b": 4, "qwen1.5-32b": 4, "qwen3-14b": 2,
             "glm4-9b": 2, "recurrentgemma-9b": 2}.get(arch, 1) \
        if shape.kind == "train" else 1
    return {"fsdp": fsdp, "kv_int8": kv_int8, "shard_seq": shard_seq,
            "microbatches": micro}


# ------------------------------------------------------------------ lower
def lower_cell(arch: str, shape_name: str, *,
               multi_pod: bool = False) -> Dict[str, Any]:
    """One cell's record: the port's step on rank 0 of the production mesh
    (a fake world of 256 ranks, 512 multi-pod), counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, get_shape, shape_applicable
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import registry
    from repro_torch.runtime.executor import SHARD_SEQ

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch skips long_500k"}
    policy = cell_policy(arch, shape)
    if policy["shard_seq"]:
        raise NotImplementedError(SHARD_SEQ)
    model = registry.build(cfg)
    t0 = time.time()
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        with FakeTensorMode():
            fn, args = _cell_step(model, mesh, shape, policy)
            t_lower = time.time() - t0
            counted = count.count_step(fn, *args)
        n_dev = mesh.size
        mesh_shape = dict(mesh.shape)
    return {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "unroll": True, "multi_pod": multi_pod, "n_devices": n_dev,
        "mesh": mesh_shape, "policy": policy, "skipped": False,
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        **counted,
        "model_params": int(cfg.total_params()),
        "model_params_active": int(cfg.active_params()),
    }


def _cell_step(model, mesh, shape, policy):
    """(step function, its fake arguments) of one cell on this rank."""
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import param_pspecs
    from repro_torch.runtime import steps as steps_lib
    cfg = model.cfg
    if shape.kind == "decode":
        nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
        params, specs, cache, tokens = count.fake_decode_args(
            model, mesh, shape, policy, shape.seq_len + nv)
        fn = count.decode_step_fn(model, mesh, policy, specs)
        return fn, (params, cache, tokens)
    specs = param_pspecs(model.init(0, "meta"), mesh, fsdp=policy["fsdp"])
    params = count.fake_local_params(model, mesh, specs)
    if shape.kind == "train":
        batch = {k: torch.zeros(tuple(v.shape), dtype=v.dtype)
                 for k, v in model.input_specs(shape).items()}
        step = steps_lib.make_sharded_train_step(
            model, adamw.AdamWConfig(), mesh, specs=specs, remat=True,
            microbatches=policy["microbatches"], fsdp=policy["fsdp"])
        return step, (params, adamw.init(params), batch)
    from repro_torch.parallel import activation as act
    batch = count.fake_local_batch(model.input_specs(shape), mesh)
    kv_dtype = torch.int8 if policy["kv_int8"] else None
    step = steps_lib.make_prefill_step(model, shape.seq_len,
                                       kv_dtype=kv_dtype)

    def prefill(params, batch):
        params = count.gathered(params, specs, mesh, policy)
        with act.use(mesh, fsdp=policy["fsdp"]):
            return step(params, batch)
    return prefill, (params, batch)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = DRYRUN_DIR) -> Dict[str, Any]:
    tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, tag + ".json")
    try:
        result = lower_cell(arch, shape_name, multi_pod=multi_pod)
    except Exception as e:
        result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                  "skipped": False, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-3000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DRYRUN_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, get_config,
                                     shape_applicable)

    if args.all:
        cells = [(a, s.name) for a in ASSIGNED_ARCHS for s in SHAPES
                 if shape_applicable(get_config(a), s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    failures = 0
    for arch, shp in cells:
        for mp in meshes:
            tag = f"{arch}_{shp}_{'pod2' if mp else 'pod1'}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if "error" not in prev:
                    print(f"SKIP {tag} (cached)")
                    continue
            r = run_cell(arch, shp, mp, args.out)
            if r.get("error"):
                failures += 1
                print(f"FAIL {tag}: {r['error']}", flush=True)
            elif r.get("skipped"):
                print(f"N/A  {tag}: {r['reason']}", flush=True)
            else:
                mem_gb = r["memory"]["real_bytes"] / 1e9
                print(f"OK   {tag}: count={r['count_s']}s "
                      f"mem/dev={mem_gb:.2f}GB "
                      f"GFLOP={r['cost']['flops']/1e9:.1f} "
                      f"wire={r['collectives']['total_wire_bytes']/1e6:.1f}MB",
                      flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
