"""Counting one rank's step on fake tensors, with no card: the FLOPs,
bytes, peak of live tensor bytes, collectives and kernel launches of the
port's own eager program (:class:`StepCounter`, :func:`count_step`), and
the fake arguments of a sharded step on a rank of a mesh
(:func:`fake_decode_args` and its kin).

Under a ``FakeTensorMode`` and ``kernels.ops.analysis``:

  * FLOPs — the matmuls' (``torch.utils.flop_counter``'s formula table)
    plus each kernel's ``cost()``;
  * bytes accessed — every aten op's inputs read and outputs written once
    (views and metadata ops 0), plus each kernel's ``cost()``;
  * memory — the peak of live tensor bytes, arguments included (the
    kernels' outputs and scratch too);
  * collectives — each ``c10d`` op's count, result bytes and group, with
    JAX's ring wire factors (:func:`wire_factor`).

The card runs the kernels, not their plain versions, so no plain version's
operation or S x S intermediate is counted. ``launch.dryrun`` (one record
per production cell) and ``ShardedExecutor.lower_decode`` both count
through this module.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ------------------------------------------------------------- collectives
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# c10d ops under the names of JAX's HLO collectives; any other c10d op
# (a broadcast) is recorded under its own name at factor 1
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "send": "collective-permute"}


def wire_factor(op: str, g: int) -> float:
    """Ring-algorithm wire bytes per result byte, per device (JAX's
    ``parse_collectives``), for a group of ``g`` ranks:
      all-gather        (g-1)/g × output
      all-reduce        2(g-1)/g × operand
      reduce-scatter    (g-1) × output      (input = g × output)
      all-to-all        (g-1)/g × operand
      collective-permute  1 × operand
    Any other collective sends its whole tensor (1)."""
    if op == "collective-permute" or op not in _COLLECTIVES:
        return 1.0
    if g <= 1:
        return 0.0
    if op == "all-gather":
        return (g - 1) / g
    if op == "all-reduce":
        return 2 * (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)
    return (g - 1) / g


def empty_collectives() -> Dict[str, Any]:
    """JAX's collective record, plus ``groups`` per op: wire bytes by the
    group's ranks ("0,1,2,..."), which the roofline reads to price a
    group inside one node at NVLink's rate and any other at the
    network's."""
    out = {k: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0, "groups": {}}
           for k in _COLLECTIVES}
    out["total_wire_bytes"] = 0.0
    return out


def record_collective(coll: Dict[str, Any], op: str, nbytes: float,
                      ranks) -> None:
    """Add one collective of ``nbytes`` of result per device over the group
    ``ranks`` to ``coll`` (:func:`empty_collectives`)."""
    ranks = list(ranks)
    wire = float(nbytes) * wire_factor(op, len(ranks))
    entry = coll.setdefault(op, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0,
                                 "groups": {}})
    entry["count"] += 1
    entry["bytes"] += float(nbytes)
    entry["wire_bytes"] += wire
    key = ",".join(map(str, ranks))
    entry["groups"][key] = entry["groups"].get(key, 0.0) + wire
    coll["total_wire_bytes"] += wire


# ------------------------------------------------------------------ counter
def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


# no data moves: allocation, metadata, a view not flagged as one
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "lift_fresh", "resize_",
               "set_", "sym_size", "sym_stride", "sym_numel",
               "sym_storage_offset", "_local_scalar_dense", "is_same_size",
               "record_stream"}
# write their destination only
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_"}
# write only the elements of their source into their destination
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "masked_scatter_", "index_fill_"}
_SOURCE = ("values", "src", "source")


def op_bytes(func, args, kwargs, out) -> float:
    """Bytes one aten op moves: its inputs read once and its outputs
    written once. A destination it only writes (``copy_``, ``out=``)
    counts once; one it updates (``add_``) read and written; a scatter
    writes its source's bytes into it; views, allocation and metadata move
    nothing, and so does an op outside aten (``prim.device``)."""
    name = func.overloadpacket.__name__
    if func.namespace != "aten" or func.is_view or name in _NO_TRAFFIC:
        return 0.0
    read = written = 0
    seen = set()
    for i, a in enumerate(func._schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(a.name)
        ts = list(_tensors(v))
        if not ts:
            continue
        seen.update(id(t) for t in ts)
        n = _nbytes(ts)
        if a.alias_info is not None and a.alias_info.is_write:
            if name in _SCATTER:
                continue
            written += n
            if not (name in _WRITE_ONLY or a.kwarg_only):
                read += n
        else:
            read += n
            if name in _SCATTER and a.name in _SOURCE:
                written += n
    written += sum(t.numel() * t.element_size() for t in _tensors(out)
                   if id(t) not in seen)
    return float(read + written)


def _group_ranks(args, kwargs):
    """The ranks of a c10d op's process group (its boxed ProcessGroup)."""
    import torch.distributed as dist
    PG = torch._C._distributed_c10d.ProcessGroup
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                pg = PG.unbox(a)
            except (RuntimeError, TypeError):
                continue            # the op's ReduceOp
            return dist.get_process_group_ranks(pg)
    return [0]


class StepCounter(TorchDispatchMode):
    """Counts one rank's step (module docstring): ``flops``, ``bytes``,
    ``kernels`` ({name: calls, flops, bytes}, from ``kernels.ops.analysis``,
    which calls :meth:`kernel`), ``collectives`` and the peak of live
    tensor bytes (``peak``; :meth:`track` registers the arguments first).
    Enter it inside a ``FakeTensorMode``, with ``ops.analysis(counter)``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.collectives = empty_collectives()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    def track(self, tree) -> int:
        """Register every tensor of ``tree`` as live (once per storage);
        returns the bytes of the storages it added."""
        return sum(self._add(t) for t in _tensors(tree))

    def _add(self, t) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def kernel(self, name: str, cost) -> None:
        """One kernel launch (``kernels.ref.Cost``): its operations and
        bytes, and its outputs and scratch live beside everything else."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += cost.flops
        k["bytes"] += cost.bytes
        self.flops += cost.flops
        self.bytes += cost.bytes
        self.peak = max(self.peak,
                        self.live + cost.out_bytes + cost.scratch_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            op = _C10D.get(func._schema.name.split("::")[-1],
                           func._schema.name.split("::")[-1])
            record_collective(self.collectives, op, _nbytes(args[0]),
                              _group_ranks(args, kwargs))
        else:
            f = self._flops.get(func.overloadpacket)
            if f is not None:
                self.flops += float(f(*args, **kwargs, out_val=out))
            self.bytes += op_bytes(func, args, kwargs, out)
        for t in _tensors(out):
            self._add(t)
        return out


def count_step(fn, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under a :class:`StepCounter` and
    ``kernels.ops.analysis``; ``args`` are fake tensors (trees) made in
    the running ``FakeTensorMode``. Returns the record's ``memory``,
    ``cost``, ``collectives``, ``kernels`` and ``count_s``; ``real_bytes``
    is the counted peak (``argument + temp + output - alias``)."""
    from repro_torch.kernels import ops
    counter = StepCounter()
    arg_bytes = counter.track(args)
    arg_storages = {id(t.untyped_storage()) for t in _tensors(args)}
    t0 = time.time()
    with counter, ops.analysis(counter):
        out = fn(*args)
    count_s = time.time() - t0
    outs, alias = {}, 0
    for t in _tensors(out):
        st = t.untyped_storage()
        if id(st) in outs:
            continue
        outs[id(st)] = st.nbytes()
        if id(st) in arg_storages:
            alias += st.nbytes()
    out_bytes = sum(outs.values())
    peak = counter.peak
    return {
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_bytes": int(peak - arg_bytes - out_bytes + alias),
                   "generated_code_bytes": 0, "alias_bytes": int(alias),
                   "real_bytes": int(peak)},
        "cost": {"flops": counter.flops, "bytes_accessed": counter.bytes},
        "collectives": counter.collectives,
        "kernels": counter.kernels,
        "count_s": round(count_s, 2),
    }


# ------------------------------------------------------------- arguments
def fake_local_params(model, mesh, specs):
    """This rank's blocks of the parameters under ``specs``, as fresh fake
    tensors (call inside the ``FakeTensorMode``)."""
    from repro_torch.parallel.sharding import local_shape, spec_at
    from repro_torch.tree import flatten, unflatten
    meta = model.init(0, "meta")
    return unflatten(meta, {
        k: torch.empty(local_shape(tuple(v.shape), spec_at(specs, k), mesh),
                       dtype=v.dtype)
        for k, v in flatten(meta).items()})


def fake_local_batch(specs, mesh):
    """Rows of the batch this rank takes (``batch_pspecs``' rule, the
    ``steps.shard_batch`` cut) as fake tensors."""
    from repro_torch.parallel.sharding import dp_axes, axis_size
    n = axis_size(mesh, dp_axes(mesh))
    out = {}
    for k, v in specs.items():
        B = v.shape[0]
        rows = B // n if n > 1 and B >= n and B % n == 0 else B
        out[k] = torch.zeros((rows,) + tuple(v.shape[1:]), dtype=v.dtype)
    return out


def fake_decode_args(model, mesh, shape, policy, cache_len: int):
    """(params, their specs, cache, its specs, tokens) of one sharded
    decode step on this rank: its parameter blocks, its block of a cache of
    the shape's global batch holding a full ``cache_len`` (position
    ``cache_len - 1``), int8 where ``policy["kv_int8"]``, cut by
    ``parallel.sharding.cache_pspecs`` as JAX lowers it (rows over the data
    axes, a KV leaf's sequence over "model" where the rule says so, axis 2
    over the data axes under ``policy["shard_seq"]``), and its tokens."""
    from repro_torch.parallel.sharding import (cache_pspecs, local_shape,
                                               param_pspecs, spec_at)
    from repro_torch.tree import flatten, unflatten
    specs = param_pspecs(model.init(0, "meta"), mesh, fsdp=policy["fsdp"])
    params = fake_local_params(model, mesh, specs)
    tokens = fake_local_batch(model.input_specs(shape), mesh)["tokens"]
    kv_dtype = torch.int8 if policy["kv_int8"] else None
    whole = model.init_cache(shape.global_batch, cache_len, kv_dtype,
                             "meta")
    cspecs = cache_pspecs(whole, mesh, batch=shape.global_batch,
                          shard_seq=policy["shard_seq"])
    cache = unflatten(whole, {
        k: torch.empty(local_shape(tuple(v.shape), spec_at(cspecs, k), mesh),
                       dtype=v.dtype) if torch.is_tensor(v) else v
        for k, v in flatten(whole).items()})
    cache["pos"] = cache_len - 1
    return params, specs, cache, cspecs, tokens


def decode_step_fn(model, mesh, policy, specs, cache_specs):
    """The sharded decode step a rank runs: ZeRO-3 leaves gathered over
    "data" for the call (as ``ShardedExecutor.compute_params``), then
    ``steps.make_decode_step`` under the mesh policy, its cache in the
    layout of ``cache_specs``."""
    from repro_torch.parallel import activation as act
    from repro_torch.runtime import steps as steps_lib
    step = steps_lib.make_decode_step(model)

    def fn(params, cache, tokens):
        params = gathered(params, specs, mesh, policy)
        with act.use(mesh, fsdp=policy["fsdp"],
                     shard_seq=policy["shard_seq"], cache_specs=cache_specs):
            return step(params, cache, tokens)
    return fn


def gathered(params, specs, mesh, policy):
    """``params`` with their ZeRO-3 leaves gathered over "data" where the
    policy shards them (as ``ShardedExecutor.compute_params``)."""
    if policy["fsdp"] and mesh.axis_size("data") > 1:
        from repro_torch.parallel.tp import gather_fsdp
        return gather_fsdp(params, specs, mesh)
    return params
