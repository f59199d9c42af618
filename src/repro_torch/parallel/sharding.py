"""Sharding rules: parameter / batch / cache partition specs for any mesh.

The port of ``repro/parallel/sharding.py``: the same *name+rank* rules over
the same leaf paths, with the same per-axis divisibility fallback
(:func:`_pick`), so the same rules serve full production configs and tiny
smoke configs. They are pure Python over leaf paths and shapes: a ``mesh``
is anything whose ``shape`` maps axis names to sizes (a
:class:`repro_torch.launch.mesh.Mesh`, or a plain stand-in), so the rules
run without a process group.

A spec is a :class:`P`, a tuple with one entry per leading dim of the leaf:
``None`` (whole), an axis name, or a tuple of axis names (``("pod",
"data")``), exactly as ``tuple(jax.sharding.PartitionSpec(...))`` reads.

Axes: ``"data"`` (+ ``"pod"`` when multi-pod) carry the batch; ``"model"``
carries tensor parallelism (feature dims), expert parallelism (MoE expert
dim) and vocab sharding.

TP placement summary (16-way "model"):
  embed [V,D]            → (model, ∅)      vocab-sharded; V padded to 512·k
  lm_head [D,V]          → (∅, model)
  attn  wq/wk/wv [L,D,E] → (∅, ∅, model)   feature out-dim (n_heads·d_head)
        wo [L,E,D]       → (∅, model, ∅)   contracting in-dim → one AR/layer
  ffn   wi [L,D,2F]      → (∅, ∅, model)   see the local cut below
        wo [L,F,D]       → (∅, model, ∅)
  moe   wi/wo [L,E,..]   → (∅, model, ∅, ∅) expert-parallel
  rglru wx/w_gate/wa/wi  → width / block axis over model
  ssd                    → replicated (370M params; TP overhead ≫ gain)
  norms, biases, scalars → replicated

Placement (:func:`shard_leaf`, :func:`gather_leaf`) cuts a whole leaf into
the block a mesh coordinate holds and puts the blocks back together. One
local cut departs from a contiguous block: the fused GLU ``wi [.., D, 2F]``
(``glu=True``) keeps its spec ``(∅, ∅, model)``, but where F divides the
model axis rank r holds ``[gate_r | up_r]`` — its slice of each half — so
that its local GLU pairs the gate and up features of the same F/m columns
(a contiguous cut would give rank 0 all of ``gate`` and rank 1 all of
``up``). Where 2F divides the axis and F does not, the cut stays
contiguous, ``wo`` stays whole, and every rank computes the block whole.
"""
from __future__ import annotations

import re
from typing import List, Mapping, Tuple

import torch

from repro_torch.tree import flatten, unflatten

__all__ = ["P", "axis_size", "coord", "dp_axes", "param_pspecs",
           "batch_pspecs", "cache_pspecs",
           "serve_state_pspecs", "serve_slot_pspec", "shard_leaf",
           "gather_leaf", "local_shape", "is_glu_leaf", "shard_params",
           "spec_at"]


class P(tuple):
    """A partition spec: ``P(None, "model")``; ``P()`` is replicated. A
    one-axis tuple entry reads as the axis (``("data",)`` is ``"data"``),
    as JAX's ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_size(mesh, axis) -> int:
    """The size of a mesh axis (a name), or of several (a tuple of names:
    their product); 1 for ``None`` or an axis the mesh lacks."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh.shape[a]
        return n
    return mesh.shape.get(axis, 1)


def coord(mesh, axis, coords: Mapping[str, int]) -> int:
    """The coordinate ``coords`` ({axis: index}) has along ``axis`` (a
    name), or along several (a tuple of names: row-major over them)."""
    if isinstance(axis, (tuple, list)):
        c = 0
        for a in axis:
            c = c * mesh.shape[a] + coords.get(a, 0)
        return c
    return coords.get(axis, 0)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes, in order: those of ("pod", "data")
    it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _fits(shape, spec: P, mesh) -> bool:
    for dim, axis in zip(shape, spec):
        if axis is not None and dim % axis_size(mesh, axis) != 0:
            return False
    return True


def _pick(shape, mesh, *candidates: P) -> P:
    """First candidate whose sharded dims divide evenly; else replicated."""
    for spec in candidates:
        if _fits(shape, spec, mesh):
            return spec
    return P()


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape; a Python scalar (the one-shot cache's ``pos``) is
    0-d."""
    return tuple(getattr(leaf, "shape", ()))


# ------------------------------------------------------------------ params
def _param_rule(path: str, shape: Tuple[int, ...], mesh) -> P:
    r = len(shape)
    mdl = "model"

    if re.search(r"(^|/)embed$", path):
        return _pick(shape, mesh, P(mdl, None))
    if re.search(r"(^|/)lm_head$", path):
        return _pick(shape, mesh, P(None, mdl))
    if re.search(r"(^|/)enc_pos$", path):
        return P()

    # ssd mixer: replicated wholesale (see module docstring)
    if "/ssd/" in path:
        return P()

    # rglru: width dims over model
    if "/rglru/" in path:
        if re.search(r"/(wx|w_gate)$", path) and r == 3:
            return _pick(shape, mesh, P(None, None, mdl))
        if re.search(r"/wo$", path) and r == 3:
            return _pick(shape, mesh, P(None, mdl, None))
        if re.search(r"/(wa|wi)$", path) and r == 4:   # block-diag [L,nb,bw,bw]
            return _pick(shape, mesh, P(None, mdl, None, None))
        if re.search(r"/(conv_w)$", path) and r == 3:
            return _pick(shape, mesh, P(None, None, mdl))
        if re.search(r"/(conv_b|ba|bi|lam)$", path) and r == 2:
            return _pick(shape, mesh, P(None, mdl))
        return P()

    # MoE: expert-parallel over model
    if "/moe/" in path:
        if re.search(r"/(wi|wo)$", path) and r == 4:
            return _pick(shape, mesh, P(None, mdl, None, None))
        return P()   # router replicated (tiny, read by every token)

    # attention (incl. enc_attn / cross): [L, D, E] out-features over model
    if re.search(r"/(wq|wk|wv)$", path) and r == 3:
        return _pick(shape, mesh, P(None, None, mdl))
    if re.search(r"/wo$", path) and r == 3:
        return _pick(shape, mesh, P(None, mdl, None))
    if re.search(r"/(bq|bk|bv)$", path) and r == 2:
        return _pick(shape, mesh, P(None, mdl))

    # dense FFN: [L, D, 2F] / [L, F, D]
    if re.search(r"/wi$", path) and r == 3:
        return _pick(shape, mesh, P(None, None, mdl))

    return P()   # norms, scalar gates, etc.


def _add_fsdp(spec: P, path: str, shape, mesh) -> P:
    """Layer a ZeRO-3/FSDP shard over the "data" axis onto an unsharded dim.

    Skips the leading stack axis of per-layer stacks and any dim that does
    not divide; picks the largest eligible dim (for weight matrices the
    feature-in dim, MaxText's fsdp placement)."""
    nd = axis_size(mesh, "data")
    if nd <= 1:
        return spec
    dims = list(spec) + [None] * (len(shape) - len(spec))
    start = 1 if ("stacks" in path and len(shape) >= 2) else 0
    best, best_dim = -1, None
    for i in range(start, len(shape)):
        if dims[i] is None and shape[i] % nd == 0 and shape[i] > best:
            best, best_dim = shape[i], i
    if best_dim is None or best < nd * 8:   # too small to matter
        return spec
    dims[best_dim] = "data"
    return P(*dims)


def param_pspecs(params_shape_tree, mesh, *, fsdp: bool = False):
    """Same-structure tree of :class:`P` for a params tree (tensors, meta
    tensors from ``model.init(seed, "meta")``, or anything with ``.shape``).
    ``fsdp=True`` also shards each leaf over "data" (ZeRO-3: gathered on
    use)."""
    specs = {}
    for key, leaf in flatten(params_shape_tree).items():
        spec = _param_rule(key, _shape(leaf), mesh)
        if fsdp:
            spec = _add_fsdp(spec, key, _shape(leaf), mesh)
        specs[key] = spec
    return unflatten(params_shape_tree, specs)


# ------------------------------------------------------------------- batch
def batch_pspecs(batch_tree, mesh, *, shard_seq: bool = False):
    """Batch dict → specs. Batch axis over (pod, data); if the batch does
    not divide and ``shard_seq``, the sequence axis shards instead."""
    dp = dp_axes(mesh) or None
    ndp = axis_size(mesh, dp)

    def rule(leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return P()
        if shape[0] % ndp == 0 and shape[0] >= ndp:
            return P(dp, *([None] * (len(shape) - 1)))
        if shard_seq and len(shape) >= 2 and shape[1] % ndp == 0:
            return P(None, dp, *([None] * (len(shape) - 2)))
        return P()

    return unflatten(batch_tree, {k: rule(v) for k, v in
                                  flatten(batch_tree).items()})


# ------------------------------------------------------------------- cache
def cache_pspecs(cache_tree, mesh, *, batch: int, shard_seq: bool = False):
    """Decode-state specs. Attention KV [L,B,S,K,Dh]: batch over
    (pod,data) and — for rank-5 KV leaves — sequence over "model"; when the
    batch cannot shard, the sequence / state axes shard over (pod,data)
    instead (``shard_seq``)."""
    dp = dp_axes(mesh) or None
    ndp = axis_size(mesh, dp)
    nm = axis_size(mesh, "model")

    def rule(leaf):
        shape = _shape(leaf)
        if len(shape) <= 1:
            return P()
        if len(shape) >= 2 and shape[1] == batch and batch % ndp == 0:
            rest = [None] * (len(shape) - 2)
            if len(shape) == 5 and shape[2] % nm == 0 and shape[2] >= nm * 64:
                rest[0] = "model"
            return P(None, dp, *rest)
        if shard_seq and len(shape) >= 3:
            if shape[2] % ndp == 0:
                return P(None, None, dp, *([None] * (len(shape) - 3)))
        return P()

    return unflatten(cache_tree, {k: rule(v) for k, v in
                                  flatten(cache_tree).items()})


# ------------------------------------------------------------- serve state
def serve_state_pspecs(state_tree, mesh, *, n_slots: int):
    """Slot-group decode-state specs for the sharded serve path: every leaf
    with ``n_slots`` at position 1 shards its slot axis over ("pod",
    "data"); rank-5 KV leaves also shard the KV-head axis over "model"
    (falling back per axis on divisibility); per-slot positions
    (``[n_slots]``) follow the slot axis."""
    dp = dp_axes(mesh) or None

    def rule(leaf):
        shape = _shape(leaf)
        if len(shape) == 1:
            return _pick(shape, mesh, P(dp)) if shape[0] == n_slots else P()
        if len(shape) >= 2 and shape[1] == n_slots:
            rest = [None] * (len(shape) - 2)
            if len(shape) == 5:      # attn KV (+ int8 scales): heads on TP
                return _pick(shape, mesh,
                             P(None, dp, None, "model", None),
                             P(None, dp, None, None, None),
                             P(None, None, None, "model", None))
            return _pick(shape, mesh, P(None, dp, *rest))
        return P()

    return unflatten(state_tree, {k: rule(v) for k, v in
                                  flatten(state_tree).items()})


def serve_slot_pspec(shape, mesh) -> P:
    """Leading-axis (slot) DP spec with divisibility fallback: the per-slot
    seed tokens' ``[n_slots, 1]`` companion of :func:`serve_state_pspecs`."""
    shape = tuple(shape)
    return _pick(shape, mesh,
                 P(dp_axes(mesh) or None, *([None] * (len(shape) - 1))))


# --------------------------------------------------------------- placement
def _blocks(shape, spec, mesh, coords, glu: bool
            ) -> List[Tuple[Tuple[slice, ...], int]]:
    """The pieces of the full leaf a coordinate holds: (index into the full
    leaf, width along the last dim), in the order they sit in the local
    block. One piece, or two under the GLU cut (the rank's gate columns,
    then its up columns)."""
    idx: List[slice] = []
    for d, dim in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        n = axis_size(mesh, axis)
        if n == 1:
            idx.append(slice(None))
            continue
        w = dim // n
        c = coord(mesh, axis, coords)
        idx.append(slice(c * w, (c + 1) * w))
    last = len(shape) - 1
    n = axis_size(mesh, spec[last]) if 0 <= last < len(spec) else 1
    if not (glu and n > 1 and (shape[last] // 2) % n == 0):
        return [(tuple(idx), 0)]
    half = shape[last] // 2
    w = half // n
    c = coord(mesh, spec[last], coords)
    gate, up = list(idx), list(idx)
    gate[last] = slice(c * w, (c + 1) * w)
    up[last] = slice(half + c * w, half + (c + 1) * w)
    return [(tuple(gate), w), (tuple(up), w)]


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of the block one coordinate holds."""
    return tuple(dim // axis_size(mesh, spec[d] if d < len(spec) else None)
                 for d, dim in enumerate(shape))


def shard_leaf(full: torch.Tensor, spec, mesh, coords: Mapping[str, int], *,
               glu: bool = False) -> torch.Tensor:
    """The block of ``full`` that the mesh coordinate ``coords`` ({axis:
    index}) holds under ``spec``: a view of ``full`` itself when nothing is
    cut (a 1 x 1 mesh places without a copy), else a contiguous copy.
    ``glu``: the fused GLU cut (module docstring)."""
    pieces = _blocks(tuple(full.shape), spec, mesh, coords, glu)
    if len(pieces) == 1:
        out = full[pieces[0][0]]
        return out if out.shape == full.shape else out.contiguous()
    return torch.cat([full[i] for i, _ in pieces], dim=-1)


def gather_leaf(parts, spec, mesh, *, glu: bool = False) -> torch.Tensor:
    """:func:`shard_leaf`'s inverse: the whole leaf from ``parts``, a
    mapping from a coordinate (a tuple of indices in the mesh's axis order)
    to the block that coordinate holds. Every block of the leaf must be
    present (replicas of one block may all be; they are equal)."""
    names = list(mesh.shape)
    items = list(parts.items())
    first = items[0][1]
    full_shape = [dim * axis_size(mesh, spec[d] if d < len(spec) else None)
                  for d, dim in enumerate(first.shape)]
    out = torch.empty(full_shape, dtype=first.dtype, device=first.device)
    for coord, block in items:
        coords = dict(zip(names, coord))
        pieces = _blocks(tuple(full_shape), spec, mesh, coords, glu)
        if len(pieces) == 1:
            out[pieces[0][0]] = block
            continue
        w = pieces[0][1]
        out[pieces[0][0]] = block[..., :w]
        out[pieces[1][0]] = block[..., w:]
    return out


def is_glu_leaf(path: str, cfg) -> bool:
    """Whether ``path`` is a fused GLU ``wi`` (the dense FFN's, under a
    swiglu/geglu activation), which takes the GLU cut."""
    return (cfg.activation in ("swiglu", "geglu")
            and re.search(r"(^|/)(dense|ffn|enc_ffn)/wi$", path) is not None)


def spec_at(specs, key: str) -> P:
    """The spec at leaf path ``key`` of a spec tree (a spec is a tuple, so
    ``tree.flatten`` would descend into it)."""
    node = specs
    for part in key.split("/"):
        node = (getattr(node, part) if hasattr(node, "_fields")
                else node[int(part)] if isinstance(node, list) else node[part])
    return node


def shard_params(params, specs, mesh, coords: Mapping[str, int], cfg):
    """Every leaf of ``params`` cut by its spec (``specs``: the same
    structure, e.g. :func:`param_pspecs`) for ``coords``."""
    out = {k: shard_leaf(v, spec_at(specs, k), mesh, coords,
                         glu=is_glu_leaf(k, cfg))
           for k, v in flatten(params).items()}
    return unflatten(params, out)
