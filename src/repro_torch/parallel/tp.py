"""Explicit-SPMD collectives of the tensor-parallel model code.

Every rank of a model group holds the same residual stream and its own
block of each sharded weight (``parallel/sharding.py``'s rules). A block
whose weights are cut computes a *partial* result — this rank's heads,
features, experts or vocab columns — and the model code marks its edges
with two operators, Megatron's f and g:

  * :func:`copy_to` at the entry (forward: identity; backward: all-reduce
    of the gradient over "model"), so a replicated input's gradient sums
    every rank's partial contribution;
  * :func:`reduce_from` at the exit (forward: all-reduce; backward:
    identity), after the contracting projection (``wo``).

:func:`gather` puts a cut weight back together on every rank where a block
computes it whole (a K/V projection whose heads do not divide the model
axis); its backward is this rank's slice of the gradient, summed over the
group first when the consumer was partial. Without grad mode the plain
collectives run, with no autograd node. Gradients need these operators,
not ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
gradient of a replicated output m times.

:func:`argmax` is the greedy token over vocab-sharded logits: each rank's
max and (global) argmax, gathered; ties go to the lowest global index, as
``torch.argmax`` gives them on the whole row.

Sequence parallelism (Megatron's, JAX's ``hidden`` rule at S >= 2048:
``parallel.activation.seq_sharded``). Inside :func:`seq_split` the
residual stream between blocks is this rank's ``S/m`` rows. A partial
block enters through :func:`gather_seq` (all-gather along S; backward
reduce-scatter) in place of :func:`copy_to`, and leaves through
:func:`scatter_seq` (reduce-scatter; backward all-gather) in place of
:func:`reduce_from` — the same wire as the all-reduce they replace. A
whole block gathers the sequence (backward: its slice, since every rank
computes the whole gradient) and leaves through :func:`split_seq` (its
rows; backward all-gather). :func:`enter`, :func:`leave`,
:func:`enter_whole` and :func:`leave_whole` pick the pair; outside
:func:`seq_split` they are the plain TP edges.

A decode cache cut into sequence blocks (``parallel.sharding.cache_pspecs``
under ``parallel.activation.use(..., cache_specs=)``, :func:`cache_cut`):
each rank attends its block and :func:`combine_partials` joins the
blocks' results from their log-sum-exps, in a fixed order, after an
all-gather (:func:`combine_blocks`), so every rank gets the same bits.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel import activation as act

__all__ = ["active", "block_mode", "gather_cut", "copy_to", "reduce_from",
           "gather", "argmax", "all_gather_cat", "gather_tree",
           "gather_fsdp", "seq_split", "gather_seq", "scatter_seq",
           "split_seq", "enter", "leave", "enter_whole", "leave_whole",
           "seq_replicated", "Block", "cache_cut", "combine_partials",
           "combine_blocks"]


def active():
    """The installed policy when its model axis is wider than one, else
    None (the single-device code path)."""
    pol = act.policy()
    return pol if pol is not None and pol.nmdl > 1 else None


def _group():
    return act.policy().model_group


def block_mode(params, widths, key: str, *, units=lambda m: True):
    """How a block runs on this rank — the one place the model code asks.

    ``widths`` ({leaf: (dim, whole width)}) are the block's leaves the
    sharding rules may cut over "model"; a leaf of this rank narrower than
    its whole width is cut. The mode is None with no model axis wider than
    one (the single-device code); "partial" when ``key`` is cut and
    ``units(m)`` says the cut falls on whole units of the block (heads,
    gate blocks): the block computes this rank's part and sums it over
    "model"; else "whole": every rank computes the whole block, its cut
    leaves put back together (:func:`gather_cut`)."""
    pol = active()
    if pol is None:
        return None
    dim, whole = widths[key]
    return ("partial" if params[key].shape[dim] != whole
            and units(pol.nmdl) else "whole")


def gather_cut(params, widths, names=None) -> dict:
    """``params`` with every leaf of ``widths`` (of ``names``, when given)
    that this rank holds cut gathered whole over "model", for a block that
    computes whole."""
    p = dict(params)
    for n in (widths if names is None else names):
        dim, whole = widths[n]
        if n in p and p[n].shape[dim] != whole:
            p[n] = gather(p[n], dim, partial=False)
    return p


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in
    rank order."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    w = x.shape[dim] // n
    return x.narrow(dim, r * w, w).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.partial:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return (_slice(g, ctx.dim, dist.get_world_size(ctx.group),
                       dist.get_rank(ctx.group)), None, None, None)


def _graph(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """Entry of a partial block (f): identity forward, all-reduced
    gradient."""
    return _CopyTo.apply(x, _group()) if _graph(x) else x


def reduce_from(x: torch.Tensor, group=None) -> torch.Tensor:
    """Exit of a partial block (g): the sum over the model group."""
    group = group if group is not None else _group()
    if _graph(x):
        return _ReduceFrom.apply(x, group)
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def gather(w: torch.Tensor, dim: int, *, partial: bool) -> torch.Tensor:
    """The whole of a model-cut ``w`` (a contiguous cut along ``dim``) on
    every rank. ``partial``: the consumer computes a partial result (its
    gradient is summed over the group before this rank takes its
    slice)."""
    group = _group()
    dim = dim % w.ndim
    return (_Gather.apply(w, group, dim, partial) if _graph(w)
            else all_gather_cat(w, group, dim))


def argmax(local_logits: torch.Tensor) -> torch.Tensor:
    """Greedy token ids (int64, shape ``local_logits.shape[:-1]``) over
    logits cut on the vocab axis: rank r holds columns [r·v, (r+1)·v)."""
    pol = act.policy()
    group, r = pol.model_group, pol.mrank
    v = local_logits.shape[-1]
    ix = torch.argmax(local_logits, dim=-1)
    mx = torch.gather(local_logits, -1, ix[..., None])[..., 0]
    vals = all_gather_cat(mx[None], group)                  # [m, ...]
    ids = all_gather_cat((ix + r * v)[None], group)         # [m, ...]
    best = torch.argmax(vals, dim=0, keepdim=True)          # lowest rank
    return torch.gather(ids, 0, best)[0]


def gather_tree(tree, specs, mesh, cfg, *, dst=None):
    """Every leaf of a mesh-placed tree (this rank's blocks, ``specs`` its
    partition specs) put back whole. A leaf that nothing cuts — every axis
    its spec names has size one, or it is not a tensor (an optimizer's
    Python step) — passes through as it is: no collective, no copy. A cut
    leaf's blocks are all-gathered and put together on every rank
    (``dst=None``), or gathered to rank ``dst`` alone and put together on
    its host (a checkpoint's writer; every other rank gets None). A
    collective: every rank calls it."""
    from repro_torch.parallel.sharding import (axis_size, gather_leaf,
                                               is_glu_leaf, spec_at)
    from repro_torch.tree import flatten, unflatten
    coords = {int(r): at for at, r in       # rank → its coordinate
              np.ndenumerate(mesh.device_mesh.mesh.numpy())}
    world, me = dist.get_world_size(), dist.get_rank()
    out = {}
    for key, leaf in flatten(tree).items():
        spec = spec_at(specs, key)
        if not torch.is_tensor(leaf) or all(axis_size(mesh, a) == 1
                                            for a in spec):
            out[key] = leaf
            continue
        leaf = leaf.contiguous()
        if dst is None:
            parts = [torch.empty_like(leaf) for _ in range(world)]
            dist.all_gather(parts, leaf)
        else:
            parts = ([torch.empty_like(leaf) for _ in range(world)]
                     if me == dst else None)
            dist.gather(leaf, parts, dst=dst)
            if me != dst:
                continue
            parts = [p.cpu() for p in parts]
        out[key] = gather_leaf({coords[r]: p for r, p in enumerate(parts)},
                               spec, mesh, glu=is_glu_leaf(key, cfg))
    if dst is not None and me != dst:
        return None
    return unflatten(tree, out)


def gather_fsdp(tree, specs, mesh):
    """The leaves of ``tree`` that a spec cuts over "data" (ZeRO-3)
    all-gathered over the data group along that dim; every other leaf as
    it is. The sharded executor gathers once per call (a horizon, a
    prefill), so between calls each rank stores 1/D of those leaves."""
    from repro_torch.parallel.sharding import spec_at
    from repro_torch.tree import flatten, unflatten
    group = mesh.group("data")
    out = {}
    for key, leaf in flatten(tree).items():
        spec = spec_at(specs, key)
        for d, axis in enumerate(spec):
            if axis == "data":
                leaf = all_gather_cat(leaf, group, d)
        out[key] = leaf
    return unflatten(tree, out)


# ------------------------------------------------------ sequence parallelism
_SEQ = False            # inside seq_split(True): the stream is cut along S


@contextlib.contextmanager
def seq_split(on: bool):
    """The residual stream is this rank's S/m rows (``on``) for the block's
    duration. Blocks enter it inside their own (rematerialised) function,
    with ``on`` taken at the forward, so a recompute takes the same path."""
    global _SEQ
    prev, _SEQ = _SEQ, bool(on)
    try:
        yield
    finally:
        _SEQ = prev


def _reduce_scatter(y: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    parts = [p.contiguous() for p in y.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, partial):
        ctx.group, ctx.partial = group, partial
        return all_gather_cat(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        if ctx.partial:
            return _reduce_scatter(g, ctx.group, 1), None, None
        return _slice(g, 1, n, dist.get_rank(ctx.group)), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _reduce_scatter(y, group, 1)

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 1), None


class _SplitSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _slice(y, 1, dist.get_world_size(group),
                      dist.get_rank(group))

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g, ctx.group, 1), None


def gather_seq(x: torch.Tensor, *, partial: bool = True) -> torch.Tensor:
    """``x [B, S/m, ...]`` of every model rank, concatenated along S in rank
    order. Backward: the gradient summed over the group, this rank's rows
    (``partial``: the consumer computes a partial result), or only this
    rank's rows (a whole consumer: every rank holds the whole gradient)."""
    group = _group()
    return (_GatherSeq.apply(x, group, partial) if _graph(x)
            else all_gather_cat(x, group, 1))


def scatter_seq(y: torch.Tensor) -> torch.Tensor:
    """This rank's S/m rows of the sum over the model group of ``y [B, S,
    ...]`` (reduce-scatter); backward all-gather."""
    group = _group()
    return (_ScatterSeq.apply(y, group) if _graph(y)
            else _reduce_scatter(y, group, 1))


def split_seq(y: torch.Tensor) -> torch.Tensor:
    """This rank's S/m rows of ``y [B, S, ...]``, which every rank holds
    whole; backward all-gather."""
    group = _group()
    if _graph(y):
        return _SplitSeq.apply(y, group)
    return _slice(y, 1, dist.get_world_size(group), dist.get_rank(group))


def enter(x: torch.Tensor) -> torch.Tensor:
    """Entry of a partial block: :func:`gather_seq` inside
    :func:`seq_split`, else :func:`copy_to`."""
    return gather_seq(x) if _SEQ else copy_to(x)


def leave(y: torch.Tensor, group=None) -> torch.Tensor:
    """Exit of a partial block: :func:`scatter_seq` inside
    :func:`seq_split`, else :func:`reduce_from` (over ``group``)."""
    return scatter_seq(y) if _SEQ else reduce_from(y, group)


def enter_whole(x: torch.Tensor) -> torch.Tensor:
    """Entry of a block every rank computes whole."""
    return gather_seq(x, partial=False) if _SEQ else x


def leave_whole(y: torch.Tensor) -> torch.Tensor:
    """Exit of a block every rank computes whole."""
    return split_seq(y) if _SEQ else y


def seq_replicated(tree):
    """A replicated leaf (a norm's scale) applied to this rank's rows:
    inside :func:`seq_split` marked with :func:`copy_to`, so its gradient
    sums every rank's rows; else as it is."""
    if not _SEQ:
        return tree
    if isinstance(tree, dict):
        return {k: seq_replicated(v) for k, v in tree.items()}
    return copy_to(tree)


# ------------------------------------------------- sequence-cut decode caches
class Block(NamedTuple):
    """Block ``j`` of ``n`` of a cache axis, cut over ``group`` (None and
    n = 1: the axis is whole on this rank)."""
    group: Optional[object]
    n: int
    j: int

    def rows(self, width: int) -> slice:
        """This block's slice of a whole axis of ``width``."""
        w = width // self.n
        return slice(self.j * w, (self.j + 1) * w)

    def whole(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` (this rank's block along ``dim``) gathered whole."""
        return x if self.n == 1 else all_gather_cat(x, self.group, dim)


def cache_cut(kind: str, leaf: str) -> Optional[Block]:
    """How this rank holds axis 2 of ``cache[kind][leaf]`` (the sequence
    of a KV leaf, the width or heads of a recurrent state): None where the
    installed policy has no ``cache_specs`` (the serve layout,
    ``decoder.local_cfg``: KV heads and RG-LRU width cut over "model"),
    else its :class:`Block` under those specs (the layout of
    ``sharding.cache_pspecs``: every KV head and the whole width on each
    rank, axis 2 cut where the specs say)."""
    from repro_torch.parallel.sharding import axis_size, spec_at
    pol = act.policy()
    if pol is None or pol.cache_specs is None:
        return None
    spec = spec_at(pol.cache_specs, f"{kind}/{leaf}")
    axis = spec[2] if len(spec) > 2 else None
    n = axis_size(pol.mesh, axis)
    if n == 1:
        return Block(None, 1, 0)
    return Block(pol.mesh.group(axis), n, pol.mesh.coord(axis))


def combine_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Attention over n blocks of one cache joined from each block's result
    ``outs [n, B, H, D]`` (f32) and log-sum-exp ``lses [n, B, H]``: with
    m* = max_i lse_i, out = sum_i e^(lse_i - m*) out_i / sum_i
    e^(lse_i - m*), the blocks summed in index order. A block with no
    attended token (lse -inf) has weight 0; a row no block attends gives
    0."""
    m = lses.amax(dim=0)                                       # [B, H]
    finite = torch.isfinite(m)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(m)
    for i in range(outs.shape[0]):
        w = torch.where(torch.isfinite(lses[i]) & finite,
                        torch.exp(lses[i] - torch.where(finite, m, 0.0)),
                        0.0)
        num = num + w[..., None] * outs[i]
        den = den + w
    return num / den.clamp_min(1e-30)[..., None]


def combine_blocks(out: torch.Tensor, lse: torch.Tensor,
                   block: Block) -> torch.Tensor:
    """:func:`combine_partials` over every rank of ``block.group``: this
    rank's ``out [B, H, D]`` and ``lse [B, H]`` all-gathered (rank order),
    then joined; every rank gets the same bits."""
    outs = all_gather_cat(out.float()[None], block.group)
    lses = all_gather_cat(lse.float()[None], block.group)
    return combine_partials(outs, lses)
