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
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel import activation as act

__all__ = ["active", "block_mode", "gather_cut", "copy_to", "reduce_from",
           "gather", "argmax", "all_gather_cat", "gather_tree",
           "gather_fsdp"]


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
