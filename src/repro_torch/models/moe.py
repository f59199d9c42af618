"""Mixture-of-Experts FFN with top-k routing (olmoe-1b-7b, dbrx-132b).

The port of ``repro/models/moe.py``. Two dispatch implementations:

* ``dense``   — every expert runs on every token, one-hot combine. Exact
                (dropless): the correctness oracle.
* ``scatter`` — capacity dispatch, the serving path: each (token, choice)
                assignment takes a slot in its expert's ``[C+1, D]`` buffer
                in (token-major, k-minor) order, all experts run as one
                batched product, and the results are gathered back with
                the routing weights. Assignments past an expert's capacity
                ``C`` drop (GShard semantics), so a token's output depends
                on the other tokens of its call; ``C`` follows the call's
                token count exactly as in JAX (:func:`_capacity`).

The expert products are ``torch.bmm`` (JAX runs them outside any Pallas
kernel too); the GLU between them goes through the fused GLU kernel on the
``[E, C+1, 2F]`` buffer (its plain version on CPU tensors). The combine
gathers ``[T·k, D]`` and sums each token's k rows in order — no atomic
scatter-add, so two launches give the same bits.

``groups`` splits the batch axis into independent token groups, each with
its own capacity and ranking: the twin of JAX's ``vmap`` over candidate
masks in GSI scoring (``core/gsi.py`` batches the candidates into one
forward). Under a model axis that divides the experts, ``moe_ffn`` takes
the expert-parallel dispatch (:func:`moe_ffn_ep`): each model rank runs
its E/m experts on every token of the call and the partial combines are
summed over "model".
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.ffn import glu_activate
from repro_torch.parallel import tp


def init_moe_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` MoE blocks: wi [n, E, D, 2F] and wo
    [n, E, F, D] in the param dtype, the router [n, D, E] in f32 (as in
    JAX, whatever the param dtype). Drawn expert by expert, so the f32
    temporary is one expert's matrix, never the whole stack."""
    pd = cfg.torch_param_dtype()
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    wi = torch.empty(n, E, D, 2 * F, dtype=pd, device=device)
    wo = torch.empty(n, E, F, D, dtype=pd, device=device)
    router = torch.empty(n, D, E, dtype=torch.float32, device=device)
    scale_o = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    for i in range(n):
        for e in range(E):
            layers.dense_init_(wi[i, e], gen)
            layers.dense_init_(wo[i, e], gen, scale=scale_o)
        layers.dense_init_(router[i], gen)
    return {"wi": wi, "wo": wo, "router": router}


def _route(params, cfg, x):
    """x: [T, D] → (weights [T, k] in x.dtype, expert_idx [T, k]): f32
    router logits, softmax, top-k renormalised. A tie keeps the lower
    expert index first, as ``jax.lax.top_k`` does (a stable descending
    sort; ``torch.topk`` promises no order)."""
    logits = torch.matmul(x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights.to(x.dtype), idx


def moe_ffn_dense(params, cfg, x):
    """Oracle path. x: [B, S, D]."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    weights, idx = _route(params, cfg, xt)                      # [T, k]
    onehot = torch.nn.functional.one_hot(idx, cfg.n_experts).to(x.dtype)
    combine = torch.einsum("tk,tke->te", weights, onehot)        # [T, E]
    h = torch.einsum("td,edf->tef", xt, params["wi"].to(x.dtype))
    h = glu_activate(h, cfg.activation)
    y = torch.einsum("tef,efd->ted", h, params["wo"].to(x.dtype))
    out = torch.einsum("ted,te->td", y, combine)
    return out.reshape(B, S, D)


def _capacity(cfg, T: int) -> int:
    """Slots per expert for a call of T tokens: ``capacity_factor · T · k /
    E``, rounded up to a multiple of 8 and at least 8, as in JAX. It is
    semantics, not a device detail: it decides which assignments drop."""
    c = int(math.ceil(cfg.moe_capacity_factor * T * cfg.moe_top_k
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)


def dispatch(cfg, idx, groups: int = 1):
    """Expert slots of the assignments ``idx [G·T, k]`` (G = ``groups``
    independent groups of T tokens, each with :func:`_capacity` ``(T)``
    slots per expert): returns (slot [G·T·k], keep [G·T·k] bool, C). An
    assignment's rank is its position among the same (group, expert)'s
    assignments in (token-major, k-minor) order — JAX's stable sort —
    and it is kept while the rank is below C; a dropped one points at the
    trash slot C."""
    E, k = cfg.n_experts, idx.shape[1]
    n = idx.numel()
    C = _capacity(cfg, n // (groups * k))
    grp = torch.arange(groups, device=idx.device).repeat_interleave(n // groups)
    key = idx.reshape(-1) + E * grp                          # (group, expert)
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    seg_start = torch.searchsorted(
        sorted_key, torch.arange(groups * E, device=idx.device))
    sorted_rank = torch.arange(n, device=idx.device) - seg_start[sorted_key]
    ranks = torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)
    keep = ranks < C
    return torch.where(keep, ranks, C), keep, C


def moe_ffn_scatter(params, cfg, x, groups: int = 1):
    """Serving path. x: [B, S, D]; ``groups`` must divide B."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    G = int(groups)
    if B % G:
        raise ValueError(f"{G} token groups do not divide a batch of {B}")
    xt = x.reshape(-1, D)
    weights, idx = _route(params, cfg, xt)                   # [G·T, k]
    slot, keep, C = dispatch(cfg, idx, G)
    T = xt.shape[0] // G
    tok = torch.arange(G * T, device=x.device).repeat_interleave(k)
    # row of each assignment in the [E, G·(C+1), D] buffer: its expert's
    # block, its group's C+1 slots, its slot
    row = (idx.reshape(-1) * (G * (C + 1))
           + (tok // T) * (C + 1) + slot)
    # the kept assignments own distinct rows; a dropped one writes zeros
    # into its trash row, which is never read back
    src = torch.where(keep[:, None], xt[tok], torch.zeros((), dtype=x.dtype,
                                                          device=x.device))
    buf = torch.zeros(E * G * (C + 1), D, dtype=x.dtype, device=x.device)
    buf[row] = src
    h = torch.bmm(buf.view(E, G * (C + 1), D), params["wi"].to(x.dtype))
    h = glu_activate(h, cfg.activation)
    y = torch.bmm(h, params["wo"].to(x.dtype)).view(-1, D)
    gathered = y[row] * keep[:, None].to(x.dtype)            # [G·T·k, D]
    wflat = weights.reshape(-1, 1).to(x.dtype)
    out = (gathered * wflat).view(G * T, k, D).sum(dim=1)
    return out.reshape(B, S, D)


def _local_dispatch(cfg, xt, weights, idx, wi, wo, e_lo: int, E_loc: int):
    """Capacity dispatch restricted to experts [e_lo, e_lo + E_loc).

    xt [T, D]; weights/idx [T, k]; wi [E_loc, D, 2F]; wo [E_loc, F, D].
    Returns the partial combine ([T, D]) of the local experts only: every
    assignment takes its rank among its expert's assignments in
    (token-major, k-minor) order, as in :func:`dispatch`, so the kept set
    is the one the whole dispatch keeps; assignments to other experts go
    to a sentinel bin and add nothing."""
    T, D = xt.shape
    k = idx.shape[1]
    C = _capacity(cfg, T)
    dev = xt.device
    flat_e = idx.reshape(-1) - e_lo                        # local ids
    inside = (flat_e >= 0) & (flat_e < E_loc)
    flat_e = torch.where(inside, flat_e, E_loc)            # sentinel bin
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E_loc + 1, device=dev, dtype=sorted_e.dtype))
    sorted_rank = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    ranks = torch.empty_like(sorted_rank).scatter_(0, order, sorted_rank)
    keep = inside & (ranks < C)
    slot = torch.where(keep, ranks, C)
    tok = torch.arange(T, device=dev).repeat_interleave(k)
    row = torch.clamp(flat_e, max=E_loc - 1) * (C + 1) + slot
    src = torch.where(keep[:, None], xt[tok],
                      torch.zeros((), dtype=xt.dtype, device=dev))
    buf = torch.zeros(E_loc * (C + 1), D, dtype=xt.dtype, device=dev)
    buf[row] = src
    h = torch.bmm(buf.view(E_loc, C + 1, D), wi.to(xt.dtype))
    h = glu_activate(h, cfg.activation)
    y = torch.bmm(h, wo.to(xt.dtype)).view(-1, D)
    gathered = y[row] * keep[:, None].to(xt.dtype)
    wflat = weights.reshape(-1, 1).to(xt.dtype)
    return (gathered * wflat).view(T, k, D).sum(dim=1)


def moe_ffn_ep(params, cfg, x, pol, groups: int = 1):
    """Expert-parallel dispatch over the policy's model group.

    x is replicated across "model" (each data rank's own tokens), so no
    token all-to-all is needed: each model rank routes every token, runs
    only its E/m experts at the capacity of the whole call, and the
    partial combines are summed with one all-reduce over "model" (the
    wire of a dense FFN's ``wo``). ``groups`` (dividing B) dispatches each
    group of rows on its own, as :func:`moe_ffn_scatter` does."""
    B, S, D = x.shape
    G = int(groups)
    if B % G:
        raise ValueError(f"{G} token groups do not divide a batch of {B}")
    m, r = pol.nmdl, pol.mrank
    E_loc = cfg.n_experts // m
    router = params["router"]
    if tp.active() is not None:
        x, router = tp.enter(x), tp.copy_to(router)
        B, S, D = x.shape       # the whole sequence under tp.seq_split
    xt = x.reshape(-1, D)
    weights, idx = _route({"router": router}, cfg, xt)
    T = xt.shape[0] // G
    out = torch.cat([_local_dispatch(cfg, xt[g * T:(g + 1) * T],
                                     weights[g * T:(g + 1) * T],
                                     idx[g * T:(g + 1) * T], params["wi"],
                                     params["wo"], r * E_loc, E_loc)
                     for g in range(G)])
    return tp.leave(out.reshape(B, S, D), pol.model_group)


def moe_ffn(params, cfg, x, *, impl: str = "scatter", groups: int = 1):
    """``impl="dense"``: the oracle; anything else the scatter path, or,
    under a model axis of m > 1 that divides the experts, the
    expert-parallel one (:func:`moe_ffn_ep`). ``groups``: independent
    token groups along the batch axis (the dense path drops nothing, so
    groups do not change it)."""
    if impl == "dense":
        return moe_ffn_dense(params, cfg, x)
    if tp.block_mode(params, {"wi": (-3, cfg.n_experts)}, "wi") == "partial":
        return moe_ffn_ep(params, cfg, x, tp.active(), groups)
    return tp.leave_whole(moe_ffn_scatter(params, cfg, tp.enter_whole(x),
                                          groups))
