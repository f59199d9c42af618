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
forward). The expert-parallel dispatch (``moe_ffn_ep``) is multi-GPU,
ROADMAP queue 1, item 16.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers
from repro_torch.models.ffn import glu_activate


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


def moe_ffn(params, cfg, x, *, impl: str = "scatter", groups: int = 1):
    """``impl="dense"``: the oracle; anything else the scatter path.
    ``groups``: independent token groups along the batch axis (scatter
    only; the dense path drops nothing, so groups do not change it)."""
    if impl == "dense":
        return moe_ffn_dense(params, cfg, x)
    return moe_ffn_scatter(params, cfg, x, groups)
