"""Static structured-pruning baselines the paper compares against (§5.1).

The port of ``repro/core/baselines.py``. Every baseline but SliceGPT emits
a boolean keep-mask over the 2L blocks (mixer blocks first, FFN blocks
second, as in ``repro_torch.core.memory``), pruning in a removal order
until the unified memory budget (params + KV for the request shape) is
met. Each factors into a *removal order* (the expensive model probe,
scored once) and the shared budget-fitting loop :func:`prune_by_order`;
``repro_torch.core.policy`` wraps the orders into serving policies, and the
``*_mask`` forms keep the one-call offline protocol. SliceGPT slices width
instead and returns (params', cfg').

 * ShortGPT    — Block-Influence 1 − cos(h_in, h_out) per *layer*; the
                 lowest-influence layers go first.     [Men et al. 2024]
 * MHA-Drop    — the same cosine per attention block. [He et al. 2024]
 * FFN-Skip    — the same cosine per FFN block.       [Jaiswal et al. 2024]
 * LLMPruner   — first-order Taylor saliency |g ⊙ w| summed per block; the
                 gradient of the loss runs through the kernels on the card
                 (``kernels.ops.KernelGrad``).         [Ma et al. 2023]
 * SliceGPT    — the reference's stand-in: the lowest-L2 d_ff channels and
                 KV-head groups sliced to a uniform width ratio (magnitude
                 ranking in place of the PCA rotation).
 * Random-Drop — uniform random blocks (the RAP^-RL ablation).
 * One-shot    — dense-model Δppl scores without re-evaluation (RAP^-GSI).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import gsi as gsi_lib
from repro_torch.core import masks as masks_lib
from repro_torch.core.memory import MemoryModel
from repro_torch.models import decoder
from repro_torch.tree import flatten, unflatten


def _stack_key(kind: str) -> str:
    return "attn" if kind == "local_attn" else kind


# ----------------------------------------------------------- cosine probes
def block_cosines(model, params, batch) -> Tuple[np.ndarray, np.ndarray]:
    """Per-block residual influence: 1 − cos(h, h + out), the mean over
    positions in f32. Returns (mixer_scores [L], ffn_scores [L]), ∞ where
    a layer has no such block; low score = redundant."""
    cfg = model.cfg
    layout = decoder.default_layout(cfg)

    def cos(a, b):
        a = a.float().reshape(-1, a.shape[-1])
        b = b.float().reshape(-1, b.shape[-1])
        num = torch.sum(a * b, -1)
        den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) \
            + 1e-9
        return torch.mean(num / den)

    mix_s, ffn_s = [], []
    with torch.no_grad():
        h = decoder._embed(params, cfg, batch["tokens"])
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        for slot in layout:
            if slot.mixer is not None:
                pm = decoder.tree_slice(params["stacks"][_stack_key(slot.mixer)],
                                        slot.mixer_idx)
                h2 = h + decoder._apply_mixer(slot.mixer, pm, cfg, h,
                                              positions)
                mix_s.append(1.0 - cos(h, h2))
                h = h2
            else:
                mix_s.append(None)
            if slot.ffn is not None:
                pf = decoder.tree_slice(params["stacks"][slot.ffn],
                                        slot.ffn_idx)
                h2 = h + decoder._apply_ffn(slot.ffn, pf, cfg, h)
                ffn_s.append(1.0 - cos(h, h2))
                h = h2
            else:
                ffn_s.append(None)
    # one read-back for every block
    vals = [s for s in mix_s + ffn_s if s is not None]
    got = iter(torch.stack(vals).cpu().tolist() if vals else [])
    out = [np.inf if s is None else next(got) for s in mix_s + ffn_s]
    L = len(layout)
    return np.asarray(out[:L]), np.asarray(out[L:])


def taylor_saliency(model, params, batch) -> np.ndarray:
    """LLMPruner-style |g ⊙ w| per block → [2L] (∞ where a block is
    missing): g is the gradient of the calibration loss with respect to
    the layer stacks (the embedding and head get none: no block owns
    them), summed per block in f32 over every leaf of its stack row."""
    cfg = model.cfg
    L = cfg.n_layers
    stacks = {kind: {k: v.detach().requires_grad_(True)
                     for k, v in flatten(tree).items()}
              for kind, tree in params["stacks"].items()}
    p = dict(params)
    p["stacks"] = {kind: unflatten(params["stacks"][kind], leaves)
                   for kind, leaves in stacks.items()}
    loss, _ = model.loss(p, batch)
    wrt = [(kind, k, v) for kind, leaves in sorted(stacks.items())
           for k, v in sorted(leaves.items())]
    grads = torch.autograd.grad(loss, [v for _, _, v in wrt])
    del loss, p
    g_of = {(kind, k): g for (kind, k, _), g in zip(wrt, grads)}

    def block(kind: str, idx: int):
        # leaves in the reference's order (sorted keys), each |g ⊙ w| in f32
        return sum(torch.sum(torch.abs(g_of[kind, k][idx].float()
                                       * v[idx].detach().float()))
                   for k, v in sorted(stacks[kind].items()))

    rows, where = [], []
    with torch.no_grad():
        for i, slot in enumerate(decoder.default_layout(cfg)):
            if slot.mixer is not None:
                rows.append(block(_stack_key(slot.mixer), slot.mixer_idx))
                where.append(i)
            if slot.ffn is not None:
                rows.append(block(slot.ffn, slot.ffn_idx))
                where.append(L + i)
        vals = torch.stack(rows).cpu().tolist() if rows else []
    sal = np.full(2 * L, np.inf)
    sal[where] = vals
    return sal


# ----------------------------------------------------- mask-based baselines
def prune_by_order(order, mm: MemoryModel, bs, sql, budget,
                   allowed: Optional[np.ndarray] = None) -> np.ndarray:
    """Remove blocks in ``order`` (most-redundant first) until the budget
    fits."""
    mask = masks_lib.full_mask(mm.n_layers)
    for b in order:
        if mm.peak_bytes(mask, bs, sql) <= budget:
            break
        if allowed is not None and not allowed[b]:
            continue
        mask[b] = False
    return mask


def shortgpt_order(model, params, batch, mm) -> list:
    """Layer-level removal order: (mixer, ffn) pairs by combined cosine
    influence, most-redundant layer first."""
    mix_s, ffn_s = block_cosines(model, params, batch)
    L = mm.n_layers
    layer_score = np.where(np.isfinite(mix_s), mix_s, 0) + \
        np.where(np.isfinite(ffn_s), ffn_s, 0)
    order = []
    for i in np.argsort(layer_score):    # drop the whole layer (both blocks)
        order += [int(i), int(L + i)]
    return order


def mha_drop_order(model, params, batch, mm) -> list:
    mix_s, _ = block_cosines(model, params, batch)
    return [int(i) for i in np.argsort(mix_s) if np.isfinite(mix_s[i])]


def ffn_skip_order(model, params, batch, mm) -> list:
    _, ffn_s = block_cosines(model, params, batch)
    L = mm.n_layers
    return [int(L + i) for i in np.argsort(ffn_s) if np.isfinite(ffn_s[i])]


def random_drop_order(model, mm, seed=0) -> list:
    rng = np.random.default_rng(seed)
    layout = decoder.default_layout(model.cfg)
    present = np.array([s.mixer is not None for s in layout]
                       + [s.ffn is not None for s in layout])
    return [int(i) for i in rng.permutation(np.nonzero(present)[0])]


def oneshot_ppl_order(model, params, batch, chunk: int = 8) -> list:
    """RAP^-GSI: dense-model one-shot Δppl scores, no re-evaluation."""
    scores = gsi_lib.oneshot_rank(model, params, batch, chunk=chunk)
    return [int(i) for i in np.argsort(scores) if np.isfinite(scores[i])]


def llmpruner_order(model, params, batch, mm) -> list:
    sal = taylor_saliency(model, params, batch)
    return [int(i) for i in np.argsort(sal) if np.isfinite(sal[i])]


def shortgpt_mask(model, params, batch, mm, bs, sql, budget) -> np.ndarray:
    """Layer-level: removes (mixer, ffn) pairs by combined cosine influence."""
    return prune_by_order(shortgpt_order(model, params, batch, mm),
                          mm, bs, sql, budget)


def mha_drop_mask(model, params, batch, mm, bs, sql, budget) -> np.ndarray:
    return prune_by_order(mha_drop_order(model, params, batch, mm),
                          mm, bs, sql, budget)


def ffn_skip_mask(model, params, batch, mm, bs, sql, budget) -> np.ndarray:
    return prune_by_order(ffn_skip_order(model, params, batch, mm),
                          mm, bs, sql, budget)


def random_drop_mask(model, mm, bs, sql, budget, seed=0) -> np.ndarray:
    return prune_by_order(random_drop_order(model, mm, seed=seed),
                          mm, bs, sql, budget)


def oneshot_ppl_mask(model, params, batch, mm, bs, sql, budget,
                     chunk: int = 8) -> np.ndarray:
    """RAP^-GSI: dense-model one-shot Δppl scores, no re-evaluation."""
    return prune_by_order(oneshot_ppl_order(model, params, batch, chunk=chunk),
                          mm, bs, sql, budget)


def llmpruner_mask(model, params, batch, mm, bs, sql, budget) -> np.ndarray:
    return prune_by_order(llmpruner_order(model, params, batch, mm),
                          mm, bs, sql, budget)


# ------------------------------------------------------- SliceGPT stand-in
def _top(norm, keep: int):
    """Per layer, the indices of the ``keep`` largest norms (ties in index
    order, as JAX's stable argsort of −norm)."""
    return torch.argsort(-norm, dim=1, stable=True)[:, :keep]


def _take(x, idx, axis: int):
    """Per layer l: ``x[l]`` indexed by ``idx[l]`` along ``axis`` (counted
    after the layer axis)."""
    return torch.stack([torch.index_select(x[l], axis, idx[l])
                        for l in range(x.shape[0])])


def slicegpt_slice(model, params, ratio: float):
    """Uniform width slicing to ``ratio``: keeps the top-|L2| d_ff channels
    and the top-|L2| KV heads with their G query heads (GQA stays
    consistent). Returns (params', cfg'), evaluable like any other model."""
    cfg = model.cfg
    keep_f = max(8, int(round(cfg.d_ff * ratio)))
    kv_keep = max(1, int(round(cfg.n_kv_heads * ratio)))
    G = cfg.n_heads // max(cfg.n_kv_heads, 1)
    new_cfg = cfg.replace(d_ff=keep_f, n_kv_heads=kv_keep,
                          n_heads=kv_keep * G, head_dim=cfg.dh)
    st = dict(params["stacks"])
    Ln, D, dh, K, F = cfg.n_layers, cfg.d_model, cfg.dh, cfg.n_kv_heads, \
        cfg.d_ff

    with torch.no_grad():
        if "dense" in st:
            tree = st["dense"]
            wi, wo = tree["wi"], tree["wo"]          # [L,D,2F], [L,F,D]
            gate, up = wi[..., :F], wi[..., F:]
            norm = (torch.linalg.norm(gate.float(), dim=1)
                    + torch.linalg.norm(up.float(), dim=1)
                    + torch.linalg.norm(wo.float(), dim=2))      # [L,F]
            idx = _top(norm, keep_f)
            new = dict(tree)
            new["wi"] = torch.cat([_take(gate, idx, 1), _take(up, idx, 1)],
                                  dim=-1)
            new["wo"] = _take(wo, idx, 0)
            st["dense"] = new

        if "attn" in st and cfg.n_kv_heads > 0:
            tree = st["attn"]
            wk = tree["wk"].reshape(Ln, D, K, dh)
            kidx = _top(torch.linalg.norm(wk.float(), dim=(1, 3)), kv_keep)
            take_kv = lambda m: _take(m.reshape(Ln, D, K, dh), kidx, 1) \
                .reshape(Ln, D, kv_keep * dh)
            take_q = lambda m: _take(m.reshape(Ln, D, K, G, dh), kidx, 1) \
                .reshape(Ln, D, kv_keep * G * dh)
            take_o = lambda m: _take(m.reshape(Ln, K, G, dh, D), kidx, 0) \
                .reshape(Ln, kv_keep * G * dh, D)
            new = dict(tree)
            new["wq"] = take_q(tree["wq"])
            new["wk"] = take_kv(tree["wk"])
            new["wv"] = take_kv(tree["wv"])
            new["wo"] = take_o(tree["wo"])
            if cfg.qkv_bias:
                new["bq"] = _take(tree["bq"].reshape(Ln, K, G, dh), kidx,
                                  0).reshape(Ln, kv_keep * G * dh)
                for b in ("bk", "bv"):
                    new[b] = _take(tree[b].reshape(Ln, K, dh), kidx,
                                   0).reshape(Ln, kv_keep * dh)
            st["attn"] = new

    p = dict(params)
    p["stacks"] = st
    return p, new_cfg


def slicegpt_fit_ratio(cfg, mm: MemoryModel, bs, sql, budget,
                       tol: float = 1e-3) -> float:
    """Bisect the width ratio whose (params + KV) footprint meets the
    budget. Width slicing scales block params and the KV cache ~ratio."""
    lo, hi = 0.05, 1.0
    full = masks_lib.full_mask(cfg.n_layers)
    embed = mm.embed_bytes
    blocks = mm.param_bytes(full) - embed
    state = mm.state_bytes(full, bs, sql)
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if embed + blocks * mid + state * mid <= budget:
            lo = mid
        else:
            hi = mid
    return lo


BASELINES = ("shortgpt", "mha_drop", "ffn_skip", "random", "oneshot",
             "llmpruner", "slicegpt")
