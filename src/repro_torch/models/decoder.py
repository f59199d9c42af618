"""Decoder-only LM: the uniform all-attention paths.

Parameters live in per-kind *stacks* (leading axis = number of layers of
that kind), as in ``repro/models/decoder.py``; the layer loop is a Python
loop where JAX used ``lax.scan``. RAP's masked mode multiplies each residual
branch by a 0/1 gate: ``gates`` = {"mixer": [L] or [L, B], "ffn": ...}; the
[L, B] form gives every batch row its own keep-mask (continuous batching,
and the batched GSI scoring forward).

Heterogeneous layouts (recurrent, SSD, MoE, local attention) are later
slices (ROADMAP queue 1, items 11-14) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import attention, ffn as ffn_mod, layers


class LayerSlot(NamedTuple):
    mixer: Optional[str]   # attn|local_attn|rglru|ssd|None
    mixer_idx: int         # index into the kind's stack
    ffn: Optional[str]     # dense|moe|None
    ffn_idx: int


def default_layout(cfg) -> Tuple[LayerSlot, ...]:
    slots = []
    counts: Dict[str, int] = {}
    for mixer, f in cfg.layer_specs():
        mk = "attn" if mixer == "local_attn" else mixer
        mi = counts.get(mk, 0)
        counts[mk] = mi + 1
        if f == "none":
            fk, fi = None, 0
        else:
            fi = counts.get(f, 0)
            counts[f] = fi + 1
            fk = f
        slots.append(LayerSlot(mixer, mi, fk, fi))
    return tuple(slots)


def layout_counts(layout) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for s in layout:
        if s.mixer is not None:
            mk = "attn" if s.mixer == "local_attn" else s.mixer
            counts[mk] = max(counts.get(mk, 0), s.mixer_idx + 1)
        if s.ffn is not None:
            counts[s.ffn] = max(counts.get(s.ffn, 0), s.ffn_idx + 1)
    return counts


def _check_uniform(cfg) -> None:
    if not all(m == "attn" and f == "dense" for m, f in cfg.layer_specs()):
        raise NotImplementedError(
            f"{cfg.name!r} mixes {sorted(set(cfg.layer_specs()))}; only "
            f"uniform attention + dense-FFN decoders are ported so far "
            f"(other architectures: ROADMAP queue 1, items 11-14)")


# --------------------------------------------------------------------- params
def init_params(gen: torch.Generator, cfg, device) -> dict:
    """Random parameters drawn from ``gen`` on ``device``, in the JAX
    package's pytree layout (see ``repro_torch.bridge``)."""
    _check_uniform(cfg)
    counts = layout_counts(default_layout(cfg))
    pd = cfg.torch_param_dtype()
    zeros = lambda *s: torch.zeros(*s, dtype=pd, device=device)
    embed = torch.empty(cfg.vocab_padded, cfg.d_model, dtype=pd, device=device)
    params: dict = {"embed": layers.embed_init_(embed, gen),
                    "final_norm": {"scale": zeros(cfg.d_model)}}
    if not cfg.tie_embeddings:
        head = torch.empty(cfg.d_model, cfg.vocab_padded, dtype=pd,
                           device=device)
        params["lm_head"] = layers.dense_init_(head, gen)
    params["stacks"] = {
        "attn": dict(norm={"scale": zeros(counts["attn"], cfg.d_model)},
                     **attention.init_attn_params(gen, cfg, counts["attn"],
                                                  device)),
        "dense": dict(norm={"scale": zeros(counts["dense"], cfg.d_model)},
                      **ffn_mod.init_ffn_params(gen, cfg, counts["dense"],
                                                device)),
    }
    return params


def tree_slice(tree, idx: int):
    if isinstance(tree, dict):
        return {k: tree_slice(v, idx) for k, v in tree.items()}
    return tree[idx]


# --------------------------------------------------------------- helpers
def _embed(params, cfg, tokens):
    h = params["embed"][tokens].to(cfg.torch_dtype())
    if cfg.embed_scale:
        h = h * math.sqrt(cfg.d_model)
    return h


def _unembed(params, cfg, h):
    """Final norm + LM head → f32 logits. The product runs in the model
    dtype (JAX accumulates a bf16 einsum straight into f32; here a bf16
    product is rounded once before the cast)."""
    h = layers.apply_norm(cfg, params["final_norm"], h)
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(h, w.to(h.dtype)).float()


def _ones_gates(n_layers: int, device):
    return {"mixer": torch.ones(n_layers, device=device),
            "ffn": torch.ones(n_layers, device=device)}


def _bgate(g, ref):
    """Broadcast one layer's gate against an activation [B, S, D]: a scalar
    (one keep-mask for the batch) or a [B] row (one keep-mask per row)."""
    g = g.to(ref.dtype)
    if g.ndim == 0:
        return g
    return g.reshape(g.shape + (1,) * (ref.ndim - g.ndim))


def _block(params, cfg, i, h, gates, mixer_out):
    """Residual updates of layer ``i`` around its mixer output."""
    h = h + _bgate(gates["mixer"][i], h) * mixer_out
    pf = tree_slice(params["stacks"]["dense"], i)
    hn = layers.apply_norm(cfg, pf["norm"], h)
    return h + _bgate(gates["ffn"][i], h) * ffn_mod.ffn(pf, cfg, hn)


# -------------------------------------------------------------------- forward
def forward(params, cfg, tokens, *, gates=None, unembed: bool = True):
    """Full-sequence forward. Returns (logits f32 [B,S,Vp], None);
    ``unembed=False`` returns the pre-final-norm hidden state instead."""
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        out, _ = attention.attention(pm, cfg, layers.apply_norm(
            cfg, pm["norm"], h), positions)
        h = _block(params, cfg, i, h, gates, out)
    if not unembed:
        return h, None
    return _unembed(params, cfg, h), None


def prefill(params, cfg, tokens, max_len: int, *,
            gates=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; return (last-position logits [B,Vp], cache) with
    cache {"attn": {"k","v"} [L, B, max_len, K, Dh], "pos"}: the prompt's
    K/V in positions [0, S), zeros after."""
    _check_uniform(cfg)
    B, S = tokens.shape
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=h.device)[None, :]
    shape = (L, B, max_len, cfg.n_kv_heads, cfg.dh)
    cache = {"attn": {"k": torch.zeros(shape, dtype=h.dtype, device=h.device),
                      "v": torch.zeros(shape, dtype=h.dtype, device=h.device)},
             "pos": S}
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        out, kv = attention.attention(pm, cfg, layers.apply_norm(
            cfg, pm["norm"], h), positions)
        cache["attn"]["k"][i, :, :S] = kv["k"]
        cache["attn"]["v"][i, :, :S] = kv["v"]
        h = _block(params, cfg, i, h, gates, out)
    logits = _unembed(params, cfg, h[:, -1:, :])[:, 0]
    return logits, cache


# --------------------------------------------------------------------- decode
def paged_decode_step(params, cfg, pools: dict, page_table, pos, tokens, *,
                      gates=None) -> torch.Tensor:
    """One autoregressive step against a paged KV pool.

    pools: {"k","v"} page arrays [L, n_pages, page_tokens, K, Dh], updated
    in place (one new token per row); page_table: int32 [B, max_pages];
    pos: int32 [B] per-row write positions; tokens: [B, 1]. Gates may be
    [L] or [L, B]. Returns logits [B, 1, Vp].
    """
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        kv = {"k": pools["k"][i], "v": pools["v"][i]}
        out = attention.paged_decode_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h), kv, page_table,
            pos)
        h = _block(params, cfg, i, h, gates, out)
    return _unembed(params, cfg, h)


def paged_decode_horizon(params, cfg, pools: dict, page_table, pos, tokens,
                         horizon: int, *, gates=None):
    """``horizon`` greedy paged decode steps with the argmax token fed back
    on the device (the loop form of JAX's ``lax.scan``): nothing is read
    back to the host inside the loop. The page table is constant across
    the horizon — callers pre-grant every page it can touch. Returns
    (toks int32 [B, horizon], pools, pos + horizon)."""
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    tok = tokens
    toks = []
    for _ in range(horizon):
        logits = paged_decode_step(params, cfg, pools, page_table, pos, tok,
                                   gates=gates)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks.append(nxt)
        tok = nxt[:, None]
        pos = pos + 1
    return torch.stack(toks, dim=1), pools, pos
