"""Decoder-only LM: the uniform all-attention paths.

Parameters live in per-kind *stacks* (leading axis = number of layers of
that kind), as in ``repro/models/decoder.py``; the layer loop is a Python
loop where JAX used ``lax.scan``. RAP's masked mode multiplies each residual
branch by a 0/1 gate: ``gates`` = {"mixer": [L] or [L, B], "ffn": ...}; the
[L, B] form gives every batch row its own keep-mask (continuous batching,
and the batched GSI scoring forward).

Decode runs against a slot cache (:func:`init_cache`: one dense
``[L, B, S_max, K, Dh]`` cache per attention leaf, model-dtype or int8 with
per-(token, head) scales; :func:`decode_step`, :func:`decode_horizon`) or a
page pool (:func:`paged_decode_step`, :func:`paged_decode_horizon`).

Heterogeneous layouts (recurrent, SSD, MoE, local attention) are later
slices (ROADMAP queue 1, items 11-13) and raise ``NotImplementedError``.
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
            f"(other architectures: ROADMAP queue 1, items 11-13)")


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


# ---------------------------------------------------------------------- cache
def init_cache(cfg, batch: int, max_len: int, kv_dtype=None,
               device=None) -> dict:
    """Zeroed decode state of a uniform attention decoder: {"pos": 0,
    "attn": {"k","v"} [L, batch, max_len, K, Dh]} in ``kv_dtype`` (default
    the model dtype; ``torch.int8`` adds per-(token, head) scales)."""
    _check_uniform(cfg)
    return {"pos": 0,
            "attn": attention.init_kv_cache(cfg, batch, max_len,
                                            cfg.n_layers, kv_dtype, device)}


def prefill(params, cfg, tokens, max_len: int, *, gates=None,
            kv_dtype=None) -> Tuple[torch.Tensor, dict]:
    """Process the prompt; return (last-position logits [B,Vp], cache) with
    cache :func:`init_cache` ``(B, max_len, kv_dtype)`` holding the
    prompt's K/V in positions [0, S) (encoded by ``store_kv``), zeros
    after, and ``"pos"`` = S."""
    _check_uniform(cfg)
    B, S = tokens.shape
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    positions = torch.arange(S, device=h.device)[None, :]
    cache = init_cache(cfg, B, max_len, kv_dtype or h.dtype, h.device)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        out, kv = attention.attention(pm, cfg, layers.apply_norm(
            cfg, pm["norm"], h), positions)
        for key, val in attention.store_kv(cache["attn"], kv["k"],
                                           kv["v"]).items():
            cache["attn"][key][i, :, :S] = val
        h = _block(params, cfg, i, h, gates, out)
    cache["pos"] = S
    logits = _unembed(params, cfg, h[:, -1:, :])[:, 0]
    return logits, cache


# ------------------------------------------------------------ chunked prefill
def prefill_chunk(params, cfg, cache: dict, tokens, start: int, *,
                  gates=None) -> torch.Tensor:
    """One prompt chunk against a partly filled slot cache.

    cache: {"attn": {"k","v"} [L, B, S_max, K, Dh]} (an int8 cache adds
    {"ks","vs"}), written in place at [start, start + C); tokens: [B, C] at
    absolute offset ``start``.
    Running a prompt chunk by chunk and reading the last chunk's logits
    gives :func:`prefill`'s logits. Returns last-position logits [B, Vp]
    and sets ``cache["pos"]``."""
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        kv = {name: leaf[i] for name, leaf in cache["attn"].items()}
        out = attention.chunk_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h), kv, start)
        h = _block(params, cfg, i, h, gates, out)
    cache["pos"] = start + tokens.shape[1]
    return _unembed(params, cfg, h[:, -1:, :])[:, 0]


def paged_prefill_chunk(params, cfg, pools: dict, page_table, tokens,
                        start: int, *, scratch_page: int,
                        gates=None) -> torch.Tensor:
    """Paged sibling of :func:`prefill_chunk`: one prompt chunk written
    straight into granted pages.

    pools: {"k","v"} [L, n_pages, page_tokens, K, Dh] (quantized pools add
    {"ks","vs"} [L, n_pages, K]), updated in place; page_table: int32
    [B, max_pages]; tokens: [B, C] at absolute offset ``start``. Returns
    last-position logits [B, Vp]."""
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        out = attention.paged_chunk_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h),
            _pool_layer(pools, i), page_table, start,
            scratch_page=scratch_page)
        h = _block(params, cfg, i, h, gates, out)
    return _unembed(params, cfg, h[:, -1:, :])[:, 0]


def _pool_layer(pools: dict, i: int) -> dict:
    """Layer ``i``'s views of every pool leaf (pages and, for a quantized
    pool, the per-page scales)."""
    return {name: leaf[i] for name, leaf in pools.items()}


# --------------------------------------------------------------------- decode
def decode_step(params, cfg, cache: dict, tokens, *,
                gates=None) -> Tuple[torch.Tensor, dict]:
    """One autoregressive step against a slot cache (updated in place).

    ``cache["pos"]`` is a scalar (the one-shot path: the whole batch at one
    position) or an int32 [B] tensor (continuous batching: each slot at its
    own offset); gates may be [L] or [L, B]. tokens: [B, 1]. Returns
    (logits [B, 1, Vp], cache) with ``cache["pos"]`` advanced by one."""
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    pos = cache["pos"]
    h = _embed(params, cfg, tokens)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        out = attention.decode_attention(
            pm, cfg, layers.apply_norm(cfg, pm["norm"], h),
            _pool_layer(cache["attn"], i), pos)
        h = _block(params, cfg, i, h, gates, out)
    cache["pos"] = pos + 1
    return _unembed(params, cfg, h), cache


def decode_horizon(params, cfg, cache: dict, tokens, horizon: int, *,
                   gates=None) -> Tuple[torch.Tensor, dict]:
    """``horizon`` greedy :func:`decode_step` s with the argmax token fed
    back on the device (the loop form of JAX's ``lax.scan``): nothing is
    read back to the host inside the loop. tokens: int32 [B, 1] seed.
    Returns (toks int32 [B, horizon], cache)."""
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    tok = tokens
    toks = []
    for _ in range(horizon):
        logits, cache = decode_step(params, cfg, cache, tok, gates=gates)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), cache


def paged_decode_step(params, cfg, pools: dict, page_table, pos, tokens, *,
                      gates=None) -> torch.Tensor:
    """One autoregressive step against a paged KV pool.

    pools: {"k","v"} page arrays [L, n_pages, page_tokens, K, Dh] —
    quantized pools add {"ks","vs"} scales [L, n_pages, K] — updated in
    place (one new token per row); page_table: int32 [B, max_pages]; pos:
    int32 [B] per-row write positions; tokens: [B, 1]. Gates may be [L] or
    [L, B]. Returns logits [B, 1, Vp].
    """
    _check_uniform(cfg)
    L = cfg.n_layers
    gates = gates or _ones_gates(L, tokens.device)
    h = _embed(params, cfg, tokens)
    for i in range(L):
        pm = tree_slice(params["stacks"]["attn"], i)
        kv = _pool_layer(pools, i)
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
