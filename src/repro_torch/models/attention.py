"""Multi-head / grouped-query attention with RoPE: prefill and paged decode.

The model-dtype part of ``repro/models/attention.py``. Prefill attention
and the scoring forward go through the flash-attention kernel; one-token
decode appends the new K/V into its page and goes through the paged decode
kernel (``repro_torch.kernels.ops``; plain versions on CPU tensors).
Quantized pages, chunk attention and slot-cache decode are later slices
(ROADMAP queue 1).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers


def init_attn_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` attention blocks (separate wq/wk/wv/wo)."""
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(
            "qkv_bias / qk_norm come with the qwen configs (ROADMAP queue 1, "
            "slice C)")
    pd = cfg.torch_param_dtype()
    shapes = {"wq": (cfg.d_model, cfg.q_dim), "wk": (cfg.d_model, cfg.kv_dim),
              "wv": (cfg.d_model, cfg.kv_dim), "wo": (cfg.q_dim, cfg.d_model)}
    p = {k: torch.empty(n, *s, dtype=pd, device=device)
         for k, s in shapes.items()}
    for i in range(n):
        for k in ("wq", "wk", "wv"):
            layers.dense_init_(p[k][i], gen)
        layers.dense_init_(p["wo"][i], gen,
                           scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    return p


def _project_qkv(params, cfg, x):
    """x: [B, S, D] → q [B,S,H,Dh], k/v [B,S,K,Dh]."""
    B, S = x.shape[:2]
    q = torch.matmul(x, params["wq"].to(x.dtype))
    k = torch.matmul(x, params["wk"].to(x.dtype))
    v = torch.matmul(x, params["wv"].to(x.dtype))
    return (q.reshape(B, S, cfg.n_heads, cfg.dh),
            k.reshape(B, S, cfg.n_kv_heads, cfg.dh),
            v.reshape(B, S, cfg.n_kv_heads, cfg.dh))


def attention(params, cfg, x, positions, *,
              window: int = 0) -> Tuple[torch.Tensor, dict]:
    """Full-sequence causal attention. Returns (out [B,S,D], {"k","v"})."""
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.logit_softcap)
    y = torch.matmul(out.reshape(*out.shape[:2], -1),
                     params["wo"].to(x.dtype))
    return y, {"k": k, "v": v}


def paged_decode_attention(params, cfg, x, kv: dict, page_table,
                           pos) -> torch.Tensor:
    """One-token decode against a paged KV pool (one layer's slice).

    x: [B,1,D]; kv: {"k","v"} page pools [n_pages, page_tokens, K, Dh]
    shared by every in-flight request; page_table: int32 [B, max_pages];
    pos: int32 [B] per-row write positions. Returns out [B,1,D].

    The new token's K/V is written into its page IN PLACE (the JAX version
    returns updated pools through a donated jit; here ``kv`` holds views of
    the pool, which is never copied). Rows own disjoint pages; padded batch
    rows all point at the scratch page, so their writes collide there in
    no fixed order — harmless, the page is never read under a valid
    length. A position past the table width (a request over-generating in
    its final horizon) clamps to the last column, as JAX's gather does.
    """
    B = x.shape[0]
    page_tokens = kv["k"].shape[1]
    q, k, v = _project_qkv(params, cfg, x)
    positions = pos.reshape(-1, 1)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    col = torch.clamp(pos // page_tokens, max=page_table.shape[1] - 1).long()
    page_ids = page_table[rows, col].long()
    offs = (pos % page_tokens).long()
    kv["k"][page_ids, offs] = k[:, 0].to(kv["k"].dtype)
    kv["v"][page_ids, offs] = v[:, 0].to(kv["v"].dtype)
    out = kops.paged_decode_attention(q, kv["k"], kv["v"], page_table,
                                      pos + 1, softcap=cfg.logit_softcap)
    return torch.matmul(out.reshape(B, 1, -1), params["wo"].to(x.dtype))
