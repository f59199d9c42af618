"""Multi-head / grouped-query attention with RoPE: prefill, chunked
prefill, and one-token decode against a slot cache or a page pool.

The port of ``repro/models/attention.py``'s serving half. Prefill
attention and the scoring forward go through the flash-attention kernel;
one-token decode writes the new K/V into its slot (slot cache) or page
(page pool) and goes through the dense or the paged decode kernel
(``repro_torch.kernels.ops``; plain versions on CPU tensors). On the card
the slot path's decode runs the dense decode kernel for both forms of
position — a scalar (one mask ``[S]`` for the batch, where JAX's
``impl="pallas"`` reaches its Pallas kernel) and a per-row ``[B]`` vector
(a mask ``[B, S]``, which JAX computes with ``_sdpa``).

Slot caches are model-dtype, float8_e4m3fn (a plain cast on store and
load, as in JAX) or int8 with one f32 scale per (token, kv head)
(:func:`kv_quant`); page pools are model-dtype or int8 /
float8_e4m3fn with one f32 scale per (page, kv head) (:func:`page_quant`).
Chunk attention (one prompt chunk against a partly filled cache) is a
plain masked softmax over the cache, as JAX's XLA path is: no kernel runs
there.

Under a model axis wider than one (``parallel.activation.use``) every
path computes this rank's heads and sums the output projection over
"model" (:func:`_tp_mode`, :func:`out_proj`): the same kernels on
rank-local shapes. Under sequence parallelism (``parallel.tp.seq_split``)
the block gathers the sequence at its entry and reduce-scatters it at its
exit. A slot cache in the layout of ``parallel.sharding.cache_pspecs``
(``parallel.tp.cache_cut``) holds every KV head and, where it is cut,
one block of the sequence: a rank attends all heads over its block and
the blocks are joined from their log-sum-exps (:func:`attend_cached`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (_causal_mask, _raw, _sdpa,
                                     gather_pages, page_dequant, put_pages,
                                     take_pages)
from repro_torch.models import layers
from repro_torch.parallel import tp

__all__ = ["init_attn_params", "attention", "kv_quant", "init_kv_cache",
           "store_kv", "load_kv", "decode_attention", "attend_cached",
           "page_qmax",
           "page_quant", "page_dequant", "paged_decode_attention",
           "chunk_attention", "paged_chunk_attention"]


def init_attn_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` attention blocks (separate wq/wk/wv/wo),
    plus zero-initialised q/k/v biases ``bq``/``bk``/``bv`` under
    ``cfg.qkv_bias`` (qwen1.5) and per-head RMSNorm scales
    ``q_norm``/``k_norm [n, Dh]`` under ``cfg.qk_norm`` (qwen3), as in the
    JAX package."""
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
    zeros = lambda d: torch.zeros(n, d, dtype=pd, device=device)
    if cfg.qkv_bias:
        p.update(bq=zeros(cfg.q_dim), bk=zeros(cfg.kv_dim),
                 bv=zeros(cfg.kv_dim))
    if cfg.qk_norm:
        p.update(q_norm=zeros(cfg.dh), k_norm=zeros(cfg.dh))
    return p


def _widths(cfg) -> dict:
    """The leaves the rules may cut over "model", with their dim and whole
    width (``parallel.tp.block_mode``)."""
    qd, kd = (-1, cfg.q_dim), (-1, cfg.kv_dim)
    return {"wq": qd, "bq": qd, "wk": kd, "bk": kd, "wv": kd, "bv": kd,
            "wo": (-2, cfg.q_dim)}


_QKV = ("wq", "bq", "wk", "bk", "wv", "bv")


def _tp_mode(params, cfg) -> Tuple[Optional[str], Optional[slice]]:
    """(``parallel.tp.block_mode``, kv_sel): the block is partial when its
    heads divide the model axis m — this rank's H/m query heads, its K/m
    KV heads (``kv_sel`` None), or, when K < m divides it, every KV head
    computed whole and the one its query heads read (``kv_sel``)."""
    H, K = cfg.n_heads, cfg.n_kv_heads
    mode = tp.block_mode(params, _widths(cfg), "wq", units=lambda m: (
        H % m == 0 and (K % m == 0 or m % K == 0)))
    if mode != "partial" or K % tp.active().nmdl == 0:
        return mode, None
    g = tp.active().nmdl // K                 # query-head ranks per KV head
    r = tp.active().mrank // g
    return mode, slice(r, r + 1)


def _tp_weights(params, cfg, mode: str, kv_sel) -> dict:
    """The projection weights this rank computes with: a whole block's cut
    leaves gathered over "model", and a whole-K block's K/V leaves too; a
    replicated leaf a partial block reads marked for its gradient."""
    if mode == "whole":
        return tp.gather_cut(params, _widths(cfg), _QKV)
    p = dict(params)
    whole = _widths(cfg)
    for n in (("wk", "wv", "bk", "bv") if kv_sel is not None else ()):
        if n in p:
            p[n] = (tp.gather(p[n], -1, partial=True)
                    if p[n].shape[-1] != whole[n][1] else tp.copy_to(p[n]))
    for n in ("q_norm", "k_norm"):
        if n in p:
            p[n] = tp.copy_to(p[n])
    return p


def _project_qkv(params, cfg, x):
    """x: [B, S, D] → q [B,S,H,Dh], k/v [B,S,K,Dh]: the projections, the
    biases after them (``qkv_bias``) and the per-head RMSNorm of q and k
    (``qk_norm``, before RoPE). Every path projects through here: prefill,
    chunked prefill, slot and paged decode, and the scoring forward. Under
    a model axis (``_tp_mode``) H and K are this rank's heads, read from
    the weights' widths; K is every KV head where a whole-K block stores
    them all (its cache too) and reads ``kv_heads``."""
    mode, kv_sel = _tp_mode(params, cfg)
    if mode is not None:
        params = _tp_weights(params, cfg, mode, kv_sel)
        x = tp.enter(x) if mode == "partial" else tp.enter_whole(x)
    B, S = x.shape[:2]
    q = torch.matmul(x, params["wq"].to(x.dtype))
    k = torch.matmul(x, params["wk"].to(x.dtype))
    v = torch.matmul(x, params["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, q.shape[-1] // cfg.dh, cfg.dh)
    k = k.reshape(B, S, k.shape[-1] // cfg.dh, cfg.dh)
    v = v.reshape(B, S, v.shape[-1] // cfg.dh, cfg.dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def kv_heads(params, cfg, kv):
    """The KV heads this rank's query heads read (``kv [..., K, Dh]``): all
    of them, except in a whole-K block under a model axis."""
    _, kv_sel = _tp_mode(params, cfg)
    return kv if kv_sel is None else kv[..., kv_sel, :].contiguous()


def out_proj(params, cfg, out, dtype):
    """The output projection of heads ``out [B, S, H, Dh]``: ``wo``, summed
    over "model" in a partial block (``wo`` cut on its rows), gathered
    whole in a whole one (each leaving the sequence cut as it entered,
    under ``parallel.tp.seq_split``)."""
    mode, _ = _tp_mode(params, cfg)
    y_in = out.reshape(*out.shape[:2], -1)
    wo = (tp.gather_cut(params, _widths(cfg), ("wo",))["wo"]
          if mode == "whole" else params["wo"])
    y = torch.matmul(y_in, wo.to(dtype))
    if mode == "partial":
        return tp.leave(y)
    return tp.leave_whole(y) if mode == "whole" else y


def attention(params, cfg, x, positions, *,
              window: int = 0) -> Tuple[torch.Tensor, dict]:
    """Full-sequence causal attention. Returns (out [B,S,D], {"k","v"})."""
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = kops.flash_attention(q, kv_heads(params, cfg, k),
                               kv_heads(params, cfg, v), causal=True,
                               window=window, softcap=cfg.logit_softcap)
    return out_proj(params, cfg, out, x.dtype), {"k": k, "v": v}


# ------------------------------------------------------------ slot cache
def kv_quant(x):
    """Per-(token, head) symmetric int8 quantization of ``x [..., Dh]``:
    returns (codes int8, scales f32 [..., 1]). 1e-8 is ADDED to the scale
    (``page_quant`` uses it as a floor instead), as in JAX."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int, dtype=None,
                  device=None) -> dict:
    """Zeroed slot cache {"k","v"} [n_layers, batch, max_len, K, Dh]; an
    int8 cache adds per-(token, head) scales {"ks","vs"} [..., 1] f32."""
    dt = dtype or cfg.torch_dtype()
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if dt == torch.int8:
        sshape = shape[:-1] + (1,)
        cache["ks"] = torch.zeros(sshape, device=device)
        cache["vs"] = torch.zeros(sshape, device=device)
    return cache


def store_kv(entry: dict, k, v) -> dict:
    """(k, v) ``[..., K, Dh]`` encoded in the entry's storage dtype: the
    leaves of :func:`init_kv_cache` without the layer axis."""
    if "ks" in entry:
        kq, ks = kv_quant(k)
        vq, vs = kv_quant(v)
        return {"k": kq, "v": vq, "ks": ks, "vs": vs}
    return {"k": k.to(entry["k"].dtype), "v": v.to(entry["v"].dtype)}


def load_kv(entry: dict, dtype):
    """The entry's K and V in ``dtype`` (an int8 cache dequantized first)."""
    if "ks" in entry:
        return ((entry["k"].float() * entry["ks"]).to(dtype),
                (entry["v"].float() * entry["vs"]).to(dtype))
    return entry["k"].to(dtype), entry["v"].to(dtype)


def decode_attention(params, cfg, x, kv: dict, pos, *, window: int = 0,
                     split_rows: int = 0, cut=None) -> torch.Tensor:
    """One-token decode against a slot cache (one layer's entry, leaves
    ``[B, S_max, K, Dh]`` + scales), written IN PLACE. Returns out [B,1,D].

    ``pos`` is a scalar (the whole batch at one position: the one-shot
    path; a Python int or a 0-d tensor) or an int32 ``[B]`` tensor (each
    slot at its own position). A scalar write clamps its slot into the
    cache, as JAX's ``dynamic_update_slice`` does; a row whose vector
    position is past the cache (a slot that finished inside a horizon)
    drops its write, as JAX's ``.at[].set`` does — on the device, by
    writing the old value back, with no host sync. ``window > 0`` makes the
    cache a ring buffer: the token lands at ``pos % S`` and the last
    ``window`` tokens are valid. ``split_rows`` goes to the kernel
    (``ops.decode_attention``).

    ``cut`` (``parallel.tp.cache_cut``; None: the serve layout) is how this
    rank holds the cache's sequence under ``cache_pspecs``: every KV head,
    block ``cut.j`` of ``cut.n``. The new token's K/V heads are gathered
    over "model" and written only by the rank whose block holds its slot;
    ``valid`` is taken at the block's global positions (a ring's age from
    the global slot); :func:`attend_cached` attends and joins the blocks.
    """
    B = x.shape[0]
    dev = x.device
    batched = torch.is_tensor(pos) and pos.ndim > 0
    q, k, v = _project_qkv(params, cfg, x)
    if cfg.use_rope:
        rp = (pos.reshape(-1, 1) if torch.is_tensor(pos)
              else torch.full((1, 1), int(pos), device=dev))
        q = layers.apply_rope(q, rp, cfg.rope_theta)
        k = layers.apply_rope(k, rp, cfg.rope_theta)
    S = kv["k"].shape[1]                    # this rank's slots
    n, j = (cut.n, cut.j) if cut is not None else (1, 0)
    Sg = S * n                              # the whole cache's
    if cut is not None and k.shape[2] != kv["k"].shape[2]:
        # this rank's K/m heads: every rank stores every head
        grp = tp.active().model_group
        k = tp.all_gather_cat(k, grp, 2)
        v = tp.all_gather_cat(v, grp, 2)
    slot = pos % Sg if window > 0 else pos
    new = store_kv(kv, k, v)
    if n > 1:
        # only the rank whose block holds the slot writes it; a scalar
        # slot clamps into the whole cache first, as it does unsplit
        g = (slot.reshape(-1) if torch.is_tensor(slot)
             else torch.tensor([int(slot)], device=dev))
        if not batched:
            g = torch.clamp(g, 0, Sg - 1)
        local = (g - j * S).expand(B)
        keep = ((local >= 0) & (local < S))[:, None, None]
        idx = torch.clamp(local, 0, S - 1).long()
        rows = torch.arange(B, device=dev)
        for key, val in new.items():
            dst = _raw(kv[key])
            old = dst[rows, idx]
            dst[rows, idx] = torch.where(keep, _raw(val[:, 0]), old)
    elif batched:
        rows = torch.arange(B, device=dev)
        keep = (slot < S)[:, None, None]                   # [B, 1, 1]
        idx = torch.clamp(slot, max=S - 1).long()
        for key, val in new.items():
            dst = _raw(kv[key])     # one-byte codes as uint8: bit-exact
            old = dst[rows, idx]
            dst[rows, idx] = torch.where(keep, _raw(val[:, 0]), old)
    else:
        idx = (torch.clamp(slot, 0, S - 1).long() if torch.is_tensor(slot)
               else min(max(int(slot), 0), S - 1))
        for key, val in new.items():
            _raw(kv[key])[:, idx] = _raw(val[:, 0])
    kpos = torch.arange(j * S, (j + 1) * S, device=dev)[None, :]
    posc = (pos.reshape(-1, 1) if torch.is_tensor(pos)
            else torch.full((1, 1), int(pos), device=dev))
    if window > 0:
        age = torch.remainder(posc - kpos, Sg)
        valid = age < torch.clamp(posc + 1, max=window)    # [B or 1, S]
    else:
        valid = kpos <= posc                                # [B or 1, S]
    ck, cv = load_kv(kv, q.dtype)
    valid = valid if batched else valid[0]
    if cut is not None:
        out = attend_cached(params, cfg, q, ck, cv, valid, cut,
                            split_rows=split_rows)
    else:
        out = kops.decode_attention(q, kv_heads(params, cfg, ck),
                                    kv_heads(params, cfg, cv), valid,
                                    softcap=cfg.logit_softcap,
                                    split_rows=split_rows)
    return out_proj(params, cfg, out, x.dtype)


def attend_cached(params, cfg, q, ck, cv, valid, cut, *,
                  split_rows: int = 0) -> torch.Tensor:
    """This rank's query heads ``q [B, 1, H', Dh]`` against a cache block
    in the ``cache_pspecs`` layout (``ck``/``cv [B, S, K, Dh]``: every KV
    head; ``cut``: block j of n of the sequence). One block: the decode
    kernel on the KV heads this rank's queries read. Several: the query
    heads gathered over "model" (a partial block), the kernel over every
    head of the block with its log-sum-exp, the blocks joined over
    ``cut.group`` (``tp.combine_blocks``), then this rank's heads taken
    again. Returns [B, 1, H', Dh]."""
    mode, kv_sel = _tp_mode(params, cfg)
    partial = mode == "partial"
    kw = dict(softcap=cfg.logit_softcap, split_rows=split_rows)
    if cut.n == 1:
        if partial:
            ck, cv = _own_kv(cfg, ck, kv_sel), _own_kv(cfg, cv, kv_sel)
        return kops.decode_attention(q, ck, cv, valid, **kw)
    h_own = q.shape[2]
    if partial:
        q = tp.all_gather_cat(q, tp.active().model_group, 2)
    out, lse = kops.decode_attention(q, ck, cv, valid, return_lse=True, **kw)
    out = tp.combine_blocks(out[:, 0], lse, cut).to(q.dtype)[:, None]
    if partial:
        r = tp.active().mrank
        out = out[:, :, r * h_own:(r + 1) * h_own].contiguous()
    return out


def _own_kv(cfg, kv, kv_sel):
    """This rank's KV heads of ``kv [..., K, Dh]`` holding every head, in a
    partial block: its K/m heads, or the one its query heads read."""
    if kv_sel is not None:
        return kv[..., kv_sel, :].contiguous()
    m, r = tp.active().nmdl, tp.active().mrank
    w = cfg.n_kv_heads // m
    return kv[..., r * w:(r + 1) * w, :].contiguous()


# ------------------------------------------------------- quantized pages
def page_qmax(dtype) -> float:
    """Symmetric quantization ceiling of a paged storage dtype: 127 for
    int8, 448 for float8_e4m3fn (its largest finite value)."""
    return 127.0 if dtype == torch.int8 else 448.0


def page_quant(xf, dtype, scale_floor=None):
    """Quantize whole pages ``[..., page_tokens, K, Dh]`` (f32) into
    ``dtype`` with ONE symmetric scale per (page, kv head): returns
    ``(codes, scales[..., K])``.

    ``scale_floor`` (shaped like the scales) keeps a page's scale monotone:
    while an append does not raise the page's amax the scale is unchanged
    and requantizing its tokens reproduces their codes. 1e-8 is a floor,
    never an addend. int8 rounds half to even; fp8 is clipped to ±448
    before the cast (torch would saturate, JAX gives NaN)."""
    amax = xf.abs().amax(dim=(-3, -1))                      # [..., K]
    qmax = page_qmax(dtype)
    scale = amax / qmax
    if scale_floor is not None:
        scale = torch.maximum(scale, scale_floor)
    scale = torch.clamp(scale, min=1e-8)
    y = xf / scale[..., None, :, None]
    if dtype == torch.int8:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(dtype), scale.float()


def _append_quant(pool, scales, page_ids, offs, new) -> None:
    """Code-space append of one token per row into its page, in place.

    pool: [n_pages, pt, K, Dh] codes; scales: [n_pages, K]; page_ids/offs:
    [B] page and slot of each row's token; new: [B, 1, K, Dh]. The page's
    scale grows to max(token amax / qmax, old scale) (a fresh page, slot 0,
    forgets its previous occupant's), existing codes rescale by old/new —
    exactly 1.0 while the scale is stable, so they round-trip — the token
    quantizes into its slot and slots past it are zeroed. Index tensors
    only: no host sync."""
    pt = pool.shape[1]
    qmax = page_qmax(pool.dtype)
    slot = torch.arange(pt, device=new.device)[None, :, None, None]
    off_b = offs[:, None, None, None]
    fresh = (offs == 0)[:, None]                            # [B, 1]
    tok = new[:, 0].float()                                 # [B, K, Dh]
    old_s = scales[page_ids]                                # [B, K]
    floor = torch.where(fresh, 0.0, old_s)
    new_s = torch.clamp(torch.maximum(tok.abs().amax(-1) / qmax, floor),
                        min=1e-8)
    r = torch.where(fresh, 0.0, old_s / new_s)              # [B, K] <= 1
    pg = take_pages(pool, page_ids).float() * r[:, None, :, None]
    tok_q = tok / new_s[..., None]
    if pool.dtype == torch.int8:
        pg, tok_q = torch.round(pg), torch.round(tok_q)
    pg = torch.where(slot == off_b, tok_q[:, None], pg)
    pg = torch.where(slot <= off_b, pg, 0.0)               # stale slots → 0
    put_pages(pool, page_ids, torch.clamp(pg, -qmax, qmax))
    scales[page_ids] = new_s


# ---------------------------------------------------------------- decode
def paged_decode_attention(params, cfg, x, kv: dict, page_table, pos, *,
                           split_rows: int = 0) -> torch.Tensor:
    """One-token decode against a paged KV pool (one layer's slice).

    x: [B,1,D]; kv: {"k","v"} page pools [n_pages, page_tokens, K, Dh]
    shared by every in-flight request — quantized pools add {"ks","vs"}
    scales [n_pages, K]; page_table: int32 [B, max_pages]; pos: int32 [B]
    per-row write positions. Returns out [B,1,D].

    The new token's K/V is written into its page IN PLACE (the JAX version
    returns updated pools through a donated jit; here ``kv`` holds views of
    the pool, which is never copied); quantized pools take the code-space
    append (:func:`_append_quant`). Rows own disjoint pages; padded batch
    rows all point at the scratch page, so their writes collide there in
    no fixed order — harmless, the page is never read under a valid
    length. A position past the table width (a request over-generating in
    its final horizon) clamps to the last column, as JAX's gather does.
    ``split_rows`` goes to the kernel (``ops.paged_decode_attention``).
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
    if "ks" in kv:
        _append_quant(kv["k"], kv["ks"], page_ids, offs, k)
        _append_quant(kv["v"], kv["vs"], page_ids, offs, v)
    else:
        kv["k"][page_ids, offs] = k[:, 0].to(kv["k"].dtype)
        kv["v"][page_ids, offs] = v[:, 0].to(kv["v"].dtype)
    out = kops.paged_decode_attention(q, kv["k"], kv["v"], page_table,
                                      pos + 1, k_scales=kv.get("ks"),
                                      v_scales=kv.get("vs"),
                                      softcap=cfg.logit_softcap,
                                      split_rows=split_rows)
    return out_proj(params, cfg, out, x.dtype)


# ------------------------------------------------------- chunked prefill
def chunk_attention(params, cfg, x, kv: dict,
                    start: int) -> torch.Tensor:
    """Prefill one prompt chunk against a partly filled slot cache.

    x: [B, C, D] — C prompt tokens at absolute positions [start,
    start + C); kv: one layer's cache {"k","v"} [B, S_max, K, Dh] (an int8
    cache adds {"ks","vs"}), written in place at [start, start + C) through
    :func:`store_kv` and read back through :func:`load_kv`. The chunk's
    queries attend the whole cache width under the causal mask
    ``kpos <= start + qi`` (positions past the write frontier get zero
    probability). Returns out [B, C, D].
    """
    B, C = x.shape[:2]
    q, k, v = _project_qkv(params, cfg, x)
    positions = start + torch.arange(C, device=x.device)[None, :]
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    for key, val in store_kv(kv, k, v).items():
        kv[key][:, start:start + C] = val
    ck, cv = load_kv(kv, q.dtype)
    mask = _causal_mask(C, ck.shape[1], 0, q_offset=start, device=x.device)
    out = _sdpa(q, kv_heads(params, cfg, ck), kv_heads(params, cfg, cv),
                mask, cfg.logit_softcap)
    return out_proj(params, cfg, out, x.dtype)


def paged_chunk_attention(params, cfg, x, kv: dict, page_table, start: int,
                          *, scratch_page: int) -> torch.Tensor:
    """Paged sibling of :func:`chunk_attention`: C prompt tokens written
    straight into granted pages (in place).

    x: [B, C, D]; kv: one layer's page pools (quantized pools carry
    {"ks","vs"}); page_table: int32 [B, max_pages]; start: the chunk's
    first absolute position (every row of a request shares it). Tokens
    past the table width go to the scratch page. A quantized pool
    requantizes only the pages the chunk touches: a leading page the chunk
    straddles keeps its scale as a floor, pages starting at or after
    ``start`` reset it; settled pages are not rewritten (JAX routes their
    unchanged write-back to the scratch page — same pool). Attention is
    the plain gather + masked softmax of JAX's XLA path. Returns out
    [B, C, D].
    """
    B, C = x.shape[:2]
    dev = x.device
    pt = kv["k"].shape[1]
    max_pages = page_table.shape[1]
    q, k, v = _project_qkv(params, cfg, x)
    tok_pos = start + torch.arange(C, device=dev)                 # [C]
    if cfg.use_rope:
        q = layers.apply_rope(q, tok_pos[None, :], cfg.rope_theta)
        k = layers.apply_rope(k, tok_pos[None, :], cfg.rope_theta)
    if "ks" in kv:
        c0 = start // pt
        c1 = min((start + C - 1) // pt, max_pages - 1)
        if c0 <= c1:                      # else the chunk is past the table
            ids = page_table[:, c0:c1 + 1].long()                 # [B, n]
            n, base = c1 - c0 + 1, c0 * pt
            hi = min(start + C, (c1 + 1) * pt) - base
            fresh = (torch.arange(c0, c1 + 1, device=dev) * pt
                     >= start)[None, :, None]                     # [1, n, 1]
            for pk, sk, new in (("k", "ks", k), ("v", "vs", v)):
                old_s = kv[sk][ids]                               # [B, n, K]
                view = page_dequant(take_pages(kv[pk], ids), old_s)
                view = view.reshape(B, n * pt, *view.shape[3:])
                view[:, start - base:hi] = new[:, :hi - start + base].float()
                view[:, hi:] = 0.0                 # past the write frontier
                qp, sp = page_quant(view.reshape(B, n, pt, *view.shape[2:]),
                                    kv[pk].dtype,
                                    scale_floor=torch.where(fresh, 0.0,
                                                            old_s))
                put_pages(kv[pk], ids, qp)
                kv[sk][ids] = sp
    else:
        cols = tok_pos // pt
        page_ids = page_table[:, torch.clamp(cols, max=max_pages - 1)].long()
        page_ids = torch.where((cols < max_pages)[None, :], page_ids,
                               scratch_page)                      # [B, C]
        offs = (tok_pos % pt).long().expand(B, C)
        kv["k"][page_ids, offs] = k.to(kv["k"].dtype)
        kv["v"][page_ids, offs] = v.to(kv["v"].dtype)
    ck = gather_pages(kv["k"], page_table, q.dtype, kv.get("ks"))
    cv = gather_pages(kv["v"], page_table, q.dtype, kv.get("vs"))
    mask = _causal_mask(C, ck.shape[1], 0, q_offset=start, device=dev)
    out = _sdpa(q, kv_heads(params, cfg, ck), kv_heads(params, cfg, cv),
                mask, cfg.logit_softcap)
    return out_proj(params, cfg, out, x.dtype)
