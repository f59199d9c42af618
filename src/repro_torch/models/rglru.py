"""Griffin RG-LRU recurrent block [arXiv:2402.19427] (RecurrentGemma).

The port of ``repro/models/rglru.py``.

Block:  y = W_out( GeLU(W_gate x) ⊙ RG-LRU( conv1d_4(W_x x) ) )
RG-LRU: r_t = σ(W_a u_t + b_a);  i_t = σ(W_i u_t + b_i)
        log a_t = -c · softplus(Λ) · r_t            (c = 8)
        h_t = a_t · h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ u_t)

W_a / W_i are block-diagonal (n_blocks = n_heads). The sequence pass runs
the recurrence through ``kernels.ops.rglru`` (the CUDA kernel on the card;
its plain sequential loop, the counterpart of JAX's ``blocked_scan``, on
the CPU). JAX wraps the projections in ``parallel.activation.width``, a
sharding hint that is the identity on one device; under a model axis the
port computes the width leaves on this rank's columns (:func:`_tp`).
The decode state (``init_rglru_cache``) is f32 whatever the model dtype.

A decode state in the layout of ``parallel.sharding.cache_pspecs``
(``cut``, :func:`rglru_decode_step`) is whole on every rank, or, under
``shard_seq``, has its width cut over the data axes: each data rank
updates its channels of the gates and the state, and the output
projection's rows of those channels are summed over the data group.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.parallel import tp

_C = 8.0
_CONV_W = 4


def _n_blocks(cfg) -> int:
    nb = max(cfg.n_heads, 1)
    w = cfg.rnn_width or cfg.d_model
    while w % nb != 0:
        nb //= 2
    return max(nb, 1)


def init_rglru_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` RG-LRU blocks."""
    pd = cfg.torch_param_dtype()
    D = cfg.d_model
    W = cfg.rnn_width or cfg.d_model
    nb = _n_blocks(cfg)
    bw = W // nb
    f32 = dict(dtype=torch.float32, device=device)

    def dense(d_in, d_out, scale=1.0):
        w = torch.empty(n, d_in, d_out, dtype=pd, device=device)
        for i in range(n):
            layers.dense_init_(w[i], gen, scale=scale)
        return w

    def blk():
        w = torch.empty(n, nb, bw, bw, **f32).normal_(generator=gen)
        return (w / math.sqrt(bw)).to(pd)

    zeros = lambda: torch.zeros(n, W, dtype=pd, device=device)
    conv_w = torch.empty(n, _CONV_W, W, **f32).normal_(generator=gen)
    # Λ init so that a^c ∈ (0.9, 0.999) roughly (the paper's stable range)
    lam = torch.empty(n, W, **f32).uniform_(0.9 ** 2, 0.999 ** 2,
                                            generator=gen)
    return {
        "wx": dense(D, W), "w_gate": dense(D, W),
        "conv_w": (conv_w / math.sqrt(_CONV_W)).to(pd), "conv_b": zeros(),
        "wa": blk(), "ba": zeros(), "wi": blk(), "bi": zeros(),
        "lam": torch.log(torch.expm1(-torch.log(lam) / _C)),
        "wo": dense(W, D, scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }


def _block_diag_proj(u, w, b):
    """u: [..., W]; w: [nb, bw, bw] → [..., W]."""
    nb, bw, _ = w.shape
    ub = u.reshape(*u.shape[:-1], nb, bw)
    out = torch.einsum("...nb,nbc->...nc", ub, w.to(u.dtype))
    return out.reshape(u.shape) + b.to(u.dtype)


def _gates(params, u):
    """(a, b) of the recurrence from the conv output u, both f32."""
    r = torch.sigmoid(_block_diag_proj(u, params["wa"], params["ba"]).float())
    i = torch.sigmoid(_block_diag_proj(u, params["wi"], params["bi"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r
    # sqrt(1 - a^2), computed stably through expm1
    b_scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    return torch.exp(log_a), b_scale * (i * u.float())


def _widths(cfg) -> dict:
    """The leaves the rules may cut over "model", with their dim and whole
    width (``parallel.tp.block_mode``): the width W, or the gate blocks."""
    W, nb = (-1, cfg.rnn_width or cfg.d_model), (-3, _n_blocks(cfg))
    return {"wx": W, "w_gate": W, "conv_w": W, "conv_b": W, "ba": W,
            "bi": W, "lam": W, "wa": nb, "wi": nb,
            "wo": (-2, cfg.rnn_width or cfg.d_model)}


def tp_mode(params, cfg):
    """``parallel.tp.block_mode`` of these (this rank's) RG-LRU leaves:
    partial where the width and the gate blocks are both cut."""
    return tp.block_mode(params, _widths(cfg), "wx",
                         units=lambda m: _n_blocks(cfg) % m == 0)


def _tp(params, cfg, x):
    """(params, x, partial) of this rank under a model axis of m > 1
    (``parallel.tp``). A partial block runs on this rank's W/m columns,
    its state too, and ``wo``'s product is summed over "model"
    (:func:`_out`); a whole one gathers the cut leaves."""
    mode = tp_mode(params, cfg)
    if mode == "partial":
        return params, tp.enter(x), True
    if mode == "whole":
        params = tp.gather_cut(params, _widths(cfg))
        x = tp.enter_whole(x)
    return params, x, False


def _out(params, y, dtype, partial: bool):
    y = torch.matmul(y, params["wo"].to(dtype))
    return tp.leave(y) if partial else tp.leave_whole(y)


def rglru_sequence(params, cfg, x):
    """Full-sequence Griffin block. x: [B,T,D] → (out [B,T,D], final h
    [B,W] f32, conv buffer [B,3,W] f32: the last 3 pre-conv inputs,
    zero-padded on the left when T < 3, as the causal conv's own padding
    is). Under a partial model axis W is this rank's width."""
    params, x, partial = _tp(params, cfg, x)
    u = torch.matmul(x, params["wx"].to(x.dtype))
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    K = params["conv_w"].shape[0]
    up = F.pad(u, (0, 0, K - 1, 0))
    conv_buf = up[:, -(K - 1):].float()
    w = params["conv_w"].to(u.dtype)
    uc = sum(up[:, i:i + u.shape[1], :] * w[i][None, None]
             for i in range(K)) + params["conv_b"].to(u.dtype)
    a, b = _gates(params, uc)                               # [B,T,W] f32
    h = kops.rglru(a.contiguous(), b.contiguous())
    y = h.to(x.dtype) * layers.gelu(g)
    return _out(params, y, x.dtype, partial), h[:, -1], conv_buf


def rglru_mixer(params, cfg, x):
    """Full-sequence Griffin block. x: [B,T,D] → [B,T,D]."""
    return rglru_sequence(params, cfg, x)[0]


def init_rglru_cache(cfg, batch: int, n_layers: int, device=None) -> dict:
    """Zeroed f32 decode state of ``n_layers`` RG-LRU blocks: {"h"
    [n, B, W], "conv" [n, B, 3, W]}."""
    W = cfg.rnn_width or cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(n_layers, batch, W, **f32),
            "conv": torch.zeros(n_layers, batch, _CONV_W - 1, W, **f32)}


def rglru_decode_step(params, cfg, x, h_prev, conv_buf, *, cut=None):
    """One token. x: [B,1,D]; h_prev: [B,W]; conv_buf: [B,3,W].

    Returns (y [B,1,D], h, conv_buf) — new tensors; the caller stores
    them. Under a partial model axis W is this rank's width. ``cut``
    (``parallel.tp.cache_cut``; None: that serve layout) is how this rank
    holds the state in the ``cache_pspecs`` layout: :func:`_decode_cut`."""
    if cut is not None:
        return _decode_cut(params, cfg, x, h_prev, conv_buf, cut)
    params, x, partial = _tp(params, cfg, x)
    u = torch.matmul(x, params["wx"].to(x.dtype))
    g = torch.matmul(x, params["w_gate"].to(x.dtype))
    full = torch.cat([conv_buf.to(u.dtype), u], dim=1)       # [B,4,W]
    u_t = torch.einsum("bkw,kw->bw", full, params["conv_w"].to(u.dtype)) \
        + params["conv_b"].to(u.dtype)
    a, b = _gates(params, u_t)                                # [B,W]
    h = a * h_prev + b
    y = (h.to(x.dtype) * layers.gelu(g[:, 0]))[:, None, :]
    return _out(params, y, x.dtype, partial), h, full[:, 1:]


def _cols(params, sl: slice, blocks: slice) -> dict:
    """The leaves of channels ``sl`` (gate blocks ``blocks``; ``wo``'s
    rows)."""
    p = {k: params[k][..., sl] for k in ("wx", "w_gate", "conv_w", "conv_b",
                                         "ba", "bi", "lam")}
    p.update(wa=params["wa"][blocks], wi=params["wi"][blocks],
             wo=params["wo"][sl])
    return p


def _decode_cut(params, cfg, x, h_prev, conv_buf, cut):
    """:func:`rglru_decode_step` on a state in the ``cache_pspecs`` layout:
    ``conv_buf [B, 3, W]`` whole and ``h_prev`` this rank's block ``cut``
    of the width (whole where ``cut.n`` is 1). A partial block (weights
    cut over "model") steps its W/m columns of both and all-gathers the
    new ones over "model". Otherwise, with the width cut over a group, this
    rank updates its channels: the gates over the whole gate blocks that
    hold them (the conv buffer needs every channel's input), its channels'
    state, and its rows of ``wo``, summed over ``cut.group``."""
    mode = tp_mode(params, cfg)
    W = cfg.rnn_width or cfg.d_model
    if mode == "partial":
        pol = tp.active()
        own = slice(pol.mrank * (W // pol.nmdl),
                    (pol.mrank + 1) * (W // pol.nmdl))
        h_all = cut.whole(h_prev, -1)
        y, h, conv = rglru_decode_step(params, cfg, x, h_all[..., own],
                                       conv_buf[..., own])
        h = tp.all_gather_cat(h, pol.model_group, -1)
        conv = tp.all_gather_cat(conv, pol.model_group, -1)
        return y, h[..., cut.rows(W)], conv
    if cut.n == 1:
        return rglru_decode_step(params, cfg, x, h_prev, conv_buf)
    if mode == "whole":
        params = tp.gather_cut(params, _widths(cfg))
    own = cut.rows(W)
    bw = W // _n_blocks(cfg)
    blocks = slice(own.start // bw, -(-own.stop // bw))
    span = slice(blocks.start * bw, blocks.stop * bw)   # ⊇ own
    p = _cols(params, span, blocks)
    u = torch.matmul(x, params["wx"].to(x.dtype))
    full = torch.cat([conv_buf.to(u.dtype), u], dim=1)       # [B,4,W]
    u_t = torch.einsum("bkw,kw->bw", full[..., span],
                       p["conv_w"].to(u.dtype)) + p["conv_b"].to(u.dtype)
    a, b = _gates(p, u_t)                                     # [B,|span|]
    mine = slice(own.start - span.start, own.stop - span.start)
    h = a[:, mine] * h_prev + b[:, mine]
    g = torch.matmul(x, params["w_gate"][..., own].to(x.dtype))
    y = (h.to(x.dtype) * layers.gelu(g[:, 0]))[:, None, :]
    y = torch.matmul(y, params["wo"][own].to(x.dtype))
    return tp.reduce_from(y, cut.group), h, full[:, 1:]
