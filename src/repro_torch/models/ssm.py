"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

The port of ``repro/models/ssm.py``. Layout (n_groups = 1):

  in_proj:  x [B,T,D] → z (gate, d_inner) | xc (d_inner) | B (N) | C (N)
            | dt (H)
  conv1d:   causal depthwise width-4 over the (xc|B|C) channels
  SSD:      heads H = d_inner / P, one scalar decay per head, through
            ``kernels.ops.ssd`` (the CUDA kernel on the card; its plain
            chunked version, JAX's ``_ssd_scan``, on the CPU)
  out:      gated RMSNorm → out_proj

The scan takes f32 ``xh·dt``, ``log_a``, ``B`` and ``C`` and returns f32
``y`` and the final state, so a prefill keeps the state from the same
kernel call instead of scanning twice. The decode state (``init_ssd_cache``)
is f32 whatever the model dtype: the SSM state and the last K-1 pre-conv
inputs.

The mixer's weights are replicated on every rank (``parallel.sharding``),
so under sequence parallelism it gathers the sequence and computes whole
(``parallel.tp.enter_whole``). A decode state whose heads are cut over a
group (``cache_pspecs`` under ``shard_seq``: the data axes) steps this
rank's heads, and the out projection's rows of them are summed over the
group (:func:`ssd_decode_step`'s ``cut``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.parallel import tp


def init_ssd_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` SSD mixers."""
    pd = cfg.torch_param_dtype()
    D, DI, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.ssm_conv_width
    conv_ch = DI + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = torch.empty(n, D, 2 * DI + 2 * N + H, dtype=pd, device=device)
    out_proj = torch.empty(n, DI, D, dtype=pd, device=device)
    for i in range(n):
        layers.dense_init_(in_proj[i], gen)
        layers.dense_init_(out_proj[i], gen,
                           scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    conv_w = torch.empty(n, K, conv_ch, **f32).normal_(generator=gen)
    dt = torch.empty(n, H, **f32).uniform_(math.log(1e-3), math.log(1e-1),
                                           generator=gen)
    return {
        "in_proj": in_proj,
        "conv_w": (conv_w / math.sqrt(K)).to(pd),
        "conv_b": torch.zeros(n, conv_ch, dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)).expand(
            n, H).clone(),
        "D": torch.ones(n, H, **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(dt))),
        "norm_scale": torch.zeros(n, DI, dtype=pd, device=device),
        "out_proj": out_proj,
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: [B,T,C]; w: [K,C]."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    return out + b[None, None, :]


def _split_proj(params, cfg, x):
    DI, N = cfg.ssm_inner, cfg.ssm_state
    zxbcdt = torch.matmul(x, params["in_proj"].to(x.dtype))
    return torch.split(zxbcdt, [DI, DI + 2 * N, cfg.ssm_heads], dim=-1)


def _out(params, cfg, y, z, x):
    """Gated RMSNorm, then the out projection."""
    y = layers.rms_norm(y * layers.silu(z), params["norm_scale"],
                        cfg.norm_eps)
    return torch.matmul(y, params["out_proj"].to(x.dtype))


def ssd_sequence(params, cfg, x):
    """Full-sequence mixer. x: [B,T,D] → (out [B,T,D], final SSM state
    [B,H,P,N] f32, conv buffer [B,K-1,C] f32: the last K-1 pre-conv
    inputs, zero-padded on the left when T < K-1, as the causal conv's own
    padding is)."""
    DI, N, H, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    K = params["conv_w"].shape[0]
    x = tp.enter_whole(x)
    z, xBC, dt = _split_proj(params, cfg, x)
    conv_buf = F.pad(xBC, (0, 0, K - 1, 0))[:, -(K - 1):].float()
    xBCc = layers.silu(_causal_conv(xBC, params["conv_w"].to(x.dtype),
                                    params["conv_b"].to(x.dtype)))
    xc, Bm, Cm = torch.split(xBCc, [DI, N, N], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])                # [B,T,H]
    log_a = dt * -torch.exp(params["A_log"])                       # [B,T,H]
    xh = xc.reshape(*xc.shape[:2], H, P)
    y, state = kops.ssd((xh.float() * dt[..., None]).contiguous(),
                        log_a.contiguous(), Bm.float().contiguous(),
                        Cm.float().contiguous(), cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:2], DI).to(x.dtype)
    return tp.leave_whole(_out(params, cfg, y, z, x)), state, conv_buf


def ssd_mixer(params, cfg, x):
    """Full-sequence Mamba-2 mixer. x: [B,T,D] → [B,T,D]."""
    return ssd_sequence(params, cfg, x)[0]


def init_ssd_cache(cfg, batch: int, n_layers: int, device=None) -> dict:
    """Zeroed f32 decode state of ``n_layers`` SSD mixers: {"state"
    [n, B, H, P, N], "conv" [n, B, K-1, d_inner + 2N]}."""
    DI, N = cfg.ssm_inner, cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "state": torch.zeros(n_layers, batch, cfg.ssm_heads,
                             cfg.ssm_head_dim, N, **f32),
        "conv": torch.zeros(n_layers, batch, cfg.ssm_conv_width - 1,
                            DI + 2 * N, **f32),
    }


def ssd_decode_step(params, cfg, x, state, conv_buf, *, cut=None):
    """One token. x: [B,1,D]; state: [B,H,P,N]; conv_buf: [B,K-1,C].

    Returns (y [B,1,D], state, conv_buf) — new tensors; the caller stores
    them. ``cut`` (``parallel.tp.cache_cut``): ``state`` holds this rank's
    block of the heads; the projections, the conv buffer and the norm's
    statistics stay whole (the sum of squares of each block all-gathered
    and added in order), this rank's heads step, and its rows of the out
    projection are summed over ``cut.group``."""
    if cut is not None and cut.n > 1:
        return _decode_heads(params, cfg, x, state, conv_buf, cut)
    DI, N, H, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xBC, dt = _split_proj(params, cfg, x)                        # [B,1,*]
    full = torch.cat([conv_buf, xBC.to(conv_buf.dtype)], dim=1)     # [B,K,C]
    w = params["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", full.to(x.dtype), w) \
        + params["conv_b"].to(x.dtype)
    xBC_t = layers.silu(conv_out)                                   # [B,C]
    xc, Bm, Cm = torch.split(xBC_t, [DI, N, N], dim=-1)
    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])           # [B,H]
    a = torch.exp(dt * -torch.exp(params["A_log"]))                 # [B,H]
    xh = xc.reshape(-1, H, P).float()
    dBx = torch.einsum("bn,bhp,bh->bhpn", Bm.float(), xh, dt)
    state = state * a[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + params["D"][None, :, None] * xh
    y = y.reshape(-1, 1, DI).to(x.dtype)
    return _out(params, cfg, y, z, x), state, full[:, 1:]


def _decode_heads(params, cfg, x, state, conv_buf, cut):
    """:func:`ssd_decode_step` with the state's heads cut: block
    ``cut.j`` of ``cut.n``."""
    DI, N, H, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    hs = cut.rows(H)
    ch = slice(hs.start * P, hs.stop * P)           # their d_inner channels
    z, xBC, dt = _split_proj(params, cfg, x)                        # [B,1,*]
    full = torch.cat([conv_buf, xBC.to(conv_buf.dtype)], dim=1)     # [B,K,C]
    w = params["conv_w"].to(x.dtype)
    conv_out = torch.einsum("bkc,kc->bc", full.to(x.dtype), w) \
        + params["conv_b"].to(x.dtype)
    xc, Bm, Cm = torch.split(layers.silu(conv_out), [DI, N, N], dim=-1)
    dt = F.softplus(dt[:, 0, hs].float() + params["dt_bias"][hs])   # [B,h]
    a = torch.exp(dt * -torch.exp(params["A_log"][hs]))
    xh = xc[:, ch].reshape(-1, hs.stop - hs.start, P).float()
    dBx = torch.einsum("bn,bhp,bh->bhpn", Bm.float(), xh, dt)
    state = state * a[:, :, None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + params["D"][hs][None, :, None] * xh
    y = y.reshape(-1, 1, ch.stop - ch.start).to(x.dtype)
    # the gated RMSNorm over all of d_inner: the blocks' sums of squares
    yz = (y * layers.silu(z[..., ch])).float()
    ss = tp.all_gather_cat(yz.square().sum(-1, keepdim=True)[None],
                           cut.group)
    var = ss.sum(0) / DI
    yn = (yz * torch.rsqrt(var + cfg.norm_eps)
          * (1.0 + params["norm_scale"][ch].float())).to(x.dtype)
    out = torch.matmul(yn, params["out_proj"][ch].to(x.dtype))
    return tp.reduce_from(out, cut.group), state, full[:, 1:]
