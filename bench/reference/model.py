"""A dense decoder-only LM in plain PyTorch (glm4-9b: grouped-query
attention, q/k/v biases), in the parameter layout the benchmark draws
(``benchlib/inputs.py``).

Every layer: RMSNorm (``x / rms · (1 + scale)``), q/k/v projections (with
their biases under ``qkv_bias``), half-split RoPE, causal softmax
attention (query head h reads KV head h // (H / K), scores scaled by
1/√Dh), the output projection, and a residual branch gated by the
request's keep-mask; then the FFN branch the same way: the SwiGLU
``silu(gate) · up`` of the fused ``[gate | up]`` product.

``Precision`` sets the arithmetic of every matrix product of weights:
``f32`` (the reference; TF32 off) or ``fp8`` (weights per output channel
and activations per row rounded to float8 e4m3 first: the control).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _q8(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
        s = amax / 448.0
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A weight ``[..., in, out]`` in f32, rounded per output column."""
        w = w.float()
        return w if self.name == "f32" else self._q8(w, -2)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., in] @ w [in, out]`` (``w`` from :meth:`weight`)."""
        if self.name == "fp8":
            x = self._q8(x, -1)
        return x @ w


def rms_norm(x, scale, eps: float):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def rope(x, positions, theta: float):
    """x [S, H, Dh]; positions [S]."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                          device=x.device) / dh))
    ang = positions.float()[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024):
    """q [S, H, Dh], k/v [S, K, Dh] → [S, H, Dh], in query blocks."""
    S, H, Dh = q.shape
    K = k.shape[1]
    G = H // K
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)      # [H, S, Dh]
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(a + block, S)
        qb = q[a:b].transpose(0, 1)                           # [H, n, Dh]
        s = (qb @ kk[:, :b].transpose(1, 2)) / math.sqrt(Dh)  # [H, n, b]
        qpos = torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(kpos[None, :b] > qpos, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = (p @ vv[:, :b]).transpose(0, 1)
    return out


def layer(h, params: Dict, i: int, cfg: Dict, gates, positions,
          prec: Precision):
    """Layer ``i`` over rows ``h [R, S, D]`` (independent sequences);
    ``gates`` [2, R] of 0/1 (mixer, FFN)."""
    R, S, D = h.shape
    H, K = int(cfg["n_heads"]), int(cfg["n_kv_heads"])
    Dh = int(cfg.get("head_dim") or D // H)
    eps = float(cfg.get("norm_eps", 1e-6))
    a = params["stacks"]["attn"]
    hn = rms_norm(h, a["norm"]["scale"][i], eps)
    q = prec.mm(hn, prec.weight(a["wq"][i]))
    kx = prec.mm(hn, prec.weight(a["wk"][i]))
    v = prec.mm(hn, prec.weight(a["wv"][i]))
    if cfg.get("qkv_bias"):
        q = q + a["bq"][i].float()
        kx = kx + a["bk"][i].float()
        v = v + a["bv"][i].float()
    q, kx = q.reshape(R, S, H, Dh), kx.reshape(R, S, K, Dh)
    v = v.reshape(R, S, K, Dh)
    theta = float(cfg.get("rope_theta", 10000.0))
    att = torch.stack([causal_attention(rope(q[r], positions, theta),
                                        rope(kx[r], positions, theta), v[r])
                       for r in range(R)])
    out = prec.mm(att.reshape(R, S, H * Dh), prec.weight(a["wo"][i]))
    h = h + gates[0][:, None, None] * out
    f = params["stacks"]["dense"]
    hn = rms_norm(h, f["norm"]["scale"][i], eps)
    g, u = prec.mm(hn, prec.weight(f["wi"][i])).chunk(2, dim=-1)
    out = prec.mm(torch.nn.functional.silu(g) * u, prec.weight(f["wo"][i]))
    return h + gates[1][:, None, None] * out


@torch.no_grad()
def logits(params: Dict, cfg: Dict, tokens: torch.Tensor, masks,
           positions_out: Optional[Sequence[int]] = None,
           prec: Optional[Precision] = None):
    """f32 logits over the vocabulary of rows ``tokens [R, S]``, each row
    under its keep-mask (``masks [R, 2L]``), at ``positions_out`` (all
    positions by default): ``[R, n, V]``."""
    prec = prec or Precision("f32")
    no_tf32()
    L, V = int(cfg["n_layers"]), int(cfg["vocab_size"])
    R, S = tokens.shape
    m = torch.as_tensor(masks, dtype=torch.float32, device=tokens.device)
    h = params["embed"][tokens.long()].float()
    positions = torch.arange(S, device=tokens.device)
    for i in range(L):
        h = layer(h, params, i, cfg, (m[:, i], m[:, L + i]), positions,
                  prec)
    if positions_out is not None:
        h = h[:, list(positions_out)]
    h = rms_norm(h, params["final_norm"]["scale"],
                 float(cfg.get("norm_eps", 1e-6)))
    return prec.mm(h, prec.weight(params["lm_head"][:, :V]))
