"""Primitive layers: initializers, norms, RoPE, activations.

Plain functions on tensors, mirroring the JAX package's ``models/layers.py``
(parameters are nested dicts of tensors, not ``nn.Module``s, so the weight
bridge maps the JAX pytree one to one). Initializers draw from an explicit
``torch.Generator``; the streams differ from ``jax.random``'s, so the tests
carry JAX weights across instead of re-drawing them.
"""
from __future__ import annotations

import math

import torch


# ----------------------------------------------------------------- initializers
def dense_init_(out: torch.Tensor, gen: torch.Generator,
                scale: float = 1.0) -> torch.Tensor:
    """Fill ``out [in_dim, out_dim]`` in place with the truncated-normal
    fan-in init (std ``scale / sqrt(in_dim)``, cut at ±2 std), drawn in f32
    and cast to ``out.dtype``."""
    std = scale / math.sqrt(out.shape[-2])
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.copy_(w.mul_(std))


def embed_init_(out: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    w = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    w.normal_(0.0, 1.0, generator=gen)
    return out.copy_(w.mul_(0.02))


# ----------------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with the ``(1 + scale)`` convention (zero-init scale)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """LayerNorm with the ``(1 + scale)`` convention plus a bias, in f32."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float()) + bias.float()).to(dt)


def init_norm(cfg, *lead: int, device=None) -> dict:
    """Zero-initialised norm params ``[*lead, d_model]``: ``scale``, and
    ``bias`` for a layernorm config."""
    z = lambda: torch.zeros(*lead, cfg.d_model,
                            dtype=cfg.torch_param_dtype(), device=device)
    if cfg.norm == "layernorm":
        return {"scale": z(), "bias": z()}
    return {"scale": z()}


def apply_norm(cfg, params: dict, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], cfg.norm_eps)
    return rms_norm(x, params["scale"], cfg.norm_eps)


# ------------------------------------------------------------------------ RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim//2]


def apply_rope(x, positions, theta: float):
    """Half-split RoPE. x: [..., S, H, Dh]; positions broadcastable to
    [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # [dh/2]
    angles = positions[..., :, None].float() * freqs         # [..., S, dh/2]
    angles = angles[..., None, :]                            # [..., S, 1, dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- activations
def gelu(x):
    """tanh-approximate gelu (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x):
    return torch.nn.functional.silu(x)


def softcap(x, cap: float):
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
