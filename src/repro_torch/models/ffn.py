"""Dense feed-forward blocks: SwiGLU / GeGLU / GELU."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers


def init_ffn_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` FFN blocks: wi [n, D, 2F] (GLU) or [n, D, F]
    (plain gelu), wo [n, F, D]."""
    pd = cfg.torch_param_dtype()
    width = 2 * cfg.d_ff if is_glu(cfg) else cfg.d_ff
    wi = torch.empty(n, cfg.d_model, width, dtype=pd, device=device)
    wo = torch.empty(n, cfg.d_ff, cfg.d_model, dtype=pd, device=device)
    for i in range(n):
        layers.dense_init_(wi[i], gen)
        layers.dense_init_(wo[i], gen,
                           scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    return {"wi": wi, "wo": wo}


def is_glu(cfg) -> bool:
    return cfg.activation in ("swiglu", "geglu")


def glu_activate(h, activation: str):
    """h: [..., 2F] fused (gate, up) → [..., F] through the fused GLU
    kernel (its plain version on CPU tensors)."""
    return kops.fused_glu(h, activation)


def ffn(params, cfg, x):
    """The GLU goes through the fused GLU kernel; the plain tanh-gelu FFN
    (whisper) has no kernel on either side, as in JAX."""
    h = torch.matmul(x, params["wi"].to(x.dtype))
    h = glu_activate(h, cfg.activation) if is_glu(cfg) else layers.gelu(h)
    return torch.matmul(h, params["wo"].to(x.dtype))
