"""Dense feed-forward blocks: SwiGLU / GeGLU."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers


def init_ffn_params(gen, cfg, n: int, device) -> dict:
    """Stacked params of ``n`` FFN blocks: wi [n, D, 2F], wo [n, F, D]."""
    if cfg.activation not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"activation {cfg.activation!r} comes with whisper-medium, the "
            f"one architecture that uses it (ROADMAP queue 1, item 14)")
    pd = cfg.torch_param_dtype()
    wi = torch.empty(n, cfg.d_model, 2 * cfg.d_ff, dtype=pd, device=device)
    wo = torch.empty(n, cfg.d_ff, cfg.d_model, dtype=pd, device=device)
    for i in range(n):
        layers.dense_init_(wi[i], gen)
        layers.dense_init_(wo[i], gen,
                           scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1)))
    return {"wi": wi, "wo": wo}


def glu_activate(h, activation: str):
    """h: [..., 2F] fused (gate, up) → [..., F] through the fused GLU
    kernel (its plain version on CPU tensors)."""
    return kops.fused_glu(h, activation)


def ffn(params, cfg, x):
    h = torch.matmul(x, params["wi"].to(x.dtype))
    h = glu_activate(h, cfg.activation)
    return torch.matmul(h, params["wo"].to(x.dtype))
