"""Dense feed-forward blocks: SwiGLU / GeGLU / GELU."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.parallel import tp


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
    (whisper) has no kernel on either side, as in JAX.

    Under a model axis of m > 1 (``parallel.tp``) with ``wo`` cut on its
    F rows, the block is partial: this rank's F/m features (its ``wi``
    block holds ``[gate_r | up_r]``, ``parallel/sharding.py``'s GLU cut),
    the ``wo`` product summed over "model". Where F does not divide m,
    every rank gathers the cut leaves and computes the whole block. Under
    ``parallel.tp.seq_split`` the block gathers the sequence at its entry
    and cuts it again at its exit (``tp.enter`` / ``tp.leave``)."""
    widths = {"wi": (-1, 2 * cfg.d_ff if is_glu(cfg) else cfg.d_ff),
              "wo": (-2, cfg.d_ff)}
    mode = tp.block_mode(params, widths, "wo")
    partial = mode == "partial"
    if mode == "whole":     # F does not divide the axis: wi's cut is 2F/m
        params = tp.gather_cut(params, widths)
    wi, wo = params["wi"], params["wo"]
    if partial:
        x = tp.enter(x)
    elif mode == "whole":
        x = tp.enter_whole(x)
    h = torch.matmul(x, wi.to(x.dtype))
    h = glu_activate(h, cfg.activation) if is_glu(cfg) else layers.gelu(h)
    y = torch.matmul(h, wo.to(x.dtype))
    if partial:
        return tp.leave(y)
    return tp.leave_whole(y) if mode == "whole" else y
