"""Fused GLU gate: ``act(gate) * up`` from a fused ``[..., 2F]`` (gate|up).

``glu_ref`` is the plain PyTorch version (any device); ``fused_glu_cuda``
launches the CUDA kernel ``csrc/swiglu.cu`` (the port of the Pallas kernel
``repro/kernels/swiglu.py::fused_glu``). ``kernels.ops.fused_glu`` picks
between them by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import Cost
from repro_torch.models import layers

_ACTS = {"swiglu": 0, "geglu": 1}


def glu_ref(h, activation: str = "swiglu"):
    """h: [..., 2F] → [..., F] in h.dtype; the activation and the product
    are computed in f32, as the kernels do."""
    gate, up = h.float().chunk(2, dim=-1)
    act = layers.silu(gate) if activation == "swiglu" else layers.gelu(gate)
    return (act * up).to(h.dtype)


def cost(h, activation: str = "swiglu") -> Cost:
    """(gate, up) read, the product written; 5 f32 operations an output
    element."""
    F = h.shape[-1] // 2
    T = h.numel() // max(2 * F, 1)
    return Cost(flops=5.0 * T * F, bytes=float(3 * T * F * h.element_size()),
                outputs=((tuple(h.shape[:-1]) + (F,), h.dtype),),
                op_dtype=torch.float32)


def fused_glu_cuda(h, activation: str = "swiglu"):
    if activation not in _ACTS:
        raise ValueError(f"unknown activation {activation!r}")
    if not h.is_cuda:
        raise ValueError("fused_glu_cuda takes a CUDA tensor")
    F = h.shape[-1] // 2
    if h.shape[-1] != 2 * F:
        raise ValueError(f"last dim must be even (gate|up), got {h.shape}")
    x = h.contiguous()
    out = torch.empty(*h.shape[:-1], F, dtype=h.dtype, device=h.device)
    fn = build.function("rap_fused_glu",
                        [build.P, build.P, build.LL, build.I, build.I,
                         build.I, build.P])
    build.check(fn(x.data_ptr(), out.data_ptr(), x.numel() // (2 * F), F,
                   _ACTS[activation], build.dtype_code(x), build.stream(x)),
                "fused_glu")
    return out
