"""Causal (optionally banded, softcapped) attention for prefill and scoring.

``attention_ref`` is the plain PyTorch version (any device);
``flash_attention_cuda`` launches the CUDA kernel ``csrc/flash_attention.cu``
(the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``). bf16 and fp16 inputs
run its tensor-core body (``mma.sync`` with f32 accumulation, the softmax in
f32, and P rounded to the input type before P·V, as ``attention_ref`` and
the JAX reference round it); f32 inputs run its f32 FMA body, which keeps
full-f32 products and probabilities.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import Cost, _causal_mask, _sdpa


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0):
    """q: [B,Sq,H,D]; k,v: [B,Skv,K,D] (H % K == 0) → [B,Sq,H,D]."""
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        mask = _causal_mask(Sq, Skv, window, device=q.device)
    else:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos > qpos - window if window > 0
                else torch.ones(Sq, Skv, dtype=torch.bool, device=q.device))[None]
    return _sdpa(q, k, v, mask, softcap)


def cost(q, k, v, *, causal: bool = True, window: int = 0,
         softcap: float = 0.0) -> Cost:
    """q and out read and written at H heads, k and v read at K heads; 4·D
    operations per kept (query, key) pair and query head (the pairs of
    ``attention_ref``'s mask)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qi = np.arange(Sq, dtype=np.int64)
    if causal:
        hi = np.minimum(qi + 1, Skv)
        lo = np.maximum(qi - window + 1, 0) if window > 0 else 0
    else:
        hi = np.full(Sq, Skv, dtype=np.int64)
        lo = np.maximum(qi - window + 1, 0) if window > 0 else 0
    pairs = int(np.maximum(hi - lo, 0).sum())
    return Cost(flops=4.0 * B * H * D * pairs,
                bytes=float((2 * B * Sq * H * D + 2 * B * Skv * K * D)
                            * q.element_size()),
                outputs=((tuple(q.shape), q.dtype),), op_dtype=q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if k.shape != (B, Skv, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D > 256:
        raise ValueError(f"head dim {D} > 256 is not supported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    fn = build.function("rap_flash_attention",
                        [build.P, build.P, build.P, build.P] + [build.I] * 6
                        + [build.F32, build.F32, build.I, build.I, build.I,
                           build.P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, Skv, H, K, D, 1.0 / math.sqrt(D), float(softcap),
                   int(causal), int(window), build.dtype_code(q),
                   build.stream(q)),
                "flash_attention")
    return out
