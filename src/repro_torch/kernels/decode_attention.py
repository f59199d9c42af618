"""One-token decode attention against a contiguous KV cache.

``decode_attention_ref`` is the plain PyTorch version (any device): a
masked softmax over the whole cache width. ``decode_attention_cuda``
launches the CUDA kernel ``csrc/decode_attention.cu``, the port of the
Pallas kernel ``repro/kernels/decode_attention.py::decode_attention``.

``valid`` is JAX's ``[S]`` (one mask for every row: the one-shot path,
scalar position) or ``[B, S]`` (one mask per row: the slot cache, where
each row decodes at its own position). The ``[B, S]`` form is the same
function applied row by row; it is what JAX computes with ``_sdpa`` on its
slot path.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import _sdpa

TILE = 64            # csrc/flash_decode.cuh kTile


def decode_attention_ref(q, k, v, valid, *, softcap: float = 0.0):
    """q: [B,1,H,D]; k/v: [B,S,K,D]; valid: bool [S] or [B,S] → [B,1,H,D].
    Row b attends the tokens where its mask is set."""
    if valid.ndim == 1:
        valid = valid[None]
    return _sdpa(q, k, v, valid[:, None, :], softcap)


def _check(q, k, v, valid):
    """Shapes, dtypes and shared memory; returns (B, H, K, D, S)."""
    B, one, H, D = q.shape
    Bk, S, K, Dk = k.shape
    if (one != 1 or Bk != B or Dk != D or v.shape != k.shape or H % K
            or valid.shape not in ((S,), (B, S))):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} valid {tuple(valid.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype} (a quantized cache is "
                        f"dequantized by load_kv first)")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    G = H // K
    smem = 16 + 9 * TILE + (2 * G * D + TILE * G + 3 * G) * 4
    if smem > 227 * 1024:
        raise ValueError(f"head dim {D} / group {G} exceed the kernel's "
                         f"shared memory")
    return B, H, K, D, S


def decode_attention_cuda(q, k, v, valid, *, softcap: float = 0.0):
    if not all(t.is_cuda for t in (q, k, v, valid)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    B, H, K, D, S = _check(q, k, v, valid)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    fn = build.function("rap_decode_attention",
                        [build.P] * 4 + [build.LL, build.P] + [build.I] * 5
                        + [build.F32, build.F32, build.I, build.P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   valid.data_ptr(), S if valid.ndim == 2 else 0,
                   out.data_ptr(), B, H, K, D, S, 1.0 / math.sqrt(D),
                   float(softcap), build.dtype_code(q), build.stream(q)),
                "decode_attention")
    return out
