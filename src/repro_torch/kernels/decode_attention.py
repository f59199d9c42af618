"""One-token decode attention against a contiguous KV cache.

``decode_attention_ref`` is the plain PyTorch version (any device): a
masked softmax over the whole cache width. ``decode_attention_cuda``
launches the CUDA kernel ``csrc/decode_attention.cu``, the port of the
Pallas kernel ``repro/kernels/decode_attention.py::decode_attention``: one
CTA per (row, kv head, split of the cache), the splits from
``ref.decode_splits`` and their f32 partials in scratch allocated here,
combined in a fixed order (``ref.split_decode_ref`` mirrors it).

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
from repro_torch.kernels.ref import (H100_SMS, Cost, _sdpa, concrete,
                                    decode_splits)


def split_scratch(q, B: int, K: int, S: int, split_rows: int = 0):
    """(split_tokens, nsplit, partials) of one decode launch of ``B`` rows
    over ``S`` token slots: the splits from static shapes
    (``ref.decode_splits`` for ``split_rows`` rows, default ``B``, and the
    card's SM count), and f32 scratch for their partials (none for one
    split). A caller that steps a varying subset of a fixed set of rows
    passes the set's size, so a row's sums do not depend on which rows step
    with it."""
    split, n = decode_splits(split_rows or B, K, S,
                             build.sm_count(q.device))
    H, D = q.shape[2], q.shape[3]
    part = torch.empty(B * H * n * (D + 2) if n > 1 else 0,
                       dtype=torch.float32, device=q.device)
    return split, n, part


def split_scratch_bytes(q, B: int, K: int, S: int, split_rows: int = 0
                        ) -> int:
    """Bytes of :func:`split_scratch`'s partials, from shapes alone (the
    card's SM count on a CUDA tensor, an H100's elsewhere)."""
    sms = build.sm_count(q.device) if q.is_cuda else H100_SMS
    _, n = decode_splits(split_rows or B, K, S, sms)
    return B * q.shape[2] * n * (q.shape[3] + 2) * 4 if n > 1 else 0


def io_cost(q, toks: int, K: int, kv_bytes: float, other_bytes: float,
            scratch: int) -> Cost:
    """A decode launch that attends ``toks`` (row, token) pairs of K heads
    of ``kv_bytes`` per element (K and V): q read and out written, the
    attended K/V read once, ``other_bytes`` of masks, tables or scales; 4·D
    operations per attended token and query head."""
    H, D = q.shape[2], q.shape[3]
    return Cost(flops=4.0 * toks * H * D,
                bytes=float(2 * q.numel() * q.element_size()
                            + 2 * toks * K * D * kv_bytes + other_bytes),
                outputs=((tuple(q.shape), q.dtype),), scratch_bytes=scratch,
                op_dtype=q.dtype)


def cost(q, k, v, valid, *, softcap: float = 0.0, split_rows: int = 0
         ) -> Cost:
    """The attended tokens are the mask's (every slot of a fake or meta
    mask: a full cache); the mask is read once."""
    B, S, K = q.shape[0], k.shape[1], k.shape[2]
    if concrete(valid):
        toks = int(valid.sum()) * (B if valid.ndim == 1 else 1)
    else:
        toks = B * S
    return io_cost(q, toks, K, k.element_size(), valid.numel(),
                   split_scratch_bytes(q, B, K, S, split_rows))


def decode_attention_ref(q, k, v, valid, *, softcap: float = 0.0):
    """q: [B,1,H,D]; k/v: [B,S,K,D]; valid: bool [S] or [B,S] → [B,1,H,D].
    Row b attends the tokens where its mask is set."""
    if valid.ndim == 1:
        valid = valid[None]
    return _sdpa(q, k, v, valid[:, None, :], softcap)


def _check(q, k, v, valid):
    """Shapes and dtypes; returns (B, H, K, D, S). The kernel refuses a
    group and width whose tiles do not fit a block's shared memory."""
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
    return B, H, K, D, S


def decode_attention_cuda(q, k, v, valid, *, softcap: float = 0.0,
                          split_rows: int = 0):
    if not all(t.is_cuda for t in (q, k, v, valid)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    B, H, K, D, S = _check(q, k, v, valid)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    valid = valid.contiguous().view(torch.uint8)
    out = torch.empty_like(q)
    split, n, part = split_scratch(q, B, K, S, split_rows)
    fn = build.function("rap_decode_attention",
                        [build.P] * 4 + [build.LL] + [build.P] * 2
                        + [build.I] * 7
                        + [build.F32, build.F32, build.I, build.P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   valid.data_ptr(), S if valid.ndim == 2 else 0,
                   out.data_ptr(), part.data_ptr(), B, H, K, D, S,
                   split, n, 1.0 / math.sqrt(D), float(softcap),
                   build.dtype_code(q), build.stream(q)),
                "decode_attention")
    return out
