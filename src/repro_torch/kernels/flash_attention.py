"""Causal (optionally banded, softcapped) attention for prefill and scoring.

``attention_ref`` is the plain PyTorch version (any device);
``flash_attention_cuda`` launches the CUDA kernel ``csrc/flash_attention.cu``
(the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``). bf16 and fp16 inputs
run its Hopper body (TMA loads into an mbarrier ring fed by a producer
warp, ``wgmma`` on 64-row consumer warpgroups with f32 accumulation, the
softmax in f32, and P rounded to the input type before P·V, as
``attention_ref`` and the JAX reference round it); f32 inputs run its f32
FMA body, which keeps full-f32 products and probabilities.

:func:`plan` is the wrapper's static choice, a pure function of the query
length, head width, dtype and the inputs' layout: the body, the tiles the
kernel is instantiated with, its shared memory, the padded head width,
and whether the inputs are copied. The Hopper body takes D % 8 == 0 and
16-byte aligned contiguous tensors (TMA's rule); the wrapper pads any
other D with zero columns and copies a misaligned or strided view, so
every bf16/fp16 call runs that body. The scale stays 1/sqrt(D) of the
unpadded D.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import Cost, _causal_mask, _sdpa

# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# launches of each body, raised where the wrapper launches it (the
# ``ops.flash_attention.launches`` count is their sum on the model's path)
BODY_LAUNCHES = {"wgmma": 0, "fma": 0}


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale=None):
    """q: [B,Sq,H,D]; k,v: [B,Skv,K,D] (H % K == 0) → [B,Sq,H,D]. Scores
    scaled by ``scale``, 1/sqrt(D) by default."""
    Sq, Skv = q.shape[1], k.shape[1]
    if causal:
        mask = _causal_mask(Sq, Skv, window, device=q.device)
    else:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        mask = (kpos > qpos - window if window > 0
                else torch.ones(Sq, Skv, dtype=torch.bool, device=q.device))[None]
    return _sdpa(q, k, v, mask, softcap, scale)


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


@dataclass(frozen=True)
class FlashPlan:
    body: str        # "wgmma" (bf16/fp16) or "fma" (f32)
    q_tile: int      # query rows a CTA (64 per consumer warpgroup)
    kv_tile: int     # keys a KV tile
    width: int       # head width the kernel's tiles hold (64, 128 or 256)
    d_pad: int       # head width the kernel is given (bf16/fp16: D to 8s)
    smem_bytes: int  # dynamic shared memory a CTA
    copy: bool       # inputs copied first (a strided or misaligned view)


@functools.lru_cache(maxsize=1024)
def plan(Sq: int, D: int, dtype, contiguous: bool = True,
         aligned: bool = True) -> FlashPlan:
    """The static plan of one call: ``Sq`` query rows of width ``D`` in
    ``dtype``; ``contiguous`` and ``aligned`` (every data pointer 16-byte
    aligned) describe the inputs. Mirrors ``csrc/flash_attention.cu``'s
    ``wg::Tiles`` (bf16/fp16) and its f32 body's constants."""
    if D > 256:
        raise ValueError(f"head dim {D} > 256 is not supported")
    if dtype == torch.float32:
        width = 64 if D <= 64 else 128 if D <= 128 else 256
        smem = (32 * (D + 1) + 2 * 32 * (D + 1) + 32 * 33) * 4
        return FlashPlan("fma", 32, 32, width, D, smem, not contiguous)
    if dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"flash attention takes float32/bfloat16/float16, "
                        f"got {dtype}")
    d_pad = -(-D // 8) * 8
    width = 64 if d_pad <= 64 else 128 if d_pad <= 128 else 256
    q_tile = 64 if Sq <= 64 or width == 256 else 128
    kv_tile = 128 if width == 64 else 64
    stages = 2
    # 1024 bytes to align the tiles, Q, the K and V rings, the mbarriers
    smem = (1024 + q_tile * width * 2 + 2 * stages * kv_tile * width * 2
            + 8 * (1 + 4 * stages))
    return FlashPlan("wgmma", q_tile, kv_tile, width, d_pad, smem,
                     not (contiguous and aligned))


def _fresh(t):
    """``t`` in fresh contiguous memory (the allocator aligns it)."""
    return t.contiguous() if not t.is_contiguous() else t.clone()


def run_planned(q, k, v, p: FlashPlan, core):
    """The wrapper's layout work around one call of ``core(q, k, v,
    scale)``: copy a view the plan refuses, pad D to ``p.d_pad`` with zero
    columns (which add nothing to q·k and give zero output columns), scale
    by 1/sqrt(D) of the unpadded D, and slice the output back."""
    D = q.shape[-1]
    if p.copy:
        q, k, v = (_fresh(t) if not t.is_contiguous()
                   or (p.body == "wgmma" and t.data_ptr() % 16) else t
                   for t in (q, k, v))
    if p.d_pad != D:
        q, k, v = (F.pad(t, (0, p.d_pad - D)) for t in (q, k, v))
    out = core(q, k, v, 1.0 / math.sqrt(D))
    return out if p.d_pad == D else out[..., :D].contiguous()


def _launch(p: FlashPlan, causal, window, softcap, q, k, v, scale):
    """One launch of the planned body on contiguous q, k, v whose D the
    body takes, into a fresh output."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = build.function("rap_flash_attention",
                        [build.P, build.P, build.P, build.P] + [build.I] * 6
                        + [build.F32, build.F32] + [build.I] * 5 + [build.P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Sq, Skv, H, K, D, scale, float(softcap), int(causal),
                   int(window), build.dtype_code(q), p.q_tile, p.kv_tile,
                   build.stream(q)),
                "flash_attention")
    BODY_LAUNCHES[p.body] += 1
    return out


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
    p = plan(Sq, D, q.dtype,
             q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             not (q.data_ptr() | k.data_ptr() | v.data_ptr()) & 15)
    if p.copy or p.d_pad != D:
        return run_planned(q, k, v, p, functools.partial(
            _launch, p, causal, window, softcap))
    return _launch(p, causal, window, softcap, q, k, v, 1.0 / math.sqrt(D))
