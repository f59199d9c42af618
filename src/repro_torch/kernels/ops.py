"""Dispatch from the model code to the kernels.

A CUDA tensor goes to the hand-written CUDA kernel (or the call raises); a
CPU tensor goes to the kernel's plain PyTorch version. There is no fallback
from a CUDA tensor to the plain version. Each wrapper carries a plain
integer ``launches`` attribute, raised by one exactly where it launches its
kernel, so a run can show which kernels the main path went through
(:func:`launch_counts`, :func:`reset_launches`).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import rglru as _rg
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import swiglu as _glu


def fused_glu(h, activation: str = "swiglu"):
    """h: [..., 2F] fused (gate, up) → act(gate) * up, [..., F]."""
    if h.is_cuda:
        fused_glu.launches += 1
        return _glu.fused_glu_cuda(h, activation)
    return _glu.glu_ref(h, activation)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           k_scales=None, v_scales=None,
                           softcap: float = 0.0, split_rows: int = 0):
    """q: [B,1,H,D]; k/v_pages: [n_pages, pt, K, D]; page_table: int32
    [B, max_pages]; lengths: int32 [B] → [B,1,H,D]. ``k/v_scales`` (f32
    ``[n_pages, K]``, both or neither) mark int8/fp8 pages and go to
    :func:`paged_decode_attention_quant`. ``split_rows`` (0: B) is the row
    count the kernel's split-KV cut is chosen for (``ref.decode_splits``);
    the plain version has no splits."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    if k_scales is not None:
        return paged_decode_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            softcap=softcap, split_rows=split_rows)
    if q.is_cuda:
        paged_decode_attention.launches += 1
        return _pdec.paged_decode_attention_cuda(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap,
            split_rows=split_rows)
    return _pdec.paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                            lengths, softcap=softcap)


def paged_decode_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, lengths, *,
                                 softcap: float = 0.0, split_rows: int = 0):
    """Fused-dequant paged decode: int8/fp8 pages with per-(page, kv head)
    f32 scales ``[n_pages, K]``; otherwise as :func:`paged_decode_attention`."""
    if q.is_cuda:
        paged_decode_attention_quant.launches += 1
        return _pdec.paged_decode_attention_quant_cuda(
            q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
            softcap=softcap, split_rows=split_rows)
    return _pdec.paged_decode_attention_quant_ref(
        q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
        softcap=softcap)


def decode_attention(q, k, v, valid, *, softcap: float = 0.0,
                     split_rows: int = 0):
    """q: [B,1,H,D]; k/v: [B,S,K,D] contiguous cache; valid: bool [S] (one
    mask for all rows) or [B,S] (one per row) → [B,1,H,D]. ``split_rows``
    as in :func:`paged_decode_attention`."""
    if q.is_cuda:
        decode_attention.launches += 1
        return _dec.decode_attention_cuda(q, k, v, valid, softcap=softcap,
                                          split_rows=split_rows)
    return _dec.decode_attention_ref(q, k, v, valid, softcap=softcap)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [B,Sq,H,D]; k/v: [B,Skv,K,D] → [B,Sq,H,D] (q.dtype)."""
    if q.is_cuda:
        flash_attention.launches += 1
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    return _fa.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)


def ssd(xh, log_a, Bm, Cm, chunk: int = 256):
    """Chunked SSD scan: xh [B,T,H,P], log_a [B,T,H], Bm/Cm [B,T,N], all
    f32 and contiguous → (y [B,T,H,P], final state [B,H,P,N]), f32."""
    if xh.is_cuda:
        ssd.launches += 1
        return _ssd.ssd_cuda(xh, log_a, Bm, Cm, chunk)
    return _ssd.ssd_ref(xh, log_a, Bm, Cm, chunk)


def rglru(a, b):
    """h_t = a_t * h_{t-1} + b_t from zero: a, b [B,T,W] f32 → h f32."""
    if a.is_cuda:
        rglru.launches += 1
        return _rg.rglru_cuda(a, b)
    return _rg.rglru_ref(a, b)


KERNELS = (fused_glu, paged_decode_attention,
           paged_decode_attention_quant, flash_attention, decode_attention,
           ssd, rglru)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
