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

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pdec
from repro_torch.kernels import swiglu as _glu


def fused_glu(h, activation: str = "swiglu"):
    """h: [..., 2F] fused (gate, up) → act(gate) * up, [..., F]."""
    if h.is_cuda:
        fused_glu.launches += 1
        return _glu.fused_glu_cuda(h, activation)
    return _glu.glu_ref(h, activation)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           softcap: float = 0.0):
    """q: [B,1,H,D]; k/v_pages: [n_pages, pt, K, D]; page_table: int32
    [B, max_pages]; lengths: int32 [B] → [B,1,H,D]."""
    if q.is_cuda:
        paged_decode_attention.launches += 1
        return _pdec.paged_decode_attention_cuda(
            q, k_pages, v_pages, page_table, lengths, softcap=softcap)
    return _pdec.paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                            lengths, softcap=softcap)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [B,Sq,H,D]; k/v: [B,Skv,K,D] → [B,Sq,H,D] (q.dtype)."""
    if q.is_cuda:
        flash_attention.launches += 1
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
    return _fa.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)


KERNELS = (fused_glu, paged_decode_attention, flash_attention)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}
