"""One-token decode attention against a global KV page pool.

``paged_decode_attention_ref`` is the plain PyTorch version (any device): it
gathers each row's pages into a contiguous ``[B, max_pages·pt, K, D]`` view
and runs a masked softmax. ``paged_decode_attention_cuda`` launches the CUDA
kernel ``csrc/paged_decode_attention.cu`` (the port of the Pallas kernel
``repro/kernels/paged_decode_attention.py::paged_decode_attention``,
model-dtype pages), which chases the page table without a gather; it cuts
each row's ``max_pages · page_tokens`` slots into the same splits as the
dense kernel (``decode_attention.split_scratch``).

The quantized pair serves int8 / float8_e4m3fn pages with f32 scales
``[n_pages, K]``: ``paged_decode_attention_quant_ref`` widens the gathered
pages with ``page_dequant`` before the same masked softmax (as JAX's XLA
gather does), and ``paged_decode_attention_quant_cuda`` launches the same
CUDA kernel body with a dequantizing page loader (the port of
``_kernel_quant``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (io_cost, split_scratch,
                                                  split_scratch_bytes)
from repro_torch.kernels.ref import _sdpa, concrete, gather_pages


def _tokens_pages(k_pages, page_table, lengths):
    """(attended tokens, touched pages): the rows' lengths (every slot of
    the table for fake or meta lengths)."""
    pt = k_pages.shape[1]
    if concrete(lengths):
        return (int(lengths.sum()),
                int(((lengths.long() + pt - 1) // pt).sum()))
    return page_table.numel() * pt, page_table.numel()


def cost(q, k_pages, v_pages, page_table, lengths, *, softcap: float = 0.0,
         split_rows: int = 0):
    """The rows' tokens read from their pages, the table and lengths
    once."""
    toks, _ = _tokens_pages(k_pages, page_table, lengths)
    B, K = q.shape[0], k_pages.shape[2]
    slots = page_table.shape[1] * k_pages.shape[1]
    return io_cost(q, toks, K, k_pages.element_size(),
                   4 * (page_table.numel() + lengths.numel()),
                   split_scratch_bytes(q, B, K, slots, split_rows))


def cost_quant(q, k_pages, v_pages, k_scales, v_scales, page_table, lengths,
               *, softcap: float = 0.0, split_rows: int = 0):
    """As :func:`cost` on int8/fp8 codes, plus one f32 scale per touched
    (page, kv head) of K and of V."""
    toks, pages = _tokens_pages(k_pages, page_table, lengths)
    B, K = q.shape[0], k_pages.shape[2]
    slots = page_table.shape[1] * k_pages.shape[1]
    return io_cost(q, toks, K, k_pages.element_size(),
                   2 * pages * K * 4
                   + 4 * (page_table.numel() + lengths.numel()),
                   split_scratch_bytes(q, B, K, slots, split_rows))


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               softcap: float = 0.0):
    """q: [B,1,H,D]; k/v_pages: [n_pages, pt, K, D]; page_table: int
    [B, max_pages]; lengths: int [B] → [B,1,H,D]. Row b attends its first
    lengths[b] tokens; token t lives at (page_table[b, t // pt], t % pt)."""
    return paged_decode_attention_quant_ref(q, k_pages, v_pages, None, None,
                                            page_table, lengths,
                                            softcap=softcap)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scales, v_scales,
                                     page_table, lengths, *,
                                     softcap: float = 0.0):
    """As :func:`paged_decode_attention_ref` on int8/fp8 pages with f32
    scales ``k/v_scales [n_pages, K]``: each gathered page is widened to
    ``code.float() * scale`` before the masked softmax (``None`` scales:
    model-dtype pages, read as they are)."""
    ck = gather_pages(k_pages, page_table, q.dtype, k_scales)
    cv = gather_pages(v_pages, page_table, q.dtype, v_scales)
    valid = (torch.arange(ck.shape[1], device=q.device)[None, :]
             < lengths[:, None])
    return _sdpa(q, ck, cv, valid[:, None, :], softcap)


def _check(q, k_pages, v_pages, page_table, lengths):
    """Shapes, index dtypes and layout of either kernel; returns (B, H, K,
    D, pt). The kernels refuse a group and width whose tiles do not fit a
    block's shared memory."""
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    B, one, H, D = q.shape
    n_pages, pt, K, Dk = k_pages.shape
    if (one != 1 or Dk != D or v_pages.shape != k_pages.shape or H % K
            or page_table.shape[0] != B or lengths.shape != (B,)):
        raise ValueError(f"bad shapes q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} table "
                         f"{tuple(page_table.shape)} lengths "
                         f"{tuple(lengths.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        # the pool is updated in place: a silent copy would detach it
        raise ValueError("k/v pages must be contiguous")
    return B, H, K, D, pt


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                                softcap: float = 0.0, split_rows: int = 0):
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes CUDA tensors")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("q and the pages must share one dtype (int8/fp8 "
                        "pages go to paged_decode_attention_quant_cuda)")
    B, H, K, D, pt = _check(q, k_pages, v_pages, page_table, lengths)
    q = q.contiguous()
    table = page_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    max_pages = table.shape[1]
    split, n, part = split_scratch(q, B, K, max_pages * pt, split_rows)
    fn = build.function("rap_paged_decode_attention",
                        [build.P] * 7 + [build.I] * 8
                        + [build.F32, build.F32, build.I, build.P])
    build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   part.data_ptr(), B, H, K, D, pt, max_pages,
                   split, n, 1.0 / math.sqrt(D), float(softcap),
                   build.dtype_code(q), build.stream(q)),
                "paged_decode_attention")
    return out


PAGE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}   # csrc page loaders


def paged_decode_attention_quant_cuda(q, k_pages, v_pages, k_scales,
                                      v_scales, page_table, lengths, *,
                                      softcap: float = 0.0,
                                      split_rows: int = 0):
    """Fused-dequant paged decode on the card: q bf16/f32/f16, pages int8 or
    float8_e4m3fn, scales f32 ``[n_pages, K]``."""
    tensors = (q, k_pages, v_pages, k_scales, v_scales, page_table, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_quant_cuda takes CUDA "
                         "tensors")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in PAGE_CODES:
        raise TypeError(f"quantized pages must be int8 or float8_e4m3fn, "
                        f"got {k_pages.dtype}/{v_pages.dtype}")
    B, H, K, D, pt = _check(q, k_pages, v_pages, page_table, lengths)
    n_pages = k_pages.shape[0]
    for s in (k_scales, v_scales):
        if s.dtype != torch.float32 or s.shape != (n_pages, K):
            raise ValueError(f"scales must be f32 [{n_pages}, {K}], got "
                             f"{s.dtype} {tuple(s.shape)}")
        if not s.is_contiguous():
            raise ValueError("scales must be contiguous (updated in place)")
    q = q.contiguous()
    table = page_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    max_pages = table.shape[1]
    split, n, part = split_scratch(q, B, K, max_pages * pt, split_rows)
    fn = build.function("rap_paged_decode_attention_quant",
                        [build.P] * 9 + [build.I] * 8
                        + [build.F32, build.F32, build.I, build.I, build.P])
    build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   k_scales.data_ptr(), v_scales.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                   part.data_ptr(), B, H, K, D, pt, max_pages,
                   split, n, 1.0 / math.sqrt(D), float(softcap),
                   build.dtype_code(q), PAGE_CODES[k_pages.dtype],
                   build.stream(q)),
                "paged_decode_attention_quant")
    return out
