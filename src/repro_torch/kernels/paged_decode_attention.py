"""One-token decode attention against a global KV page pool.

``paged_decode_attention_ref`` is the plain PyTorch version (any device): it
gathers each row's pages into a contiguous ``[B, max_pages·pt, K, D]`` view
and runs a masked softmax. ``paged_decode_attention_cuda`` launches the CUDA
kernel ``csrc/paged_decode_attention.cu`` (the port of the Pallas kernel
``repro/kernels/paged_decode_attention.py::paged_decode_attention``,
model-dtype pages), which chases the page table without a gather.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import _sdpa


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               softcap: float = 0.0):
    """q: [B,1,H,D]; k/v_pages: [n_pages, pt, K, D]; page_table: int
    [B, max_pages]; lengths: int [B] → [B,1,H,D]. Row b attends its first
    lengths[b] tokens; token t lives at (page_table[b, t // pt], t % pt)."""
    B = q.shape[0]
    pt = k_pages.shape[1]
    S = page_table.shape[1] * pt
    idx = page_table.long()
    ck = k_pages[idx].reshape(B, S, *k_pages.shape[2:]).to(q.dtype)
    cv = v_pages[idx].reshape(B, S, *v_pages.shape[2:]).to(q.dtype)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    return _sdpa(q, ck, cv, valid[:, None, :], softcap)


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                                softcap: float = 0.0):
    tensors = (q, k_pages, v_pages, page_table, lengths)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_decode_attention_cuda takes CUDA tensors")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("q and the pages must share one dtype (quantized "
                        "pages are ROADMAP queue 2, item 2)")
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
    G = H // K
    smem = 64 * 8 + (2 * G * D + 64 * G + 3 * G) * 4
    if D > 256 or smem > 227 * 1024:
        raise ValueError(f"head dim {D} / group {G} exceed the kernel's "
                         f"shared memory")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        # the pool is updated in place: a silent copy would detach it
        raise ValueError("k/v pages must be contiguous")
    q = q.contiguous()
    table = page_table.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    fn = build.function("rap_paged_decode_attention",
                        [build.P] * 6 + [build.I] * 6
                        + [build.F32, build.F32, build.I, build.P])
    build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(),
                   out.data_ptr(), B, H, K, D, pt, table.shape[1],
                   1.0 / math.sqrt(D), float(softcap), build.dtype_code(q),
                   build.stream(q)),
                "paged_decode_attention")
    return out
