"""One-token decode attention against a contiguous KV cache.

``decode_attention_ref`` is the plain PyTorch version (any device): a
masked softmax over the whole cache width. ``decode_attention_cuda``
launches the CUDA kernel ``csrc/decode_attention.cu``, the port of the
Pallas kernel ``repro/kernels/decode_attention.py::decode_attention``: one
CTA per (row, kv head, split of the cache), the splits from
``ref.decode_splits`` and their f32 partials in scratch allocated here,
combined in a fixed order (``ref.split_decode_ref`` mirrors it).

``return_lse=True`` gives what a caller needs to join the results of
several blocks of one cache (``parallel.tp.combine_partials``): the output
in f32, unrounded (as the kernel's own splits keep their partials), and
each row and head's log-sum-exp of its attended scores, f32 ``[B, H]``
(-inf where no token is valid). The output's arithmetic is the same
either way: in f32 the two forms are the same bits.

``valid`` is JAX's ``[S]`` (one mask for every row: the one-shot path,
scalar position) or ``[B, S]`` (one mask per row: the slot cache, where
each row decodes at its own position). The ``[B, S]`` form is the same
function applied row by row; it is what JAX computes with ``_sdpa`` on its
slot path.

:func:`plan` is the one place that routes a decode call, for this wrapper
and the paged ones alike: a pure function of static shapes, dtypes and the
inputs' layout that names the body (``"wgmma"``: bf16/fp16 q on the
tensor cores, K and V by TMA into a ring of ``stages``; ``"fma"``: f32 q
and one query head a kv head, one cp.async stage), its shared memory,
whether the dense K/V
are copied first, whether an lse is written, and the split-KV cut; no
caller overrides it. K and V reach the kernel with
their batch, sequence and head strides: a sequence block ``k[:, a:b]`` or
a batch slice of a cache is read in place, and only a view whose rows of
D are not contiguous (or, for the tensor-core body, not 16-byte aligned)
is copied. ``BODY_LAUNCHES`` counts the launches of each body (of all
three decode wrappers) and ``COPIES`` the K/V copies this wrapper made.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (DECODE_TILE, H100_SMS, Cost, _sdpa,
                                    _sdpa_lse, concrete, decode_splits)

# dynamic shared memory one block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
# launches of each body by the three decode wrappers, raised where a
# wrapper launches it (``ops``' per-kernel counts are their sum by kernel)
BODY_LAUNCHES = {"wgmma": 0, "fma": 0}
# K/V copies made by ``decode_attention_cuda`` (a view the plan refuses)
COPIES = {"kv": 0}
# ring stages of the tensor-core body (fewer where a split has fewer tiles)
TC_STAGES = 3
# the narrowest group (query heads a kv head) the tensor-core body takes;
# G = 1 runs the FMA body. The card's timings (PERF.md rows 1, 2 and 5):
# at G = 5, 6 and 7 the tensor cores win on every kernel, by 1.4-1.7x at
# the medians; at G = 1 they lose on int8/fp8 pages (widening a tile of
# codes costs more than they save) and gain 2-11% on bf16 pages and the
# dense cache. That gain is given up: on the tensor cores' other rounding a
# near-tie token of serve 3 flipped against its sharded twin, whose decode
# inputs already differ (ROADMAP queue 3, D5). G = 2 to 4 (no model of the
# repo) follow G = 5 untimed.
TC_MIN_GROUP = 2
# csrc body codes
BODY_CODES = {"fma": 0, "wgmma": 1}
# one-byte page codes (int8, float8_e4m3fn)
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


@dataclass(frozen=True)
class DecodePlan:
    body: str           # "wgmma" (bf16/fp16 q, tensor cores) or "fma"
    stages: int         # K/V ring stages (the FMA body: 1)
    heads: int          # query heads a CTA's products hold (wgmma: G to 8s)
    width: int          # head width the tiles hold (wgmma: D to 64s)
    smem_bytes: int     # dynamic shared memory a CTA
    copy: bool          # the dense K/V are copied first
    lse: bool           # out in f32 and the lse [B, H] beside it
    split_tokens: int   # tokens a split (whole 64-token tiles)
    nsplit: int         # splits a row


def _fma_smem(G: int, D: int, esize: int, paged: bool) -> int:
    """``csrc/flash_decode.cuh::smem_bytes``: the loader's state (the
    dense mask flags, or the paged offsets and scales), one K/V tile, the
    f32 words of the loop."""
    state = 2 * 64 * 8 + 4 * 64 * 4 if paged else 2 * 64 + 16
    a16 = lambda n: (n + 15) // 16 * 16
    return (a16(state) + 2 * DECODE_TILE * D * esize
            + a16((2 * G * D + G * DECODE_TILE + 3 * G) * 4))


def _tc_smem(width: int, heads: int, stages: int, codes: bool,
             D: int) -> int:
    """``csrc/flash_decode.cuh::tc::layout``: the K/V ring, the widened
    tiles of codes, Q, P and its remainder, the warps' per-head words,
    each stage's flags and scales, the barriers, and 1024 bytes to align
    the tiles."""
    tile = 64 * D if codes else 64 * width * 2
    return (stages * 2 * tile + (2 * 64 * width * 2 if codes else 0)
            + heads * width * 2 + 2 * heads * 128 + 4 * heads * 4
            + stages * 64 + stages * 64 + stages * 16 + 1024)


def _tc_refusal(dtype, page_dtype, G: int, D: int,
                page_tokens: int) -> Optional[str]:
    """Why the tensor-core body cannot take these shapes (None: it can)."""
    if dtype not in (torch.bfloat16, torch.float16):
        return f"q in {dtype} (bf16/fp16 only)"
    codes = page_dtype in CODE_DTYPES
    if D > 256 or D % (16 if codes else 8):
        return f"D = {D} (a multiple of {16 if codes else 8}, at most 256)"
    if G > 16:
        return f"G = {G} (at most 16 heads a kv head, the serves' widest)"
    if page_tokens and page_tokens % 8:
        return f"page_tokens = {page_tokens} (a multiple of 8)"
    return None


@functools.lru_cache(maxsize=4096)
def plan(dtype, page_dtype, G: int, D: int, page_tokens: int,
         return_lse: bool, rows: int, K: int, S: int,
         sms: int = H100_SMS, contiguous: bool = True,
         aligned: bool = True) -> DecodePlan:
    """The static plan of one decode call: q in ``dtype``; K/V in
    ``page_dtype`` (the dense cache: None; pages: their dtype, int8 or
    float8_e4m3fn for codes) of ``page_tokens`` tokens a page (dense: 0);
    ``G`` query heads a kv head of width ``D``; ``return_lse`` (the dense
    kernel only: the f32 output and its lse); the split-KV cut of ``rows``
    rows (``split_rows``, or the launch's) of ``K`` kv heads over ``S``
    token slots on ``sms`` SMs (``ref.decode_splits``); ``contiguous`` (the
    dense K/V's rows of D contiguous, K and V at the same strides) and
    ``aligned`` (every base and stride a 16-byte multiple). bf16/fp16 q
    takes the tensor-core body where it can and G reaches ``TC_MIN_GROUP``,
    f32 q the FMA body. A plan the card cannot run raises ValueError;
    nothing is routed elsewhere at run time."""
    tc = (_tc_refusal(dtype, page_dtype, G, D, page_tokens) is None
          and G >= TC_MIN_GROUP)
    # a pool is never copied: a misaligned one runs the FMA body
    body = "wgmma" if tc and (aligned or not page_tokens) else "fma"
    return _body_plan(body, dtype, page_dtype, G, D, page_tokens,
                      return_lse, rows, K, S, sms, contiguous, aligned)


def _check_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"decode kernels take float32/bfloat16/float16 q, "
                        f"got {dtype}")


def _body_plan(body: str, dtype, page_dtype, G: int, D: int,
               page_tokens: int, return_lse: bool, rows: int, K: int,
               S: int, sms: int = H100_SMS, contiguous: bool = True,
               aligned: bool = True) -> DecodePlan:
    """:func:`plan`'s plan on ``body``: what :func:`plan` returns for the
    body it names, and, for tests and timing only (the private launch
    entries ``_decode_cuda``, ``_paged_cuda``, ``_paged_quant_cuda``), the
    plan of the other body; a body that cannot take the shapes raises
    ValueError."""
    _check_dtype(dtype)
    if body not in BODY_CODES:
        raise ValueError(f"unknown decode body {body!r}")
    why = _tc_refusal(dtype, page_dtype, G, D, page_tokens)
    if body == "wgmma" and why is not None:
        raise ValueError(f"the tensor-core decode body cannot take {why}")
    if return_lse and page_tokens:
        raise ValueError("return_lse is the dense decode kernel's")
    codes = page_dtype in CODE_DTYPES
    split, n = decode_splits(rows, K, S, sms)
    if body == "wgmma":
        heads = 8 if G <= 8 else 16
        width = 64 if D <= 64 else 128 if D <= 128 else 256
        stages = min(TC_STAGES, split // DECODE_TILE)
        smem = _tc_smem(width, heads, stages, codes, D)
        copy = not (contiguous and aligned)
    else:
        heads, width, stages = G, D, 1
        smem = _fma_smem(G, D, (page_dtype or dtype).itemsize,
                         bool(page_tokens))
        copy = not contiguous
    if smem > SMEM_LIMIT:
        raise ValueError(f"G = {G} heads of D = {D} need {smem} bytes of "
                         f"shared memory a block ({body} body), over the "
                         f"{SMEM_LIMIT} an H100 block may use")
    if copy and page_tokens:
        raise ValueError("a page pool is updated in place: it must be "
                         "contiguous, and 16-byte aligned for the "
                         "tensor-core body")
    return DecodePlan(body, stages, heads, width, smem, copy,
                      bool(return_lse), split, n)


def split_rows_of(B: int, split_rows: int) -> int:
    """The rows a launch's split-KV cut is chosen for: the caller's slot
    width where it passes one (so a row's sums do not depend on which rows
    step with it), else the launch's own."""
    return split_rows or B


def planned(what: str, q, K: int, page_dtype, G: int, D: int,
            page_tokens: int, S: int, split_rows: int, *,
            return_lse: bool = False, contiguous: bool = True,
            aligned: bool = True, body: Optional[str] = None
            ) -> DecodePlan:
    """:func:`plan` for a launch of ``q``'s rows on its card (``body``: the
    private entries' forced body, :func:`_body_plan`); a shape the card
    cannot run raises RuntimeError naming the kernel ``what``."""
    args = (q.dtype, page_dtype, G, D, page_tokens, return_lse,
            split_rows_of(q.shape[0], split_rows), K, S,
            build.sm_count(q.device), contiguous, aligned)
    try:
        return plan(*args) if body is None else _body_plan(body, *args)
    except ValueError as e:
        raise RuntimeError(f"{what}: {e}") from None


def scratch(q, p: DecodePlan):
    """f32 scratch for the splits' partials of ``q``'s rows (none for one
    split)."""
    B, H, D = q.shape[0], q.shape[2], q.shape[3]
    n = p.nsplit
    return torch.empty(B * H * n * (D + 2) if n > 1 else 0,
                       dtype=torch.float32, device=q.device)


def aligned16(*tensors) -> bool:
    """Every base 16-byte aligned."""
    return not any(t.data_ptr() % 16 for t in tensors)


def split_scratch_bytes(q, B: int, K: int, S: int, split_rows: int = 0
                        ) -> int:
    """Bytes of :func:`scratch`'s partials, from shapes alone (the
    card's SM count on a CUDA tensor, an H100's elsewhere)."""
    sms = build.sm_count(q.device) if q.is_cuda else H100_SMS
    _, n = decode_splits(split_rows or B, K, S, sms)
    return B * q.shape[2] * n * (q.shape[3] + 2) * 4 if n > 1 else 0


def io_cost(q, toks: int, K: int, kv_bytes: float, other_bytes: float,
            scratch: int, lse: bool = False) -> Cost:
    """A decode launch that attends ``toks`` (row, token) pairs of K heads
    of ``kv_bytes`` per element (K and V): q read and out written, the
    attended K/V read once, ``other_bytes`` of masks, tables or scales; 4·D
    operations per attended token and query head. ``lse``: out in f32 and
    an f32 [B, H] beside it."""
    B, H, D = q.shape[0], q.shape[2], q.shape[3]
    out_dt = torch.float32 if lse else q.dtype
    outputs = ((tuple(q.shape), out_dt),)
    if lse:
        outputs += (((B, H), torch.float32),)
    return Cost(flops=4.0 * toks * H * D,
                bytes=float(q.numel() * (q.element_size() + out_dt.itemsize)
                            + 2 * toks * K * D * kv_bytes + other_bytes
                            + (B * H * 4 if lse else 0)),
                outputs=outputs, scratch_bytes=scratch, op_dtype=q.dtype)


def cost(q, k, v, valid, *, softcap: float = 0.0, split_rows: int = 0,
         return_lse: bool = False) -> Cost:
    """The attended tokens are the mask's (every slot of a fake or meta
    mask: a full cache); the mask is read once; under ``return_lse`` out
    in f32 and the lse's B·H·4 bytes."""
    B, S, K = q.shape[0], k.shape[1], k.shape[2]
    if concrete(valid):
        toks = int(valid.sum()) * (B if valid.ndim == 1 else 1)
    else:
        toks = B * S
    return io_cost(q, toks, K, k.element_size(), valid.numel(),
                   split_scratch_bytes(q, B, K, S, split_rows), return_lse)


def decode_attention_ref(q, k, v, valid, *, softcap: float = 0.0,
                         return_lse: bool = False):
    """q: [B,1,H,D]; k/v: [B,S,K,D]; valid: bool [S] or [B,S] → [B,1,H,D]
    (under ``return_lse``: in f32, and the lse [B, H]). Row b attends the
    tokens where its mask is set."""
    if valid.ndim == 1:
        valid = valid[None]
    if not return_lse:
        return _sdpa(q, k, v, valid[:, None, :], softcap)
    out, lse = _sdpa_lse(q, k, v, valid[:, None, :], softcap)
    return out, lse[:, 0]


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


def _kv_layout(k, v):
    """(contiguous, aligned) of the cache views for :func:`plan`: rows of
    D contiguous at the same strides in k and v; every base and stride a
    16-byte multiple."""
    contiguous = k.stride(-1) == 1 and k.stride() == v.stride()
    es = k.element_size()
    aligned = aligned16(k, v) and all(
        (s * es) % 16 == 0 for s in _strides(k))
    return contiguous, aligned


def _strides(k):
    """(batch, sequence, head) strides of a [B, S, K, D] view in elements,
    a dimension of one element given the stride it would have contiguous
    (any value indexes its one coordinate alike)."""
    B, S, K, D = k.shape
    sb, ss, sh, _ = k.stride()
    sh = sh if K > 1 else D
    ss = ss if S > 1 else K * sh
    sb = sb if B > 1 else S * ss
    return sb, ss, sh


def decode_attention_cuda(q, k, v, valid, *, softcap: float = 0.0,
                          split_rows: int = 0, return_lse: bool = False):
    return _decode_cuda(q, k, v, valid, softcap=softcap,
                        split_rows=split_rows, return_lse=return_lse)


def _decode_cuda(q, k, v, valid, *, softcap: float = 0.0,
                 split_rows: int = 0, return_lse: bool = False,
                 body: Optional[str] = None):
    """:func:`decode_attention_cuda` on the plan's body, or (tests and
    timing only) on ``body``."""
    if not all(t.is_cuda for t in (q, k, v, valid)):
        raise ValueError("decode_attention_cuda takes CUDA tensors")
    B, H, K, D, S = _check(q, k, v, valid)
    q = q if q.is_contiguous() and aligned16(q) else q.clone(
        memory_format=torch.contiguous_format)
    contiguous, aligned = _kv_layout(k, v)
    p = planned("decode_attention", q, K, None, H // K, D, 0, S, split_rows,
                return_lse=return_lse, contiguous=contiguous,
                aligned=aligned, body=body)
    if p.copy:
        k, v = (t.clone(memory_format=torch.contiguous_format)
                for t in (k, v))
        COPIES["kv"] += 1
    if valid.stride(-1) != 1:
        valid = valid.contiguous()
    valid_stride = valid.stride(0) if valid.ndim == 2 else 0
    valid = valid.view(torch.uint8)
    out = torch.empty_like(q, dtype=torch.float32 if p.lse else None)
    lse = (torch.empty(B, H, dtype=torch.float32, device=q.device)
           if p.lse else None)
    part = scratch(q, p)
    sb, ss, sh = _strides(k)
    fn = build.function("rap_decode_attention",
                        [build.P] * 4 + [build.LL] + [build.P] * 3
                        + [build.I] * 6 + [build.LL] * 3 + [build.I] * 2
                        + [build.F32, build.F32] + [build.I] * 3 + [build.P])
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   valid.data_ptr(), valid_stride,
                   out.data_ptr(), part.data_ptr(),
                   lse.data_ptr() if p.lse else None,
                   int(p.lse), B, H, K, D, S, sb, ss, sh,
                   p.split_tokens, p.nsplit, 1.0 / math.sqrt(D),
                   float(softcap), build.dtype_code(q), BODY_CODES[p.body],
                   p.stages, build.stream(q)),
                "decode_attention")
    BODY_LAUNCHES[p.body] += 1
    return (out, lse) if p.lse else out
