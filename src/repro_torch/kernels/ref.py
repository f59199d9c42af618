"""The masked-softmax attention core of the plain kernel versions.

``_sdpa`` and ``_causal_mask`` mirror ``repro/models/attention.py``'s
functions of the same names: scores are taken in f32, the softmax in f32,
and the probabilities are cast to ``v.dtype`` before the P·V product, so a
bf16 plain result rounds where the JAX reference rounds. (The decode
kernels and the f32 flash body, like the Pallas kernels, keep the
probabilities in f32; the bf16/fp16 flash body rounds them as here.) In
the port every attention goes through ``kernels.ops``, whose plain
versions — ``flash_attention.attention_ref`` and
``paged_decode_attention.paged_decode_attention_ref`` — are built on these.

Quantized page pools (int8 / float8_e4m3fn codes with one f32 scale per
(page, kv head)) are widened by :func:`page_dequant`, the exact function
the fused-dequant kernel is pinned against; :func:`take_pages` and
:func:`put_pages` gather and scatter whole pages of any pool, and
:func:`gather_pages` lays each row's pages out as one contiguous cache.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

NEG_INF = -2.0e38


def page_dequant(q, scales):
    """Pages ``[..., page_tokens, K, Dh]`` of codes with per-(page, head)
    scales ``[..., K]`` → f32: ``code.float() * scale`` and nothing else."""
    return q.float() * scales[..., None, :, None]


def _raw(t):
    # one-byte codes go through indexing as uint8: bit-exact, and not every
    # indexing kernel takes float8
    return t.view(torch.uint8) if t.element_size() == 1 else t


def take_pages(pool, idx):
    """``pool[idx]`` for a page pool of any dtype."""
    return _raw(pool)[idx].view(pool.dtype)


def put_pages(pool, idx, val) -> None:
    """``pool[idx] = val`` in place, ``val`` cast to the pool's dtype."""
    _raw(pool)[idx] = _raw(val.to(pool.dtype))


def gather_pages(pages, page_table, dtype, scales=None):
    """Each row's pages ``[n_pages, pt, K, Dh]`` at ``page_table [B,
    max_pages]`` as one contiguous ``[B, max_pages·pt, K, Dh]`` tensor in
    ``dtype``; quantized pages are widened with their ``scales [n_pages,
    K]`` first (:func:`page_dequant`)."""
    idx = page_table.long()
    c = take_pages(pages, idx)
    if scales is not None:
        c = page_dequant(c, scales[idx])
    return c.reshape(page_table.shape[0], -1, *pages.shape[2:]).to(dtype)


def _sdpa(q, k, v, mask, softcap: float = 0.0):
    """q [B,Sq,H,Dh], k/v [B,Skv,K,Dh], mask bool broadcastable to
    [B,Sq,Skv]. Query head h reads kv head h // (H // K)."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, Dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(Dh))
    logits = layers.softcap(logits, softcap)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _causal_mask(Sq: int, Skv: int, window: int = 0, q_offset: int = 0,
                 device=None):
    """[1, Sq, Skv] causal (banded if window > 0) mask."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None]
