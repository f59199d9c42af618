"""The masked-softmax attention core of the plain kernel versions.

``_sdpa`` and ``_causal_mask`` mirror ``repro/models/attention.py``'s
functions of the same names: scores are taken in f32, the softmax in f32,
and the probabilities are cast to ``v.dtype`` before the P·V product, so a
bf16 plain result rounds where the JAX reference rounds. (The CUDA kernels,
like the Pallas kernels, keep the probabilities in f32.) In the port every
attention goes through ``kernels.ops``, whose plain versions —
``flash_attention.attention_ref`` and
``paged_decode_attention.paged_decode_attention_ref`` — are built on these.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

NEG_INF = -2.0e38


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
