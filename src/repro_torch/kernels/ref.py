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

The decode kernels cut each row's tokens into splits of whole 64-token
tiles (:func:`decode_splits`, from static shapes only) and combine the
splits' partial softmaxes in a fixed order; :func:`split_decode_ref` and
:func:`split_paged_decode_ref` mirror that arithmetic in plain PyTorch for
the tests (nothing on the serving path calls them).

The CUDA ``ssd`` kernels decompose the chunked scan: C·Bᵀ once per
(batch, chunk) for all heads, each chunk's own state in parallel, the
state passed across chunks, then y per 64-row query tile.
:func:`ssd_split_ref` mirrors that decomposition in plain PyTorch for the
tests (the serving path runs ``kernels/ssd.py::ssd_ref`` on the CPU).

Quantized page pools (int8 / float8_e4m3fn codes with one f32 scale per
(page, kv head)) are widened by :func:`page_dequant`, the exact function
the fused-dequant kernel is pinned against; :func:`take_pages` and
:func:`put_pages` gather and scatter whole pages of any pool, and
:func:`gather_pages` lays each row's pages out as one contiguous cache.

Each kernel module's ``cost(...)`` takes its wrapper's arguments and
returns a :class:`Cost`: the operations the kernel does, the bytes it must
move (each input read once, each output written once), its outputs' shapes
and its scratch. ``chip_smoke.py`` divides these by the card's peaks for
each kernel's bound, and the dry run (``kernels.ops.analysis``) adds them
to a counted step in place of the kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models import layers

NEG_INF = -2.0e38
H100_SMS = 132              # SMs of an H100 SXM5: the split count off the card


class Cost(NamedTuple):
    """What one launch of a kernel costs. ``flops``: its operations, of
    type ``op_dtype`` (the peak they run at); ``bytes``: what it must move;
    ``outputs``: the (shape, dtype) of each tensor it returns;
    ``scratch_bytes``: device scratch its wrapper allocates beside them."""
    flops: float
    bytes: float
    outputs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]
    scratch_bytes: int = 0
    op_dtype: torch.dtype = torch.bfloat16

    @property
    def out_bytes(self) -> int:
        return sum(math.prod(s) * d.itemsize for s, d in self.outputs)


def concrete(t) -> bool:
    """True for a tensor that holds values (not a fake or meta one): a cost
    reads data-dependent counts (valid tokens) only from such a tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    return not isinstance(t, FakeTensor) and t.device.type != "meta"


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


def take_slots(leaf, idx):
    """``leaf[:, idx]`` (a slot cache's rows) for a leaf of any dtype."""
    return _raw(leaf)[:, idx].view(leaf.dtype)


def put_slots(leaf, idx, val) -> None:
    """``leaf[:, idx] = val`` in place, ``val`` cast to the leaf's dtype."""
    _raw(leaf)[:, idx] = _raw(val.to(leaf.dtype))


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


DECODE_TILE = 64            # csrc/flash_decode.cuh kTile
SPLIT_CTAS_PER_SM = 4       # CTAs the decode kernels aim to start per SM


def decode_splits(B: int, K: int, S: int, sms: int):
    """(tokens per split, splits) of the decode kernels for ``B`` rows of
    ``K`` kv heads over ``S`` token slots (the dense cache width, or the
    paged table's ``max_pages · page_tokens``) on a card of ``sms`` SMs.
    Splits are whole 64-token tiles, the fewest that start about
    ``SPLIT_CTAS_PER_SM · sms`` CTAs. Shapes alone decide it — never the
    lengths or the mask, which live on the device — so the dense and the
    paged kernel cut the same tokens at the same places."""
    tiles = max(1, -(-S // DECODE_TILE))
    want = -(-SPLIT_CTAS_PER_SM * sms // max(1, B * K))
    per = -(-tiles // max(1, min(want, tiles)))
    return per * DECODE_TILE, -(-tiles // per)


def split_decode_ref(q, k, v, valid, split_tokens: int, *,
                     softcap: float = 0.0):
    """The decode kernels' split-and-combine arithmetic in plain f32: q
    [B,1,H,D], k/v [B,S,K,D], valid bool [S] or [B,S] → [B,1,H,D]. Each
    split of ``split_tokens`` keeps its partial (m, l, acc) — m the max
    attended score (``NEG_INF`` if none), p = 0 exactly for masked tokens —
    and the splits combine in order: m* = max m_i, out = Σ e^(m_i − m*)
    acc_i / max(Σ e^(m_i − m*) l_i, 1e-30), skipping splits with l_i = 0."""
    B, _, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    n = -(-S // split_tokens)
    pad = n * split_tokens - S
    mask = (valid[None] if valid.ndim == 1 else valid).expand(B, S)
    mask = torch.nn.functional.pad(mask, (0, pad))               # [B, n·T]
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, K, G, D).float(), kf)
    s = layers.softcap(s * (1.0 / math.sqrt(D)), softcap)
    mask = mask[:, None, None, :].expand_as(s)
    s = s.masked_fill(~mask, NEG_INF).reshape(B, K, G, n, split_tokens)
    mask = mask.reshape(s.shape)
    m = s.amax(-1)                                               # [B,K,G,n]
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p,
                       vf.reshape(B, n, split_tokens, K, D))
    w = torch.where(l > 0, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    out = torch.einsum("bkgn,bkgnd->bkgd", w, acc) \
        / (w * l).sum(-1).clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


def split_paged_decode_ref(q, k_pages, v_pages, page_table, lengths,
                           split_tokens: int, *, k_scales=None,
                           v_scales=None, softcap: float = 0.0):
    """:func:`split_decode_ref` over each row's pages, widened to f32 (with
    their scales, for int8/fp8 pages), attending its first ``lengths[b]``
    tokens up to the table's width."""
    ck = gather_pages(k_pages, page_table, torch.float32, k_scales)
    cv = gather_pages(v_pages, page_table, torch.float32, v_scales)
    valid = (torch.arange(ck.shape[1], device=q.device)[None, :]
             < lengths[:, None])
    return split_decode_ref(q, ck, cv, valid, split_tokens, softcap=softcap)


def ssd_split_ref(xh, log_a, Bm, Cm, chunk: int = 256, tile: int = 64):
    """The CUDA ``ssd`` kernels' decomposition of the chunked scan, in plain
    f32 (inputs and outputs as ``kernels/ssd.py::ssd_ref``):

    1. per (batch, chunk), for all heads at once: G = C·Bᵀ; per (batch,
       head, chunk), in parallel: the chunk's own state
       (x ⊙ exp(total − a_cum))ᵀ·B;
    2. per (batch, head), in chunk order: the state entering each chunk,
       s_c = s_{c−1}·exp(total_c) + own_c, from zero;
    3. per (batch, head, chunk, ``tile``-row query tile): y =
       exp(a_cum) ⊙ (C·s_{c−1}ᵀ), skipped on the first chunk (its state is
       zero), plus (G ⊙ L)·x over the key tiles up to the diagonal, with
       L = exp(a_cum[q] − a_cum[s]) taken only where s <= q."""
    B, T, H, P = xh.shape
    Q = min(int(chunk), T)
    x_all, la = xh.float(), log_a.float()
    Bf, Cf = Bm.float(), Cm.float()
    parts = []
    for c0 in range(0, T, Q):
        sl = slice(c0, min(T, c0 + Q))
        a = torch.cumsum(la[:, sl], dim=1)                     # [B,q,H]
        w = torch.exp(a[:, -1:] - a)
        own = torch.einsum("bshp,bsh,bsn->bhpn", x_all[:, sl], w, Bf[:, sl])
        parts.append((sl, a, torch.einsum("bqn,bsn->bqs", Cf[:, sl],
                                          Bf[:, sl]), own))
    state = torch.zeros_like(parts[0][3])
    y = torch.empty(B, T, H, P, dtype=torch.float32, device=xh.device)
    for c, (sl, a, G, own) in enumerate(parts):
        x, Cc, q = x_all[:, sl], Cf[:, sl], a.shape[1]
        for q0 in range(0, q, tile):
            q1 = min(q0 + tile, q)
            yt = torch.zeros(B, q1 - q0, H, P, device=xh.device)
            if c > 0:
                yt = torch.einsum("bqn,bhpn->bqhp", Cc[:, q0:q1], state) \
                    * torch.exp(a[:, q0:q1])[..., None]
            for k0 in range(0, q1, tile):
                k1 = min(k0 + tile, q)
                causal = (torch.arange(k0, k1, device=xh.device)[None, :]
                          <= torch.arange(q0, q1, device=xh.device)[:, None])
                seg = a[:, q0:q1, None, :] - a[:, None, k0:k1, :]
                L = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                              float("-inf")))
                yt = yt + torch.einsum("bqs,bqsh,bshp->bqhp",
                                       G[:, q0:q1, k0:k1], L, x[:, k0:k1])
            y[:, sl.start + q0:sl.start + q1] = yt
        state = state * torch.exp(a[:, -1])[..., None, None] + own
    return y, state


def _sdpa(q, k, v, mask, softcap: float = 0.0, scale=None):
    """q [B,Sq,H,Dh], k/v [B,Skv,K,Dh], mask bool broadcastable to
    [B,Sq,Skv]. Query head h reads kv head h // (H // K). The scores are
    scaled by ``scale``, 1/sqrt(Dh) by default."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, Dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(Dh) if scale is None else scale)
    logits = layers.softcap(logits, softcap)
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def _sdpa_lse(q, k, v, mask, softcap: float = 0.0):
    """Attention as :func:`_sdpa` with the probabilities and the output
    kept in f32 (the decode kernels' partials), and each query row and
    head's log-sum-exp of its attended (scaled, softcapped) scores: (out
    f32 [B, Sq, H, Dh], lse f32 [B, Sq, H]). A row with no attended token
    gives out 0 and lse -inf, as the decode kernels do. On f32 inputs the
    output is :func:`_sdpa`'s."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) \
        * (1.0 / math.sqrt(Dh))
    logits = layers.softcap(logits, softcap)
    lse = torch.logsumexp(logits.masked_fill(~mask[:, None, None],
                                             float("-inf")), dim=-1)
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None], NEG_INF),
                          dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    out = out.reshape(B, Sq, H, Dh)
    lse = lse.permute(0, 3, 1, 2).reshape(B, Sq, H)          # [B,Sq,H]
    return torch.where(torch.isinf(lse)[..., None], 0.0, out), lse


def _causal_mask(Sq: int, Skv: int, window: int = 0, q_offset: int = 0,
                 device=None):
    """[1, Sq, Skv] causal (banded if window > 0) mask."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None]
