"""Chunked SSD (state-space duality) scan of the Mamba-2 mixer.

``ssd_ref`` is the plain PyTorch version (any device): the chunked form
of ``repro/models/ssm.py::_ssd_scan``, a Python loop over chunks batched
over (batch, head) — what the model runs on the CPU. ``ssd_cuda``
launches the CUDA kernels of ``csrc/ssd.cu``, the port of the Pallas kernel
``repro/kernels/ssd.py::ssd``, from one entry point: the chunked scan's
GPU decomposition (``ref.ssd_split_ref`` mirrors its arithmetic for the
tests).

Inputs are f32: ``xh [B,T,H,P]`` (dt already folded in), ``log_a
[B,T,H]``, ``Bm``/``Cm [B,T,N]`` (one group, shared by every head).
Within a chunk of ``Q = min(chunk, T)`` tokens, ``y = (C·Bᵀ ⊙ L)·x`` with
``L[q, s] = exp(a_cum[q] - a_cum[s])`` for ``s <= q``; across chunks a
``[P, N]`` state carries. A ragged last chunk is shorter; JAX pads it with
``x = 0, log_a = 0``, which leaves ``y`` and the state unchanged.
Returns ``(y [B,T,H,P] f32, final state [B,H,P,N] f32)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import Cost

TILE = 64          # csrc/ssd.cu kT: query and key tiles of C·Bᵀ


def ssd_ref(xh, log_a, Bm, Cm, chunk: int = 256):
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(int(chunk), T)
    state = torch.zeros(B, H, P, N, dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, T, Q):
        x = xh[:, c0:c0 + Q].float()                       # [B,q,H,P]
        Bc = Bm[:, c0:c0 + Q].float()                      # [B,q,N]
        Cc = Cm[:, c0:c0 + Q].float()
        a_cum = torch.cumsum(log_a[:, c0:c0 + Q].float(), dim=1)  # [B,q,H]
        q = x.shape[1]
        causal = torch.ones(q, q, dtype=torch.bool,
                            device=xh.device).tril()[None, :, :, None]
        seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # [B,q,s,H]
        # exp only where s <= q: the upper triangle would overflow
        L = torch.exp(seg.masked_fill(~causal, float("-inf")))
        scores = torch.einsum("bqn,bsn->bqs", Cc, Bc)
        y = torch.einsum("bqsh,bshp->bqhp", scores[..., None] * L, x)
        y = y + torch.einsum("bqn,bhpn->bqhp", Cc, state) \
            * torch.exp(a_cum)[..., None]
        total = a_cum[:, -1]                                # [B,H]
        decay_in = torch.exp(total[:, None] - a_cum)        # [B,q,H]
        state = state * torch.exp(total)[..., None, None] + torch.einsum(
            "bqhp,bqn->bhpn", x * decay_in[..., None], Bc)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def cost(xh, log_a, Bm, Cm, chunk: int = 256) -> Cost:
    """Bytes: xh, log_a, B and C read once, y and the final state written
    once. Operations on causal pairs only: C·Bᵀ once per (batch, chunk)
    for every head (one group); per head (C·Bᵀ ⊙ L)·x and the chunk's own
    state 2·q·N·P, and C·stateᵀ 2·q·N·P only after the first chunk, whose
    carried state is zero. Scratch: ``ssd_cuda``'s C·Bᵀ tiles and, past one
    chunk, the chunks' states."""
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(int(chunk), T)
    chunks = [min(Q, T - c) for c in range(0, T, Q)]
    pairs = sum(q * (q + 1) // 2 for q in chunks)
    ops = (B * 2 * pairs * N
           + B * H * (2 * pairs * P + 2 * T * N * P
                      + 2 * (T - chunks[0]) * N * P))
    nbytes = 4 * (2 * B * T * H * P + B * T * H + 2 * B * T * N
                  + B * H * P * N)
    nc, qp = len(chunks), TILE * -(-Q // TILE)
    scratch = 4 * (B * nc * qp * qp
                   + (B * nc * H * (P * N + 1) if nc > 1 else 0))
    return Cost(flops=float(ops), bytes=float(nbytes),
                outputs=((tuple(xh.shape), torch.float32),
                         ((B, H, P, N), torch.float32)),
                scratch_bytes=scratch, op_dtype=torch.float32)


def ssd_cuda(xh, log_a, Bm, Cm, chunk: int = 256):
    ts = (xh, log_a, Bm, Cm)
    if not all(t.is_cuda for t in ts):
        raise ValueError("ssd_cuda takes CUDA tensors")
    if not all(t.dtype == torch.float32 for t in ts):
        raise TypeError(f"ssd_cuda takes float32 tensors, got "
                        f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd_cuda takes contiguous tensors")
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    if (log_a.shape != (B, T, H) or Bm.shape != (B, T, N)
            or Cm.shape != Bm.shape or T < 1):
        raise ValueError(f"bad shapes xh {tuple(xh.shape)} log_a "
                         f"{tuple(log_a.shape)} B {tuple(Bm.shape)} C "
                         f"{tuple(Cm.shape)}")
    # the kernel refuses a chunk over 256 and a state width N whose tiles do
    # not fit a block's shared memory; build.check raises on its error code
    Q = min(int(chunk), T)
    nc = -(-T // Q)
    qp = TILE * -(-Q // TILE)
    y = torch.empty_like(xh)
    final = torch.empty(B, H, P, N, dtype=torch.float32, device=xh.device)
    # scratch: the causal 64 x 64 tiles of C·Bᵀ of each (batch, chunk), and,
    # past one chunk, each chunk's own state (then the state entering it)
    # [B, nc, H, P, N] followed by its decay exp(total) [B, nc, H]
    g = torch.empty(B, nc, qp, qp, dtype=torch.float32, device=xh.device)
    states = (torch.empty(B * nc * H * (P * N + 1), dtype=torch.float32,
                          device=xh.device) if nc > 1 else None)
    fn = build.function("rap_ssd", [build.P] * 8 + [build.I] * 6
                        + [build.P])
    build.check(fn(xh.data_ptr(), log_a.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), y.data_ptr(), final.data_ptr(),
                   g.data_ptr(), None if states is None else states.data_ptr(),
                   B, T, H, P, N, Q, build.stream(xh)), "ssd")
    return y, final
