"""The work the maths needs, counted from shapes and lengths — frozen with
the benchmark, so a later change to the program cannot move a yardstick.

Operations are multiply-adds counted twice; the elementwise work of norms,
RoPE, softmax and activations is left out. Bytes count each input read
once and each output written once at the dtype the call is given; no
scratch buffer an implementation chooses (split-KV partials, padding) is
counted.

``cfg`` is the ``model`` section of a configuration file (the port's
field names); ``mask`` a keep-mask of 2L blocks (mixers, then FFNs).
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def dims(cfg: dict):
    D, H = int(cfg["d_model"]), int(cfg["n_heads"])
    K = int(cfg["n_kv_heads"])
    Dh = int(cfg.get("head_dim") or D // H)
    return D, H, K, Dh


def mixer_token_flops(cfg: dict) -> float:
    """Projections of one attention block for one token (q, k, v, o)."""
    D, H, K, Dh = dims(cfg)
    return 2.0 * D * (H * Dh + 2 * K * Dh) + 2.0 * H * Dh * D


def ffn_token_flops(cfg: dict) -> float:
    """One FFN block for one token: the gated product (3 matrices)."""
    return 6.0 * int(cfg["d_model"]) * int(cfg["d_ff"])


def attn_pair_flops(cfg: dict) -> float:
    """Scores and the weighted sum for one (query, key) pair, all heads."""
    _, H, _, Dh = dims(cfg)
    return 4.0 * H * Dh


def head_flops(cfg: dict) -> float:
    """The LM head for one position."""
    return 2.0 * int(cfg["d_model"]) * int(cfg["vocab_size"])


def _kept(cfg: dict, mask) -> tuple:
    L = int(cfg["n_layers"])
    m = np.asarray(mask, bool)
    return int(m[:L].sum()), int(m[L:].sum())


def forward_flops(cfg: dict, mask, rows: int, seq: int,
                  head_positions: int) -> float:
    """A causal forward of ``rows`` sequences of ``seq`` tokens under
    ``mask``, the LM head at ``head_positions`` positions of each row."""
    mix, ffn = _kept(cfg, mask)
    tokens = float(rows) * seq
    pairs = float(rows) * seq * (seq + 1) / 2.0
    return (tokens * (mix * mixer_token_flops(cfg)
                      + ffn * ffn_token_flops(cfg))
            + pairs * mix * attn_pair_flops(cfg)
            + float(rows) * head_positions * head_flops(cfg))


def decode_flops(cfg: dict, mask, contexts: Iterable[int]) -> float:
    """One decode token for each row, the row attending ``ctx`` keys (its
    own included)."""
    ctx = np.asarray(list(contexts), np.float64)
    mix, ffn = _kept(cfg, mask)
    n = float(ctx.size)
    return (n * (mix * mixer_token_flops(cfg) + ffn * ffn_token_flops(cfg)
                 + head_flops(cfg))
            + float(ctx.sum()) * mix * attn_pair_flops(cfg))


def gsi_pass_flops(cfg: dict, mask, calib_rows: int,
                   calib_seq: int) -> float:
    """One importance pass of the controller at ``mask``: the log-ppl
    forward of the calibration batch, and one forward per active block
    with that block gated off as well (the NLL needs the head at
    ``calib_seq - 1`` positions)."""
    m = np.asarray(mask, bool)
    hp = calib_seq - 1
    total = forward_flops(cfg, m, calib_rows, calib_seq, hp)
    for b in np.flatnonzero(m):
        cand = m.copy()
        cand[b] = False
        total += forward_flops(cfg, cand, calib_rows, calib_seq, hp)
    return total


def paged_decode_call(cfg: dict, lengths: Sequence[int],
                      kv_bytes: int = 2, io_bytes: int = 2,
                      page_tokens: int = 16) -> tuple:
    """(bytes, operations) of one paged-decode call (one layer, one step)
    over rows of ``lengths`` valid tokens: K and V of the valid tokens,
    q and out once, each row's page ids and its length."""
    _, H, K, Dh = dims(cfg)
    n = np.asarray(list(lengths), np.int64)
    pages = -(-n // page_tokens)
    nbytes = (2.0 * float(n.sum()) * K * Dh * kv_bytes
              + 2.0 * n.size * H * Dh * io_bytes
              + 4.0 * float(pages.sum()) + 4.0 * n.size)
    return nbytes, float(n.sum()) * attn_pair_flops(cfg)


def flash_call(cfg: dict, rows: int, seq: int, io_bytes: int = 2) -> tuple:
    """(bytes, operations) of one causal flash-attention call (one layer):
    q and out at H heads, k and v at K heads, once each; 4·Dh operations
    per kept causal pair per head."""
    _, H, K, Dh = dims(cfg)
    tokens = float(rows) * seq
    nbytes = tokens * Dh * io_bytes * (2 * H + 2 * K)
    pairs = float(rows) * seq * (seq + 1) / 2.0
    return nbytes, pairs * attn_pair_flops(cfg)


def least_seconds(nbytes: float, ops: float) -> tuple:
    """(least time on one H100, which bound sets it)."""
    tb, to = nbytes / PEAK_HBM_BYTES, ops / PEAK_BF16_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------ a window's work, by span
def _fresh_passes(trace, inside=None):
    """The masks of the importance passes of every decision the memo did
    not serve (the dense one, then one after each removal), as recorded."""
    inside = inside or trace.within
    for sp in trace.spans:
        if sp.kind == "decide" and inside(sp.t0):
            _, d, passes = sp.info
            if not d.cached:
                yield from (m for m, _ in passes)


def model_flops(trace) -> float:
    """The kept blocks' operations of every forward the window ran:
    prefills (the head at the last position), the decode tokens the
    caller received, and the controller's importance passes."""
    cfg = trace.cfg
    rows, seq = trace.serving["calib"]
    total = 0.0
    for sp in trace.spans:
        if not trace.within(sp.t0):
            continue
        if sp.kind == "prefill":
            b, S = sp.info
            total += forward_flops(cfg, trace.served[sp.rid].mask, b, S, 1)
        elif sp.kind == "horizon":
            for rid, (pos, n, b) in sp.info["rows"].items():
                ctx = [pos + 1 + h for h in range(n)]
                total += b * decode_flops(cfg, trace.served[rid].mask, ctx)
    for m in _fresh_passes(trace):
        total += gsi_pass_flops(cfg, m, rows, seq)
    return total


def paged_decode_least(trace) -> float:
    """Least seconds of the traced paged-decode calls: every layer of
    every step of a horizon, over the rows of resident requests (padding
    rows are the executor's choice, not work)."""
    cfg = trace.cfg
    L = int(cfg["n_layers"])
    pt = int(trace.serving.get("tokens_per_page", 16))
    total = 0.0
    for sp in trace.spans:
        if sp.kind != "horizon" or not trace.traced(sp.t0):
            continue
        for h in range(sp.info["horizon"]):
            lengths = [pos + 1 + h for pos, _, b in sp.info["rows"].values()
                       for _ in range(b)]
            if lengths:
                total += L * least_seconds(
                    *paged_decode_call(cfg, lengths, page_tokens=pt))[0]
    return total


def flash_least(trace) -> float:
    """Least seconds of the traced flash-attention calls: each layer of
    each prefill and of each forward of the controller's importance
    passes (the log-ppl forward and one per chunk of candidates)."""
    cfg = trace.cfg
    L = int(cfg["n_layers"])
    rows, seq = trace.serving["calib"]
    chunk = 8
    total = 0.0
    for sp in trace.spans:
        if sp.kind == "prefill" and trace.traced(sp.t0):
            b, S = sp.info
            total += L * least_seconds(*flash_call(cfg, b, S))[0]
    for m in _fresh_passes(trace, trace.traced):
        n = int(np.asarray(m).sum())
        calls = [rows] + [rows * min(chunk, n - a)
                          for a in range(0, n, chunk)]
        total += L * sum(least_seconds(*flash_call(cfg, r, seq))[0]
                         for r in calls)
    return total


def kernel_seconds(trace, names) -> float:
    """Device seconds of the kernels whose name, without its namespaces,
    is in ``names``."""
    return sum(v for k, v in trace.device["by_kernel"].items()
               if k.rsplit("::", 1)[-1] in names)
