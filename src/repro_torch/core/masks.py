"""Block masks ↔ gates ↔ structural compaction.

A *mask* is a boolean [2L] vector (True = keep), indexed per
``repro_torch.core.memory``: block b < L is layer b's attention block,
block b >= L is layer b-L's FFN block. Two execution forms:

* masked mode   — ``mask_to_gates`` turns it into 0/1 gate inputs of the
                  one shared forward;
* structural    — the retained layers only: ``compact_layout`` +
                  ``compact_params`` gather the per-kind stacks along the
                  layer axis (JAX's form); ``retained_layout`` indexes the
                  retained rows of the full stacks instead (the executors'
                  form: the same rows, no copy of the weights). Slot groups
                  are keyed by ``gather_key`` (the exact rows) after
                  ``quantize_mask`` snaps the mask onto a bucket ladder.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.decoder import LayerSlot, default_layout


def full_mask(n_layers: int) -> np.ndarray:
    return np.ones(2 * n_layers, bool)


def mask_to_gates(mask, device=None) -> Dict[str, torch.Tensor]:
    m = torch.as_tensor(np.asarray(mask), device=device).float()
    L = m.shape[0] // 2
    return {"mixer": m[:L], "ffn": m[L:]}


def remove_block(mask: np.ndarray, block: int) -> np.ndarray:
    out = np.array(mask, copy=True)
    out[block] = False
    return out


def active_blocks(mask: np.ndarray) -> np.ndarray:
    return np.nonzero(np.asarray(mask))[0]


def compact_layout(cfg, mask: np.ndarray) -> Tuple[Tuple[LayerSlot, ...], Dict]:
    """Retained layout: drop layers where both blocks are pruned; keep gate
    info for half-pruned layers. Returns (layout, per-kind gather indices)."""
    base = default_layout(cfg)
    L = len(base)
    m = np.asarray(mask)
    keep = [i for i in range(L) if m[i] or m[L + i]]
    gather: Dict[str, list] = {}
    slots = []
    counters: Dict[str, int] = {}
    for i in keep:
        s = base[i]
        mixer = s.mixer if m[i] else None
        f = s.ffn if m[L + i] else None
        mi = fi = 0
        if mixer is not None:
            mk = "attn" if mixer == "local_attn" else mixer
            gather.setdefault(mk, []).append(s.mixer_idx)
            mi = counters.get(mk, 0)
            counters[mk] = mi + 1
        if f is not None:
            gather.setdefault(f, []).append(s.ffn_idx)
            fi = counters.get(f, 0)
            counters[f] = fi + 1
        slots.append(LayerSlot(mixer, mi, f, fi))
    return tuple(slots), gather


def compact_params(params: dict, cfg, mask: np.ndarray):
    """Gather the stacks' retained rows (``torch.index_select`` on each
    leaf's layer axis). Returns (small_params, layout): the compacted
    stacks run with ``layout`` and all-ones gates."""
    layout, gather = compact_layout(cfg, mask)
    small = dict(params)
    small["stacks"] = {}
    for kind, idxs in gather.items():
        idx = torch.as_tensor(idxs, dtype=torch.long,
                              device=params["embed"].device)
        small["stacks"][kind] = _tree_map(
            lambda x: torch.index_select(x, 0, idx), params["stacks"][kind])
    return small, layout


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def retained_layout(cfg, mask: np.ndarray) -> Tuple[LayerSlot, ...]:
    """``compact_layout``'s rows with their *original* stack indices: the
    layout that runs the retained layers on the full param stacks, row
    for row the computation of ``compact_params``'s stacks."""
    base = default_layout(cfg)
    L = len(base)
    m = np.asarray(mask)
    return tuple(LayerSlot(s.mixer if m[i] else None, s.mixer_idx,
                           s.ffn if m[L + i] else None, s.ffn_idx)
                 for i, s in enumerate(base) if m[i] or m[L + i])


def bucket_key(cfg, mask: np.ndarray) -> Tuple:
    """The retained layout signature (kinds sequence) of a mask: any k
    whole-layer drops of a uniform model share one (L-k)-layer
    signature."""
    layout, _ = compact_layout(cfg, mask)
    return tuple((s.mixer, s.ffn) for s in layout)


def keep_rows(cfg, mask: np.ndarray) -> np.ndarray:
    """Original layer indices retained by ``mask`` (either block kept)."""
    L = cfg.n_layers
    m = np.asarray(mask)
    return np.asarray([i for i in range(L) if m[i] or m[L + i]], np.int64)


def gather_key(cfg, mask: np.ndarray) -> Tuple:
    """Identity of the exact retained rows per kind. ``bucket_key``
    collapses masks that drop *different* layers onto one signature; a
    slot group runs its rows' weights, so groups are keyed by this, never
    by the signature alone (DESIGN.md §9, the aliasing fault)."""
    _, gather = compact_layout(cfg, mask)
    return tuple(sorted((kind, tuple(idxs)) for kind, idxs in gather.items()))


def quantize_mask(cfg, mask: np.ndarray, mode: str) -> np.ndarray:
    """Snap a mask onto a bucket ladder; returns the *bucket* mask, whose
    retained rows keep both blocks (the request's exact mask then rides
    per-slot 0/1 gates inside the bucket, which gives the bits of the
    structural drop: ``h + 0·out == h`` for finite ``out``).

      * ``none``  — the mask itself;
      * ``layer`` — whole layers over the exact retained rows;
      * ``pow2``  — the row count rounded up to a power of two (capped at
                    L) with the lowest-indexed dropped layers, so at most
                    ceil(log2 L) + 1 signatures exist.
    """
    if mode == "none":
        return np.array(mask, copy=True)
    if mode not in ("layer", "pow2"):
        raise ValueError(f"unknown bucket_quant mode {mode!r}; "
                         "expected none|layer|pow2")
    L = cfg.n_layers
    m = np.asarray(mask)
    rows = [i for i in range(L) if m[i] or m[L + i]]
    k = max(len(rows), 1)
    if mode == "pow2":
        target = min(1 << (k - 1).bit_length(), L)
        extras = [i for i in range(L) if not (m[i] or m[L + i])]
        rows = sorted(rows + extras[: target - len(rows)])
    elif not rows:
        rows = [0]
    out = np.zeros(2 * L, bool)
    for i in rows:
        out[i] = out[L + i] = True
    return out


def mask_param_fraction(cfg, mask: np.ndarray) -> float:
    """Fraction of block params retained (excludes embeddings) — Table 4."""
    mix, ffn = cfg.block_param_counts()
    L = cfg.n_layers
    m = np.asarray(mask)
    tot = float(np.sum(mix) + np.sum(ffn))
    kept = float(np.asarray(mix) @ m[:L] + np.asarray(ffn) @ m[L:])
    return kept / max(tot, 1.0)
