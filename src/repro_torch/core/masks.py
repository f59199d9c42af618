"""Block masks ↔ gates, and the bucket signature of a mask.

A *mask* is a boolean [2L] vector (True = keep), indexed per
``repro_torch.core.memory``: block b < L is layer b's attention block,
block b >= L is layer b-L's FFN block. Masked mode turns it into 0/1 gate
inputs of the one shared forward (``mask_to_gates``). Structural
compaction (``compact_params``, ``gather_key``, ``quantize_mask``) is a
later slice (ROADMAP queue 1, item 8).
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


def bucket_key(cfg, mask: np.ndarray) -> Tuple:
    """The retained layout signature (kinds sequence) of a mask."""
    layout, _ = compact_layout(cfg, mask)
    return tuple((s.mixer, s.ffn) for s in layout)


def keep_rows(cfg, mask: np.ndarray) -> np.ndarray:
    """Original layer indices retained by ``mask`` (either block kept)."""
    L = cfg.n_layers
    m = np.asarray(mask)
    return np.asarray([i for i in range(L) if m[i] or m[L + i]], np.int64)
