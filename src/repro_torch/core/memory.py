"""Runtime memory model — paper Eq. (3)–(4), Appendix A.2.

Peak inference memory = static parameter bytes + dynamic state bytes
(KV cache for attention; recurrent/conv state for RG-LRU; SSD state for
Mamba-2; window cache for local attention). Block indexing convention used
across the RAP core:

    block b ∈ [0, 2L):  b <  L → mixer (MHA-class) block of layer b
                        b >= L → FFN-class block of layer b - L

Masks are boolean [2L] arrays (True = keep). All byte counts are analytical
and are validated against actual pytree sizes in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def dtype_bytes(name: str) -> int:
    return _DTYPE_BYTES[name]


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Per-block byte tables for one (cfg, request-shape) pair."""
    n_layers: int
    mixer_param_bytes: np.ndarray   # [L]
    ffn_param_bytes: np.ndarray     # [L]
    mixer_state_unit: np.ndarray    # [L] state bytes per (batch · token) — see note
    mixer_state_fixed: np.ndarray   # [L] state bytes per batch element (seq-independent)
    embed_bytes: int

    def param_bytes(self, mask: np.ndarray) -> float:
        m = np.asarray(mask)
        L = self.n_layers
        return (float(self.mixer_param_bytes @ m[:L])
                + float(self.ffn_param_bytes @ m[L:]) + self.embed_bytes)

    def state_bytes(self, mask: np.ndarray, batch: int, seq: int) -> float:
        m = np.asarray(mask)[: self.n_layers]
        batch, seq = max(int(batch), 0), max(int(seq), 0)
        per_tok = float(self.mixer_state_unit @ m) * batch * seq
        fixed = float(self.mixer_state_fixed @ m) * batch
        return per_tok + fixed

    def peak_bytes(self, mask: np.ndarray, batch: int, seq: int) -> float:
        """Eq. (3) + (4): Mem_param + Mem_state."""
        return self.param_bytes(mask) + self.state_bytes(mask, batch, seq)

    def dense_peak(self, batch: int, seq: int) -> float:
        return self.peak_bytes(np.ones(2 * self.n_layers, bool), batch, seq)

    def block_bytes(self, batch: int, seq: int) -> np.ndarray:
        """Per-block total footprint [2L] (params + state) for the reward.

        Guarded against degenerate request shapes: callers occasionally pass
        seq=0 (decode-only accounting) or negative deltas; the per-token term
        must vanish then while the seq-independent ``mixer_state_fixed``
        component (recurrent/conv/window state) is still charged per batch
        element.
        """
        L = self.n_layers
        batch, seq = max(int(batch), 0), max(int(seq), 0)
        out = np.zeros(2 * L)
        out[:L] = (self.mixer_param_bytes
                   + self.mixer_state_unit * batch * seq
                   + self.mixer_state_fixed * batch)
        out[L:] = self.ffn_param_bytes
        return out


def build_memory_model(cfg, *, param_bytes_per: Optional[int] = None,
                       kv_bytes_per: Optional[int] = None) -> MemoryModel:
    pb = param_bytes_per or dtype_bytes(cfg.param_dtype)
    kb = kv_bytes_per or dtype_bytes(cfg.dtype)
    L = cfg.n_layers
    mix_counts, ffn_counts = cfg.block_param_counts()
    mixer_pb = np.asarray(mix_counts, np.float64) * pb
    ffn_pb = np.asarray(ffn_counts, np.float64) * pb
    if cfg.is_encoder_decoder:
        # decoder cross-attn params ride with the mixer block
        cross = (cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim)
                 + cfg.q_dim * cfg.d_model + cfg.d_model) * pb
        mixer_pb = mixer_pb + cross

    unit = np.zeros(L)
    fixed = np.zeros(L)
    for i, (mixer, _) in enumerate(cfg.layer_specs()):
        if mixer == "attn":
            unit[i] = 2 * cfg.n_kv_heads * cfg.dh * kb       # K and V per token
        elif mixer == "local_attn":
            fixed[i] = 2 * cfg.attn_window * cfg.n_kv_heads * cfg.dh * kb
        elif mixer == "rglru":
            W = cfg.rnn_width or cfg.d_model
            fixed[i] = W * 4 + 3 * W * kb                    # f32 state + conv buf
        elif mixer == "ssd":
            fixed[i] = (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                        + (cfg.ssm_conv_width - 1)
                        * (cfg.ssm_inner + 2 * cfg.ssm_state) * kb)
    if cfg.is_encoder_decoder:
        # cross-attn KV is fixed-size (encoder length), rides with mixer block
        fixed += 2 * cfg.n_audio_frames * cfg.n_kv_heads * cfg.dh * kb

    return MemoryModel(
        n_layers=L,
        mixer_param_bytes=mixer_pb,
        ffn_param_bytes=ffn_pb,
        mixer_state_unit=unit,
        mixer_state_fixed=fixed,
        embed_bytes=cfg.embed_params() * pb,
    )


def budget_bytes(mm: MemoryModel, batch: int, seq: int, fraction: float) -> float:
    """`fraction` of the dense model's peak (the paper's 80%/60% budgets)."""
    return fraction * mm.dense_peak(batch, seq)


# ------------------------------------------------------------ pool accounting
class PoolExhausted(RuntimeError):
    """Raised when a reservation cannot fit the shared pool budget."""


@dataclasses.dataclass
class PoolAccounting:
    """Reserved-vs-in-use byte ledger for a shared device pool.

    The KV pool grants memory at *page* granularity, so two numbers
    describe its pressure at any instant:

      * ``reserved_bytes`` — bytes granted to live allocations (page-rounded;
        this is what actually occupies the device budget);
      * ``in_use_bytes``   — exact bytes the requests asked for (the
        analytical Eq. (3)–(4) state footprint).

    ``reserved - in_use`` is internal fragmentation. The ledger enforces the
    hard invariant ``reserved_bytes <= capacity_bytes`` unless the caller
    explicitly overcommits (legacy one-shot serving executes regardless of
    fit; the engine's strict admission path never does).

    ``in_use_scale`` is the pool's byte width relative to the analytical
    memory model: admission charges arrive in model-dtype bytes (Eq. (3)–(4)
    at the model's KV width), but a quantized pool stores each element
    narrower (plus per-page scales). Every in-use charge is multiplied by
    this ratio on entry so ``in_use_bytes`` / ``peak_in_use_bytes`` /
    ``fragmentation()`` report *physical* bytes — without it, an int8 pool's
    ledger would claim 4× its true occupancy and fragmentation would go
    negative. Reserved bytes are already physical (page-granular) and are
    never scaled.
    """
    capacity_bytes: float
    reserved_bytes: float = 0.0
    in_use_bytes: float = 0.0
    peak_reserved_bytes: float = 0.0
    peak_in_use_bytes: float = 0.0
    overcommit_events: int = 0
    in_use_scale: float = 1.0

    @property
    def available_bytes(self) -> float:
        return max(self.capacity_bytes - self.reserved_bytes, 0.0)

    def can_reserve(self, reserved: float) -> bool:
        return self.reserved_bytes + reserved <= self.capacity_bytes

    def reserve(self, reserved: float, in_use: float, *,
                allow_overcommit: bool = False) -> None:
        in_use = in_use * self.in_use_scale
        if in_use > reserved + 1e-6:
            raise ValueError(f"in_use {in_use} exceeds reservation {reserved}")
        if not self.can_reserve(reserved):
            if not allow_overcommit:
                raise PoolExhausted(
                    f"reserve {reserved:.0f}B > available "
                    f"{self.available_bytes:.0f}B "
                    f"(capacity {self.capacity_bytes:.0f}B)")
            self.overcommit_events += 1
        self.reserved_bytes += reserved
        self.in_use_bytes += in_use
        self.peak_reserved_bytes = max(self.peak_reserved_bytes,
                                       self.reserved_bytes)
        self.peak_in_use_bytes = max(self.peak_in_use_bytes,
                                     self.in_use_bytes)

    def grow(self, reserved_delta: float, in_use_delta: float) -> None:
        """Incremental variant of :meth:`reserve` for allocations that grow
        over time (per-token page appends): unlike ``reserve``, the
        ``in_use <= reserved`` consistency is an invariant of the *totals*,
        not of each call — an append may raise in-use bytes without granting
        a new page (the token lands in a partially filled page). Strict
        only: the token-granular pool path never overcommits (overflow
        pages would have no physical backing)."""
        if not self.can_reserve(reserved_delta):
            raise PoolExhausted(
                f"grow {reserved_delta:.0f}B > available "
                f"{self.available_bytes:.0f}B "
                f"(capacity {self.capacity_bytes:.0f}B)")
        self.reserved_bytes += reserved_delta
        self.in_use_bytes += in_use_delta * self.in_use_scale
        self.peak_reserved_bytes = max(self.peak_reserved_bytes,
                                       self.reserved_bytes)
        self.peak_in_use_bytes = max(self.peak_in_use_bytes,
                                     self.in_use_bytes)

    def release(self, reserved: float, in_use: float) -> None:
        self.reserved_bytes = max(self.reserved_bytes - reserved, 0.0)
        self.in_use_bytes = max(
            self.in_use_bytes - in_use * self.in_use_scale, 0.0)

    def fragmentation(self) -> float:
        """Internal fragmentation: wasted fraction of reserved bytes."""
        if self.reserved_bytes <= 0:
            return 0.0
        return 1.0 - self.in_use_bytes / self.reserved_bytes

    def occupancy(self) -> float:
        if self.capacity_bytes <= 0:
            return 0.0
        return self.reserved_bytes / self.capacity_bytes
