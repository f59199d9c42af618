"""Model configuration dataclass (PyTorch side).

The same ``ModelConfig`` as the JAX package's ``configs/base.py``: every
architecture is a frozen dataclass whose ``layer_specs()`` lists per-layer
(mixer_kind, ffn_kind), and whose parameter counts feed the analytical
memory model and the roofline. Only the dtype accessors differ: they
return torch dtypes. ``ShapeConfig`` / ``SHAPES`` are the dry run's four
input-shape cells.

Mixer kinds:   'attn' | 'local_attn' | 'rglru' | 'ssd'
FFN kinds:     'dense' | 'moe' | 'none'
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense|moe|ssm|hybrid|vlm|audio
    source: str = ""       # citation tag

    # trunk ----------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: Optional[int] = None       # default d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256
    vocab_round_to: int = 512            # production vocab padding (TP-friendly)

    # attention flavour ------------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    logit_softcap: float = 0.0           # gemma-2 style (0 = off)
    attn_window: int = 0                 # local attention window (0 = global)
    rope_theta: float = 10000.0
    use_rope: bool = True

    # ffn flavour -----------------------------------------------------------
    activation: str = "swiglu"           # swiglu|geglu|gelu
    n_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25

    # ssm (mamba-2 / SSD) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma / griffin) ---------------------------------------
    block_pattern: Tuple[str, ...] = ()
    rnn_width: int = 0

    # enc-dec (whisper) --------------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # multimodal stub ----------------------------------------------------------
    n_vision_tokens: int = 0

    # norms / embeddings --------------------------------------------------------
    norm: str = "rmsnorm"                # rmsnorm|layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False

    # numerics -------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"              # activation dtype

    # ------------------------------------------------------------------ derived
    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, self.vocab_round_to)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.dh

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def layer_specs(self) -> Tuple[Tuple[str, str], ...]:
        """Per-decoder-layer (mixer_kind, ffn_kind)."""
        if self.family == "ssm":
            ffn = "dense" if self.d_ff > 0 else "none"
            return tuple(("ssd", ffn) for _ in range(self.n_layers))
        if self.block_pattern:
            pat = self.block_pattern
            mix = [pat[i % len(pat)] for i in range(self.n_layers)]
            return tuple((m, "dense") for m in mix)
        ffn = "moe" if self.n_experts > 0 else "dense"
        mixer = "local_attn" if self.attn_window > 0 else "attn"
        return tuple((mixer, ffn) for _ in range(self.n_layers))

    def is_uniform(self) -> bool:
        specs = self.layer_specs()
        return all(s == specs[0] for s in specs)

    def mixer_kinds(self) -> Tuple[str, ...]:
        return tuple(m for m, _ in self.layer_specs())

    def n_attn_layers(self) -> int:
        return sum(1 for m in self.mixer_kinds() if m in ("attn", "local_attn"))

    def sub_quadratic(self) -> bool:
        """True if decode-time cache is bounded independent of seq_len."""
        kinds = set(self.mixer_kinds())
        return kinds <= {"ssd", "rglru", "local_attn"}

    # parameter counting (used by the memory model and the roofline) -------------
    def block_param_counts(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(per-layer mixer params, per-layer ffn params), embeddings excluded."""
        mixers, ffns = [], []
        for mixer, ffn in self.layer_specs():
            if mixer in ("attn", "local_attn"):
                p = self.d_model * (self.q_dim + 2 * self.kv_dim)  # wqkv
                p += self.q_dim * self.d_model                       # wo
                if self.qkv_bias:
                    p += self.q_dim + 2 * self.kv_dim
                if self.qk_norm:
                    p += 2 * self.dh
            elif mixer == "rglru":
                w = self.rnn_width or self.d_model
                p = self.d_model * (2 * w) + 4 * w + 2 * w * w // 8 + w + w * self.d_model
            elif mixer == "ssd":
                di, hn = self.ssm_inner, self.ssm_heads
                p = self.d_model * (2 * di + 2 * self.ssm_state + hn)
                p += self.ssm_conv_width * (di + 2 * self.ssm_state)
                p += hn + hn
                p += di * self.d_model
            else:
                p = 0
            p += self.d_model  # pre-norm scale
            mixers.append(p)

            if ffn == "dense":
                if self.activation in ("swiglu", "geglu"):
                    f = self.d_model * 2 * self.d_ff + self.d_ff * self.d_model
                else:
                    f = 2 * self.d_model * self.d_ff
                f += self.d_model
            elif ffn == "moe":
                f = self.n_experts * (self.d_model * 2 * self.d_ff + self.d_ff * self.d_model)
                f += self.d_model * self.n_experts  # router
                f += self.d_model
            else:
                f = 0
            ffns.append(f)
        return tuple(mixers), tuple(ffns)

    def embed_params(self) -> int:
        p = self.vocab_padded * self.d_model
        if not self.tie_embeddings:
            p += self.vocab_padded * self.d_model
        p += self.d_model  # final norm
        if self.is_encoder_decoder:
            m, f = self._encoder_block_params()
            p += self.n_encoder_layers * (m + f)
            p += self.n_audio_frames * self.d_model
        return p

    def _encoder_block_params(self) -> Tuple[int, int]:
        m = self.d_model * (self.q_dim + 2 * self.kv_dim) + self.q_dim * self.d_model + self.d_model
        f = 2 * self.d_model * self.d_ff + self.d_model
        return m, f

    def total_params(self) -> int:
        m, f = self.block_param_counts()
        total = sum(m) + sum(f) + self.embed_params()
        if self.is_encoder_decoder:
            # decoder cross-attention (one per decoder layer)
            total += self.n_layers * (self.d_model * (self.q_dim + 2 * self.kv_dim)
                                      + self.q_dim * self.d_model + self.d_model)
        return total

    def active_params(self) -> int:
        """MoE: experts actually used per token (for MODEL_FLOPS = 6·N_active·D)."""
        if self.n_experts == 0:
            return self.total_params()
        m, _ = self.block_param_counts()
        act_ffn = self.n_layers * (self.moe_top_k *
                                   (self.d_model * 2 * self.d_ff + self.d_ff * self.d_model)
                                   + self.d_model * self.n_experts + self.d_model)
        return sum(m) + act_ffn + self.embed_params()

    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def torch_param_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the dry run: a global batch of sequences."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
