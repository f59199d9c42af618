"""Whisper-style encoder-decoder [arXiv:2212.04356] (whisper-medium).

The port of ``repro/models/encdec.py``. The conv frontend is a stub: the
encoder consumes precomputed mel-frame embeddings ``frames [B,
n_audio_frames, d_model]``, adds learned positions and runs bidirectional
attention. The decoder is causal, with a per-layer self-attention KV cache
plus a cross-attention K/V computed once at prefill. Decoder positions are
sinusoidal (the JAX package's adaptation, DESIGN.md), so no parameter
depends on the decode length.

RAP mapping: the (self-attention + cross-attention) pair is the prunable
"MHA" unit and shares the mixer gate; the FFN has its own. Encoder layers
run once per request and are not pruned.

Kernels: the encoder's and the cross-attention's unmasked attention go
through the flash kernel with ``causal=False`` (JAX runs ``_sdpa`` there:
the port routes kernels by device), the decoder's self-attention through
the causal flash kernel at prefill and the dense decode kernel at decode,
and the decode-time cross-attention (one query against every frame)
through the dense decode kernel with an all-true mask. The FFN is the
plain tanh-gelu one (no kernel on either side).

Sequence parallelism (``models/decoder.py``'s rule and edges) cuts the
encoder's stream and the decoder's at S >= 2048 positions between the
blocks (each cut from the whole embedded stream); the cross K/V are
projected from the whole encoder output. Under ``cache_specs`` the decode
step reads its self and cross caches in the ``cache_pspecs`` layout
(``attention.attend_cached``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import attention, ffn as ffn_mod, layers
from repro_torch.models.decoder import (_bgate, _checkpointed, _norm,
                                        _ones_gates, _pool_layer,
                                        embed_lookup, local_cfg, tree_slice,
                                        vocab_logits)
from repro_torch.parallel import activation as act
from repro_torch.parallel import tp


def _sinusoid(positions, d_model: int):
    """[..., d_model] f32: sin then cos of positions × geometric freqs."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(gen: torch.Generator, cfg, device) -> dict:
    """Random parameters drawn from ``gen`` on ``device``, in the JAX
    pytree layout: ``embed`` (tied with the LM head), learned ``enc_pos``,
    ``final_norm`` and ``enc_final_norm`` (layernorm: scale and bias), and
    the stacks ``enc_attn``, ``enc_ffn`` (encoder layers), ``attn``,
    ``cross``, ``ffn`` (decoder layers), each with its pre-norm."""
    pd = cfg.torch_param_dtype()
    embed = torch.empty(cfg.vocab_padded, cfg.d_model, dtype=pd, device=device)
    enc_pos = torch.empty(cfg.n_audio_frames, cfg.d_model, dtype=torch.float32,
                          device=device).normal_(0.0, 1.0, generator=gen)

    def stack(n, init_fn):
        return dict(norm=layers.init_norm(cfg, n, device=device),
                    **init_fn(gen, cfg, n, device))

    return {
        "embed": layers.embed_init_(embed, gen),
        "enc_pos": enc_pos.mul_(0.02).to(pd),
        "final_norm": layers.init_norm(cfg, device=device),
        "enc_final_norm": layers.init_norm(cfg, device=device),
        "stacks": {
            "enc_attn": stack(cfg.n_encoder_layers,
                              attention.init_attn_params),
            "enc_ffn": stack(cfg.n_encoder_layers, ffn_mod.init_ffn_params),
            "attn": stack(cfg.n_layers, attention.init_attn_params),
            "cross": stack(cfg.n_layers, attention.init_attn_params),
            "ffn": stack(cfg.n_layers, ffn_mod.init_ffn_params),
        },
    }


def _bidir_attend(cfg, q, k, v):
    """Unmasked attention: the flash kernel with ``causal=False``."""
    return kops.flash_attention(q, k, v, causal=False,
                                softcap=cfg.logit_softcap)


def encode(params, cfg, frames, *, remat: bool = False):
    """frames: [B, T_enc, D] (stub frontend output) → [B, T_enc, D]."""
    dt = cfg.torch_dtype()
    h = frames.to(dt) + params["enc_pos"][None].to(dt)
    sp = act.seq_sharded(h.shape[1])
    if sp:
        h = tp.split_seq(h)

    def layer(h, pa, pf):
        with tp.seq_split(sp):
            hn = _norm(cfg, pa["norm"], h)
            q, k, v = attention._project_qkv(pa, cfg, hn)
            h = h + attention.out_proj(pa, cfg, _bidir_attend(
                cfg, q, attention.kv_heads(pa, cfg, k),
                attention.kv_heads(pa, cfg, v)), h.dtype)
            hn = _norm(cfg, pf["norm"], h)
            return h + ffn_mod.ffn(pf, cfg, hn)

    st = params["stacks"]
    for i in range(cfg.n_encoder_layers):
        h = _checkpointed(layer, remat)(h, tree_slice(st["enc_attn"], i),
                                        tree_slice(st["enc_ffn"], i))
    if sp:
        h = tp.gather_seq(h, partial=False)
    return layers.apply_norm(cfg, params["enc_final_norm"], h)


def _cross_kv(pc, cfg, enc_h):
    """One decoder layer's cross K/V from the encoder output: [B, T_enc,
    K, Dh] each (outside the layer's ``tp.seq_split``: the encoder output
    is whole)."""
    _, k, v = attention._project_qkv(pc, cfg, enc_h)
    return k, v


def _decoder_layer(cfg, h, positions, pa, pc, pf, gm, gf, xk, xv,
                   sp: bool = False):
    """One decoder layer over a full sequence against the cross K/V
    ``xk``/``xv``: gated self-attention (causal flash), gated
    cross-attention (the same mixer gate), gated FFN. Returns (h, the
    self-attention's {"k","v"}); ``sp``: ``h`` is this rank's rows."""
    with tp.seq_split(sp):
        hn = _norm(cfg, pa["norm"], h)
        out, kv = attention.attention(pa, cfg, hn, positions)
        h = h + _bgate(gm, h) * out
        hn = _norm(cfg, pc["norm"], h)
        q, _, _ = attention._project_qkv(pc, cfg, hn)
        xout = _bidir_attend(cfg, q,
                             attention.kv_heads(pc, cfg, xk.to(h.dtype)),
                             attention.kv_heads(pc, cfg, xv.to(h.dtype)))
        h = h + _bgate(gm, h) * attention.out_proj(pc, cfg, xout, h.dtype)
        hn = _norm(cfg, pf["norm"], h)
        return h + _bgate(gf, h) * ffn_mod.ffn(pf, cfg, hn), kv


def _layer_params(params, i: int):
    st = params["stacks"]
    return (tree_slice(st["attn"], i), tree_slice(st["cross"], i),
            tree_slice(st["ffn"], i))


def _decoder_pass(params, cfg, h, positions, enc_h, gates, *,
                  remat: bool = False):
    """Teacher-forced decoder over a full sequence (train / scoring); each
    layer projects its cross K/V from ``enc_h`` inside the (remat) layer.
    Under sequence parallelism the stream is cut between the layers and
    gathered back at the end."""
    sp = act.seq_sharded(h.shape[1])
    if sp:
        h = tp.split_seq(h)

    def layer(h, pa, pc, pf, gm, gf):
        xk, xv = _cross_kv(pc, cfg, enc_h)
        return _decoder_layer(cfg, h, positions, pa, pc, pf, gm, gf,
                              xk, xv, sp)[0]

    for i in range(cfg.n_layers):
        h = _checkpointed(layer, remat)(h, *_layer_params(params, i),
                                        gates["mixer"][i], gates["ffn"][i])
    return tp.gather_seq(h, partial=False) if sp else h


def _embed_tokens(params, cfg, tokens, offset):
    """Token embeddings plus sinusoidal positions ``offset..offset+S-1``:
    (h [B, S, D] in the model dtype, positions [1, S])."""
    h = embed_lookup(params, cfg, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device) + offset
    return h + _sinusoid(pos, cfg.d_model)[None].to(h.dtype), pos[None]


def unembed(params, cfg, h):
    """Final norm + the tied LM head → f32 logits."""
    h = layers.apply_norm(cfg, params["final_norm"], h)
    return vocab_logits(cfg, h, params["embed"].t())


_unembed = unembed      # :func:`forward`'s ``unembed`` flag shadows the name


def forward(params, cfg, tokens, frames, *, gates=None, remat: bool = False,
            unembed: bool = True):
    """Teacher-forced logits [B, S, Vp] (f32); ``unembed=False`` returns the
    pre-final-norm hidden state (the chunked-CE path). Gates [L] or
    [L, B]."""
    gates = gates or _ones_gates(cfg.n_layers, tokens.device)
    enc_h = encode(params, cfg, frames, remat=remat)
    h, positions = _embed_tokens(params, cfg, tokens, 0)
    h = _decoder_pass(params, cfg, h, positions, enc_h, gates, remat=remat)
    if not unembed:
        return h
    return _unembed(params, cfg, h)


def init_cache(cfg, batch: int, max_len: int, kv_dtype=None,
               device=None) -> dict:
    """``"pos": 0``; the self-attention cache ``"attn"`` {"k","v"} [L, B,
    max_len, K, Dh] in ``kv_dtype`` (default the model dtype; int8 adds
    per-(token, head) scales, fp8 is a plain cast); the cross K/V
    ``"cross"`` [L, B, n_audio_frames, K, Dh], fixed-size and in the
    activation dtype."""
    dt = cfg.torch_dtype()
    shape = (cfg.n_layers, batch, cfg.n_audio_frames, cfg.n_kv_heads, cfg.dh)
    return {"pos": 0,
            "attn": attention.init_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                            kv_dtype, device),
            "cross": {"k": torch.zeros(shape, dtype=dt, device=device),
                      "v": torch.zeros(shape, dtype=dt, device=device)}}


def prefill(params, cfg, tokens, frames, max_len: int, *, gates=None,
            kv_dtype=None) -> Tuple[torch.Tensor, dict]:
    """Encode the audio and consume the decoder prompt. Returns (last
    logits [B, Vp], cache) with the prompt's self K/V in positions [0, S)
    (encoded by ``store_kv``), every layer's cross K/V and ``"pos"`` = S."""
    gates = gates or _ones_gates(cfg.n_layers, tokens.device)
    B, S = tokens.shape
    enc_h = encode(params, cfg, frames)
    cache = init_cache(local_cfg(params, cfg), B, max_len, kv_dtype,
                       tokens.device)
    h, positions = _embed_tokens(params, cfg, tokens, 0)
    sp = act.seq_sharded(S)
    if sp:
        h = tp.split_seq(h)
    cross, entry = cache["cross"], cache["attn"]
    for i in range(cfg.n_layers):
        pa, pc, pf = _layer_params(params, i)
        xk, xv = _cross_kv(pc, cfg, enc_h)
        cross["k"][i], cross["v"][i] = xk, xv
        h, kv = _decoder_layer(cfg, h, positions, pa, pc, pf,
                               gates["mixer"][i], gates["ffn"][i],
                               cross["k"][i], cross["v"][i], sp)
        for key, val in attention.store_kv(entry, kv["k"], kv["v"]).items():
            entry[key][i, :, :S] = val
    if sp:
        h = tp.gather_seq(h, partial=False)
    cache["pos"] = S
    return unembed(params, cfg, h[:, -1:, :])[:, 0], cache


def decode_step(params, cfg, cache: dict, tokens, *,
                gates=None) -> Tuple[torch.Tensor, dict]:
    """One step at the scalar ``cache["pos"]`` (updated in place). The
    self-attention writes its token and runs the dense decode kernel; the
    cross-attention is one query against every frame (the dense decode
    kernel, all frames valid). Returns (logits [B, 1, Vp], cache). Under
    ``cache_specs`` both caches are in the ``cache_pspecs`` layout
    (``tp.cache_cut``)."""
    gates = gates or _ones_gates(cfg.n_layers, tokens.device)
    pos = cache["pos"]
    h, _ = _embed_tokens(params, cfg, tokens, pos)
    cross = cache["cross"]
    every = torch.ones(cross["k"].shape[2], dtype=torch.bool,
                       device=h.device)
    self_cut, cross_cut = tp.cache_cut("attn", "k"), tp.cache_cut("cross",
                                                                  "k")
    for i in range(cfg.n_layers):
        pa, pc, pf = _layer_params(params, i)
        gm, gf = gates["mixer"][i], gates["ffn"][i]
        hn = layers.apply_norm(cfg, pa["norm"], h)
        out = attention.decode_attention(pa, cfg, hn,
                                         _pool_layer(cache["attn"], i), pos,
                                         cut=self_cut)
        h = h + _bgate(gm, h) * out
        hn = layers.apply_norm(cfg, pc["norm"], h)
        q, _, _ = attention._project_qkv(pc, cfg, hn)
        xk, xv = cross["k"][i].to(h.dtype), cross["v"][i].to(h.dtype)
        if cross_cut is not None:
            xout = attention.attend_cached(pc, cfg, q, xk, xv, every,
                                           cross_cut)
        else:
            xout = kops.decode_attention(
                q, attention.kv_heads(pc, cfg, xk),
                attention.kv_heads(pc, cfg, xv), every,
                softcap=cfg.logit_softcap)
        h = h + _bgate(gm, h) * attention.out_proj(pc, cfg, xout, h.dtype)
        hn = layers.apply_norm(cfg, pf["norm"], h)
        h = h + _bgate(gf, h) * ffn_mod.ffn(pf, cfg, hn)
    cache["pos"] = pos + 1
    return unembed(params, cfg, h), cache
