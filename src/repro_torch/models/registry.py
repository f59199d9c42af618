"""Uniform model API over every architecture family (the JAX registry's
two builders): the decoder-only LM (dense, ``moe`` (olmoe, dbrx), ``vlm``
(internvl2), ``ssm`` (mamba2), ``hybrid`` (recurrentgemma)) and the
encoder-decoder (``audio``: whisper).

``build(cfg)`` returns a ``Model`` with:
  init(seed, device)                 → params ("meta": shapes only, the
                                       twin of ``jax.eval_shape``)
  loss(params, batch, gates=None, remat=False, layout=None, groups=1)
                                     → (scalar loss, aux)  [teacher-forced LM]
  logits(params, batch, gates=None, remat=False, layout=None, groups=1)
                                     → [B, S, Vp] f32
  prefill(params, batch, max_len, gates=None, kv_dtype=None)
                                     → (last_logits, slot cache)
  decode(params, cache, tokens, gates=None) → (logits [B,1,Vp], cache)
  init_cache(batch_size, max_len, kv_dtype=None, device="cuda") → cache
  input_specs(shape_cfg)             → {name: meta tensor}: the batch of a
                                       dry-run cell (``configs.ShapeConfig``),
                                       the twin of JAX's ``ShapeDtypeStruct``s

Batches are dicts of tensors with ``tokens`` / ``labels`` (and an optional
``loss_mask``); a ``vlm`` batch may carry ``vision_embeds [B, P, D]``,
prepended to the tokens (logits and the prefill's cache cover P + S
positions; the loss is taken on the text positions only); an
encoder-decoder batch carries ``frames [B, n_audio_frames, D]`` (not
``decode``'s: the cache holds the cross K/V). From ``CHUNKED_CE_MIN_SEQ``
tokens the loss takes the chunked cross-entropy, as JAX's does.
``groups`` splits the batch into independent groups of rows for the MoE
FFN's capacity (the GSI scorer's candidates; ``decoder.forward``); the
encoder-decoder has no MoE and ignores it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.models import decoder, encdec


class Model(NamedTuple):
    cfg: Any
    init: Callable
    loss: Callable
    logits: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    input_specs: Callable


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


CHUNKED_CE_MIN_SEQ = 2048


def _nll_terms(logits, labels, vocab_size: int):
    """Per-position NLL; padded-vocab entries (ids >= vocab_size) are
    excluded from the partition function."""
    logits = logits.float()
    if logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def cross_entropy(logits, labels, vocab_size: int, mask=None):
    """Mean next-token CE; padded-vocab entries are excluded from Z."""
    nll = _nll_terms(logits, labels, vocab_size)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunked_cross_entropy(unembed_fn, h, labels, vocab_size: int,
                          mask=None, chunk: int = 512):
    """Mean next-token CE without the whole ``[B, S, V]`` logits: one
    sequence chunk at a time, each rematerialised in the backward
    (``torch.utils.checkpoint``), so the peak holds one ``[B, chunk, V]``
    block. h: [B, S, D] pre-final-norm hidden; ``unembed_fn(h_chunk)`` →
    logits chunk. Position t predicts ``labels[:, t + 1]``; the last
    position is masked. The chunk halves until it divides S."""
    B, S, _ = h.shape
    labels_next = torch.cat([labels[:, 1:], labels.new_zeros(B, 1)], dim=1)
    w = torch.ones(B, S, dtype=torch.float32, device=h.device)
    w[:, -1] = 0.0
    if mask is not None:
        w = w * torch.cat([mask[:, 1:].float(),
                           w.new_zeros(B, 1)], dim=1)
    cs = chunk
    while cs > 1 and S % cs:
        cs //= 2

    def one(h_c, l_c, w_c):
        nll = _nll_terms(unembed_fn(h_c), l_c, vocab_size)
        return torch.sum(nll * w_c)

    nll = sum(torch.utils.checkpoint.checkpoint(
        one, h[:, c0:c0 + cs], labels_next[:, c0:c0 + cs],
        w[:, c0:c0 + cs], use_reentrant=False) for c0 in range(0, S, cs))
    return nll / torch.clamp(w.sum(), min=1.0)


def _lm_build(cfg) -> Model:
    decoder.check_supported(cfg)
    is_vlm = cfg.family == "vlm"

    def extra(batch):
        return batch.get("vision_embeds") if is_vlm else None

    def init(seed: int = 0, device="cuda"):
        return decoder.init_params(_generator(seed, device), cfg, device)

    def logits(params, batch, gates=None, remat=False, layout=None,
               groups=1):
        out, _ = decoder.forward(params, cfg, batch["tokens"], gates=gates,
                                 extra_embeds=extra(batch), remat=remat,
                                 layout=layout, groups=groups)
        return out

    def loss(params, batch, gates=None, remat=False, layout=None, groups=1):
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if labels.shape[1] >= CHUNKED_CE_MIN_SEQ:
            h, _ = decoder.forward(params, cfg, batch["tokens"], gates=gates,
                                   extra_embeds=extra(batch), remat=remat,
                                   layout=layout, unembed=False,
                                   groups=groups)
            h = h[:, -labels.shape[1]:, :]      # text positions only
            l = chunked_cross_entropy(
                lambda hc: decoder._unembed(params, cfg, hc), h, labels,
                cfg.vocab_size, mask)
            return l, {"loss": l, "ppl": torch.exp(l)}
        lg = logits(params, batch, gates, remat, layout, groups)
        lg = lg[:, -labels.shape[1]:, :][:, :-1]    # text positions only
        if mask is not None:
            mask = mask[:, 1:]
        l = cross_entropy(lg, labels[:, 1:], cfg.vocab_size, mask)
        return l, {"loss": l, "ppl": torch.exp(l)}

    def prefill(params, batch, max_len, gates=None, kv_dtype=None):
        return decoder.prefill(params, cfg, batch["tokens"], max_len,
                               gates=gates, extra_embeds=extra(batch),
                               kv_dtype=kv_dtype)

    def decode(params, cache, tokens, gates=None):
        """One step; ``cache["pos"]`` scalar (one-shot) or [B] (slots)."""
        return decoder.decode_step(params, cfg, cache, tokens, gates=gates)

    def init_cache(batch_size, max_len, kv_dtype=None, device="cuda"):
        return decoder.init_cache(cfg, batch_size, max_len, kv_dtype, device)

    def input_specs(shape_cfg) -> dict:
        B, S = shape_cfg.global_batch, shape_cfg.seq_len
        i32 = torch.int32
        specs = {}
        nv = cfg.n_vision_tokens if is_vlm else 0
        tok_len = S - nv
        if shape_cfg.kind == "train":
            specs["tokens"] = _spec((B, tok_len), i32)
            specs["labels"] = _spec((B, tok_len), i32)
        elif shape_cfg.kind == "prefill":
            specs["tokens"] = _spec((B, tok_len), i32)
        else:  # decode: one new token against a seq_len cache
            specs["tokens"] = _spec((B, 1), i32)
        if is_vlm and shape_cfg.kind != "decode":
            specs["vision_embeds"] = _spec((B, nv, cfg.d_model),
                                           cfg.torch_dtype())
        return specs

    return Model(cfg, init, loss, logits, prefill, decode, init_cache,
                 input_specs)


def _generator(seed, device) -> torch.Generator:
    # a meta template draws nothing: its generator may live anywhere
    gdev = "cpu" if torch.device(device).type == "meta" else device
    return torch.Generator(device=gdev).manual_seed(int(seed))


def _encdec_build(cfg) -> Model:
    def init(seed: int = 0, device="cuda"):
        return encdec.init_params(_generator(seed, device), cfg, device)

    def logits(params, batch, gates=None, remat=False, layout=None,
               groups=1):
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"],
                              gates=gates, remat=remat)

    def loss(params, batch, gates=None, remat=False, layout=None, groups=1):
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        if labels.shape[1] >= CHUNKED_CE_MIN_SEQ:
            h = encdec.forward(params, cfg, batch["tokens"], batch["frames"],
                               gates=gates, remat=remat, unembed=False)
            l = chunked_cross_entropy(
                lambda hc: encdec.unembed(params, cfg, hc), h, labels,
                cfg.vocab_size, mask)
            return l, {"loss": l, "ppl": torch.exp(l)}
        lg = logits(params, batch, gates, remat)[:, :-1]
        if mask is not None:
            mask = mask[:, 1:]
        l = cross_entropy(lg, labels[:, 1:], cfg.vocab_size, mask)
        return l, {"loss": l, "ppl": torch.exp(l)}

    def prefill(params, batch, max_len, gates=None, kv_dtype=None):
        return encdec.prefill(params, cfg, batch["tokens"], batch["frames"],
                              max_len, gates=gates, kv_dtype=kv_dtype)

    def decode(params, cache, tokens, gates=None):
        """One step at the scalar ``cache["pos"]``."""
        return encdec.decode_step(params, cfg, cache, tokens, gates=gates)

    def init_cache(batch_size, max_len, kv_dtype=None, device="cuda"):
        return encdec.init_cache(cfg, batch_size, max_len, kv_dtype, device)

    def input_specs(shape_cfg) -> dict:
        B, S = shape_cfg.global_batch, shape_cfg.seq_len
        i32 = torch.int32
        specs = {}
        if shape_cfg.kind == "train":
            specs["tokens"] = _spec((B, S), i32)
            specs["labels"] = _spec((B, S), i32)
        elif shape_cfg.kind == "prefill":
            specs["tokens"] = _spec((B, S), i32)
        else:  # decode: the encoder ran at prefill; cache holds cross-KV
            specs["tokens"] = _spec((B, 1), i32)
        if shape_cfg.kind in ("train", "prefill"):
            specs["frames"] = _spec((B, cfg.n_audio_frames, cfg.d_model),
                                    cfg.torch_dtype())
        return specs

    return Model(cfg, init, loss, logits, prefill, decode, init_cache,
                 input_specs)


def build(cfg) -> Model:
    if cfg.is_encoder_decoder:
        return _encdec_build(cfg)
    return _lm_build(cfg)
