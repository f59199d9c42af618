"""Uniform model API (the decoder-only LM builder of the JAX registry):
the dense, ``ssm`` (mamba2) and ``hybrid`` (recurrentgemma) families.

``build(cfg)`` returns a ``Model`` with:
  init(seed, device)                 → params
  loss(params, batch, gates=None)    → (scalar loss, aux)  [teacher-forced LM]
  logits(params, batch, gates=None)  → [B, S, Vp] f32
  prefill(params, batch, max_len, gates=None, kv_dtype=None)
                                     → (last_logits, slot cache)
  decode(params, cache, tokens, gates=None) → (logits [B,1,Vp], cache)

Batches are dicts of tensors with ``tokens`` / ``labels``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import decoder


class Model(NamedTuple):
    cfg: Any
    init: Callable
    loss: Callable
    logits: Callable
    prefill: Callable
    decode: Callable


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


def _lm_build(cfg) -> Model:
    decoder.check_supported(cfg)

    def init(seed: int = 0, device="cuda"):
        gen = torch.Generator(device=device).manual_seed(int(seed))
        return decoder.init_params(gen, cfg, device)

    def logits(params, batch, gates=None):
        out, _ = decoder.forward(params, cfg, batch["tokens"], gates=gates)
        return out

    def loss(params, batch, gates=None):
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        lg = logits(params, batch, gates)[:, :-1]
        if mask is not None:
            mask = mask[:, 1:]
        l = cross_entropy(lg, labels[:, 1:], cfg.vocab_size, mask)
        return l, {"loss": l, "ppl": torch.exp(l)}

    def prefill(params, batch, max_len, gates=None, kv_dtype=None):
        return decoder.prefill(params, cfg, batch["tokens"], max_len,
                               gates=gates, kv_dtype=kv_dtype)

    def decode(params, cache, tokens, gates=None):
        """One step; ``cache["pos"]`` scalar (one-shot) or [B] (slots)."""
        return decoder.decode_step(params, cfg, cache, tokens, gates=gates)

    return Model(cfg, init, loss, logits, prefill, decode)


def build(cfg) -> Model:
    return _lm_build(cfg)
