"""Uniform model API (the decoder-only LM builder of the JAX registry).

``build(cfg)`` returns a ``Model`` with:
  init(seed, device)                 → params
  loss(params, batch, gates=None)    → (scalar loss, aux)  [teacher-forced LM]
  logits(params, batch, gates=None)  → [B, S, Vp] f32
  prefill(params, batch, max_len)    → (last_logits, cache)

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
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise NotImplementedError(
            "encoder-decoder and vision stubs are ROADMAP queue 1, items 11-14")

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

    def prefill(params, batch, max_len, gates=None):
        return decoder.prefill(params, cfg, batch["tokens"], max_len,
                               gates=gates)

    return Model(cfg, init, loss, logits, prefill)


def build(cfg) -> Model:
    return _lm_build(cfg)
