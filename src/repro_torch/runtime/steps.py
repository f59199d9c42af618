"""Step factories: the serving steps of ``repro/runtime/steps.py``.

``make_prefill_step`` and ``make_decode_step`` wrap a model's ``prefill``
and ``decode`` (the one-shot slot-cache path; a scalar ``cache["pos"]``
decodes the whole batch at one position). The port runs eagerly, so a step
is the plain function JAX would ``jit``. The train and eval steps come with
training (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

from typing import Callable


def make_prefill_step(model, max_len: int, *, kv_dtype=None,
                      gates: bool = False) -> Callable:
    """(params, batch[, gates]) → (last_logits, cache)."""
    if gates:
        def prefill_step(params, batch, gate_vals):
            return model.prefill(params, batch, max_len, gates=gate_vals,
                                 kv_dtype=kv_dtype)
    else:
        def prefill_step(params, batch):
            return model.prefill(params, batch, max_len, kv_dtype=kv_dtype)
    return prefill_step


def make_decode_step(model, *, gates: bool = False) -> Callable:
    """(params, cache, tokens[, gates]) → (logits, cache)."""
    if gates:
        def decode_step(params, cache, tokens, gate_vals):
            return model.decode(params, cache, tokens, gates=gate_vals)
    else:
        def decode_step(params, cache, tokens):
            return model.decode(params, cache, tokens)
    return decode_step
