"""Step factories: the steps of ``repro/runtime/steps.py``.

``make_train_step`` takes the loss's gradient with ``torch.autograd.grad``
over copies of the parameter leaves marked ``requires_grad`` (the
parameters themselves stay plain tensors, as JAX's arrays are) and applies
AdamW; ``make_eval_step`` returns the loss's metrics. ``make_prefill_step``
and ``make_decode_step`` wrap a model's ``prefill`` and ``decode`` (the
one-shot slot-cache path; a scalar ``cache["pos"]`` decodes the whole batch
at one position). The port runs eagerly, so a step is the plain function
JAX would ``jit``. On the card the loss's forward runs the kernels, and
their gradients come through ``kernels.ops.KernelGrad``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten


def loss_and_grads(model, params, batch, *, remat: bool = False):
    """(loss, aux, grads): the loss on ``batch`` and its gradient with
    respect to every parameter leaf (``grads`` in the params' structure
    and dtypes). ``aux`` is detached."""
    marked = {k: v.detach().requires_grad_(True)
              for k, v in flatten(params).items()}
    loss, aux = model.loss(unflatten(params, marked), batch, remat=remat)
    grads = torch.autograd.grad(loss, list(marked.values()))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten(params, dict(zip(marked, grads))))


def make_train_step(model, opt_cfg: adamw.AdamWConfig, *,
                    remat: bool = True, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) → (params', opt_state', metrics).

    ``microbatches > 1`` accumulates the gradients of batch slices in f32
    (activation memory scales 1/m), averages them, then takes one AdamW
    step; the metrics are the mean over the slices, as in JAX."""
    m = int(microbatches)

    def train_step(params, opt_state, batch):
        if m <= 1:
            _, aux, grads = loss_and_grads(model, params, batch, remat=remat)
        else:
            gsum, auxes = {}, []
            for i in range(m):
                one = {k: v.reshape(m, v.shape[0] // m, *v.shape[1:])[i]
                       for k, v in batch.items()}
                _, aux, g = loss_and_grads(model, params, one, remat=remat)
                for k, x in flatten(g).items():
                    gsum[k] = x.float() + gsum.get(k, 0.0)
                auxes.append(aux)
            grads = unflatten(params, {k: g / m for k, g in gsum.items()})
            aux = {k: torch.mean(torch.stack([a[k] for a in auxes]))
                   for k in auxes[0]}
        params, opt_state, om = adamw.apply(opt_cfg, params, grads,
                                            opt_state)
        return params, opt_state, {**aux, **om}

    return train_step


def make_eval_step(model) -> Callable:
    """(params, batch, gate_vals=None) → the loss's metrics (``loss``,
    ``ppl``), without a graph."""
    def eval_step(params, batch, gate_vals=None):
        with torch.no_grad():
            _, aux = model.loss(params, batch, gates=gate_vals)
        return aux
    return eval_step


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
