"""Greedy Sequential Importance scoring (paper §4.1, Algorithm 1).

A candidate block removal is scored by the log-perplexity of the model with
that block additionally gated off, on a calibration batch. All candidates
of one state are scored in batched forwards: the calibration batch is
repeated once per candidate and every row carries its candidate's keep-mask
as per-row ``[L, n_cand·B]`` gates (the counterpart of the JAX package's
``vmap``/``lax.map`` over candidate gate vectors), ``chunk`` candidates per
forward; an MoE model routes each candidate's rows as an independent group
(``groups``: its own expert capacity, as under JAX's ``vmap``), and an
encoder-decoder batch repeats its ``frames`` with the tokens.
:func:`gsi_rank` is Algorithm 1 (re-score every remaining block
after each removal); :func:`oneshot_rank` scores the dense model once (the
RAP^-GSI ablation).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import masks as masks_lib
from repro_torch.models.registry import _nll_terms


def _gates(cand: torch.Tensor, rows: int) -> dict:
    """[n, 2L] candidate masks → per-row gates {mixer, ffn}: [L, n·rows]."""
    L = cand.shape[1] // 2
    g = cand.t().repeat_interleave(rows, dim=1)
    return {"mixer": g[:L], "ffn": g[L:]}


def _candidate_losses(model, params, batch, cand: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of the calibration batch under each of the
    ``n`` candidate masks ``cand [n, 2L]`` → [n] f32."""
    tokens, labels = batch["tokens"], batch["labels"]
    B = tokens.shape[0]
    n = cand.shape[0]
    rep = {k: v.repeat(n, *(1,) * (v.ndim - 1)) for k, v in batch.items()
           if k not in ("labels", "loss_mask")}
    logits = model.logits(params, rep, gates=_gates(cand, B), groups=n)
    logits = logits[:, -labels.shape[1]:]       # text positions only
    nll = _nll_terms(logits[:, :-1], labels.repeat(n, 1)[:, 1:],
                     model.cfg.vocab_size)
    return nll.reshape(n, -1).mean(dim=1)


def make_ppl_fn(model, batch) -> Callable:
    """Returns fn(params, mask[2L]) → log-perplexity (float)."""

    def log_ppl(params, mask) -> float:
        m = torch.as_tensor(np.asarray(mask, np.float32),
                            device=batch["tokens"].device)
        return float(_candidate_losses(model, params, batch, m[None])[0])

    return log_ppl


def make_candidate_scorer(model, batch, *, chunk: int = 8) -> Callable:
    """Returns fn(params, mask) → scores[2L] (numpy f64):

    scores[b] = log-ppl of the model with block b additionally removed
                (+inf where b is already inactive — those are not run).
    """

    def score(params, mask) -> np.ndarray:
        mask = np.asarray(mask, np.float32)
        n = mask.shape[0]
        scores = np.full(n, np.inf)
        active = [b for b in range(n) if mask[b] > 0.5]
        dev = batch["tokens"].device
        for i in range(0, len(active), chunk):
            blocks = active[i:i + chunk]
            cand = np.repeat(mask[None], len(blocks), axis=0)
            cand[np.arange(len(blocks)), blocks] = 0.0
            losses = _candidate_losses(model, params, batch,
                                       torch.as_tensor(cand, device=dev))
            scores[blocks] = losses.cpu().numpy()
        return scores

    return score


def importance_scores(scores: np.ndarray, current_log_ppl: float) -> np.ndarray:
    """RL-state importance: Δlog-ppl caused by removing each block (≥ 0);
    inactive blocks get 0."""
    imp = np.asarray(scores, np.float64) - float(current_log_ppl)
    imp = np.where(np.isfinite(imp), np.maximum(imp, 0.0), 0.0)
    return imp


@dataclasses.dataclass
class GSIResult:
    order: list            # blocks in removal order
    ppl_trace: list        # log-ppl after each removal
    score_snapshots: list  # [step][2L] candidate scores at each state
    final_mask: np.ndarray


def gsi_rank(model, params, batch, *, stop: Optional[Callable] = None,
             max_removals: Optional[int] = None, chunk: int = 8,
             mask: Optional[np.ndarray] = None) -> GSIResult:
    """Algorithm 1. ``stop(mask) → bool`` ends early (e.g. memory target
    met); by default it runs until ``max_removals`` (or 2L-2) blocks are
    gone."""
    L = model.cfg.n_layers
    scorer = make_candidate_scorer(model, batch, chunk=chunk)
    mask = masks_lib.full_mask(L) if mask is None else np.array(mask, copy=True)
    max_removals = max_removals if max_removals is not None else 2 * L - 2

    order, trace, snaps = [], [], []
    for _ in range(max_removals):
        if stop is not None and stop(mask):
            break
        scores = scorer(params, mask)
        snaps.append(scores)
        k = int(np.argmin(scores))
        if not np.isfinite(scores[k]):
            break
        mask[k] = False
        order.append(k)
        trace.append(float(scores[k]))
    return GSIResult(order, trace, snaps, mask)


def oneshot_rank(model, params, batch, *, chunk: int = 8) -> np.ndarray:
    """One-shot scores on the dense model (the RAP^-GSI ablation):
    scores[b] = log-ppl with only block b removed; no re-evaluation."""
    scorer = make_candidate_scorer(model, batch, chunk=chunk)
    return scorer(params, masks_lib.full_mask(model.cfg.n_layers))
