"""Shared benchmark substrate: the RAP subject model + evaluation protocol.

The twin of the JAX package's ``benchmarks/common.py``. The paper's
experiments run Llama2-7B on WikiText2/PTB and commonsense suites; the
in-repo analogue is:
  * subject model — same family (RMSNorm + SwiGLU + RoPE decoder,
    ``RAP_SUBJECT``: 8 layers, d_model 256), trained here on the synthetic
    Zipf-Markov corpus;
  * "WikiText2 ppl"  → held-out synthetic perplexity;
  * "commonsense acc" → next-token top-1 accuracy on held-out text.

The trained subject is cached as a checkpoint under
``experiments/bench_torch/`` (never the JAX package's
``experiments/bench/``), so reruns resume instead of retraining. Training
runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.llama2_7b import RAP_SUBJECT
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.models import registry
from repro_torch.models.registry import _nll_terms
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

BENCH_DIR = "experiments/bench_torch"
SUBJECT_STEPS = 300
EVAL_REQUEST = (8, 2048)     # (batch, seq): KV-dominated regime


def subject(*, device="cuda", bench_dir: str = BENCH_DIR) -> Tuple:
    """(model, trained params, corpus): ``RAP_SUBJECT`` trained for
    ``SUBJECT_STEPS`` steps (batch 16 × 128 tokens, AdamW lr 1e-3, warmup
    30), once; later calls restore the cached checkpoint."""
    cfg = RAP_SUBJECT
    steps = SUBJECT_STEPS
    model = registry.build(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    tr = Trainer(model, adamw.AdamWConfig(lr=1e-3, total_steps=steps,
                                          warmup_steps=30),
                 TrainerConfig(total_steps=steps,
                               ckpt_dir=os.path.join(bench_dir,
                                                     "subject_ckpt"),
                               ckpt_every=100, log_every=100,
                               remat=False, ckpt_async=False),
                 device=device)
    if not tr.maybe_restore() or tr.step < steps:
        start = tr.step
        print(f"[common] training subject model {start}→{steps}")
        tr.run(batch_iterator(corpus, 16, 128, start=start))
    return model, tr.params, corpus


def _on(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def calib_batch(corpus, n=4, seq=128, *, device="cuda") -> Dict:
    return _on(corpus.batch(n, seq, split="calib"), device)


def eval_batches(corpus, n_batches=4, bs=8, seq=128, *, device="cuda"):
    return [_on(corpus.batch(bs, seq, split="eval", index=i), device)
            for i in range(n_batches)]


def evaluate(model, params, batches, gates=None) -> Dict[str, float]:
    """Held-out perplexity + next-token top-1 accuracy (downstream proxy)."""
    tot_nll, tot_correct, tot_tok = 0.0, 0.0, 0
    with torch.no_grad():
        for b in batches:
            lg = model.logits(params, b, gates=gates)
            lg, labels = lg[:, :-1], b["labels"][:, 1:]
            tot_nll += float(torch.sum(_nll_terms(lg, labels,
                                                  model.cfg.vocab_size)))
            pad = torch.arange(lg.shape[-1], device=lg.device) \
                >= model.cfg.vocab_size
            pred = torch.argmax(lg.masked_fill(pad, -1e30), dim=-1)
            tot_correct += float(torch.sum(pred == labels.long()))
            tot_tok += labels.numel()
    return {"ppl": float(np.exp(tot_nll / tot_tok)),
            "acc": tot_correct / tot_tok}
