"""Shared benchmark substrate: the RAP subject model + evaluation protocol.

The twin of the JAX package's ``benchmarks/common.py``. The paper's
experiments run Llama2-7B on WikiText2/PTB and commonsense suites; the
in-repo analogue is:
  * subject model — same family (RMSNorm + SwiGLU + RoPE decoder,
    ``RAP_SUBJECT``: 8 layers, d_model 256), trained here on the synthetic
    Zipf-Markov corpus;
  * "WikiText2 ppl"  → held-out synthetic perplexity;
  * "commonsense acc" → next-token top-1 accuracy on held-out text;
  * unified memory budget — Eq. (3)+(4) peak at an evaluation request
    shape (``EVAL_REQUEST``) chosen so KV cache dominates parameters.

The trained subject is cached as a checkpoint, and each DQN policy as a
Q-net file in the JAX package's JSON layout, under ``BENCH_DIR``
(``experiments/bench_torch/``, never the JAX package's
``experiments/bench/``), so reruns are incremental; :func:`emit` writes each
experiment's rows there. Everything runs on ``DEVICE`` (the card) unless a
caller passes ``device="cpu"`` or sets ``DEVICE``; ``bench_dir=`` and
``BENCH_DIR`` move the cache. The experiment scripts reach
:func:`subject` and :func:`trained_controller` through this module's
attributes, as the JAX package's scripts do.
"""
from __future__ import annotations

import json
import os
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.llama2_7b import RAP_SUBJECT
from repro_torch.core import dqn, env as env_lib, memory
from repro_torch.core.controller import RAPController
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.models import registry
from repro_torch.models.registry import _nll_terms
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig

BENCH_DIR = "experiments/bench_torch"
DEVICE = "cuda"
SUBJECT_STEPS = 300
EVAL_REQUEST = (8, 2048)     # (batch, seq): KV-dominated regime


def ensure_dirs(bench_dir: Optional[str] = None) -> str:
    d = bench_dir or BENCH_DIR
    os.makedirs(d, exist_ok=True)
    return d


def subject(*, device=None, bench_dir: Optional[str] = None) -> Tuple:
    """(model, trained params, corpus): ``RAP_SUBJECT`` trained for
    ``SUBJECT_STEPS`` steps (batch 16 × 128 tokens, AdamW lr 1e-3, warmup
    30), once; later calls restore the cached checkpoint."""
    bench_dir = ensure_dirs(bench_dir)
    device = device or DEVICE
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


def calib_batch(corpus, n=4, seq=128, *, device=None) -> Dict:
    return _on(corpus.batch(n, seq, split="calib"), device or DEVICE)


def eval_batches(corpus, n_batches=4, bs=8, seq=128, *, device=None):
    return [_on(corpus.batch(bs, seq, split="eval", index=i),
                device or DEVICE)
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


def memory_model(cfg=None) -> memory.MemoryModel:
    return memory.build_memory_model(cfg or RAP_SUBJECT)


def trained_controller(model, params, corpus, *, episodes=6, seed=0,
                       alpha=1.0, beta=0.3, tag="default", force=False,
                       device=None, bench_dir: Optional[str] = None
                       ) -> Tuple[RAPController, dqn.TrainResult]:
    """DQN policy for the subject model, cached per tag and seed as
    ``qnet_{tag}_s{seed}.json`` in the JAX package's layout (``q_params``
    as nested lists, ``rewards``, ``fits``): a file written by either
    package loads in the other. Training runs ``episodes`` episodes of the
    pruning MDP, its scoring forwards on ``device`` (default: the params')
    (calibration batch 2 × 64,
    candidates in chunks of 16); requests are sampled as the JAX package
    does (batch 2^0..2^3, 256..2048 tokens, budget 0.55-0.9 of the dense
    peak)."""
    bench_dir = ensure_dirs(bench_dir)
    mm = memory_model(model.cfg)
    calib = calib_batch(corpus, n=2, seq=64,
                        device=device or params["embed"].device)
    env_cfg = env_lib.EnvConfig(alpha=alpha, beta=beta)

    def sampler(rng):
        bs = int(2 ** rng.integers(0, 4))
        sql = int(rng.integers(4, 33)) * 64
        frac = float(rng.uniform(0.55, 0.9))
        return bs, sql, frac * mm.dense_peak(bs, sql)

    meta_p = os.path.join(bench_dir, f"qnet_{tag}_s{seed}.json")
    if os.path.exists(meta_p) and not force:
        with open(meta_p) as f:
            meta = json.load(f)
        qp = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in meta["q_params"].items()}
        tr = dqn.TrainResult(qp, meta["rewards"], meta["fits"], [])
    else:
        print(f"[common] training DQN policy ({tag}, seed {seed}, "
              f"{episodes} eps)")
        e = env_lib.PruneEnv(model, params, calib, mm, env_cfg, chunk=16)
        tr = dqn.train(lambda: e, episodes=episodes, seed=seed,
                       cfg=dqn.DQNConfig(eps_decay_episodes=episodes * 2 // 3),
                       request_sampler=sampler)
        with open(meta_p, "w") as f:
            json.dump({"q_params": {k: v.numpy().tolist()
                                    for k, v in tr.q_params.items()},
                       "rewards": tr.episode_rewards,
                       "fits": tr.episode_fits}, f)
    ctl = RAPController(model, params, calib, mm, tr.q_params,
                        env_cfg=env_cfg, chunk=16)
    return ctl, tr


def device_label(device=None) -> str:
    """The device the experiments' timings come from: the card's name and
    power limit as ``nvidia-smi`` gives them, or ``cpu``."""
    dev = torch.device(device or DEVICE)
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        line = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name(dev)}, power limit not read"


def emit(name: str, rows, header=None):
    """Write ``BENCH_DIR/<name>.json`` and print the rows as a CSV block."""
    bench_dir = ensure_dirs()
    with open(os.path.join(bench_dir, name + ".json"), "w") as f:
        json.dump(rows, f, indent=1, default=float)
    if header:
        print(",".join(header))
    for r in rows:
        if isinstance(r, dict):
            print(",".join(str(r.get(h, "")) for h in (header or r)))
    print(flush=True)
