"""Quickstart on the PyTorch port: train a small LM, score its blocks with
GSI, make one runtime-adaptive pruning decision, and run the pruned model.

  PYTHONPATH=src python examples/quickstart_torch.py                # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu   # plain
                                                 # kernel versions on the CPU

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same steps
on the GPU's kernels (flash attention and the fused GLU in every forward).
``--smoke`` takes the 2-layer SMOKE config, and ``--steps``,
``--episodes`` and ``--seq`` shrink the run.
"""
import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.llama2_7b import RAP_SUBJECT
from repro_torch.core import dqn, env as env_lib, gsi, masks, memory
from repro_torch.core.controller import RAPController
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.launch import resolve_device
from repro_torch.models import decoder, registry
from repro_torch.optim import adamw
from repro_torch.runtime import Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the 2-layer SMOKE config instead of the 6-layer "
                         "RAP subject")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. a small llama-family model + synthetic corpus
    cfg = (get_smoke_config("llama2-7b") if args.smoke
           else RAP_SUBJECT.replace(n_layers=6))
    model = registry.build(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)

    # 2. train briefly
    trainer = Trainer(model, adamw.AdamWConfig(lr=1e-3,
                                               total_steps=args.steps),
                      TrainerConfig(total_steps=args.steps,
                                    log_every=max(args.steps // 3, 1),
                                    remat=False),
                      on_log=lambda s, m: print(
                          f"  step {s}: loss {m['loss']:.3f}"),
                      device=device)
    print(f"training {args.steps} steps on {device}...")
    trainer.run(batch_iterator(corpus, 8, args.seq))
    params = trainer.params

    # 3. GSI block importance (Algorithm 1)
    calib = {k: torch.from_numpy(v).to(device) for k, v in corpus.batch(
        4, args.seq, split="calib").items()}
    res = gsi.gsi_rank(model, params, calib,
                       max_removals=min(4, 2 * cfg.n_layers - 2), chunk=16)
    print(f"GSI removal order (least-important first): {res.order}")

    # 4. train the RL controller (Algorithm 2) and decide (Algorithm 3)
    mm = memory.build_memory_model(cfg)
    e = env_lib.PruneEnv(model, params, calib, mm, chunk=16)

    def sampler(rng):
        bs, sql = int(rng.integers(1, 16)), int(rng.integers(256, 4096))
        return bs, sql, float(rng.uniform(0.6, 0.9)) * mm.dense_peak(bs, sql)

    tr = dqn.train(lambda: e, episodes=args.episodes,
                   request_sampler=sampler)
    ctl = RAPController(model, params, calib, mm, tr.q_params, chunk=16)

    bs, sql = 8, 2048
    budget = 0.7 * mm.dense_peak(bs, sql)
    d = ctl.decide(bs, sql, budget)
    print(f"request (bs={bs}, seq={sql}) at 70% budget → keep "
          f"{int(d.mask.sum())}/{len(d.mask)} blocks, "
          f"peak {d.peak_bytes/1e6:.1f}MB ≤ {budget/1e6:.1f}MB: {d.fits}")

    # 5. run the structurally pruned model
    small, layout = masks.compact_params(params, cfg, d.mask)
    with torch.no_grad():
        logits, _ = decoder.forward(small, cfg, calib["tokens"],
                                    layout=layout)
    finite = bool(torch.isfinite(logits).all())
    print(f"pruned forward OK: logits {tuple(logits.shape)}, "
          f"finite={finite}")
    return {"order": res.order, "mask": np.asarray(d.mask), "fits": d.fits,
            "logits_shape": tuple(logits.shape), "finite": finite}


if __name__ == "__main__":
    main()
