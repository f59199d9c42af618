"""Elastic-budget serving demo on the PyTorch port (paper Fig. 5 scenario).

A co-running application grabs memory mid-flight; the RAP server observes
the shrinking budget per request and prunes deeper on the fly, then relaxes
back to (nearly) the dense model when pressure clears. Then the same
contention made real: a burst of concurrent requests competing for one
shared KV pool through the engine.

  PYTHONPATH=src python examples/serve_elastic_budget_torch.py              # GPU
  PYTHONPATH=src python examples/serve_elastic_budget_torch.py --device cpu

The twin of ``examples/serve_elastic_budget.py`` on ``repro_torch``
(serving through the dense decode kernel on the GPU). ``--smoke``,
``--steps``, ``--episodes``, ``--seq`` and ``--burst`` shrink the run.
"""
import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.llama2_7b import RAP_SUBJECT
from repro_torch.core import dqn, env as env_lib, masks, memory
from repro_torch.core.controller import RAPController
from repro_torch.core.policy import RLPolicy
from repro_torch.data import SyntheticCorpus, batch_iterator
from repro_torch.launch import resolve_device
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.runtime import (EngineConfig, EngineRequest, RAPEngine,
                                 RAPServer, Trainer, TrainerConfig)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the 2-layer SMOKE config instead of the 6-layer "
                         "RAP subject")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--seq", type=int, default=512,
                    help="prompt tokens of the traced requests")
    ap.add_argument("--burst", type=int, default=8,
                    help="requests in the shared-pool burst")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (get_smoke_config("llama2-7b") if args.smoke
           else RAP_SUBJECT.replace(n_layers=6))
    model = registry.build(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    trainer = Trainer(model, adamw.AdamWConfig(lr=1e-3,
                                               total_steps=args.steps),
                      TrainerConfig(total_steps=args.steps,
                                    log_every=args.steps, remat=False),
                      device=device)
    print(f"training the served model ({args.steps} steps on {device})...")
    trainer.run(batch_iterator(corpus, 8, 128))
    params = trainer.params

    calib = {k: torch.from_numpy(v).to(device) for k, v in corpus.batch(
        4, 128, split="calib").items()}
    mm = memory.build_memory_model(cfg)
    e = env_lib.PruneEnv(model, params, calib, mm, chunk=16)

    def sampler(rng):
        bs, sql = int(rng.integers(1, 16)), int(rng.integers(256, 4096))
        return bs, sql, float(rng.uniform(0.55, 0.95)) * mm.dense_peak(bs, sql)

    print(f"training the RAP controller ({args.episodes} episodes)...")
    tr = dqn.train(lambda: e, episodes=args.episodes, request_sampler=sampler)
    ctl = RAPController(model, params, calib, mm, tr.q_params, chunk=16)
    policy = RLPolicy(ctl)
    server = RAPServer(model, params, policy, mode="structural",
                       max_new_tokens=8)

    # memory pressure trace: healthy → interference spike → recovery
    trace = [0.95, 0.9, 0.62, 0.55, 0.58, 0.85, 0.95]
    rng = np.random.default_rng(0)
    bs, sql = 4, args.seq
    print(f"\nserving {len(trace)} requests (bs={bs}, seq={sql}) under a "
          "memory-pressure trace:")
    kept = []
    for t, frac in enumerate(trace):
        prompt = corpus.sample_tokens(rng, bs, sql)
        budget = frac * mm.dense_peak(bs, sql + 8)
        r = server.serve(prompt, budget)
        kept.append(int(r.mask.sum()))
        bar = "#" * int(30 * frac)
        print(f"  t={t}: avail {frac:4.2f} {bar:<30s} kept "
              f"{kept[-1]:2d}/{len(r.mask)} blocks  "
              f"peak/budget {r.peak_bytes/budget:4.2f}  fits={r.fits}  "
              f"{'new slot group' if r.compiled_new else 'cached'}")
    print("\nslot groups minted:", server.stats())

    # ---- phase 2: the same contention made real — a burst of concurrent
    # requests competing for one shared KV pool through the engine
    # (DESIGN.md §10). Admission control queues what the pool cannot hold;
    # the controller prunes deeper as the pool fills.
    full = masks.full_mask(cfg.n_layers)
    max_total = 256 + 8
    pool_budget = (mm.param_bytes(full)
                   + 2.0 * mm.state_bytes(full, 1, max_total))
    engine = RAPEngine(model, params, policy, EngineConfig(
        mode="structural", max_new_tokens=8, max_active=4,
        max_len=max_total, budget_bytes=pool_budget))
    burst = [EngineRequest(rid=f"burst{i}",
                           prompt=corpus.sample_tokens(rng, 1, 256),
                           arrival_t=0.0)
             for i in range(args.burst)]
    print(f"\nburst: {args.burst} concurrent requests into a shared pool "
          f"sized for ~2 dense requests ({pool_budget/1e6:.1f}MB total "
          f"budget)")
    rep = engine.run(burst)
    for r in rep.results:
        print(f"  {r.rid}: kept {int(r.mask.sum()):2d}/{len(r.mask)}  "
              f"queued {r.queue_delay_s*1e3:5.0f}ms  fits={r.fits}")
    print(f"engine: {rep.tokens_per_s:.1f} tok/s, pool peak "
          f"{rep.pool['peak_reserved_bytes']/1e6:.2f}MB of "
          f"{rep.pool['capacity_bytes']/1e6:.2f}MB "
          f"(never exceeded), frag {rep.pool['fragmentation']:.2f}")
    return {"kept": kept, "burst": rep}


if __name__ == "__main__":
    main()
