"""Serving launcher: RAP-managed inference over a synthetic workload trace.

  python -m repro_torch.launch.serve --executor paged --mode masked \
      --policy rl --episodes 0 --requests 6

Boots the model (random weights from ``--seed``), builds the pruning
policy — ``rl`` is the RAP controller (paper Algorithm 3) with a seeded,
untrained Q-network; ``dense`` never prunes — and serves an Azure-like
workload trace of (batch, prompt) requests through the continuous-batching
engine: one shared KV page pool with admission control, every in-flight
request decoding together in horizons.

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead (for tests). Without a GPU and without ``--device cpu`` it
raises. Training the controller (``--episodes > 0``), structural mode, the
slot and sharded executors and the static baselines are later slices
(ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced SMOKE config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--mode", choices=("structural", "masked"),
                    default="masked")
    ap.add_argument("--policy", default="rl", help="rl | dense")
    ap.add_argument("--scheduler", choices=("fifo", "sjf", "priority"),
                    default="fifo")
    ap.add_argument("--executor", choices=("local", "paged", "sharded"),
                    default="paged")
    ap.add_argument("--episodes", type=int, default=0,
                    help="DQN training episodes (training is a later slice: "
                         "only 0 is served)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-prompt", type=int, default=256,
                    help="prompts are cut to this many tokens")
    ap.add_argument("--slots", type=int, default=4,
                    help="engine decode slots (concurrent rows)")
    ap.add_argument("--decode-horizon", type=int, default=8,
                    help="decode tokens per engine macro-tick, read back "
                         "once per horizon")
    ap.add_argument("--pool-requests", type=float, default=2.5,
                    help="KV pool sized for this many concurrent dense "
                         "requests of the largest batch")
    ap.add_argument("--budget-quantum", type=float, default=0.05,
                    help="admission grid: the budget the policy sees is "
                         "floored to a multiple of this fraction of the "
                         "request's dense peak (EngineConfig."
                         "budget_quantum_frac). In masked mode the paged "
                         "pool stores every layer, so a request that fits "
                         "its pages fits its dense peak; only this floor "
                         "makes the policy prune there")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Tuple[object, object]:
    """Parse ``argv``, serve, print the report; returns (engine, report)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.executor != "paged":
        raise NotImplementedError(
            f"--executor {args.executor}: the slot and sharded executors are "
            f"ROADMAP queue 1, items 9 and 16")
    if args.mode != "masked":
        raise NotImplementedError("--mode structural is ROADMAP queue 1, "
                                  "item 8")
    if args.episodes > 0:
        raise NotImplementedError(
            "--episodes > 0: DQN training (dqn.train, env.PruneEnv, "
            "optim/adamw.py) is ROADMAP queue 1, item 3")

    import numpy as np
    import torch

    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass --device cpu to "
                               "run the plain versions on the CPU")
        device = torch.device(args.device)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import dqn, masks, memory, workload
    from repro_torch.core.controller import RAPController
    from repro_torch.core.policy import make_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.runtime import (EngineConfig, EngineRequest,
                                     PagedExecutor, RAPEngine)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype} on {device}")
    model = registry.build(cfg)
    params = model.init(args.seed, device)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    calib = {k: torch.from_numpy(v).to(device)
             for k, v in corpus.batch(2, 64, split="calib").items()}
    mm = memory.build_memory_model(cfg)

    if args.policy == "rl":
        L = cfg.n_layers
        qp = dqn.init_qnet(torch.Generator().manual_seed(args.seed),
                           2 * L + 4, 2 * L + 1, 32)
        policy = make_policy("rl", controller=RAPController(
            model, params, calib, mm, qp))
    else:
        policy = make_policy(args.policy, mm=mm)

    wl = workload.WorkloadConfig(seed=args.seed, max_batch=8,
                                 short_len=(32, 128), long_len=(128, 512),
                                 long_frac=0.3)
    reqs = workload.generate(wl)[: args.requests]
    rng = np.random.default_rng(args.seed)
    max_total = args.max_prompt + args.max_new
    full = masks.full_mask(cfg.n_layers)
    slots = max(args.slots, *(r.batch for r in reqs))
    max_b = max(r.batch for r in reqs)
    budget = (mm.param_bytes(full)
              + args.pool_requests * mm.state_bytes(full, max_b, max_total))
    executor = PagedExecutor(model, params, max_active=slots)
    engine = RAPEngine(model, params, policy, EngineConfig(
        mode="masked", max_new_tokens=args.max_new, max_active=slots,
        max_len=max_total, budget_bytes=budget,
        decode_horizon=args.decode_horizon,
        budget_quantum_frac=args.budget_quantum),
        scheduler=args.scheduler, executor=executor)
    ereqs = []
    for i, r in enumerate(reqs):
        sql = min(r.seq_len, args.max_prompt)
        prompt = corpus.sample_tokens(rng, r.batch, sql)
        ereqs.append(EngineRequest(rid=f"req{i}", prompt=prompt,
                                   arrival_t=r.t - reqs[0].t,
                                   priority=0 if sql <= 128 else 1))
    print(f"engine[{policy.name}/{args.scheduler}/paged]: {len(ereqs)} "
          f"requests (batch {min(r.batch for r in reqs)}–{max_b}), {slots} "
          f"slots, budget {budget / 1e9:.3f} GB (params "
          f"{mm.param_bytes(full) / 1e9:.3f} GB)")
    rep = engine.run(ereqs)
    for r in rep.results:
        if r.status == "done":
            print(f"{r.rid}: kept {int(r.mask.sum())}/{len(r.mask)} blocks  "
                  f"queue {r.queue_delay_s * 1e3:.0f}ms  "
                  f"decide {r.decide_s * 1e3:.0f}ms"
                  f"{' (memo)' if r.cached_decision else ''}  "
                  f"ttft {r.ttft_s * 1e3:.0f}ms  fits={r.fits}")
        else:
            print(f"{r.rid}: {r.status.upper()} ({r.reason})")
    print(f"engine: {rep.tokens_per_s:.1f} tok/s, {rep.generated_tokens} "
          f"tokens, {rep.decode_iters} decode iters, mean queue "
          f"{rep.mean_queue_delay_s * 1e3:.0f}ms, fit-rate "
          f"{rep.budget_fit_rate:.2f}")
    if rep.ttft.get("count"):
        print(f"latency: ttft p50/p99 {rep.ttft['p50'] * 1e3:.1f}/"
              f"{rep.ttft['p99'] * 1e3:.1f}ms, itl p50/p99 "
              f"{rep.itl['p50'] * 1e3:.2f}/{rep.itl['p99'] * 1e3:.2f}ms")
    print(f"pool: peak {rep.pool['peak_reserved_bytes'] / 1e6:.2f}MB of "
          f"{rep.pool['capacity_bytes'] / 1e6:.2f}MB, frag "
          f"{rep.pool['fragmentation']:.2f}, measured frag "
          f"{rep.measured_frag:.2f}, overcommits "
          f"{int(rep.pool['overcommit_events'])}")
    return engine, rep


if __name__ == "__main__":
    main()
