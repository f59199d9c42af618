"""Serving launcher: RAP-managed inference over a synthetic workload trace.

  python -m repro_torch.launch.serve --executor {local,paged} \
      --mode {structural,masked} [--bucket-quant pow2] --policy rl \
      --episodes 0 --requests 6 [--kv-dtype int8] \
      [--chunked-prefill | --max-prefill-tokens N] \
      [--budget-trace staircase]
  python -m repro_torch.launch.serve --serial --mode masked --requests 2

Boots the model (``--arch``: one of :data:`ARCHS` — the dense llama2-7b,
gemma-2b, glm4-9b, qwen3-14b and qwen1.5-32b, the vision-language
internvl2-1b (served text-only, as the JAX engine serves it), the MoE
olmoe-1b-7b and dbrx-132b, mamba2-370m or recurrentgemma-9b; the
encoder-decoder whisper-medium is refused by the engine, as in JAX;
``--smoke`` for its reduced config; random weights from ``--seed``),
builds the pruning policy — ``rl`` is the RAP controller (paper
Algorithm 3), its Q-network trained for ``--episodes`` episodes of the
pruning MDP (paper Algorithm 2: ``dqn.train`` over ``env.PruneEnv``, whose
GSI scoring forwards run on the card) or, with 0 episodes, seeded and
untrained; ``dense`` never prunes; the static baselines ``shortgpt``,
``mha_drop``, ``ffn_skip``, ``llmpruner`` (whose Taylor saliency takes one
forward and backward of the whole model on the card), ``oneshot`` and
``random`` score one removal order on the calibration batch, then prune in
it until each request fits — and serves an Azure-like workload
trace of (batch, prompt) requests. Two serving paths:

  * default — continuous batching through ``RAPEngine``: one shared KV
    pool with admission control, every in-flight request decoding together
    in horizons. ``--mode structural`` (the default) runs each request in
    its mask's retained-layer bucket (``--bucket-quant`` snaps masks onto a
    ladder of whole-layer buckets first; the paged executor floors
    ``none`` at ``layer``), ``--mode masked`` runs all layers with the mask
    as 0/1 gates. ``--executor local`` (the default) keeps dense slot caches
    and decodes through the dense decode kernel; ``--executor paged`` keeps
    a page pool and decodes through the paged decode kernel.
    ``--kv-dtype`` picks the KV precision (int8 slot caches are dequantized
    and fp8 slot caches cast before the kernel; int8/fp8 pages decode
    through the fused-dequant kernel) and ``--chunked-prefill`` (chunks of
    at most 64 tokens) or ``--max-prefill-tokens N`` turns on chunked
    prefill.
    ``--budget-trace`` makes the budget move while requests are served
    (DESIGN.md §11): running requests are preempted (state and KV spilled
    to the host) when it drops and resumed when it recovers, unless
    ``--no-enable-preemption``. The
    recurrent architectures serve on ``--executor local`` at the model
    dtype or on int8/fp8 slot caches (the local-attention ring
    quantized, the recurrent state f32) and prefill monolithically (their
    state has no positional frontier to resume from); the paged executor
    refuses them;
  * ``--serial`` — the one-shot ``RAPServer`` replay: each request alone,
    against its own budget from the trace, executed whether it fits or not.

Runs on the GPU; ``--device cpu`` runs the kernels' plain versions on the
CPU instead (for tests). Without a GPU and without ``--device cpu`` it
raises.

``--executor sharded --mesh DATAxMODEL|auto`` serves on a mesh of ranks
(masked mode): one process per card, every process running this same
command on the same seed, e.g.
``torchrun --nproc-per-node 4 -m repro_torch.launch.serve --executor
sharded --mesh 2x2 --mode masked``; without torchrun, a world of one
(``--mesh 1x1``). ``cuda`` runs NCCL, ``--device cpu`` gloo.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

ARCHS = ("llama2-7b", "gemma-2b", "glm4-9b", "qwen3-14b", "qwen1.5-32b",
         "internvl2-1b", "olmoe-1b-7b", "dbrx-132b", "mamba2-370m",
         "recurrentgemma-9b")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama2-7b",
                    help="architecture: " + ", ".join(ARCHS) + " "
                         "(whisper-medium raises the engine's "
                         "NotImplementedError: it serves decoder-only "
                         "models, as JAX's does)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced SMOKE config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--mode", choices=("structural", "masked"),
                    default="structural",
                    help="structural = each request runs its retained "
                         "layers (a group per bucket); masked = all layers, "
                         "the mask as per-slot 0/1 gates")
    ap.add_argument("--policy", default="rl",
                    help="pruning policy: rl | dense | shortgpt | llmpruner "
                         "| mha_drop | ffn_skip | oneshot | random (any "
                         "registered name)")
    ap.add_argument("--scheduler", choices=("fifo", "sjf", "priority"),
                    default="fifo")
    ap.add_argument("--executor", choices=("local", "paged", "sharded"),
                    default="local",
                    help="local = dense slot caches (dense decode kernel); "
                         "paged = a KV page pool with per-request page "
                         "tables (paged decode kernel); sharded = slot "
                         "groups on a mesh of ranks (masked mode; see "
                         "--mesh; one process per card under torchrun)")
    ap.add_argument("--mesh", default="auto",
                    help="sharded executor mesh as DATAxMODEL (e.g. 2x2) "
                         "over the world's ranks; 'auto' picks a "
                         "DP-majority mesh whose data axis divides --slots")
    ap.add_argument("--serial", action="store_true",
                    help="one-shot RAPServer replay instead of the engine")
    ap.add_argument("--episodes", type=int, default=0,
                    help="DQN training episodes before serving (0: a "
                         "seeded, untrained Q-network)")
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
    ap.add_argument("--kv-dtype", default="model",
                    choices=("model", "fp32", "bf16", "int8", "fp8", "auto"),
                    help="KV precision: 'model' stores at the model "
                         "dtype; int8/fp8 store quantized pages with one "
                         "scale per (page, kv head), dequantized inside the "
                         "decode kernel (about twice the pages of bf16 in "
                         "the same bytes); on slot caches int8 keeps one "
                         "scale per (token, kv head) and fp8 is a plain "
                         "cast; 'auto' picks int8 when the pool "
                         "cannot hold --slots dense batch-1 requests, else "
                         "the model dtype")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="prefill prompts in pow2 chunks, one chunk per "
                         "engine tick between decode horizons, so a long "
                         "prompt cannot stall running decodes; the chunk cap "
                         "is 64 tokens unless --max-prefill-tokens is given")
    ap.add_argument("--max-prefill-tokens", type=int, default=0,
                    help="chunked prefill: prompts prefill in pow2 chunks of "
                         "at most this many tokens, one chunk per engine "
                         "tick between decode horizons (implies "
                         "--chunked-prefill; 0 = monolithic unless "
                         "--chunked-prefill is set)")
    ap.add_argument("--budget-trace", choices=("none", "workload",
                                               "staircase"),
                    default="none",
                    help="time-varying budget: 'workload' replays the "
                         "trace's memory-availability walk (each request's "
                         "budget_frac is a breakpoint); 'staircase' cuts half "
                         "the KV headroom for the middle half of the trace "
                         "and restores it; 'none' serves the static budget")
    ap.add_argument("--enable-preemption", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="preempt running requests when the budget trace "
                         "drops (--no-enable-preemption: only new "
                         "admissions are gated)")
    ap.add_argument("--bucket-quant", choices=("none", "layer", "pow2"),
                    default="none",
                    help="structural bucket quantization (DESIGN.md §9): "
                         "snap decision masks onto whole-layer buckets before "
                         "minting one — the exact mask runs as 0/1 gates "
                         "inside it, with the same tokens — so an adaptive "
                         "policy mints a bounded set; 'pow2' bounds it at "
                         "ceil(log2 L)+1 layouts. The paged executor floors "
                         "'none' at 'layer'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv: Optional[List[str]] = None) -> Tuple[object, object]:
    """Parse ``argv``, serve, print the report; returns (engine, report)."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.chunked_prefill and args.max_prefill_tokens <= 0:
        args.max_prefill_tokens = 64
    if args.serial and args.executor != "local":
        ap.error(f"--executor {args.executor} drives the batching engine; "
                 f"drop --serial")
    from repro_torch.launch import resolve_device
    device = resolve_device(args.device)
    if args.executor != "sharded":
        return _serve(ap, args, device)
    # the world first: under torchrun it picks this rank's card, which the
    # model's weights are then drawn on; torn down here if started here
    import torch.distributed as dist

    from repro_torch.launch.mesh import destroy_distributed, init_distributed
    started = not dist.is_initialized()
    init_distributed(device)
    try:
        return _serve(ap, args, device)
    finally:
        if started:
            destroy_distributed()


def _serve(ap, args, device):
    """Build the model, the policy and the engine's trace; serve and print
    the report; returns (engine, report) — or the one-shot server's
    (server, [ServeResult]) under ``--serial``."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import dqn, env as env_lib, masks, memory, workload
    from repro_torch.core.controller import RAPController
    from repro_torch.core.policy import available_policies, make_policy
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.runtime import (EngineConfig, EngineRequest,
                                     LocalExecutor, PagedExecutor, RAPEngine,
                                     ShardedExecutor, staircase_trace,
                                     workload_budget_trace)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    RAPEngine.check_servable(cfg)       # before any model or policy is built
    print(f"model {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype} on {device}")
    model = registry.build(cfg)
    params = model.init(args.seed, device)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    calib = {k: torch.from_numpy(v).to(device)
             for k, v in corpus.batch(2, 64, split="calib").items()}
    mm = memory.build_memory_model(cfg)

    wl = workload.WorkloadConfig(seed=args.seed, max_batch=8,
                                 short_len=(32, 128), long_len=(128, 512),
                                 long_frac=0.3)
    if args.policy == "rl" and args.episodes > 0:
        print(f"training RAP controller ({args.episodes} episodes)...")
        t0 = time.perf_counter()
        e = env_lib.PruneEnv(model, params, calib, mm)
        tr = dqn.train(lambda: e, episodes=args.episodes,
                       request_sampler=workload.request_sampler(wl, mm),
                       seed=args.seed)
        train_s = time.perf_counter() - t0
        print(f"  reward: first={tr.episode_rewards[0]:.3f} "
              f"last={tr.episode_rewards[-1]:.3f} "
              f"fit-rate={np.mean(tr.episode_fits):.2f}")
        print(f"  {len(tr.losses)} TD updates, {e.forwards} scoring forwards, "
              f"{train_s:.1f} s ({train_s / args.episodes:.2f} s/episode)")
        policy = make_policy("rl", controller=RAPController(
            model, params, calib, mm, tr.q_params))
    elif args.policy == "rl":
        L = cfg.n_layers
        qp = dqn.init_qnet(torch.Generator().manual_seed(args.seed),
                           2 * L + 4, 2 * L + 1, 32)
        policy = make_policy("rl", controller=RAPController(
            model, params, calib, mm, qp))
    else:
        print(f"building static policy {args.policy!r} "
              f"(available: {', '.join(available_policies())})")
        policy = make_policy(args.policy, model=model, params=params,
                             calib=calib, mm=mm, seed=args.seed)

    reqs = workload.generate(wl)[: args.requests]
    rng = np.random.default_rng(args.seed)
    if args.serial:
        return _serve_serial(args, model, params, policy, mm, corpus, reqs,
                             rng)
    max_total = args.max_prompt + args.max_new
    full = masks.full_mask(cfg.n_layers)
    slots = max(args.slots, *(r.batch for r in reqs))
    max_b = max(r.batch for r in reqs)
    budget = (mm.param_bytes(full)
              + args.pool_requests * mm.state_bytes(full, max_b, max_total))
    kv_dtype = None if args.kv_dtype == "model" else args.kv_dtype
    if kv_dtype == "auto":
        # one pool holds one precision, so it is chosen once, here: quantize
        # when the pool cannot host the decode slots densely at model width
        kv_cap = budget - mm.param_bytes(full)
        dense_req = mm.state_bytes(full, 1, max_total)
        kv_dtype = "int8" if kv_cap < slots * dense_req else None
        print(f"--kv-dtype auto → {kv_dtype or 'model precision'} "
              f"(pool {kv_cap / 1e6:.1f}MB vs {slots} dense requests "
              f"{slots * dense_req / 1e6:.1f}MB)")
    if args.executor == "sharded":
        mesh = _sharded_mesh(ap, args, slots, device)
        print(f"sharded mesh: {dict(mesh.shape)} over {mesh.size} of "
              f"{torch.distributed.get_world_size()} ranks")
        executor = ShardedExecutor(model, mesh, params=params,
                                   mode=args.mode, max_active=slots,
                                   kv_dtype=kv_dtype)
    else:
        make = PagedExecutor if args.executor == "paged" else LocalExecutor
        executor = make(model, params, mode=args.mode, max_active=slots,
                        kv_dtype=kv_dtype, bucket_quant=args.bucket_quant)
    engine = RAPEngine(model, params, policy, EngineConfig(
        mode=args.mode, bucket_quant=args.bucket_quant,
        max_new_tokens=args.max_new, max_active=slots,
        max_len=max_total, budget_bytes=budget, kv_dtype=kv_dtype,
        decode_horizon=args.decode_horizon,
        budget_quantum_frac=args.budget_quantum,
        max_prefill_tokens=args.max_prefill_tokens,
        preemption_enabled=args.enable_preemption),
        scheduler=args.scheduler, executor=executor)
    ereqs = []
    for i, r in enumerate(reqs):
        sql = min(r.seq_len, args.max_prompt)
        prompt = corpus.sample_tokens(rng, r.batch, sql)
        ereqs.append(EngineRequest(rid=f"req{i}", prompt=prompt,
                                   arrival_t=r.t - reqs[0].t,
                                   priority=0 if sql <= 128 else 1))
    # a moving budget: breakpoints on the engine's virtual clock
    trace = None
    if args.budget_trace == "workload":
        trace = [(t - reqs[0].t, b) for t, b in
                 workload_budget_trace(reqs, budget)]
    elif args.budget_trace == "staircase":
        span = max(ereqs[-1].arrival_t, 0.2)
        # cut half the KV headroom, not of the total: params stay resident,
        # and half the total would leave no pool at all
        kv = budget - mm.param_bytes(full)
        shocked = (mm.param_bytes(full) + 0.5 * kv) / budget
        trace = staircase_trace(budget, 0.25 * span, 0.75 * span,
                                frac=shocked)
    if trace is not None:
        print(f"budget trace: {args.budget_trace} ({len(trace)} breakpoints, "
              f"{min(b for _, b in trace) / 1e9:.3f}–"
              f"{max(b for _, b in trace) / 1e9:.3f} GB), preemption "
              f"{'on' if args.enable_preemption else 'off'}")
    print(f"engine[{policy.name}/{args.scheduler}/{args.executor}]: "
          f"{len(ereqs)} "
          f"requests (batch {min(r.batch for r in reqs)}–{max_b}), {slots} "
          f"slots, budget {budget / 1e9:.3f} GB (params "
          f"{mm.param_bytes(full) / 1e9:.3f} GB)")
    rep = engine.run(ereqs, budget_trace=trace)
    for r in rep.results:
        if r.status == "done":
            print(f"{r.rid}: kept {int(r.mask.sum())}/{len(r.mask)} blocks  "
                  f"queue {r.queue_delay_s * 1e3:.0f}ms  "
                  f"decide {r.decide_s * 1e3:.0f}ms"
                  f"{' (memo)' if r.cached_decision else ''}  "
                  f"ttft {r.ttft_s * 1e3:.0f}ms  fits={r.fits}"
                  f"{f'  bucket {len(r.bucket)} layers' if r.bucket else ''}")
        else:
            print(f"{r.rid}: {r.status.upper()} ({r.reason})")
    print(f"engine: {rep.tokens_per_s:.1f} tok/s, {rep.generated_tokens} "
          f"tokens, {rep.decode_iters} decode iters, mean queue "
          f"{rep.mean_queue_delay_s * 1e3:.0f}ms, fit-rate "
          f"{rep.budget_fit_rate:.2f}")
    if trace is not None:
        print(f"preemption: {rep.preempted_count} preempted, "
              f"{rep.spilled_mb:.2f}MB spilled, resume p50/p99 "
              f"{rep.resume_latency.get('p50', 0.0) * 1e3:.0f}/"
              f"{rep.resume_latency.get('p99', 0.0) * 1e3:.0f}ms, "
              f"preempted-request itl p99 "
              f"{rep.itl_preempted.get('p99', 0.0) * 1e3:.2f}ms, "
              f"{len(rep.budget_events)} budget events")
    if rep.ttft.get("count"):
        print(f"latency: ttft p50/p99 {rep.ttft['p50'] * 1e3:.1f}/"
              f"{rep.ttft['p99'] * 1e3:.1f}ms, itl p50/p99 "
              f"{rep.itl['p50'] * 1e3:.2f}/{rep.itl['p99'] * 1e3:.2f}ms")
    kv_name = (engine.pool.effective_kv_dtype() if executor.paged
               else str(executor.kv_dtype).replace("torch.", ""))
    print(f"pool: {int(rep.pool['n_pages'])} pages "
          f"({'physical' if executor.paged else 'accounting'}), KV in "
          f"{kv_name or cfg.dtype}, peak "
          f"{rep.pool['peak_reserved_bytes'] / 1e6:.2f}MB of "
          f"{rep.pool['capacity_bytes'] / 1e6:.2f}MB, frag "
          f"{rep.pool['fragmentation']:.2f}, measured frag "
          f"{rep.measured_frag:.2f}, overcommits "
          f"{int(rep.pool['overcommit_events'])}")
    print("bucket stats:", executor.stats())
    return engine, rep


def _sharded_mesh(ap, args, slots: int, device):
    """The ``--mesh`` of ``--executor sharded`` over the running world
    (torchrun's ranks, else a world of one): 'auto' the DP-majority serve
    mesh; DATAxMODEL exactly that mesh, an error when the world has
    another size, a warning when the data axis does not divide the
    slots."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
    if args.mesh == "auto":
        return make_serve_mesh(slots, device=device)
    try:
        d, m = (int(x) for x in args.mesh.lower().split("x"))
    except ValueError:
        ap.error(f"--mesh must be DATAxMODEL (e.g. 2x2), got {args.mesh!r}")
    world = dist.get_world_size()
    if d * m != world:
        ap.error(f"--mesh {args.mesh} needs {d * m} ranks, the world has "
                 f"{world} (torchrun --nproc-per-node {d * m})")
    if slots % d != 0:
        # serve_state_pspecs replicates the slot axis then: every data rank
        # decodes every slot, no DP sharding
        print(f"WARNING: data axis {d} does not divide {slots} slots — the "
              f"slot axis will replicate instead of sharding (pick --slots "
              f"a multiple of {d}, or --mesh auto)")
    return make_host_mesh((d, m), ("data", "model"), device=device)


def _serve_serial(args, model, params, policy, mm, corpus, reqs, rng):
    """One request at a time through ``RAPServer``, each against its own
    budget (the trace's fraction of its dense peak); returns (server,
    [ServeResult])."""
    from repro_torch.runtime import RAPServer
    server = RAPServer(model, params, policy, mode=args.mode,
                        max_new_tokens=args.max_new,
                        kv_dtype=None if args.kv_dtype == "model"
                        else args.kv_dtype)
    results = []
    for i, r in enumerate(reqs):
        sql = min(r.seq_len, args.max_prompt)
        prompt = corpus.sample_tokens(rng, r.batch, sql)
        budget = r.budget_frac * mm.dense_peak(r.batch, sql + args.max_new)
        res = server.serve(prompt, budget)
        results.append(res)
        print(f"req {i}: bs={r.batch} sql={sql} budget={r.budget_frac:.2f} "
              f"→ kept {int(res.mask.sum())}/{len(res.mask)} blocks, peak "
              f"{res.peak_bytes / 1e6:.1f}MB fits={res.fits} decide "
              f"{res.decide_s * 1e3:.0f}ms infer {res.infer_s:.2f}s"
              f"{' (new slot group)' if res.compiled_new else ''}")
    print("server stats:", server.stats())
    return server, results


if __name__ == "__main__":
    main()
