#!/usr/bin/env python3
"""Find what, if anything, makes a preempted request's tokens differ from
an unshocked run's on one NVIDIA GPU.

    python3 tools/shock_divergence.py [--configs paged_bf16,local]
        [--slots 8] [--pool-requests 5] [--requests 12]

Under a budget shock a request steps in a decode batch of another width
than it would unshocked (victims leave, the occupied slots fall into a
smaller bucket of ``decode_buckets``). Two things on the card could depend
on that width: the decode kernels' split count (``ref.decode_splits``,
which the executors now give the group's slot width, ``split_rows``) and
cuBLAS's choice of GEMM kernel by M. This tool prints one JSON line per
finding, with the card's name and power limit:

* ``gemm``: for llama2-7b's decode GEMMs (bf16), whether row 0 of ``x[:M]
  @ w`` is bitwise the same at M = 1, 2, 3, 4 and 8;
* ``decode``: how many of 8 rows of the paged and the dense decode
  kernels differ, launched 8 at a time against 4 and 1 at a time (f32
  and bf16, llama2-7b's heads, ragged lengths up to 272), and the splits
  each launch takes;
* ``shock``: ``chip_smoke.py``'s shock trace (llama2-7b at full width,
  DensePolicy, 12 requests, 8 slots, a pool of 5 requests of 272 tokens;
  other counts by the options) unshocked and shocked, per executor and in
  three variants: as the port runs it, with the split count taken from
  each launch's rows instead of the slot width, and with every horizon
  stepped at the full slot width (``decode_buckets=()``); the token
  agreement (``token_agreement``: the first diverging token and its logit
  margin).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def gemm_rows(torch) -> list:
    g = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for name, (k, n) in {"wq": (4096, 4096), "wi": (4096, 22016),
                         "wo_ffn": (11008, 4096),
                         "lm_head": (4096, 32000)}.items():
        x = torch.randn(8, k, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn(k, n, generator=g, device="cuda")
             / k ** 0.5).to(torch.bfloat16)
        ref = (x[:8] @ w)[0]
        out.append({name: {m: bool(torch.equal((x[:m] @ w)[0], ref))
                           for m in (1, 2, 3, 4)}})
    return out


def decode_rows(torch) -> dict:
    """Rows of the paged and the dense decode kernels launched 8 at a time
    against the same rows launched 4 and 1 at a time, in f32 and bf16:
    how many of the 8 rows differ bitwise, and by how much at most."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels.ref import decode_splits
    g = torch.Generator().manual_seed(1)
    B, H, K, D, pt, S = 8, 32, 32, 128, 16, 272
    maxp = S // pt
    q0 = torch.randn(B, 1, H, D, generator=g)
    kp0 = torch.randn(B * maxp, pt, K, D, generator=g)
    vp0 = torch.randn(B * maxp, pt, K, D, generator=g)
    table = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp).cuda()
    lengths = torch.tensor([S - 7, 60, 130, 200, 17, 250, 99, 180],
                           dtype=torch.int32).cuda()
    valid = torch.arange(S, device="cuda")[None, :] < lengths[:, None]
    res = {"splits": {b: decode_splits(b, K, S, build.sm_count(
        torch.device("cuda"))) for b in (1, 4, 8)}}
    for dt in (torch.float32, torch.bfloat16):
        q, kp, vp = (t.to(dt).cuda() for t in (q0, kp0, vp0))
        kd = kp[table.long()].reshape(B, S, K, D)
        vd = vp[table.long()].reshape(B, S, K, D)
        for name, run in (
                ("paged", lambda r: pdec.paged_decode_attention_cuda(
                    q[r], kp, vp, table[r], lengths[r])),
                ("dense", lambda r: dec.decode_attention_cuda(
                    q[r], kd[r], vd[r], valid[r]))):
            ref = run(slice(0, 8))
            for width in (4, 1):
                got = torch.cat([run(slice(i, i + width))
                                 for i in range(0, 8, width)])
                diff = (got.float() - ref.float()).abs().flatten(1)
                res[f"{name} {str(dt)[6:]} B={width} vs B=8"] = {
                    "rows_differing": int((diff.amax(1) > 0).sum()),
                    "max_abs": float(diff.max())}
    return res


@contextlib.contextmanager
def splits_from_launch():
    """The decode kernels' split count from the launch's own rows, as
    before the executors passed their slot width (``split_rows``)."""
    from repro_torch.kernels import decode_attention as dec
    orig = dec.split_rows_of
    dec.split_rows_of = lambda B, split_rows: B
    try:
        yield
    finally:
        dec.split_rows_of = orig


def shock_runs(torch, configs, slots: int, pool_requests: float,
               n_requests: int) -> list:
    from chip_smoke import shock_requests
    from repro_torch.configs import get_config
    from repro_torch.core import masks, memory
    from repro_torch.core.policy import DensePolicy
    from repro_torch.models import registry
    from repro_torch.runtime import (EngineConfig, LocalExecutor,
                                     PagedExecutor, RAPEngine, TickStaircase,
                                     token_agreement)
    cfg = get_config("llama2-7b")
    model = registry.build(cfg)
    params = model.init(0, "cuda")
    mm = memory.build_memory_model(cfg)
    reqs = shock_requests(cfg, n_requests)
    full = masks.full_mask(cfg.n_layers)
    max_len = 256 + 16
    budget = mm.param_bytes(full) + pool_requests * mm.state_bytes(
        full, 1, max_len)
    kinds = {"paged_bf16": ("paged", None), "paged_int8": ("paged", "int8"),
             "local": ("local", None)}
    out = []
    for conf in configs:
        kind, kv = kinds[conf]
        for variant in ("as_is", "splits_from_launch", "full_width"):
            buckets = () if variant == "full_width" else (1, 2, 4, 8)
            reps = []
            ctx = (splits_from_launch() if variant == "splits_from_launch"
                   else contextlib.nullcontext())
            with ctx:
                for shock in (False, True):
                    make = PagedExecutor if kind == "paged" else LocalExecutor
                    eng = RAPEngine(model, params, DensePolicy(mm),
                                    EngineConfig(
                                        mode="masked", max_new_tokens=16,
                                        max_active=slots, max_len=max_len,
                                        budget_bytes=budget,
                                        tokens_per_page=16, kv_dtype=kv,
                                        decode_horizon=4,
                                        decode_buckets=buckets),
                                    executor=make(model, params,
                                                  max_active=slots,
                                                  kv_dtype=kv,
                                                  decode_buckets=buckets))
                    kvb = budget - eng.resident_param_bytes
                    cut = 0.75 if kv else 0.5
                    frac = (eng.resident_param_bytes
                            + (1 - cut) * kvb) / budget
                    trace = (TickStaircase(budget, [(3, 1.0), (6, frac),
                                                    (0, 1.0)])
                             if shock else None)
                    reps.append(eng.run(reqs, budget_trace=trace))
            out.append({"config": conf, "variant": variant, "slots": slots,
                        "pool_requests": pool_requests,
                        "requests": n_requests,
                        "preempted": reps[1].preempted_count,
                        "agreement": token_agreement(model, params, reqs,
                                                     reps[0], reps[1])})
            print(json.dumps({"shock": out[-1]}), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="paged_bf16,local")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pool-requests", type=float, default=5.0)
    ap.add_argument("--requests", type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("shock_divergence: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import card_line
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(json.dumps({"card": card, "gemm": gemm_rows(torch)}), flush=True)
    print(json.dumps({"card": card, "decode": decode_rows(torch)}),
          flush=True)
    shock_runs(torch, args.configs.split(","), args.slots,
               args.pool_requests, args.requests)


if __name__ == "__main__":
    main()
