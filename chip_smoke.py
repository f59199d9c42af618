#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one GPU

Phases, each fatal on failure:

  1. build    — compile every CUDA kernel of the serving path from
                ``src/repro_torch/kernels/csrc`` into one library (one nvcc
                per source, in parallel, then one link) and print the
                card's name and power limit;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card at llama2-7b's shapes plus GQA, softcap and band cases,
                in f32 (TF32 off) and bf16, each with its stated tolerance;
                time kernel, plain version and (flash attention) the
                ``scaled_dot_product_attention`` yardstick, and work out
                each kernel's bound from its bytes and operations;
  3. reference — a small model through the kernels on the card against the
                same model through the plain versions on the CPU, and a
                warmed decode horizon under
                ``torch.cuda.set_sync_debug_mode("error")`` (no host sync
                inside the horizon);
  4. serve    — ``repro_torch.launch.serve`` with llama2-7b at full width
                (bf16, random weights from the seed, all 32 layers), paged
                executor, masked mode, RL policy with an untrained Q-net:
                every request done, at least one block pruned, zero
                overcommits, pool peak within capacity, every kernel's
                launch counter raised during the serve.

The line before the last is the ``{"kernels": [...]}`` JSON; the last line
is ``{"ok": true, "device": {...}}``. Without a GPU, or without the rest of
the repository beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
            "torch.float32": 67e12}  # dense tensor bf16 / non-tensor f32
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events, with the 50 MB L2
    flushed before every launch (the main path finds its operands cold)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def max_err(out, ref) -> float:
    return float((out.float() - ref.float()).abs().max())


def check(name: str, out, ref, dtype) -> float:
    import torch
    tol = TOL[str(dtype)]
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol)
    print(f"  {name}: max|Δ| {err:.3e} (atol=rtol={tol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max|Δ| {err})")
    return err


# ------------------------------------------------------------- kernel cases
def glu_cases(torch, ops, swiglu):
    g = torch.Generator(device="cuda").manual_seed(1)
    F = 11008
    errs = {}
    for T, act, dt in [(8, "swiglu", torch.float32), (256, "swiglu", torch.float32),
                       (8, "swiglu", torch.bfloat16), (2048, "swiglu", torch.bfloat16),
                       (37, "geglu", torch.bfloat16), (37, "geglu", torch.float32)]:
        h = torch.randn(T, 2 * F, generator=g, device="cuda").to(dt)
        errs[(T, act, str(dt))] = check(
            f"fused_glu T={T} F={F} {act} {dt}", ops.fused_glu(h, act),
            swiglu.glu_ref(h, act), dt)
    T, dt = 2048, torch.bfloat16           # prefill of 8×256 tokens
    h = torch.randn(T, 2 * F, generator=g, device="cuda").to(dt)
    es = h.element_size()
    bms, by = bound_ms(3 * T * F * es, 5 * T * F, torch.float32)
    return {"name": "fused_glu", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swiglu.cu",
            "replaces": "src/repro/kernels/swiglu.py:35",
            "max_abs_err": errs[(T, "swiglu", str(dt))],
            "ms": time_ms(lambda: swiglu.fused_glu_cuda(h, "swiglu")),
            "plain_ms": time_ms(lambda: swiglu.glu_ref(h, "swiglu")),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"h [{T}, {2 * F}] {dt}"}


def paged_inputs(torch, B, H, K, D, pt, max_len, dt, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    maxp = -(-max_len // pt)
    n_pages = B * maxp + 5
    lengths = torch.randint(1, max_len + 1, (B,), generator=g,
                            dtype=torch.int32)
    lengths[0] = max_len
    table = torch.randperm(n_pages, generator=g)[: B * maxp].reshape(
        B, maxp).to(torch.int32)
    q = torch.randn(B, 1, H, D, generator=g).to(dt)
    kp = torch.randn(n_pages, pt, K, D, generator=g).to(dt)
    vp = torch.randn(n_pages, pt, K, D, generator=g).to(dt)
    return [t.cuda() for t in (q, kp, vp, table, lengths)]


def paged_cases(torch, ops, pdec):
    errs = {}
    cases = [(1, 32, 32, 128, 16, 512, 0.0, torch.float32),
             (8, 32, 32, 128, 16, 512, 0.0, torch.float32),
             (8, 32, 32, 128, 16, 512, 0.0, torch.bfloat16),
             (1, 32, 32, 128, 16, 300, 0.0, torch.bfloat16),
             (4, 32, 8, 128, 16, 200, 0.0, torch.float32),     # GQA G=4
             (4, 32, 8, 128, 16, 200, 0.0, torch.bfloat16),
             (3, 8, 2, 64, 16, 96, 30.0, torch.float32)]       # softcap
    for i, (B, H, K, D, pt, S, cap, dt) in enumerate(cases):
        q, kp, vp, table, lengths = paged_inputs(torch, B, H, K, D, pt, S,
                                                 dt, seed=10 + i)
        errs[i] = check(
            f"paged_decode B={B} H={H} K={K} D={D} pt={pt} len<={S} "
            f"cap={cap} {dt}",
            ops.paged_decode_attention(q, kp, vp, table, lengths,
                                       softcap=cap),
            pdec.paged_decode_attention_ref(q, kp, vp, table, lengths,
                                            softcap=cap), dt)
    B, H, K, D, pt, S, dt = 8, 32, 32, 128, 16, 512, torch.bfloat16
    q, kp, vp, table, lengths = paged_inputs(torch, B, H, K, D, pt, S, dt, 12)
    es = q.element_size()
    toks = int(lengths.sum())
    nbytes = (2 * q.numel() * es + 2 * toks * K * D * es
              + table.numel() * 4 + lengths.numel() * 4)
    bms, by = bound_ms(nbytes, 4 * toks * H * D, dt)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:117",
            "max_abs_err": errs[2],
            "ms": time_ms(lambda: pdec.paged_decode_attention_cuda(
                q, kp, vp, table, lengths)),
            "plain_ms": time_ms(lambda: pdec.paged_decode_attention_ref(
                q, kp, vp, table, lengths)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={B} H=K={H} D={D} pt={pt} ragged len<={S} "
                     f"({toks} tokens) {dt}"}


def flash_cases(torch, ops, fa):
    g = torch.Generator(device="cuda").manual_seed(3)
    errs = {}
    cases = [(1, 256, 32, 32, 128, 0, 0.0, torch.float32),
             (2, 100, 32, 32, 128, 0, 0.0, torch.float32),     # ragged Sq
             (1, 256, 32, 32, 128, 0, 0.0, torch.bfloat16),
             (2, 64, 32, 8, 128, 0, 0.0, torch.bfloat16),      # GQA G=4
             (1, 200, 8, 2, 64, 48, 0.0, torch.float32),       # band
             (1, 96, 8, 4, 64, 0, 30.0, torch.float32),        # softcap
             (1, 130, 4, 4, 256, 0, 0.0, torch.bfloat16)]      # D=256
    for i, (B, S, H, K, D, w, cap, dt) in enumerate(cases):
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        errs[i] = check(
            f"flash_attention B={B} S={S} H={H} K={K} D={D} window={w} "
            f"cap={cap} {dt}",
            ops.flash_attention(q, k, v, window=w, softcap=cap),
            fa.attention_ref(q, k, v, window=w, softcap=cap), dt)
    B, S, H, D, dt = 8, 256, 32, 128, torch.bfloat16     # prefill 8×256
    q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
               for _ in range(3))
    err = check(f"flash_attention B={B} S={S} H={H} D={D} {dt}",
                fa.flash_attention_cuda(q, k, v), fa.attention_ref(q, k, v),
                dt)
    es = q.element_size()
    pairs = S * (S + 1) // 2
    bms, by = bound_ms(4 * q.numel() * es, 4 * B * H * D * pairs, dt)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            "max_abs_err": err,
            "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v)),
            "plain_ms": time_ms(lambda: fa.attention_ref(q, k, v)),
            "bound_ms": bms, "bound_by": by,
            "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True)),
            "shape": f"B={B} S={S} H=K={H} D={D} causal {dt}"}


# ---------------------------------------------------------------- phases
def reference_phase(torch) -> None:
    """Small fp32 model: kernels on the card vs plain versions on the CPU;
    then a warmed horizon with host syncs turned into errors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decoder, registry
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    model = registry.build(cfg)
    cpu_params = model.init(0, "cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(5))
    pt, npg = 16, 4
    outs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        logits, cache = decoder.prefill(p, cfg, toks.to(dev), npg * pt)
        n_pages = 2 * npg + 1
        shape = (cfg.n_layers, n_pages, pt, cfg.n_kv_heads, cfg.dh)
        pools = {"k": torch.zeros(shape, device=dev),
                 "v": torch.zeros(shape, device=dev)}
        table = torch.arange(2 * npg, dtype=torch.int32,
                             device=dev).reshape(2, npg)
        for name in ("k", "v"):
            pools[name][:, table.long()] = cache["attn"][name].reshape(
                cfg.n_layers, 2, npg, pt, cfg.n_kv_heads, cfg.dh)
        pos = torch.full((2,), 40, dtype=torch.int32, device=dev)
        first = torch.argmax(logits, -1).to(torch.int32)[:, None]
        h_toks, _, _ = decoder.paged_decode_horizon(p, cfg, pools, table, pos,
                                                    first, 8)
        outs[dev] = (logits.cpu(), h_toks.cpu())
    err = max_err(outs["cuda"][0], outs["cpu"][0])
    print(f"  reference: prefill logits max|Δ| card vs CPU {err:.2e}; "
          f"horizon tokens equal: "
          f"{bool(torch.equal(outs['cuda'][1], outs['cpu'][1]))}")
    if err > 1e-3 or not torch.equal(outs["cuda"][1], outs["cpu"][1]):
        raise AssertionError("the card's path disagrees with the CPU "
                             "reference")
    # warmed horizon: no host synchronisation inside the decode loop
    decoder.paged_decode_horizon(gpu_params, cfg, pools, table, pos, first, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decoder.paged_decode_horizon(gpu_params, cfg, pools, table, pos,
                                     first, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  warmed decode horizon ran with sync debug mode 'error': no "
          "host sync")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_phase(torch, ops, card: str) -> dict:
    from repro_torch.launch import serve
    L = 32
    argv = ["--arch", "llama2-7b", "--executor", "paged", "--mode", "masked",
            "--policy", "rl", "--episodes", "0", "--requests", "6",
            "--decode-horizon", "8", "--max-new", "8", "--seed", "0",
            "--budget-quantum", "0.3"]
    print(f"  serve argv: {' '.join(argv)}")
    ops.reset_launches()
    t0 = time.perf_counter()
    engine, rep = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    cfg = engine.mcfg
    if (cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab_size) != (
            4096, 32, 11008, 32000) or cfg.n_layers != L:
        raise AssertionError(f"not llama2-7b at full width: {cfg}")
    done = [r for r in rep.results if r.status == "done"]
    pruned = [r for r in done if r.mask.sum() < 2 * L]
    for r in done:
        if r.tokens.shape[1] != 8 or not ((r.tokens >= 0)
                                          & (r.tokens < cfg.vocab_padded)).all():
            raise AssertionError(f"{r.rid}: bad tokens {r.tokens}")
    pool = rep.pool
    print(f"  depth {cfg.n_layers} layers; done {len(done)}/"
          f"{len(rep.results)}; pruned requests {len(pruned)} "
          f"(blocks kept: {[int(r.mask.sum()) for r in done]}); overcommits "
          f"{int(pool['overcommit_events'])}; pool peak "
          f"{pool['peak_reserved_bytes'] / 1e9:.3f} of "
          f"{pool['capacity_bytes'] / 1e9:.3f} GB")
    print(f"  launches during serve: {counts}")
    if (len(done) != len(rep.results) or not pruned
            or pool["overcommit_events"] != 0
            or pool["peak_reserved_bytes"] > pool["capacity_bytes"]
            or min(counts.values()) < 1):
        raise AssertionError("serve phase failed its checks")
    decides = [r.decide_s * 1e3 for r in done if not r.cached_decision]
    summary = {"card": card, "layers": cfg.n_layers, "requests": len(done),
               "generated_tokens": rep.generated_tokens,
               "tok_per_s": rep.tokens_per_s, "wall_s": wall,
               "ttft_ms": {k: rep.ttft[k] * 1e3 for k in ("p50", "p99")},
               "itl_ms": {k: rep.itl[k] * 1e3 for k in ("p50", "p99")},
               "decide_ms": decides,
               "decide_s_total": sum(r.decide_s for r in done),
               "launch_s": rep.launch_s, "launches": counts,
               "decode_iters": rep.decode_iters}
    print(f"  serve [{card}]: {rep.tokens_per_s:.2f} tok/s over "
          f"{rep.generated_tokens} tokens; ttft p50/p99 "
          f"{summary['ttft_ms']['p50']:.1f}/{summary['ttft_ms']['p99']:.1f} "
          f"ms; itl p50/p99 {summary['itl_ms']['p50']:.2f}/"
          f"{summary['itl_ms']['p99']:.2f} ms; decide ms "
          f"{[round(d, 1) for d in decides]}; of {wall:.1f} s wall, decide "
          f"{summary['decide_s_total']:.1f} s, prefill + decode launches and "
          f"read-backs {rep.launch_s:.1f} s")
    print("serve: " + json.dumps(summary))
    return counts


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(src/repro_torch not found beside this file)")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import swiglu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    lib = build.build()
    print(f"build: {len(build.SOURCES)} kernel sources with nvcc in "
          f"{time.perf_counter() - t0:.1f} s -> {lib}")

    print("kernels vs plain versions:")
    entries = [paged_cases(torch, ops, pdec), glu_cases(torch, ops, swiglu),
               flash_cases(torch, ops, fa)]
    for e in entries:
        print(f"  {e['name']} @ {e['shape']} [{card}]: kernel "
              f"{e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}), library "
              f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)} ms")
    print("reference:")
    reference_phase(torch)
    print("serve:")
    counts = serve_phase(torch, ops, card)
    for e in entries:
        e["launches"] = counts[e["name"]]
    print(f"device: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
