#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py      # needs one GPU

Phases, each fatal on failure:

  1. build    — compile every CUDA kernel of the serving path from
                ``src/repro_torch/kernels/csrc`` into one library (one nvcc
                per source, in parallel, then one link) and print the
                card's name and power limit;
  2. kernels  — hold each kernel against its plain PyTorch version on the
                card at the serves' shapes plus GQA, softcap and band cases,
                in f32 (TF32 off) and bf16 (flash also fp16), each with its
                stated tolerance (the fused-dequant paged decode on int8
                and fp8 pages, and bitwise against the model-dtype kernel on
                dequantized pages with f32 q); time kernel, plain version
                and (attention) the ``scaled_dot_product_attention``
                yardstick, and work out each kernel's bound from its bytes
                and operations; flash is timed at the prefill, GSI scoring
                and recurrentgemma shapes (``FLASH_TIMED``). The dense
                decode kernel (the slot path's) is held against its plain
                version with per-row ``[B, S]`` and shared ``[S]`` masks,
                GQA, softcap, ring masks (recurrentgemma's G=16, D=256 among
                them) and a ragged cache length, and bitwise against the
                paged kernel on pages holding the same tokens (f32 q, prefix
                mask) at shapes of one and of several splits, and each
                decode body launched twice for the same bits; the three
                decode bodies are timed at ``DECODE_TIMED`` (llama2-7b at
                B=8 and B=1, recurrentgemma-9b), event and device-only,
                sdpa beside the dense one. The scan kernels ``ssd``
                (mamba2: tile and chunk edges, and the ``SSD_TIMED``
                shapes: prefill, GSI scoring, batch 1, a ragged three-chunk
                sequence, each launched twice for the same bits and timed
                event and device-only) and ``rglru`` (recurrentgemma: its
                prefill shape, a ragged length, batch 1) are held in f32 at
                3e-4 and 2e-5; the fused GLU at llama2-7b's and
                recurrentgemma-9b's widths and an odd one, timed at
                ``GLU_TIMED`` (llama prefill and scoring, recurrentgemma's
                GeGLU prefill), event and device-only;
  3. reference — a small model through the kernels on the card against the
                same model through the plain versions on the CPU: paged
                with a model-dtype and an int8 page pool, the slot path
                (``[B]`` positions, ``[L, B]`` gates) with a model-dtype and
                an int8 slot cache, and small mamba2 and recurrentgemma
                models past their chunk and window; warmed decode horizons
                of every path under ``torch.cuda.set_sync_debug_mode("error")``
                (no host sync inside the horizon);
  4. serve    — ``repro_torch.launch.serve`` with llama2-7b at full width
                (bf16, random weights from the seed, all 32 layers), paged
                executor, masked mode, RL policy with an untrained Q-net:
                every request done, at least one block pruned, zero
                overcommits, pool peak within capacity, the model-dtype
                path's kernels launched during the serve;
  5. serve 2  — the same serve with ``--kv-dtype int8
                --max-prefill-tokens 64``: the same checks, an int8 pool of
                at least 1.8x serve 1's pages, and every decode launch on
                the fused-dequant kernel;
  6. serve 3  — the same serve with ``--executor local`` (dense slot
                caches): serve 1's checks, every decode launch on the dense
                decode kernel and none on the paged ones;
  7. serve 4  — ``--executor local --serial``: two one-shot ``RAPServer``
                serves (force admission, pow2 slot groups), each returning
                8 tokens in range through the dense decode kernel;
  8. serve 5  — serve 3 with ``--arch mamba2-370m`` (48 layers, d_model
                1024, state 128) and a pool of one batch-8 request: serve
                1's checks, and every launch an ``ssd`` launch, 48 per
                forward;
  9. serve 6  — serve 3 with ``--arch recurrentgemma-9b`` (38 layers,
                d_model 4096, vocab 256000, 8.6B parameters): serve 1's
                checks, and the launches the layout implies (26 ``rglru``,
                12 flash and 38 GLU per forward; 12 dense decode and 38 GLU
                per decode step), none paged;
 10. serve 7  — serve 1 with ``--episodes 6``: the RAP controller is
                trained first (DQN over ``PruneEnv``, whose GSI scoring
                forwards run on the card): every episode fits, rewards and
                losses finite, at least one TD update, and 32 flash and 32
                GLU launches per scoring forward and no other launch during
                training; then serve 1's checks for the trained controller;
 11. serve 8  — serve 1 with ``--mode structural --bucket-quant pow2``:
                each request runs in its mask's retained-layer bucket
                (whole layers, pow2 row counts, the exact mask as gates):
                serve 1's checks, a bucket on every pruned request, at most
                ceil(log2 32) + 1 = 6 bucket signatures, and every kernel
                launched once per row of the layout each call ran (flash
                and GLU per prefill row, paged decode and GLU per
                decode-step row). On serve 1's grid the policy keeps more
                than 16 layers, which pow2 rounds up to all 32; so the same
                trace runs again on a grid of 0.6 (the policy cuts about
                40% of the peak) in ``--bucket-quant layer`` buckets, which
                must hold a bucket of fewer than 32 layers (fewer than 32
                launches per prefill);
 9b. serve 6 int8 / fp8 — serve 6 with ``--kv-dtype int8`` and with
                ``--kv-dtype fp8`` (the local-attention ring quantized, the
                RG-LRU state f32): serve 1's checks, the ring in that
                precision, the launches the layout implies and exactly
                those of the decoder's recorded calls (12 dense decode
                launches a decode step), wall, tok/s and peak beside
                serve 6's;
 12. serve 9  — serve 6 (recurrentgemma-9b, slot caches) with ``--mode
                structural`` (exact buckets: rows without a mixer or an
                FFN): serve 1's checks, the launches each call's layout
                implies (``rglru``, flash, dense decode, GLU), none paged;
 13. shock    — ``scenarios.run_budget_shock`` on llama2-7b at full width
                (DensePolicy, 12 requests, 8 slots) on paged bf16 pages,
                paged int8 pages and ``--executor local`` slot caches:
                preemptions and spilled MB > 0, completions in the shock and
                after it, the pool drained, the token agreement with the
                unshocked run (printed, not gated; the decode kernels take
                their split from the slot width, so the rows a request
                steps with do not change its sums), and one request's pages
                and scale rows through spill → restore bitwise; then
                ``run_cancellation_storm`` on paged bf16: at least a quarter
                cancelled, no live request, no leaked page;
 14. grads    — (after the kernels) the gradients of a loss through each
                forward kernel (``ops.KernelGrad``: flash in f32 and bf16
                with GQA, a window, a softcap and recurrentgemma's width;
                the GLU in swiglu and geglu; ``ssd``; ``rglru``) against
                the plain version's autograd on the card (``GRAD_TOL``),
                one launch each; every decode kernel refuses an input
                that requires grad;
 15. serve 10 — serve 1 with ``--policy llmpruner``: the Taylor order is
                one forward and backward of the whole model (32 flash and
                32 GLU launches), its saliency finite for all 64 blocks,
                then serve 1's checks;
 16. serve 11 — serve 1 in structural mode with ``--policy shortgpt
                --bucket-quant layer``: serve 8's checks (the cosine
                probe's own launches apart) and a bucket under 32 layers;
 17. train    — ``launch.train --smoke`` for 20 steps, rerun to 40: it
                resumes from step 20; llama2-7b at full width and 2
                layers (bf16 params, f32 moments; B = 4, S = 256, remat):
                6 steps, and 3 with an async checkpoint that a fresh
                ``Trainer`` restores and runs to 6 — losses bitwise equal
                under ``torch.use_deterministic_algorithms``; ms a step,
                tokens/s, peak memory, the checkpoint's bytes and write
                time, launches a step; then ``benchmarks.common.subject()``
                (RAP_SUBJECT, 300 steps) with its held-out ppl; then the
                paper's experiments over that subject
                (``repro_torch.benchmarks.run``: tables 1, 2 and 4,
                figures 3, 4, 6, 9, 10 and 11, their DQN policies trained
                on the card): every number finite, RAP's and the mask
                baselines' masks fit (FFN-Skip's cannot, and is reported),
                the Dense row's ppl the subject's, flash and GLU launched.
                The checkpoint directories are removed;
 18. serves 12-16 — serve 1 with 3 requests on gemma-2b, glm4-9b,
                qwen3-14b, qwen1.5-32b (full width, depth cut to 48 of 64
                layers in-process: its bf16 weights would not leave room
                for a pool on one card) and internvl2-1b (text-only):
                every request done and pruned, no overcommit, flash, GLU
                and paged decode launched exactly as the layouts of the
                decoder's calls imply; then serve 3 on fp8 slot caches
                (``--kv-dtype fp8``): the same checks through the dense
                decode kernel;
 19. MoE and whisper — serve 1 with 3 requests on olmoe-1b-7b (full
                width and depth) and dbrx-132b (full width, depth cut
                in-process to the most layers that fit: ``dbrx_depth``):
                every request done and pruned, no overcommit, launches
                exactly as the layouts imply (one GLU per MoE layer: the
                expert buffer); whisper-medium at full width: prefill of 4
                rows of random frames and greedy decode of 16 tokens on a
                bf16 and an int8 self cache (flash non-causal in the
                encoder and the cross-attention, the dense decode kernel
                for the self and the cross decode), held to the launches
                the calls imply; three training steps through
                ``launch.train --arch whisper-medium`` (finite losses,
                half of all elements and a tenth of every leaf moved,
                remat's launches); ``launch.serve --arch
                whisper-medium`` raises the engine's NotImplementedError;
                then the U1 probe (ROADMAP queue 3): the same three
                training steps with f32 params, printing the share of
                ``stacks/cross/wq`` and of all elements that moved;
 20. demo     — ``examples/kernels_demo_torch.py``'s ``main`` in this
                process on the card: every kernel launched once, each
                within its tolerance of its plain version.

The reference phase also serves a small fp32 trace (TF32 off) with and
without a budget shock on paged f32 and int8 pools and on slot caches:
tokens must be equal. Its structural runs hold small f32 models on the card
against the same models on the CPU, tokens equal: two requests whose masks
drop different layers (one bucket signature, two gather keys) on both
executors, a structural paged int8 trace under a budget shock, and a small
mamba2 trace through half-pruned layouts. Its training run holds three
SMOKE f32 train steps (remat) on the card against the CPU, and
``taylor_saliency`` and ``block_cosines`` likewise. It also holds the SMOKE
models of gemma-2b, glm4-9b, qwen3-14b, qwen1.5-32b and internvl2-1b (the
last with ``vision_embeds`` too) on the card against the CPU, logits and
greedy tokens, and an fp8 slot-cache trace likewise; and the SMOKE
models of olmoe-1b-7b and dbrx-132b (logits, the experts chosen and the
assignments dropped, paged decode tokens) and whisper-medium (prefill on
frames and three decode steps). The kernel phase checks flash, GLU and
both decode bodies at those architectures' widths: flash non-causal at
whisper's encoder and cross shapes (1500 frames), the GLU on the MoE's 3-D
expert buffer, decode at whisper's self and cross shapes and at dbrx's
G = 6. For the quantized recurrent slot caches it holds recurrentgemma and
mamba2 SMOKE in f32 on an int8 ring, card against CPU (logits, and a
shocked engine trace whose tokens equal the CPU's and the unshocked run's;
mamba2's equal its model-dtype tokens), and the one-call decode surfaces
(``decode_horizon``/``decode`` on both executors, ``SlotGroup.
decode_horizon``/``decode_once``) bitwise against ``decode_launch``/
``decode_finish``; the kernel phase runs the dense decode kernel on
recurrentgemma's wrapped ring stored in int8 and in fp8 and dequantized.

Multi-GPU (the sharded executor, the mesh trainer) runs here on the one
card as the degenerate 1 x 1 mesh, a real NCCL world of one, torn down
after each phase: serve 3 and the same argv with ``--executor sharded
--mesh 1x1`` on a clock that advances per reading (``TickClock``: the
trace's admissions then do not depend on the card's speed), whose tokens,
masks and kernel launches must be equal, and ``--mesh auto`` giving the
same mesh; a warmed sharded horizon launched under
``torch.cuda.set_sync_debug_mode("error")`` up to its one read-back; in
the reference phase, a sharded 1 x 1 SMOKE f32 trace under a shock with
the CPU's local tokens, ``moe_ffn_ep`` on a model group of one bitwise
``moe_ffn_scatter`` (the GLU kernel on the expert buffer), and
``compress_allreduce`` bitwise the CPU's quantizer; and ``launch.train
--mesh`` (llama2-7b full width, 2 layers, 3 steps, in a child process
under deterministic algorithms) with the meshless run's losses bit for
bit, one ``make_compressed_train_step`` step, and a ``remesh`` onto the
same mesh that leaves the state bitwise.

Analysis (``repro_torch.launch.dryrun``, ``ShardedExecutor.lower_decode``,
``launch.rap_sweep``, ``repro_torch.roofline``): two production-mesh cells
counted on a fake world of 256 ranks on this host (qwen3-14b decode_32k,
gemma-2b train_4k: the ``"fake"`` backend on this torch), their roofline
rows printed; then llama2-7b at full width (32 layers, bf16) on the 1 x 1
mesh at ``CARD_DECODE`` (batch 8, a full random cache of 4096): the step's
logits through the kernels against the same step through their plain
versions, in f32 at 2 layers (elementwise) and in bf16 at 32 (no further
from them than PyTorch's own sdpa and GLU ops), then ``lower_decode``'s
record beside 20 real decode steps timed with CUDA events (the wall,
host-bound) and 5 under
``torch.profiler`` (the device's busy time, which the roofline share
divides). The record's kernel calls must equal the real steps' launches,
and its counted peak must lie within ``PEAK_TOL`` of
``max_memory_allocated`` over the steps; the RAP sweep (``RAP_FRACS``:
32, 26 and 19 layers) prints its predicted bound ratios beside the
measured device-busy (and wall) ratios, each within ``SWEEP_TOL`` of its
prediction.

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
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent

BASE_ARGV = ["--arch", "llama2-7b", "--mode", "masked", "--policy", "rl",
             "--episodes", "0", "--max-new", "8", "--seed", "0"]
SERVE_ARGV = BASE_ARGV + ["--executor", "paged", "--requests", "6",
                          "--decode-horizon", "8", "--budget-quantum", "0.3"]
SERVE2_ARGV = SERVE_ARGV + ["--kv-dtype", "int8", "--max-prefill-tokens",
                            "64"]
SERVE3_ARGV = BASE_ARGV + ["--executor", "local", "--requests", "6",
                           "--decode-horizon", "8", "--budget-quantum", "0.3"]
SERVE4_ARGV = BASE_ARGV + ["--executor", "local", "--serial", "--requests",
                           "2"]
# serve 3's arguments on the two recurrent architectures. mamba2-370m's
# fixed SSM state is a third of its dense peak at batch 8 (0.41 of 1.15 GB),
# so a pool of 2.5 such requests lets every request fit unpruned: a pool of
# one makes the batch-8 request prune even with nothing else reserved
SERVE5_ARGV = ([a if a != "llama2-7b" else "mamba2-370m" for a in SERVE3_ARGV]
               + ["--pool-requests", "1.0"])
SERVE6_ARGV = [a if a != "llama2-7b" else "recurrentgemma-9b"
               for a in SERVE3_ARGV]
# serve 1 with the controller trained first: 6 episodes of the pruning
# MDP bring the replay buffer past its batch of 64 transitions at seed 0
SERVE7_ARGV = [("6" if prev == "--episodes" else a)
               for prev, a in zip([None] + SERVE_ARGV, SERVE_ARGV)]
# structural mode: serve 1 in pow2 whole-layer buckets, and serve 6 in exact
# buckets (heterogeneous layouts with half-pruned rows)
SERVE8_ARGV = SERVE_ARGV + ["--mode", "structural", "--bucket-quant", "pow2"]
# serve 8 on an admission grid of 0.6 in whole-layer buckets: the grid of
# 0.3 keeps too many blocks for pow2 to leave any layer out
SERVE8_LAYER_ARGV = [("0.6" if prev == "--budget-quantum" else a)
                     for prev, a in zip([None] + SERVE_ARGV, SERVE_ARGV)] + [
    "--mode", "structural", "--bucket-quant", "layer"]
SERVE9_ARGV = SERVE6_ARGV + ["--mode", "structural"]
# serve 6 on quantized slot caches: recurrentgemma-9b's local-attention ring
# in int8 (per-(token, head) scales) or fp8 (a plain cast); its RG-LRU
# state stays f32
SERVE6_QUANT_ARGV = {kv: SERVE6_ARGV + ["--kv-dtype", kv]
                     for kv in ("int8", "fp8")}
# the static baselines on serve 1's trace: LLMPruner's Taylor order (one
# forward and backward of the whole model), and ShortGPT's whole-layer
# order in structural layer buckets
SERVE10_ARGV = [("llmpruner" if prev == "--policy" else a)
                for prev, a in zip([None] + SERVE_ARGV, SERVE_ARGV)]
SERVE11_ARGV = [("shortgpt" if prev == "--policy" else a)
                for prev, a in zip([None] + SERVE_ARGV, SERVE_ARGV)] + [
    "--mode", "structural", "--bucket-quant", "layer"]
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2, "torch.float16": 2e-2}
# the dense decoder's other architectures: each served at full width
# (serves 12-16), its reference twin at SMOKE size; qwen1.5-32b's 64 layers
# of bf16 weights (~70 GB) leave no room for a pool and the scoring forward
# on one 80 GB card, so its serve cuts the depth to 48 layers (~54 GB)
NEW_ARCHS = ("gemma-2b", "glm4-9b", "qwen3-14b", "qwen1.5-32b",
             "internvl2-1b")
NEW_ARCH_DEPTH = {"qwen1.5-32b": 48}
NEW_ARCH_ARGV = {arch: [{"llama2-7b": arch}.get(a, a) if prev != "--requests"
                        else "3" for prev, a in zip([None] + SERVE_ARGV,
                                                    SERVE_ARGV)]
                 for arch in NEW_ARCHS}
# serve 3 on fp8 slot caches: a plain cast on store and load
SERVE_FP8_SLOT_ARGV = SERVE3_ARGV + ["--kv-dtype", "fp8"]
# serve 3 on the sharded executor: a 1 x 1 mesh, an NCCL world of one
SERVE3_SHARDED_ARGV = SERVE3_ARGV + ["--executor", "sharded", "--mesh", "1x1"]
SERVE3_AUTO_ARGV = SERVE3_ARGV + ["--executor", "sharded", "--mesh", "auto",
                                  "--requests", "2"]
# the MoE decoders: serve 1 with 3 requests at full width (dbrx-132b cut in
# depth, in-process, to the most layers that fit: ``dbrx_depth``)
MOE_ARCHS = ("olmoe-1b-7b", "dbrx-132b")
MOE_ARGV = {arch: [{"llama2-7b": arch}.get(a, a) if prev != "--requests"
                   else "3" for prev, a in zip([None] + SERVE_ARGV,
                                               SERVE_ARGV)]
            for arch in MOE_ARCHS}
# room dbrx's serve leaves beside its weights: the pool, the scoring and
# prefill transients (expert buffers, logits), the allocator's slack
DBRX_HEADROOM_BYTES = 12e9
# whisper-medium at full width: prefill of a batch of random frames, then
# greedy decode; three training steps through the launcher
WHISPER = {"batch": 4, "prompt": 32, "new": 16}
# --lr: the schedule warms up over 100 steps, so at the default 3e-4 a
# step moves a bf16 weight by less than half its last place and nearly
# every update rounds away; at 3e-2 a step moves it by up to 3e-4 to 9e-4,
# more than half the last place of any weight under 0.125
WHISPER_TRAIN_ARGV = ["--arch", "whisper-medium", "--steps", "3",
                      "--batch", "4", "--seq", "64", "--lr", "3e-2"]


def new_arch_shapes() -> dict:
    """Each new architecture's kernel widths at full size: attention (H,
    K, D) and the FFN (d_ff, GLU activation)."""
    from repro_torch.configs import get_config
    out = {}
    for arch in NEW_ARCHS:
        c = get_config(arch)
        out[arch] = (c.n_heads, c.n_kv_heads, c.dh, c.d_ff,
                     "geglu" if c.activation == "geglu" else "swiglu")
    return out


def moe_whisper_shapes() -> dict:
    """The MoE decoders' and whisper-medium's kernel widths at full size:
    attention (H, K, D), and for the MoE the expert buffer of a GSI scoring
    call of 1024 tokens in one group, (E, C + 1, d_ff)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    out = {}
    for arch in MOE_ARCHS + ("whisper-medium",):
        c = get_config(arch)
        out[arch] = (c.n_heads, c.n_kv_heads, c.dh,
                     (c.n_experts, moe._capacity(c, 1024) + 1, c.d_ff)
                     if c.n_experts else None)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(cost) -> tuple:
    """(ms, what bounds it) of one kernel call (``kernels.ref.Cost``, from
    the kernel module's ``cost()``): its bytes over the card's HBM rate or
    its operations over the peak of their type (``launch.mesh``'s
    data-sheet figures), the larger."""
    from repro_torch.launch.mesh import HBM_BW, peak_flops
    t_bytes = cost.bytes / HBM_BW * 1e3
    t_ops = cost.flops / peak_flops(cost.op_dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3,
            hide_launch: bool = False) -> float:
    """Mean device time of ``fn`` from CUDA events, with the 50 MB L2
    flushed before every launch (the main path finds its operands cold).
    The events also hold whatever of the host's launch overhead the flush
    does not cover; ``hide_launch`` queues ``fn`` behind a 0.1 ms spin, so
    that only the device's own time is left."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if hide_launch:
            torch.cuda._sleep(200_000)
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
# the shapes the fused GLU is timed at, rows, F, activation: llama2-7b's
# monolithic prefill of 8 x 256 (the headline, comparable across PRs), its
# GSI scoring forward (2 calibration rows x 8 candidates of 64 tokens) and
# recurrentgemma-9b's GeGLU prefill (8 x 264 tokens)
GLU_TIMED = {"prefill": (2048, 11008, "swiglu"),
             "scoring": (1024, 11008, "swiglu"),
             "recurrentgemma": (2112, 12288, "geglu"),
             # dbrx-132b's expert buffer of a 1024-token scoring call,
             # [16, 321, 2 x 10752], as its 5136 rows
             "dbrx_experts": (16 * 321, 10752, "swiglu")}


def glu_timing(torch, swiglu, g, T, F, act) -> dict:
    """The fused GLU on random bf16 ``h [T, 2F]``, held against its plain
    version, then timed: event (``ms``) and device-only (``busy_ms``) ms,
    the plain version's ms and the byte bound."""
    dt = torch.bfloat16
    h = torch.randn(T, 2 * F, generator=g, device="cuda").to(dt)
    shape = f"h [{T}, {2 * F}] {act} {dt}"
    err = check(f"timed fused_glu {shape}", swiglu.fused_glu_cuda(h, act),
                swiglu.glu_ref(h, act), dt)
    bms, by = bound_ms(swiglu.cost(h, act))
    return {"max_abs_err": err,
            "ms": time_ms(lambda: swiglu.fused_glu_cuda(h, act)),
            "busy_ms": time_ms(lambda: swiglu.fused_glu_cuda(h, act),
                               hide_launch=True),
            "plain_ms": time_ms(lambda: swiglu.glu_ref(h, act)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": shape}


def glu_cases(torch, ops, swiglu):
    """The fused GLU at llama2-7b's and recurrentgemma-9b's widths (the
    vector path) and at an odd width (the element path), f32 and bf16;
    timed at the ``GLU_TIMED`` shapes, llama's prefill the headline."""
    g = torch.Generator(device="cuda").manual_seed(1)
    for T, F, act, dt in [(8, 11008, "swiglu", torch.float32),
                          (256, 11008, "swiglu", torch.float32),
                          (8, 11008, "swiglu", torch.bfloat16),
                          (37, 11008, "geglu", torch.bfloat16),
                          (37, 11008, "geglu", torch.float32),
                          (264, 12288, "geglu", torch.bfloat16),
                          (5, 11007, "swiglu", torch.bfloat16)] + [
            (T, F, act, dt) for _, _, _, F, act in new_arch_shapes().values()
            for T, dt in ((8, torch.float32), (264, torch.bfloat16))]:
        h = torch.randn(T, 2 * F, generator=g, device="cuda").to(dt)
        check(f"fused_glu T={T} F={F} {act} {dt}", ops.fused_glu(h, act),
              swiglu.glu_ref(h, act), dt)
    # the MoE's expert buffer [E, C+1, 2F], a 3-D input
    for arch, (_, _, _, (E, rows, F)) in (
            (a, v) for a, v in moe_whisper_shapes().items() if v[3]):
        for dt in (torch.float32, torch.bfloat16):
            h = torch.randn(E, rows, 2 * F, generator=g,
                            device="cuda").to(dt)
            check(f"fused_glu {arch} expert buffer [{E}, {rows}, {2 * F}] "
                  f"{dt}", ops.fused_glu(h), swiglu.glu_ref(h), dt)
    timed = {name: glu_timing(torch, swiglu, g, *shape)
             for name, shape in GLU_TIMED.items()}
    return {"name": "fused_glu", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swiglu.cu",
            "replaces": "src/repro/kernels/swiglu.py:35",
            **timed.pop("prefill"), **timed}


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


# the shapes the three decode bodies are timed at, B, H, K, D, max_len:
# llama2-7b's decode at B=8 (ragged lengths, 2398 tokens: the headline,
# comparable across PRs) and at B=1 (one full row of 512), and
# recurrentgemma-9b's (16 heads on one kv head of 256, ragged up to its
# cache of 264)
DECODE_TIMED = {"llama": (8, 32, 32, 128, 512),
                "llama_b1": (1, 32, 32, 128, 512),
                "recurrentgemma": (8, 16, 1, 256, 264)}


def decode_calls(torch, dec, pdec, attention, B, H, K, D, S) -> dict:
    """The three decode bodies on the same tokens: bf16 pages of 16 tokens
    (``paged_inputs`` seed 12: ragged lengths, row 0 full), int8 pages of
    them with bf16 q, and a contiguous bf16 cache of the table's width with
    per-row prefix masks. Per body: the kernel and plain calls, its
    kernel module's ``cost()`` on these inputs (the bytes the function must
    move, its operations) and a shape label; ``sdpa``: the
    ``scaled_dot_product_attention`` call (boolean mask) for the dense
    body."""
    pt, dt = 16, torch.bfloat16
    q, kp, vp, table, lengths = paged_inputs(torch, B, H, K, D, pt, S,
                                             torch.float32, 12)
    kq, ks = attention.page_quant(kp, torch.int8)
    vq, vs = attention.page_quant(vp, torch.int8)
    q, kp, vp = q.to(dt), kp.to(dt), vp.to(dt)
    n = table.shape[1] * pt
    kd = kp[table.long()].reshape(B, n, K, D)
    vd = vp[table.long()].reshape(B, n, K, D)
    rows = torch.arange(n, device="cuda")[None, :] < lengths[:, None]
    toks = int(lengths.sum())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kd, vd))
    gqa = {"enable_gqa": True} if K < H else {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = (f"B={B} H={H} K={K} D={D} ragged len<={S} ({toks} tokens), "
             f"q {dt}")
    return {
        "paged": (lambda: pdec.paged_decode_attention_cuda(
                      q, kp, vp, table, lengths),
                  lambda: pdec.paged_decode_attention_ref(
                      q, kp, vp, table, lengths),
                  pdec.cost(q, kp, vp, table, lengths),
                  f"{shape}, bf16 pages of {pt}"),
        "quant": (lambda: pdec.paged_decode_attention_quant_cuda(
                      q, kq, vq, ks, vs, table, lengths),
                  lambda: pdec.paged_decode_attention_quant_ref(
                      q, kq, vq, ks, vs, table, lengths),
                  pdec.cost_quant(q, kq, vq, ks, vs, table, lengths),
                  f"{shape}, int8 pages of {pt}"),
        "dense": (lambda: dec.decode_attention_cuda(q, kd, vd, rows),
                  lambda: dec.decode_attention_ref(q, kd, vd, rows),
                  dec.cost(q, kd, vd, rows),
                  f"{shape}, cache of {n}, per-row prefix masks"),
        "sdpa": lambda: sdpa(qt, kt, vt, attn_mask=rows[:, None, None, :],
                             **gqa)}


def decode_timing(torch, dec, pdec, attention, B, H, K, D, S) -> dict:
    """``decode_calls`` timed: per body the event time (``ms``), the
    device-only time (``busy_ms``, host launch hidden), the plain version's
    time and the bound; sdpa as the dense body's ``library_ms`` (and
    ``library_busy_ms``). Each body is first held against its plain
    version on the inputs it is timed on."""
    calls = decode_calls(torch, dec, pdec, attention, B, H, K, D, S)
    out = {}
    for body in ("paged", "quant", "dense"):
        kernel, plain, cost, shape = calls[body]
        check(f"timed {body} decode {shape}", kernel(), plain(),
              torch.bfloat16)
        bms, by = bound_ms(cost)
        out[body] = {"ms": time_ms(kernel),
                     "busy_ms": time_ms(kernel, hide_launch=True),
                     "plain_ms": time_ms(plain), "bound_ms": bms,
                     "bound_by": by, "library_ms": None, "shape": shape}
    out["dense"]["library_ms"] = time_ms(calls["sdpa"])
    out["dense"]["library_busy_ms"] = time_ms(calls["sdpa"],
                                              hide_launch=True)
    return out


def timed_entry(timed: dict, body: str) -> dict:
    """A decode kernel's numbers: the llama shape's as the headline, the
    other ``DECODE_TIMED`` shapes as keys of their own."""
    return {**timed["llama"][body],
            **{name: t[body] for name, t in timed.items() if name != "llama"}}


def paged_cases(torch, ops, pdec, timed):
    errs = {}
    cases = [(1, 32, 32, 128, 16, 512, 0.0, torch.float32),
             (8, 32, 32, 128, 16, 512, 0.0, torch.float32),
             (8, 32, 32, 128, 16, 512, 0.0, torch.bfloat16),
             (1, 32, 32, 128, 16, 300, 0.0, torch.bfloat16),
             (4, 32, 8, 128, 16, 200, 0.0, torch.float32),     # GQA G=4
             (4, 32, 8, 128, 16, 200, 0.0, torch.bfloat16),
             (3, 8, 2, 64, 16, 96, 30.0, torch.float32)]       # softcap
    # the new architectures' widths: G = 8, 16, 5, 1 (40 kv heads), 7
    for H, K, D, _, _ in new_arch_shapes().values():
        cases += [(4, H, K, D, 16, 300, 0.0, torch.float32),
                  (4, H, K, D, 16, 300, 0.0, torch.bfloat16)]
    # the MoE decoders' (dbrx: G = 6) and whisper's widths
    for H, K, D, _ in moe_whisper_shapes().values():
        cases += [(4, H, K, D, 16, 300, 0.0, torch.float32),
                  (4, H, K, D, 16, 300, 0.0, torch.bfloat16)]
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
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:117",
            "max_abs_err": errs[2], **timed_entry(timed, "paged")}


def paged_quant_cases(torch, ops, pdec, attention, timed):
    """Fused-dequant paged decode: int8 and fp8 pages, q f32 and bf16, G=1
    and G=4, softcap, a length one past a page edge, and the serve's
    shape; each held against its plain version and, with f32 q, against
    the model-dtype kernel on ``page_dequant``-ed pages bitwise."""
    errs = {}
    # the serve's shape (G=1) uses the model-dtype kernel's timing inputs
    cases = [(8, 32, 32, 128, 16, 512, 0.0, 12),
             (4, 32, 8, 128, 16, 200, 0.0, 31),       # GQA G=4
             (3, 8, 2, 64, 16, 96, 30.0, 32),         # softcap
             (2, 32, 32, 128, 16, 17, 0.0, 33),       # one past a page edge
             (4, 48, 8, 128, 16, 300, 0.0, 34)]       # dbrx-132b: G = 6
    pdts = (torch.int8, torch.float8_e4m3fn)
    for i, (B, H, K, D, pt, S, cap, seed) in enumerate(cases):
        for pdt in pdts:
            q, kp, vp, table, lengths = paged_inputs(
                torch, B, H, K, D, pt, S, torch.float32, seed=seed)
            kq, ks = attention.page_quant(kp, pdt)
            vq, vs = attention.page_quant(vp, pdt)
            bit = torch.equal(
                ops.paged_decode_attention(q, kq, vq, table, lengths,
                                           k_scales=ks, v_scales=vs,
                                           softcap=cap),
                pdec.paged_decode_attention_cuda(
                    q, attention.page_dequant(kq, ks),
                    attention.page_dequant(vq, vs), table, lengths,
                    softcap=cap))
            print(f"  paged_decode_quant B={B} H={H} K={K} D={D} len<={S} "
                  f"cap={cap} {pdt}: f32 q equals the model-dtype kernel on "
                  f"dequantized pages bitwise: {bit}")
            if not bit:
                raise AssertionError("fused dequant is not bitwise equal to "
                                     "the kernel on dequantized pages")
            for dt in (torch.float32, torch.bfloat16):
                qd = q.to(dt)
                errs[(i, str(pdt), str(dt))] = check(
                    f"paged_decode_quant B={B} H={H} K={K} D={D} pt={pt} "
                    f"len<={S} cap={cap} {pdt} q {dt}",
                    ops.paged_decode_attention(qd, kq, vq, table, lengths,
                                               k_scales=ks, v_scales=vs,
                                               softcap=cap),
                    pdec.paged_decode_attention_quant_ref(
                        qd, kq, vq, ks, vs, table, lengths, softcap=cap), dt)
    # serve 2's decode: int8 pages, bf16 q
    return {"name": "paged_decode_attention_quant", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
            "replaces": "src/repro/kernels/paged_decode_attention.py:97",
            "max_abs_err": errs[(0, str(torch.int8), str(torch.bfloat16))],
            **timed_entry(timed, "quant")}


# the shapes flash attention is timed at: llama2-7b's monolithic prefill of
# 8 x 256 (the headline, comparable across PRs), a GSI scoring forward (2
# calibration rows x 8 candidates of 64 tokens) and recurrentgemma-9b's
# local attention (16 heads on one kv head of 256; its window of 2048 holds
# all 264 tokens, so causal sdpa computes the same function)
FLASH_TIMED = {"prefill": (8, 256, 32, 32, 128, 0),
               "scoring": (16, 64, 32, 32, 128, 0),
               "recurrentgemma": (8, 264, 16, 1, 256, 2048)}


def flash_calls(torch, fa, g, B, S, H, K, D, window, dt,
                causal=True) -> dict:
    """Random bf16/fp16 inputs at one ``FLASH_TIMED`` shape and three calls
    on them: the kernel, its plain version and the
    ``scaled_dot_product_attention`` yardstick (causal or not; GQA by
    ``enable_gqa``, on the head-major copies it takes)."""
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
            for _ in range(2))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = {"enable_gqa": True} if K < H else {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"kernel": lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal, window=window),
            "plain": lambda: fa.attention_ref(q, k, v, causal=causal,
                                              window=window),
            "library": lambda: sdpa(qt, kt, vt, is_causal=causal, **gqa)}


def flash_timing(torch, fa, g, B, S, H, K, D, window, dt,
                 causal=True) -> dict:
    calls = flash_calls(torch, fa, g, B, S, H, K, D, window, dt, causal)
    shape = (f"B={B} S={S} H={H} K={K} D={D} "
             f"{'causal' if causal else 'non-causal'}"
             f"{f' window={window}' if window else ''} {dt}")
    err = check(f"flash_attention {shape}", calls["kernel"](),
                calls["plain"](), dt)
    meta = lambda n: torch.empty(B, S, n, D, dtype=dt, device="meta")
    bms, by = bound_ms(fa.cost(meta(H), meta(K), meta(K), causal=causal,
                               window=window))
    return {"max_abs_err": err, "ms": time_ms(calls["kernel"]),
            "plain_ms": time_ms(calls["plain"]), "bound_ms": bms,
            "bound_by": by, "library_ms": time_ms(calls["library"]),
            "shape": shape}


def flash_cases(torch, ops, fa):
    """Flash attention at the serves' widths: f32 runs the kernel's FMA
    body, bf16 and fp16 its tensor-core body (64 x 64 tiles; the small
    tile-edge cases are in ``tests/test_torch_cuda.py``). Timed at the
    three ``FLASH_TIMED`` shapes; the prefill shape is the entry's
    headline, the other two ride as extra keys."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases = [(1, 256, 32, 32, 128, 0, 0.0, torch.float32),
             (2, 100, 32, 32, 128, 0, 0.0, torch.float32),     # ragged Sq
             (1, 256, 32, 32, 128, 0, 0.0, torch.bfloat16),
             (2, 64, 32, 8, 128, 0, 0.0, torch.bfloat16),      # GQA G=4
             (1, 200, 8, 2, 64, 48, 0.0, torch.float32),       # band
             (1, 96, 8, 4, 64, 0, 30.0, torch.float32),        # softcap
             (1, 130, 4, 4, 256, 0, 0.0, torch.bfloat16),      # D=256
             # recurrentgemma-9b: 16 heads on one kv head of 256; its
             # serve's prompts (<= 264) sit inside the 2048 window, and a
             # band narrower than the sequence runs too
             (1, 264, 16, 1, 256, 0, 0.0, torch.float32),
             (2, 264, 16, 1, 256, 0, 0.0, torch.bfloat16),
             (1, 600, 16, 1, 256, 256, 0.0, torch.float32),
             (1, 600, 16, 1, 256, 256, 0.0, torch.bfloat16),
             # fp16 beside bf16, and the tensor-core tiles' edges at width
             (2, 130, 32, 8, 128, 0, 0.0, torch.float16),      # G=4, ragged
             (1, 65, 16, 1, 256, 0, 0.0, torch.float16),       # straddle
             (2, 100, 32, 32, 128, 16, 0.0, torch.bfloat16),   # narrow band
             (1, 200, 8, 4, 64, 0, 30.0, torch.float16),       # softcap
             (1, 600, 16, 1, 256, 256, 0.0, torch.float16)]
    # the new architectures' widths (internvl2: D = 64, 14 heads on 2)
    for H, K, D, _, _ in new_arch_shapes().values():
        cases += [(2, 130, H, K, D, 0, 0.0, torch.float32),
                  (2, 264, H, K, D, 0, 0.0, torch.bfloat16)]
    for arch in MOE_ARCHS:
        H, K, D, _ = moe_whisper_shapes()[arch]
        cases += [(2, 130, H, K, D, 0, 0.0, torch.float32),
                  (2, 264, H, K, D, 0, 0.0, torch.bfloat16)]
    # whisper-medium's unmasked attention (causal=False): the encoder over
    # its 1500 frames (not a multiple of the 64-key tile) and a prompt's
    # cross-attention against them
    for B, Sq, Skv in ((4, 1500, 1500), (4, 32, 1500), (2, 100, 130)):
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, Sq, 16, 64, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(B, Skv, 16, 64, generator=g,
                                device="cuda").to(dt) for _ in range(2))
            check(f"flash_attention non-causal B={B} Sq={Sq} Skv={Skv} "
                  f"H=K=16 D=64 {dt}",
                  ops.flash_attention(q, k, v, causal=False),
                  fa.attention_ref(q, k, v, causal=False), dt)
    for B, S, H, K, D, w, cap, dt in cases:
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        check(f"flash_attention B={B} S={S} H={H} K={K} D={D} window={w} "
              f"cap={cap} {dt}",
              ops.flash_attention(q, k, v, window=w, softcap=cap),
              fa.attention_ref(q, k, v, window=w, softcap=cap), dt)
    timed = {name: flash_timing(torch, fa, g, *shape, torch.bfloat16)
             for name, shape in FLASH_TIMED.items()}
    timed["whisper_encoder"] = flash_timing(torch, fa, g, 4, 1500, 16, 16,
                                            64, 0, torch.bfloat16,
                                            causal=False)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            **timed.pop("prefill"), **timed}


def decode_cases(torch, ops, dec, pdec, attention, timed):
    """The dense decode kernel: per-row ``[B, S]`` prefix masks from the
    paged timing case's ragged lengths and a shared ``[S]`` mask at
    llama2-7b's shape, GQA, softcap, a wrapped ring mask and a cache length
    that is not a multiple of the 64-token tile, in f32 and bf16; bitwise
    against the paged kernel (f32) at shapes of one and of several splits;
    each of the three decode bodies launched twice on the same inputs for
    the same bits. Timed by ``decode_timing`` beside the plain version and
    ``scaled_dot_product_attention`` with a boolean mask."""
    errs = {}
    g = torch.Generator(device="cpu").manual_seed(21)
    B, H, K, D, pt, S = 8, 32, 32, 128, 16, 512
    _, _, _, _, lengths = paged_inputs(torch, B, H, K, D, pt, S,
                                       torch.float32, 12)
    kpos = torch.arange(S, device="cuda")
    rows = kpos[None, :] < lengths[:, None]                  # [B, S]
    ring_pos = (S + 7 + 11 * torch.arange(4, device="cuda"))[:, None]
    # S=512: serve 4's pow2 cache for prompts of 256; S=264: serve 3's
    cases = [(B, H, K, D, S, 0.0, rows, "rows"),
             (B, H, K, D, S, 0.0, rows[1], "one"),
             (B, H, K, D, 264, 0.0, None, "rows"),
             (4, 32, 8, 128, 200, 0.0, None, "rows"),           # GQA G=4
             (3, 8, 2, 64, 96, 30.0, None, "rows"),             # softcap
             (4, 32, 32, 128, 256, 0.0,
              torch.remainder(ring_pos - kpos[None, :256], 256) < 100,
              "ring"),                                          # ring mask
             (2, 32, 32, 128, 300, 0.0, None, "rows"),          # S % 64 != 0
             # recurrentgemma-9b's local-attention ring of 264 slots
             # (serve 6's cache), G=16 on one kv head of 256, wrapped
             (8, 16, 1, 256, 264, 0.0,
              torch.remainder((264 + 7 + 11 * torch.arange(8, device="cuda"))
                              [:, None] - kpos[None, :264], 264) < 200,
              "ring")]
    shapes = [(H, K, D) for H, K, D, _, _ in new_arch_shapes().values()] + [
        (H, K, D) for H, K, D, _ in moe_whisper_shapes().values()]
    cases += [(4, H, K, D, 300, 0.0, None, "rows") for H, K, D in shapes]
    # whisper-medium's decode: its self-attention cache, and the
    # cross-attention's one query against all 1500 frames (valid [S])
    cases += [(4, 16, 16, 64, 448, 0.0, None, "rows"),
              (4, 16, 16, 64, 1500, 0.0,
               torch.ones(1500, dtype=torch.bool, device="cuda"), "all")]
    # the analysis phase's llama2-7b step: 8 rows of a full 4096-token cache
    # under one shared mask (3 splits of 22 tiles on 132 SMs)
    cases += [(8, 32, 32, 128, 4096, 0.0,
               torch.ones(4096, dtype=torch.bool, device="cuda"), "all")]
    for i, (b, h, k, d, s, cap, valid, kind) in enumerate(cases):
        if valid is None:
            lens = torch.randint(1, s + 1, (b,), generator=g).cuda()
            lens[0] = s
            valid = kpos[None, :s] < lens[:, None]
        q = torch.randn(b, 1, h, d, generator=g).cuda()
        kc = torch.randn(b, s, k, d, generator=g).cuda()
        vc = torch.randn(b, s, k, d, generator=g).cuda()
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt) for t in (q, kc, vc)] + [valid]
            errs[(i, str(dt))] = check(
                f"decode B={b} H={h} K={k} D={d} S={s} cap={cap} mask "
                f"{kind} {tuple(valid.shape)} {dt}",
                ops.decode_attention(*args, softcap=cap),
                dec.decode_attention_ref(*args, softcap=cap), dt)
    # the paged kernel's twin: the same tokens laid out in its pages (on
    # 132 SMs the llama2-7b shapes, recurrentgemma's and the softcap case
    # run in 2, 3, 4, 5 and 8 splits, the 64-token cache in one)
    for i, (b, h, k, d, s, cap, seed) in enumerate(
            [(8, 32, 32, 128, 512, 0.0, 12), (4, 32, 8, 128, 200, 0.0, 31),
             (3, 8, 2, 64, 96, 30.0, 32), (1, 32, 32, 128, 512, 0.0, 33),
             (8, 16, 1, 256, 264, 0.0, 34), (8, 32, 32, 128, 64, 0.0, 35)]
            + [(4, H, K, D, 300, 0.0, 36 + j)
               for j, (H, K, D) in enumerate(shapes)]):
        q, kp, vp, table, lens = paged_inputs(torch, b, h, k, d, pt, s,
                                              torch.float32, seed)
        n = table.shape[1] * pt
        kd = kp[table.long()].reshape(b, n, k, d)
        vd = vp[table.long()].reshape(b, n, k, d)
        valid = torch.arange(n, device="cuda")[None, :] < lens[:, None]
        bit = torch.equal(
            dec.decode_attention_cuda(q, kd, vd, valid, softcap=cap),
            pdec.paged_decode_attention_cuda(q, kp, vp, table, lens,
                                             softcap=cap))
        print(f"  decode B={b} H={h} K={k} D={d} len<={s} cap={cap}: f32 "
              f"equals the paged kernel on the same tokens bitwise: {bit}")
        if not bit:
            raise AssertionError("the dense decode kernel is not bitwise "
                                 "equal to the paged kernel")
        # the splits combine in a fixed order: a second launch, same bits
        kq, ks = attention.page_quant(kp, torch.int8)
        vq, vs = attention.page_quant(vp, torch.int8)
        for body, run in (
                ("dense", lambda: dec.decode_attention_cuda(
                    q, kd, vd, valid, softcap=cap)),
                ("paged", lambda: pdec.paged_decode_attention_cuda(
                    q, kp, vp, table, lens, softcap=cap)),
                ("int8 paged", lambda: pdec.paged_decode_attention_quant_cuda(
                    q, kq, vq, ks, vs, table, lens, softcap=cap))):
            if not torch.equal(run(), run()):
                raise AssertionError(f"two launches of the {body} decode "
                                     f"kernel gave different bits")
        print(f"    two launches of each decode body: the same bits")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:72",
            "max_abs_err": errs[(0, str(torch.bfloat16))],
            **timed_entry(timed, "dense")}


SCAN_TOL = {"ssd": 3e-4, "rglru": 2e-5}


def check_scan(name: str, out, ref, tol: float) -> float:
    """The scan kernels against their plain versions in f32. ssd: 3e-4,
    the JAX suite's tolerance for two f32 chunked sums taken in another
    order; rglru: 2e-5, one FMA against a rounded multiply and add per step
    of a decaying recurrence."""
    import torch
    err = max_err(out, ref)
    ok = (torch.allclose(out, ref, atol=tol, rtol=tol)
          and bool(torch.isfinite(out).all()))
    print(f"  {name}: max|Δ| {err:.3e} (atol=rtol={tol}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max|Δ| {err})")
    return err


def scan_inputs(torch, B=8, T=256, H=32, P=64, N=128, W=4096, seed=41):
    """Inputs of both scans (the recipe of tests/test_kernels.py), at
    mamba2-370m's and recurrentgemma-9b's prefill shapes by default:
    (xh, log_a, Bm, Cm, a, b), f32 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=g,
                                            device="cuda") * scale
    return (rnd(B, T, H, P, scale=0.5), -rnd(B, T, H, scale=0.1).abs(),
            rnd(B, T, N, scale=0.3), rnd(B, T, N, scale=0.3),
            torch.exp(-rnd(B, T, W, scale=0.5).abs()),
            rnd(B, T, W, scale=0.5))


# the shapes ssd is timed at, B, T, H, P, N, chunk: mamba2-370m's prefill
# (the headline, comparable across PRs), the GSI scoring forward (2
# calibration rows x 8 candidates of 64 tokens: one 64-token chunk; most of
# serve 5's launches), batch 1, and a ragged sequence of three chunks
SSD_TIMED = {"prefill": (8, 256, 32, 64, 128, 256),
             "scoring": (16, 64, 32, 64, 128, 256),
             "batch1": (1, 256, 32, 64, 128, 256),
             "three_chunks": (2, 600, 32, 64, 128, 256)}


def ssd_bound(torch, ssd, xh, log_a, Bm, Cm, Q) -> tuple:
    """(bound ms, what bounds it, bound ms on TF32 tensor cores) of the
    chunked scan, from ``ssd.cost`` (bytes; operations on causal pairs).
    The first bound takes the f32 FMA rate (the inputs' type); the
    kernel's 3xTF32 products make three TF32 products of each."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_TF32
    c = ssd.cost(xh, log_a, Bm, Cm, Q)
    bms, by = bound_ms(c)
    return bms, by, max(c.bytes / HBM_BW, 3 * c.flops / PEAK_FLOPS_TF32) * 1e3


def ssd_timing(torch, ssd, B, T, H, P, N, Q) -> dict:
    """``ssd`` on ``scan_inputs`` at one shape: held against its plain
    version, launched twice for the same bits, then timed: event (``ms``)
    and device-only (``busy_ms``) ms, the plain version's ms and the
    bounds."""
    xh, log_a, Bm, Cm, _, _ = scan_inputs(torch, B, T, H, P, N, 1)
    shape = f"B={B} T={T} H={H} P={P} N={N} chunk={min(Q, T)} f32"
    y, fin = ssd.ssd_cuda(xh, log_a, Bm, Cm, Q)
    y_ref, fin_ref = ssd.ssd_ref(xh, log_a, Bm, Cm, Q)
    err = max(check_scan(f"timed ssd {shape} y", y, y_ref, SCAN_TOL["ssd"]),
              check_scan(f"timed ssd {shape} state", fin, fin_ref,
                         SCAN_TOL["ssd"]))
    y2, fin2 = ssd.ssd_cuda(xh, log_a, Bm, Cm, Q)
    if not (torch.equal(y, y2) and torch.equal(fin, fin2)):
        raise AssertionError(f"two launches of ssd at {shape} gave "
                             f"different bits")
    bms, by, tc_ms = ssd_bound(torch, ssd, xh, log_a, Bm, Cm, Q)
    run = lambda: ssd.ssd_cuda(xh, log_a, Bm, Cm, Q)
    return {"max_abs_err": err, "ms": time_ms(run),
            "busy_ms": time_ms(run, hide_launch=True),
            "plain_ms": time_ms(lambda: ssd.ssd_ref(xh, log_a, Bm, Cm, Q)),
            "bound_ms": bms, "bound_by": by, "bound_3xtf32_ms": tc_ms,
            "library_ms": None, "shape": shape}


def ssd_cases(torch, ops, ssd):
    """mamba2-370m's SSD at the ``SSD_TIMED`` shapes (each checked, twice
    for the same bits, and timed; the prefill shape is the headline) and
    at small odd shapes and tile edges; y and the final state each held to
    the plain version."""
    cases = [(2, 100, 4, 32, 64, 32), (1, 48, 3, 16, 32, 16),
             (1, 65, 2, 64, 128, 256), (1, 1, 2, 64, 128, 256),
             (1, 50, 2, 6, 10, 16)]
    for i, (B, T, H, P, N, Q) in enumerate(cases):
        xh, log_a, Bm, Cm, _, _ = scan_inputs(torch, B, T, H, P, N, 1,
                                              seed=50 + i)
        y, fin = ops.ssd(xh, log_a, Bm, Cm, Q)
        y_ref, fin_ref = ssd.ssd_ref(xh, log_a, Bm, Cm, Q)
        name = f"ssd B={B} T={T} H={H} P={P} N={N} chunk={min(Q, T)}"
        check_scan(name + " y", y, y_ref, SCAN_TOL["ssd"])
        check_scan(name + " state", fin, fin_ref, SCAN_TOL["ssd"])
    timed = {name: ssd_timing(torch, ssd, *shape)
             for name, shape in SSD_TIMED.items()}
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd.py:76",
            **timed.pop("prefill"), **timed}


def rglru_cases(torch, ops, rglru):
    """recurrentgemma-9b's RG-LRU recurrence at its prefill shape, a
    length that is no multiple of the kernel's 8-step unroll, batch 1 and a
    small odd width."""
    errs = []
    for i, (B, T, W) in enumerate([(8, 256, 4096), (2, 301, 4096),
                                   (1, 256, 4096), (3, 33, 96)]):
        _, _, _, _, a, b = scan_inputs(torch, B, T, 1, 1, 1, W, seed=60 + i)
        errs.append(check_scan(f"rglru B={B} T={T} W={W}", ops.rglru(a, b),
                               rglru.rglru_ref(a, b), SCAN_TOL["rglru"]))
    _, _, _, _, a, b = scan_inputs(torch)
    B, T, W = a.shape
    bms, by = bound_ms(rglru.cost(a, b))
    return {"name": "rglru", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru.py:49",
            "max_abs_err": errs[0],
            "ms": time_ms(lambda: rglru.rglru_cuda(a, b)),
            "plain_ms": time_ms(lambda: rglru.rglru_ref(a, b)),
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "shape": f"B={B} T={T} W={W} f32"}


# ---------------------------------------------------------------- phases
def _paged_pools(torch, attention, put_pages, cfg, cache, table, n_pages,
                 kv_dtype):
    """Lay a prefill cache [L, B, npg·pt, K, Dh] into a page pool at
    ``table`` — model dtype, or quantized as the executor's prefill does."""
    L, B, npg = cfg.n_layers, table.shape[0], table.shape[1]
    dev = table.device
    shape = (L, n_pages, cache["attn"]["k"].shape[2] // npg, cfg.n_kv_heads,
             cfg.dh)
    pools = {}
    for pk, sk in (("k", "ks"), ("v", "vs")):
        kv = cache["attn"][pk].reshape(L, B, npg, *shape[2:])
        if kv_dtype is None:
            pools[pk] = torch.zeros(shape, device=dev)
            pools[pk][:, table.long()] = kv
        else:
            codes, scales = attention.page_quant(kv.float(), kv_dtype)
            pools[pk] = torch.zeros(shape, device=dev).to(kv_dtype)
            put_pages(pools[pk], (slice(None), table.long()), codes)
            pools[sk] = torch.zeros(L, n_pages, cfg.n_kv_heads, device=dev)
            pools[sk][:, table.long()] = scales
    return pools


def reference_phase(torch) -> None:
    """Small fp32 model, model-dtype and int8 page pools: kernels on the
    card vs plain versions on the CPU; then warmed horizons with host syncs
    turned into errors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ref import put_pages
    from repro_torch.models import attention, decoder, registry
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    model = registry.build(cfg)
    cpu_params = model.init(0, "cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(5))
    pt, npg = 16, 4
    for kv_dtype in (None, torch.int8):
        outs = {}
        for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
            logits, cache = decoder.prefill(p, cfg, toks.to(dev), npg * pt)
            table = torch.arange(2 * npg, dtype=torch.int32,
                                 device=dev).reshape(2, npg)
            pools = _paged_pools(torch, attention, put_pages, cfg, cache,
                                 table, 2 * npg + 1, kv_dtype)
            pos = torch.full((2,), 40, dtype=torch.int32, device=dev)
            first = torch.argmax(logits, -1).to(torch.int32)[:, None]
            h_toks, _, _ = decoder.paged_decode_horizon(
                p, cfg, pools, table, pos, first, 8)
            outs[dev] = (logits.cpu(), h_toks.cpu())
        err = max_err(outs["cuda"][0], outs["cpu"][0])
        same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        print(f"  reference ({kv_dtype or 'model-dtype'} pool): prefill "
              f"logits max|Δ| card vs CPU {err:.2e}; horizon tokens equal: "
              f"{same}")
        if err > 1e-3 or not same:
            raise AssertionError("the card's path disagrees with the CPU "
                                 "reference")
        # warmed horizon: no host synchronisation inside the decode loop
        decoder.paged_decode_horizon(gpu_params, cfg, pools, table, pos,
                                     first, 4)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decoder.paged_decode_horizon(gpu_params, cfg, pools, table, pos,
                                         first, 4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  warmed decode horizon ({kv_dtype or 'model-dtype'} pool) "
              f"ran with sync debug mode 'error': no host sync")
    slot_reference(torch, decoder, cfg, cpu_params, gpu_params)


def slot_reference(torch, decoder, cfg, cpu_params, gpu_params) -> None:
    """The slot path: 3 rows prefilled into a 64-token slot cache, moved to
    ragged ``[B]`` positions, decoded 8 tokens with ``[L, B]`` gates (one
    row runs past its cache and drops its writes), card against CPU, for a
    model-dtype and an int8 cache; then a warmed horizon with host syncs
    turned into errors."""
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(6))
    for kv_dtype in (None, torch.int8):
        outs = {}
        for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
            logits, cache = decoder.prefill(p, cfg, toks.to(dev), 64,
                                            kv_dtype=kv_dtype)
            cache["pos"] = torch.tensor([40, 25, 60], dtype=torch.int32,
                                        device=dev)
            gates = torch.ones(2, cfg.n_layers, 3, device=dev)
            gates[0, 1, 0] = gates[1, 2, 1] = gates[0, 3, 2] = 0.0
            g = {"mixer": gates[0], "ffn": gates[1]}
            first = torch.argmax(logits, -1).to(torch.int32)[:, None]
            h_toks, cache = decoder.decode_horizon(p, cfg, cache, first, 8,
                                                   gates=g)
            outs[dev] = (logits.cpu(), h_toks.cpu())
        err = max_err(outs["cuda"][0], outs["cpu"][0])
        same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        print(f"  reference (slot cache {kv_dtype or 'model-dtype'}): prefill "
              f"logits max|Δ| card vs CPU {err:.2e}; horizon tokens equal: "
              f"{same}")
        if err > 1e-3 or not same:
            raise AssertionError("the card's slot path disagrees with the "
                                 "CPU reference")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decoder.decode_horizon(gpu_params, cfg, cache, first, 4, gates=g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  warmed slot horizon ({kv_dtype or 'model-dtype'} cache) "
              f"ran with sync debug mode 'error': no host sync")


def recurrent_reference(torch) -> None:
    """mamba2 (4 layers, chunk 8) and recurrentgemma (6 layers, window 16)
    at f32: a 37-token prefill of 3 rows (five SSD chunks, the last one
    ragged; a rolled window-16 ring) and an 8-token slot horizon with
    ``[B]`` positions and ``[L, B]`` gates, card against CPU; then a
    warmed horizon with host syncs turned into errors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decoder, registry
    for arch, layers in (("mamba2-370m", 4), ("recurrentgemma-9b", 6)):
        cfg = get_smoke_config(arch).replace(n_layers=layers)
        cpu_params = registry.build(cfg).init(0, "cpu")
        gpu_params = _tree_to(cpu_params, "cuda")
        toks = torch.randint(0, cfg.vocab_size, (3, 37),
                             generator=torch.Generator().manual_seed(7))
        outs = {}
        for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
            logits, cache = decoder.prefill(p, cfg, toks.to(dev), 64)
            cache["pos"] = torch.full((3,), 37, dtype=torch.int32,
                                      device=dev)
            gates = torch.ones(2, cfg.n_layers, 3, device=dev)
            gates[0, 1, 0] = gates[1, 2, 1] = gates[0, 3, 2] = 0.0
            g = {"mixer": gates[0], "ffn": gates[1]}
            first = torch.argmax(logits, -1).to(torch.int32)[:, None]
            h_toks, cache = decoder.decode_horizon(p, cfg, cache, first, 8,
                                                   gates=g)
            outs[dev] = (logits.cpu(), h_toks.cpu())
        err = max_err(outs["cuda"][0], outs["cpu"][0])
        same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
        print(f"  reference ({arch}, {layers} layers): prefill logits "
              f"max|Δ| card vs CPU {err:.2e}; horizon tokens equal: {same}")
        if err > 1e-3 or not same:
            raise AssertionError(f"the card's {arch} path disagrees with the "
                                 f"CPU reference")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decoder.decode_horizon(gpu_params, cfg, cache, first, 4, gates=g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print(f"  warmed slot horizon ({arch}) ran with sync debug mode "
              f"'error': no host sync")


def shock_engine(model, params, mm, kind, kv_dtype, budget, max_len,
                 max_new, horizon, tokens_per_page, slots=4):
    """A DensePolicy engine (a keep-mask the live budget cannot change) on
    the paged or slot path at ``kv_dtype``."""
    from repro_torch.core.policy import DensePolicy
    from repro_torch.runtime import (EngineConfig, LocalExecutor,
                                     PagedExecutor, RAPEngine)
    make = PagedExecutor if kind == "paged" else LocalExecutor
    return RAPEngine(model, params, DensePolicy(mm), EngineConfig(
        mode="masked", max_new_tokens=max_new, max_active=slots,
        max_len=max_len, budget_bytes=budget,
        tokens_per_page=tokens_per_page, kv_dtype=kv_dtype,
        decode_horizon=horizon),
        executor=make(model, params, max_active=slots, kv_dtype=kv_dtype))


# the shock trace: 12 batch-1 requests on 8 slots (serve 1's), a pool of 5
# dense requests of 272 tokens, so that up to 8 decode together and a
# shock moves the survivors from the 8-row decode bucket to the 4-row one
SHOCK_REQUESTS, SHOCK_SLOTS, SHOCK_POOL = 12, 8, 5.0
# name, executor, KV precision, the share of the KV headroom the shock
# cuts: int8 pages hold about twice the tokens of bf16 in the same bytes,
# so their shock cuts deeper to reach below the reservations
SHOCK_CONFIGS = (("paged bf16", "paged", None, 0.5),
                 ("paged int8", "paged", "int8", 0.75),
                 ("local", "local", None, 0.5))


def reference_shock(torch, device: str = "cuda") -> None:
    """The small fp32 model on the card: 8 requests (prompts of 16 and 24
    tokens, 6 new tokens, all arriving at t = 0) unshocked and under a
    shock that cuts 80% of the KV headroom from tick 3 to 13, on paged f32
    and int8 pools and slot caches; the tokens must be equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import masks, memory
    from repro_torch.models import registry
    from repro_torch.runtime import EngineRequest, TickStaircase
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    model = registry.build(cfg)
    params = model.init(0, device)
    mm = memory.build_memory_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(8)).numpy()
    full = masks.full_mask(cfg.n_layers)
    budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
    for name, kind, kv, _ in SHOCK_CONFIGS:
        name = name.replace("bf16", "f32")
        reps = []
        for shock in (False, True):
            eng = shock_engine(model, params, mm, kind, kv, budget, 32, 6, 2,
                               8)
            kvb = budget - eng.resident_param_bytes
            frac = (eng.resident_param_bytes + 0.2 * kvb) / budget
            trace = (TickStaircase(budget, [(3, 1.0), (10, frac), (0, 1.0)])
                     if shock else None)
            reps.append(eng.run([EngineRequest(
                rid=f"r{i}", prompt=toks[:, : (16 if i % 2 else 24)])
                for i in range(8)], budget_trace=trace))
        want = {r.rid: r.tokens for r in reps[0].results}
        same = all(np.array_equal(r.tokens, want[r.rid])
                   for r in reps[1].results if r.status == "done")
        done = sum(r.status == "done" for r in reps[1].results)
        print(f"  reference shock ({name}, f32 model): "
              f"{reps[1].preempted_count} preempted, {done}/8 done, tokens "
              f"equal to the unshocked run: {same}")
        if not same or done != 8 or reps[1].preempted_count < 1:
            raise AssertionError(f"the small model's shocked trace ({name}) "
                                 f"differs from the unshocked one")


def fixed_mask_policy(mm, seq):
    """A policy handing out the masks of ``seq`` in order, the last one
    repeating (a keep-mask that cannot depend on the device's numbers)."""
    from repro_torch.core.policy import Decision, PruningPolicy

    class Fixed(PruningPolicy):
        name = "fixed"

        def __init__(self):
            self.mm, self.i = mm, 0

        def observe(self, state):
            m = np.array(seq[min(self.i, len(seq) - 1)], copy=True)
            self.i += 1
            peak = self.mm.peak_bytes(m, state.batch, state.total_len)
            return Decision(mask=m, steps=0, peak_bytes=peak,
                            fits=peak <= state.budget_bytes, latency_s=0.0)
    return Fixed()


def _drop(L, *rows, mixer_only=()):
    m = np.ones(2 * L, bool)
    for i in rows:
        m[i] = m[L + i] = False
    for i in mixer_only:
        m[i] = False
    return m


def structural_reference(torch) -> None:
    """Structural traces of small f32 models (4 layers, TF32 off), the
    kernels on the card against the plain versions on the CPU, tokens
    equal: two requests on one slot each whose masks drop layer 0 and
    layer 1 (one bucket signature, two gather keys) on both executors; a
    paged int8 pool under a budget shock that preempts, in a pow2 bucket
    of 2 rows (one of them mixer-pruned) below the pool's 4 layers, so
    spill and restore move pool layers [0, 2) and their scale rows;
    mamba2 in exact buckets with a mixer-pruned row (a row with neither
    block) beside a dropped one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import masks, memory
    from repro_torch.models import registry
    from repro_torch.runtime import (EngineConfig, EngineRequest,
                                     LocalExecutor, PagedExecutor, RAPEngine,
                                     TickStaircase)
    alias = [_drop(4, 0), _drop(4, 1)]
    # name, arch, executor, KV precision, bucket_quant, slots, requests,
    # the share of the KV headroom a shock cuts (0: no shock), masks
    runs = (("aliasing, paged", "llama2-7b", "paged", None, "layer", 1, 2, 0,
             alias),
            ("aliasing, local", "llama2-7b", "local", None, "none", 1, 2, 0,
             alias),
            ("paged int8, pow2, shock", "llama2-7b", "paged", "int8", "pow2",
             4, 8, 0.8, [_drop(4, 1, 2, mixer_only=(3,))]),
            ("mamba2, local", "mamba2-370m", "local", None, "none", 4, 8, 0,
             [_drop(4, 3, mixer_only=(1,))]))
    for name, arch, kind, kv, quant, slots, n, cut, seq in runs:
        cfg = get_smoke_config(arch).replace(n_layers=4)
        model = registry.build(cfg)
        cpu_params = model.init(0, "cpu")
        mm = memory.build_memory_model(cfg)
        full = masks.full_mask(4)
        budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
        toks = torch.randint(0, cfg.vocab_size, (1, 24),
                             generator=torch.Generator().manual_seed(10))
        out = {}
        for dev in ("cpu", "cuda"):
            params = _tree_to(cpu_params, dev)
            make = PagedExecutor if kind == "paged" else LocalExecutor
            eng = RAPEngine(model, params, fixed_mask_policy(mm, seq),
                            EngineConfig(
                                mode="structural", max_new_tokens=6,
                                max_active=slots, max_len=32,
                                budget_bytes=budget, tokens_per_page=8,
                                kv_dtype=kv, decode_horizon=2,
                                bucket_quant=quant),
                            executor=make(model, params, mode="structural",
                                          max_active=slots, kv_dtype=kv,
                                          bucket_quant=quant))
            trace = None
            if cut:
                kvb = budget - eng.resident_param_bytes
                trace = TickStaircase(budget, [
                    (2, 1.0), (10, (eng.resident_param_bytes
                                    + (1 - cut) * kvb) / budget), (0, 1.0)])
            rep = eng.run([EngineRequest(
                rid=f"r{i}", prompt=toks[:, : (16 if i % 2 else 24)].numpy())
                for i in range(n)], budget_trace=trace)
            out[dev] = ({r.rid: r.tokens for r in rep.results},
                        {r.rid: r.bucket for r in rep.results},
                        rep.preempted_count, eng.executor.stats())
        same = (out["cuda"][0].keys() == out["cpu"][0].keys()
                and all(np.array_equal(out["cuda"][0][k], t)
                        for k, t in out["cpu"][0].items()))
        st = out["cuda"][3]
        print(f"  reference structural ({name}): {len(out['cuda'][0])} "
              f"requests, buckets of {sorted({len(b) for b in out['cuda'][1].values()})} "
              f"layers, {st['groups']} groups of {st['bucket_signatures']} "
              f"signature(s), {out['cuda'][2]} preempted; tokens equal to "
              f"the CPU's: {same}")
        if (not same or out["cuda"][1] != out["cpu"][1]
                or any(b == () for b in out["cuda"][1].values())
                or (cut and out["cuda"][2] < 1)
                or (quant == "pow2"
                    and max(len(b) for b in out["cuda"][1].values()) >= 4)
                or (name.startswith("aliasing")
                    and (st["groups"], st["bucket_signatures"]) != (2, 1))):
            raise AssertionError(f"the structural reference ({name}) "
                                 f"failed its checks")


def shock_requests(cfg, n: int = 8, max_new: int = 16):
    """``n`` batch-1 requests, all arriving at t = 0 (so admission does not
    depend on the card's speed), prompts of 64-256 tokens from the seeded
    corpus."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.runtime import EngineRequest
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    return [EngineRequest(rid=f"s{i}", prompt=corpus.sample_tokens(
                rng, 1, int(rng.integers(1, 5)) * 64), max_new=max_new)
            for i in range(n)]


def spill_roundtrip(torch, pool) -> None:
    """One request's pages and scale rows through spill → restore on the
    card, onto other pages: ``torch.equal`` on every byte."""
    from repro_torch.kernels.ref import put_pages, take_pages
    n_tok = 3 * pool.tokens_per_page + 5
    pool.alloc_tokens("probe", 2, n_tok, max_tokens=n_tok)
    ids = [p for row in pool.row_pages("probe") for p in row]
    idx = (slice(None), torch.tensor(ids, device=pool.k_pages.device))
    g = torch.Generator(device=pool.k_pages.device).manual_seed(4)
    shape = (pool.k_pages.shape[0], len(ids), *pool.k_pages.shape[2:])
    for pages in (pool.k_pages, pool.v_pages):
        put_pages(pages, idx, 60 * torch.randn(shape, generator=g,
                                               device=pages.device))
    if pool.k_scales is not None:
        for sc in (pool.k_scales, pool.v_scales):
            sc[idx] = torch.rand(sc[idx].shape, generator=g,
                                 device=sc.device) + 0.1
    want = [take_pages(p, idx).clone() for p in (pool.k_pages, pool.v_pages)]
    want += ([] if pool.k_scales is None
             else [s[idx].clone() for s in (pool.k_scales, pool.v_scales)])
    pool.spill("probe")
    pool.alloc_tokens("other", 1, pool.tokens_per_page,
                      max_tokens=pool.tokens_per_page)
    for pages in (pool.k_pages, pool.v_pages):
        put_pages(pages, idx, torch.zeros(shape, device=pages.device))
    rows = pool.restore("probe")
    new = (slice(None), torch.tensor([p for r in rows for p in r],
                                     device=pool.k_pages.device))
    got = [take_pages(p, new) for p in (pool.k_pages, pool.v_pages)]
    got += ([] if pool.k_scales is None
            else [s[new] for s in (pool.k_scales, pool.v_scales)])
    same = all(torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b)
               for a, b in zip(got, want))
    moved = set(new[1].tolist()) != set(ids)
    pool.free("probe")
    pool.free("other")
    print(f"  spill → restore of one request ({len(ids)} pages"
          f"{', scale rows' if pool.k_scales is not None else ''}) onto other "
          f"pages: equal bitwise: {same}")
    if not (same and moved and pool.bytes_reserved == 0):
        raise AssertionError("spill → restore did not round-trip bitwise")


def shock_phase(torch, ops, card: str, cfg, device: str = "cuda") -> dict:
    """``run_budget_shock`` (a share of the KV headroom cut for the middle
    ticks, one unshocked run before and one after) and a cancellation
    storm, on one model at ``cfg``'s width; returns each run's summary."""
    import gc
    from repro_torch.core import masks, memory
    from repro_torch.models import registry
    from repro_torch.runtime import (TickStaircase, run_budget_shock,
                                     run_cancellation_storm, token_agreement)
    model = registry.build(cfg)
    params = model.init(0, device)
    mm = memory.build_memory_model(cfg)
    reqs = shock_requests(cfg, SHOCK_REQUESTS)
    max_len = 256 + 16
    full = masks.full_mask(cfg.n_layers)
    budget = mm.param_bytes(full) + SHOCK_POOL * mm.state_bytes(full, 1,
                                                                max_len)
    out = {}
    for name, kind, kv, cut in SHOCK_CONFIGS:
        eng = shock_engine(model, params, mm, kind, kv, budget, max_len, 16,
                           4, 16, SHOCK_SLOTS)
        ops.reset_launches()
        t0 = time.perf_counter()
        res = run_budget_shock(eng, reqs, budget_bytes=budget, frac=cut,
                               replays=1)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        rep = res["report"]
        agree = token_agreement(model, params, reqs, res["warm_report"], rep)
        pool = rep.pool
        summary = {
            "card": card, "run": name, "requests": len(reqs),
            "preempted_count": rep.preempted_count,
            "spilled_mb": rep.spilled_mb,
            "resume_ms": {k: rep.resume_latency.get(k, 0.0) * 1e3
                          for k in ("p50", "p99")},
            "itl_ms": {k: rep.itl.get(k, 0.0) * 1e3 for k in ("p50", "p99")},
            "itl_preempted_ms": {k: rep.itl_preempted.get(k, 0.0) * 1e3
                                 for k in ("p50", "p99")},
            "completed": {p: res[p]["completed"]
                          for p in ("pre", "shock", "post")},
            "tok_per_s": rep.tokens_per_s,
            "recovery_ratio": res["recovery_ratio"],
            "agreement": agree, "launches": counts,
            "n_pages": int(pool["n_pages"]), "wall_s": wall}
        print(f"  shock ({name}) [{card}]: {rep.preempted_count} preempted, "
              f"{rep.spilled_mb:.1f} MB spilled, resume p50/p99 "
              f"{summary['resume_ms']['p50']:.1f}/"
              f"{summary['resume_ms']['p99']:.1f} ms, completed pre/shock/"
              f"post {summary['completed']}, itl p99 "
              f"{summary['itl_ms']['p99']:.2f} ms (preempted requests "
              f"{summary['itl_preempted_ms']['p99']:.2f}), recovery "
              f"{res['recovery_ratio']:.3f}; tokens equal to the unshocked "
              f"run in {agree['equal']}/{agree['requests']} requests "
              f"({agree['equal_tokens']}/{agree['tokens']} tokens), first "
              f"divergence {agree['first']}; launches {counts}")
        print("shock: " + json.dumps(summary))
        drained = (pool["reserved_bytes"] == 0
                   and pool["spilled_requests"] == 0
                   and pool["live_requests"] == 0
                   and pool["free_pages"] == pool["n_pages"])
        decode = {"paged bf16": "paged_decode_attention",
                  "paged int8": "paged_decode_attention_quant",
                  "local": "decode_attention"}[name]
        if (rep.preempted_count < 1 or rep.spilled_mb <= 0 or not drained
                or res["shock"]["completed"] < 1
                or res["post"]["completed"] < 1
                or any(r.status != "done" for r in rep.results)
                or (device == "cuda"
                    and min(counts[decode], counts["flash_attention"],
                            counts["fused_glu"]) < 1)):
            raise AssertionError(f"shock ({name}) failed its checks")
        if kind == "paged":
            spill_roundtrip(torch, eng.pool)
        out[name] = summary
        del eng, res, rep
    # a storm of cancellations under a shock, paged bf16
    eng = shock_engine(model, params, mm, "paged", None, budget, max_len,
                       16, 4, 16, SHOCK_SLOTS)
    kvb = budget - eng.resident_param_bytes
    frac = (eng.resident_param_bytes + 0.5 * kvb) / budget
    ops.reset_launches()
    storm = run_cancellation_storm(
        eng, reqs, cancel_frac=0.34, seed=5,
        budget_trace=TickStaircase(budget, [(3, 1.0), (6, frac), (0, 1.0)]))
    counts = ops.launch_counts()
    print(f"  storm (paged bf16) [{card}]: {storm['cancelled']}/"
          f"{storm['n_requests']} cancelled, {storm['done']} done, "
          f"{storm['preempted_count']} preempted, live "
          f"{int(storm['live_requests'])}, leaked pages "
          f"{int(storm['leaked_pages'])}, spilled "
          f"{int(storm['spilled_requests'])}; launches {counts}")
    if (storm["cancelled"] < 0.25 * storm["n_requests"]
            or storm["live_requests"] or storm["leaked_pages"]
            or storm["spilled_requests"]
            or storm["done"] + storm["cancelled"] != storm["n_requests"]):
        raise AssertionError("the cancellation storm leaked")
    out["storm"] = {"launches": counts,
                    **{k: storm[k] for k in ("cancelled", "done",
                                             "preempted_count")}}
    del eng, model, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def train_phase(torch, ops, card: str) -> dict:
    """Serve 7: ``launch.serve`` with ``--episodes``. The training call is
    observed from outside (``dqn.train`` wrapped for the phase): its
    result, its scoring forwards and the launches it made."""
    from repro_torch.core import dqn
    seen = {}
    train = dqn.train

    def observed(env_factory, **kw):
        env = env_factory()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        tr = train(lambda: env, **kw)
        torch.cuda.synchronize()
        seen.update(tr=tr, forwards=env.forwards,
                    seconds=time.perf_counter() - t0,
                    counts={k: v - before[k]
                            for k, v in ops.launch_counts().items()})
        return tr

    dqn.train = observed
    try:
        s7 = serve_phase(torch, ops, card, SERVE7_ARGV)
    finally:
        dqn.train = train
    tr, n = seen["tr"], len(seen["tr"].episode_rewards)
    c, f = seen["counts"], seen["forwards"]
    want = {k: 0 for k in c}
    want.update(flash_attention=s7["layers"] * f, fused_glu=s7["layers"] * f)
    print(f"  training [{card}]: {n} episodes in {seen['seconds']:.1f} s "
          f"({seen['seconds'] / n:.2f} s/episode), {len(tr.losses)} TD "
          f"updates, {f} scoring forwards; rewards "
          f"{[round(r, 4) for r in tr.episode_rewards]}, fits "
          f"{tr.episode_fits}, last loss "
          f"{tr.losses[-1] if tr.losses else None}; launches {c}")
    if (not all(tr.episode_fits) or len(tr.losses) < 1
            or not np.isfinite(tr.episode_rewards).all()
            or not np.isfinite(tr.losses).all() or c != want):
        raise AssertionError(f"serve 7's training failed its checks "
                             f"(launches {c} against {want})")
    serving = {k: v - c[k] for k, v in s7["launches"].items()}
    if min(serving["paged_decode_attention"], serving["fused_glu"],
           serving["flash_attention"]) < 1:
        raise AssertionError("serve 7 did not serve through the kernels")
    return {"launches": s7["launches"], "train_launches": c,
            "train_s": seen["seconds"], "episodes": n,
            "td_updates": len(tr.losses), "forwards": f}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def serve_phase(torch, ops, card: str, argv,
                depth: Optional[int] = None) -> dict:
    """Serve ``--arch`` at its full width and depth (``depth``: its layers
    cut to that many, in-process) through ``launch.serve`` and check the
    report; returns the launch counts and a summary of the run."""
    import gc
    import repro_torch.configs as configs
    from repro_torch.launch import serve
    arch = argv[argv.index("--arch") + 1]
    full = configs.get_config(arch)
    want = full if depth is None else full.replace(n_layers=depth)
    print(f"  serve argv: {' '.join(argv)}"
          + ("" if depth is None else f" (depth cut to {depth} of "
                                      f"{full.n_layers} layers)"))
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    get_config = configs.get_config
    configs.get_config = lambda name: want if name == arch else get_config(
        name)
    try:
        t0 = time.perf_counter()
        engine, rep = serve.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        configs.get_config = get_config
    counts = ops.launch_counts()
    cfg = engine.mcfg
    if cfg != want:
        raise AssertionError(f"not {arch} at full width and depth "
                             f"{want.n_layers}: {cfg}")
    L = cfg.n_layers
    done = [r for r in rep.results if r.status == "done"]
    pruned = [r for r in done if r.mask.sum() < 2 * L]
    for r in done:
        if r.tokens.shape[1] != 8 or not ((r.tokens >= 0)
                                          & (r.tokens < cfg.vocab_padded)).all():
            raise AssertionError(f"{r.rid}: bad tokens {r.tokens}")
    pool = rep.pool
    ex = engine.executor
    kv_dtype = (engine.pool.effective_kv_dtype() if ex.paged
                else str(ex.kv_dtype).replace("torch.", ""))
    print(f"  depth {cfg.n_layers} layers; done {len(done)}/"
          f"{len(rep.results)}; pruned requests {len(pruned)} "
          f"(blocks kept: {[int(r.mask.sum()) for r in done]}); overcommits "
          f"{int(pool['overcommit_events'])}; pool {int(pool['n_pages'])} "
          f"{'physical' if ex.paged else 'accounting'} pages, KV in "
          f"{kv_dtype}, peak "
          f"{pool['peak_reserved_bytes'] / 1e9:.3f} of "
          f"{pool['capacity_bytes'] / 1e9:.3f} GB")
    print(f"  launches during serve: {counts}")
    if (len(done) != len(rep.results) or not pruned
            or pool["overcommit_events"] != 0
            or pool["peak_reserved_bytes"] > pool["capacity_bytes"]):
        raise AssertionError("serve phase failed its checks")
    decides = [r.decide_s * 1e3 for r in done if not r.cached_decision]
    summary = {"card": card, "arch": arch, "layers": cfg.n_layers,
               "requests": len(done),
               "executor": type(ex).__name__,
               "kv_dtype": kv_dtype,
               "n_pages": int(pool["n_pages"]),
               "in_use_scale": pool["in_use_scale"],
               "max_prefill_tokens": engine.cfg.max_prefill_tokens,
               "generated_tokens": rep.generated_tokens,
               "tok_per_s": rep.tokens_per_s, "wall_s": wall,
               "ttft_ms": {k: rep.ttft[k] * 1e3 for k in ("p50", "p99")},
               "itl_ms": {k: rep.itl[k] * 1e3 for k in ("p50", "p99")},
               "decide_ms": decides,
               "decide_s_total": sum(r.decide_s for r in done),
               "launch_s": rep.launch_s, "launches": counts,
               "decode_iters": rep.decode_iters,
               "mode": engine.cfg.mode,
               "bucket_layers": [len(r.bucket) for r in done],
               "dropped_layers": [[i for i in range(L) if not (
                   r.mask[i] or r.mask[L + i])] for r in done],
               "pruned_without_bucket": sum(r.bucket == () for r in pruned),
               "all_pruned": len(pruned) == len(done),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "bucket_stats": ex.stats()}
    print(f"  serve [{card}]: {rep.tokens_per_s:.2f} tok/s over "
          f"{rep.generated_tokens} tokens; ttft p50/p99 "
          f"{summary['ttft_ms']['p50']:.1f}/{summary['ttft_ms']['p99']:.1f} "
          f"ms; itl p50/p99 {summary['itl_ms']['p50']:.2f}/"
          f"{summary['itl_ms']['p99']:.2f} ms; decide ms "
          f"{[round(d, 1) for d in decides]}; of {wall:.1f} s wall, decide "
          f"{summary['decide_s_total']:.1f} s, prefill + decode launches and "
          f"read-backs {rep.launch_s:.1f} s")
    print("serve: " + json.dumps(summary))
    summary["streams"] = {r.rid: (r.tokens.tolist(), r.mask.tolist())
                          for r in done}
    # free the model before the next serve
    del engine, rep, ex
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def serial_phase(torch, ops, card: str, argv) -> dict:
    """One-shot serving (``--serial``): every request returns 8 tokens in
    range; returns the launch counts and a summary."""
    import gc
    from repro_torch.launch import serve
    print(f"  serve argv: {' '.join(argv)}")
    ops.reset_launches()
    t0 = time.perf_counter()
    server, results = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    cfg = server.cfg
    if (cfg.d_model, cfg.n_layers, cfg.vocab_size) != (4096, 32, 32000):
        raise AssertionError(f"not llama2-7b at full width: {cfg}")
    for i, r in enumerate(results):
        if r.tokens.shape[1] != 8 or not ((r.tokens >= 0)
                                          & (r.tokens < cfg.vocab_padded)).all():
            raise AssertionError(f"serial request {i}: bad tokens {r.tokens}")
    summary = {"card": card, "requests": len(results),
               "shapes": [list(r.tokens.shape) for r in results],
               "blocks_kept": [int(r.mask.sum()) for r in results],
               "fits": [bool(r.fits) for r in results],
               "decide_ms": [r.decide_s * 1e3 for r in results],
               "infer_s": [r.infer_s for r in results],
               "wall_s": wall, "launches": counts,
               "stats": server.stats()}
    print(f"  launches during serve: {counts}")
    print("serve: " + json.dumps(summary))
    if len(results) < 1 or counts["decode_attention"] < 1:
        raise AssertionError("serve 4 did not decode through the kernel")
    del server, results
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# the decoder entry points whose layout decides a serve's launches
RECORDED = ("forward", "prefill", "prefill_chunk", "paged_prefill_chunk",
            "decode_step", "paged_decode_step")


# the encoder-decoder's entry points, recorded as "encdec.<name>"
RECORDED_ENCDEC = ("forward", "prefill", "decode_step")


class LayoutRecorder:
    """Wraps the decoder's entry points (and the encoder-decoder's, as
    ``encdec.<name>``) while a serve or a pass runs and records, per call,
    its name, its layout (None: the config's) and, for a paged decode
    step, whether its pool is quantized."""

    def __init__(self):
        from repro_torch.models import decoder, encdec
        self.modules = ((decoder, RECORDED, ""),
                        (encdec, RECORDED_ENCDEC, "encdec."))
        self.calls, self._orig = [], []

    def __enter__(self):
        for module, names, prefix in self.modules:
            for name in names:
                orig = getattr(module, name)
                self._orig.append((module, name, orig))

                def wrapped(*a, _name=prefix + name, _orig=orig, **kw):
                    quant = _name == "paged_decode_step" and "ks" in a[2]
                    self.calls.append((_name, kw.get("layout"), quant))
                    return _orig(*a, **kw)
                setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, orig in self._orig:
            setattr(module, name, orig)


def layout_launches(cfg, calls, remat: bool = False) -> dict:
    """The launches ``calls`` imply: a forward or prefill launches flash,
    ssd or rglru once per row with that mixer; a slot decode step the
    dense decode kernel, a paged one the paged kernel (its fused-dequant
    body on a quantized pool) once per attention row; every call the GLU
    once per row with a GLU FFN, dense or MoE (chunk attention is plain
    torch, as are the recurrent decode steps). An encoder-decoder forward
    or prefill launches flash once per encoder layer and twice per decoder
    layer (self, then the non-causal cross-attention), its decode step the
    dense decode kernel twice per decoder layer; its gelu FFN launches
    nothing. ``remat``: each forward is a training step's, whose backward
    runs every layer again."""
    from repro_torch.models import decoder, ffn
    want = dict.fromkeys(("fused_glu", "paged_decode_attention",
                          "paged_decode_attention_quant", "flash_attention",
                          "decode_attention", "ssd", "rglru"), 0)
    glu = ffn.is_glu(cfg)
    for name, layout, quant in calls:
        if name.startswith("encdec."):
            times = 2 if remat and name == "encdec.forward" else 1
            if name == "encdec.decode_step":
                want["decode_attention"] += 2 * cfg.n_layers
            else:
                want["flash_attention"] += times * (cfg.n_encoder_layers
                                                    + 2 * cfg.n_layers)
            want["fused_glu"] += glu * times * (
                cfg.n_layers + (name != "encdec.decode_step")
                * cfg.n_encoder_layers)
            continue
        rows = layout or decoder.default_layout(cfg)
        n = lambda *kinds: sum(s.mixer in kinds for s in rows)
        if name in ("forward", "prefill"):
            want["flash_attention"] += n("attn", "local_attn")
            want["ssd"] += n("ssd")
            want["rglru"] += n("rglru")
        elif name == "decode_step":
            want["decode_attention"] += n("attn", "local_attn")
        elif name == "paged_decode_step":
            want["paged_decode_attention_quant" if quant
                 else "paged_decode_attention"] += n("attn")
        want["fused_glu"] += glu * sum(s.ffn is not None for s in rows)
    return want


def structural_phase(torch, ops, card: str, argv,
                     base: Optional[dict] = None,
                     probe: Optional["Observed"] = None) -> dict:
    """A structural serve (``serve_phase`` with the decoder's calls
    recorded): serve 1's checks, a bucket on every pruned request, and
    each kernel launched exactly as often as the layouts of the calls
    imply (less the launches of a policy's ``probe``, which runs the
    decoder's blocks itself); its tok/s, TTFT and ITL are printed, beside
    those of the masked serve ``base`` of the same trace where one is
    given."""
    from repro_torch.configs import get_config
    arch = argv[argv.index("--arch") + 1]
    with LayoutRecorder() as rec:
        s = serve_phase(torch, ops, card, argv)
    want = layout_launches(get_config(arch), rec.calls)
    got = dict(s["launches"])
    for call in probe.calls if probe is not None else ():
        got = {k: v - call["launches"][k] for k, v in got.items()}
    rows = sorted({len(lay) for _, lay, _ in rec.calls if lay})
    half = sum(any(r.mixer is None or (r.ffn is None and arch != "mamba2-370m")
                   for r in lay) for _, lay, _ in rec.calls if lay)
    print(f"  {len(rec.calls)} decoder calls, layouts of {rows} rows "
          f"({half} calls through half-pruned rows); bucket stats "
          f"{s['bucket_stats']}; request buckets of {s['bucket_layers']} "
          f"layers")
    print(f"  launches {got}, the layouts imply {want}")
    for key, label in (("tok_per_s", "tok/s"), ("ttft_ms", "ttft p50 ms"),
                       ("itl_ms", "itl p50 ms")):
        pick = (lambda r: r[key]) if key == "tok_per_s" else (
            lambda r: r[key]["p50"])
        masked = ("" if base is None
                  else f", masked (same trace) {pick(base):.2f}")
        print(f"  {label} [{card}]: structural {pick(s):.2f}{masked}")
    if (s["mode"] != "structural" or s["pruned_without_bucket"]
            or got != want or not rows):
        raise AssertionError(f"the structural serve ({arch}) failed its "
                             f"checks")
    s["layout_rows"] = rows
    return s


def check_recurrent_launches(what: str, arch: str, counts: dict) -> None:
    """Hold a recurrent serve's launch counts to what its layout implies.
    A forward (prefill or GSI scoring) launches ssd or rglru once per such
    layer, flash once per local-attention layer and the GLU once per FFN;
    a decode step launches the dense decode kernel once per local-attention
    layer and the GLU once per FFN (the recurrent decode steps are plain
    torch, as in JAX). mamba2 has 48 SSD layers and no FFN;
    recurrentgemma 26 RG-LRU and 12 local-attention layers, 38 FFNs."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    layout = decoder.default_layout(get_config(arch))
    n = {k: sum(s.mixer == k for s in layout)
         for k in ("ssd", "rglru", "local_attn")}
    n_ffn = sum(s.ffn is not None for s in layout)
    scan = "ssd" if n["ssd"] else "rglru"
    fwd = counts[scan] / n[scan]
    steps = counts["decode_attention"] / max(n["local_attn"], 1)
    want = {"ssd": n["ssd"] * fwd, "rglru": n["rglru"] * fwd,
            "flash_attention": n["local_attn"] * fwd,
            "decode_attention": n["local_attn"] * steps,
            "fused_glu": n_ffn * (fwd + steps),
            "paged_decode_attention": 0, "paged_decode_attention_quant": 0}
    seen = (f"{steps:g} decode steps" if n["local_attn"]
            else "decode steps launch no kernel")
    print(f"  {what}: {fwd:g} forwards, {seen}; launches {counts}")
    if (fwd < 1 or fwd != int(fwd) or steps != int(steps)
            or any(counts[k] != v for k, v in want.items())
            or (n["local_attn"] and steps < 1)):
        raise AssertionError(f"{what}'s launches do not match {arch}'s "
                             f"layout: {counts} against {want}")


# --------------------------------------------------------------- gradients
# the kernels' gradient cases, each through ``ops.KernelGrad`` on the card
# against the autograd of the plain version on the card; the loss
# sum(w · out) + ½ sum(out²) feeds the kernel's own output into the
# upstream gradient, so its forward error shows in the gradients.
# Tolerance: the largest |Δ| over an input's gradient, relative to that
# gradient's largest magnitude — 1e-4 in f32 (TF32 off; two f32 sums in
# other orders), 3e-2 in bf16 (the kernel's output differs from the plain
# version's by up to a bf16 rounding, which the backward carries)
GRAD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 3e-2}


def grad_check(torch, ops, kernel: str, label: str, fn, plain, inputs,
               dt) -> float:
    """One gradient case: the loss through ``fn`` (the ``ops`` dispatcher,
    which must launch ``kernel`` once) and through ``plain`` on the same
    card inputs; returns the largest relative gradient error."""
    g = torch.Generator(device="cuda").manual_seed(97)
    ws = {}

    def grads(f):
        xs = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = f(*xs)
        o = (out[0] if isinstance(out, tuple) else out).float()
        if "w" not in ws:
            ws["w"] = torch.randn(o.shape, generator=g, device="cuda")
        loss = (ws["w"] * o).sum() + 0.5 * (o * o).sum()
        return torch.autograd.grad(loss, xs)

    before = getattr(ops, kernel).launches
    got = grads(fn)
    launched = getattr(ops, kernel).launches - before
    want = grads(plain)
    rel = max(float((a.float() - b.float()).abs().max())
              / max(float(b.float().abs().max()), 1e-30)
              for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    tol = GRAD_TOL[str(dt)]
    ok = rel <= tol and finite and launched == 1
    print(f"  grad {label}: max|Δ|/max|g| {rel:.3e} over {len(got)} inputs "
          f"(tol {tol}), {launched} launch {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"grad {label}: the kernel's gradient path "
                             f"disagrees with the plain version's autograd "
                             f"({rel}, {launched} launches)")
    return rel


def grad_cases(torch, ops, fa, swiglu, ssd, rglru) -> dict:
    """The gradients through the four forward kernels (flash in f32 and
    bf16, GQA, a window, a softcap, recurrentgemma's width; the GLU in
    swiglu and geglu at llama2-7b's and recurrentgemma-9b's widths; ssd
    over two chunks at mamba2's width; rglru); returns, per kernel, the
    largest relative error and the case count."""
    g = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *s, dt=torch.float32, scale=1.0: (
        torch.randn(*s, generator=g, device="cuda") * scale).to(dt)
    out = {}

    def note(kernel, rel):
        e = out.setdefault(kernel, {"grad_max_rel_err": 0.0,
                                    "grad_cases": 0})
        e["grad_max_rel_err"] = max(e["grad_max_rel_err"], rel)
        e["grad_cases"] += 1

    for B, S, H, K, D, w, cap, dt in [
            (2, 128, 8, 8, 64, 0, 0.0, torch.float32),
            (1, 256, 32, 32, 128, 0, 0.0, torch.bfloat16),   # llama2-7b
            (2, 100, 32, 8, 128, 0, 0.0, torch.bfloat16),    # GQA, ragged
            (1, 200, 8, 2, 64, 48, 0.0, torch.float32),      # window
            (1, 96, 8, 4, 64, 0, 30.0, torch.float32),       # softcap
            (1, 264, 16, 1, 256, 0, 0.0, torch.bfloat16)]:   # griffin
        kw = dict(window=w, softcap=cap)
        note("flash_attention", grad_check(
            torch, ops, "flash_attention",
            f"flash B={B} S={S} H={H} K={K} D={D} window={w} cap={cap} {dt}",
            lambda q, k, v: ops.flash_attention(q, k, v, **kw),
            lambda q, k, v: fa.attention_ref(q, k, v, **kw),
            (rnd(B, S, H, D, dt=dt), rnd(B, S, K, D, dt=dt),
             rnd(B, S, K, D, dt=dt)), dt))
    for T, F, act, dt in [(256, 688, "swiglu", torch.float32),
                          (512, 11008, "swiglu", torch.bfloat16),
                          (264, 12288, "geglu", torch.bfloat16),
                          (37, 11007, "geglu", torch.float32)]:
        note("fused_glu", grad_check(
            torch, ops, "fused_glu", f"fused_glu T={T} F={F} {act} {dt}",
            lambda h: ops.fused_glu(h, act),
            lambda h: swiglu.glu_ref(h, act), (rnd(T, 2 * F, dt=dt),), dt))
    xh, log_a, Bm, Cm, a, b = scan_inputs(torch, 2, 128, 8, 64, 128, 512,
                                          seed=71)
    note("ssd", grad_check(
        torch, ops, "ssd", "ssd B=2 T=128 H=8 P=64 N=128 chunk=64 f32",
        lambda *x: ops.ssd(*x, 64), lambda *x: ssd.ssd_ref(*x, 64),
        (xh, log_a, Bm, Cm), torch.float32))
    note("rglru", grad_check(
        torch, ops, "rglru", "rglru B=2 T=128 W=512 f32", ops.rglru,
        rglru.rglru_ref, (a, b), torch.float32))
    return out


def decode_refuses_grad(torch, ops) -> None:
    """Each decode kernel raises on a card input that requires grad while
    grad mode is on, and launches nothing."""
    q = torch.randn(2, 1, 4, 32, device="cuda", requires_grad=True)
    k = torch.randn(2, 16, 4, 32, device="cuda")
    pages = torch.randn(5, 8, 4, 32, device="cuda")
    table = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([16, 9], dtype=torch.int32, device="cuda")
    codes = pages.to(torch.int8)
    scales = torch.ones(5, 4, device="cuda")
    calls = {
        "decode_attention": lambda: ops.decode_attention(
            q, k, k, torch.ones(16, dtype=torch.bool, device="cuda")),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, pages, pages, table, lengths),
        "paged_decode_attention_quant": lambda: ops.paged_decode_attention(
            q, codes, codes, table, lengths, k_scales=scales,
            v_scales=scales)}
    for name, call in calls.items():
        before = getattr(ops, name).launches
        try:
            call()
        except RuntimeError as e:
            if "no gradient path" not in str(e):
                raise
        else:
            raise AssertionError(f"{name} took an input that requires grad")
        if getattr(ops, name).launches != before:
            raise AssertionError(f"{name} launched on a grad input")
        print(f"  {name}: refuses an input that requires grad, no launch")


# ---------------------------------------------------------------- training
class Observed:
    """While a phase runs, wrap ``module.name``: its result, seconds (to
    the card's end) and the launches made inside it."""

    def __init__(self, ops, module, name: str):
        self.ops, self.module, self.name = ops, module, name
        self.calls = []

    def __enter__(self):
        import torch
        orig = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            before = self.ops.launch_counts()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            self.calls.append({
                "result": out, "seconds": time.perf_counter() - t0,
                "launches": {k: v - before[k] for k, v in
                             self.ops.launch_counts().items()}})
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _steps_card_vs_cpu(torch, ops, model, batches, step):
    """``step`` over ``batches`` from the same f32 weights on the CPU and
    on the card: (params max|Δ|, loss and grad_norm max rel |Δ|, the
    card's launches, the card's losses, the card's recorded calls)."""
    from repro_torch import tree
    from repro_torch.optim import adamw
    runs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(model.init(0, "cpu"), dev)
        s = adamw.init(p)
        ops.reset_launches()
        mets = []
        with LayoutRecorder() as rec:
            for b in batches:
                p, s, m = step(p, s, _tree_to(b, dev))
                mets.append({k: float(v) for k, v in m.items()})
        runs[dev] = (p, mets, ops.launch_counts(), rec.calls)
    want_p = tree.flatten(runs["cpu"][0])
    p_err = max(max_err(a.cpu(), want_p[k])
                for k, a in tree.flatten(runs["cuda"][0]).items())
    m_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(runs["cuda"][1], runs["cpu"][1])
                for k in ("loss", "grad_norm"))
    losses = [round(m["loss"], 6) for m in runs["cuda"][1]]
    return p_err, m_err, runs["cuda"][2], losses, runs["cuda"][3]


def training_reference(torch, ops) -> None:
    """SMOKE f32 llama2 and whisper-medium (TF32 off) through three
    ``make_train_step`` steps on the card (kernels; remat, so each step
    launches every layer's kernels twice) and on the CPU (plain versions)
    from the same weights: loss, ``grad_norm`` and params within 1e-4,
    launches as remat implies; then llama2's ``taylor_saliency`` (1e-4
    relative) and ``block_cosines`` (1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import baselines
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    # whisper: random frames, so the encoder and cross-attention gradients
    # are not those of a constant input
    wcfg = get_smoke_config("whisper-medium")
    wmodel = registry.build(wcfg)
    wcorpus = SyntheticCorpus(wcfg.vocab_size, seed=0)
    gen = torch.Generator().manual_seed(82)
    wbatches = [{**{k: torch.from_numpy(v)
                    for k, v in wcorpus.batch(4, 64, index=i).items()},
                 "frames": torch.randn(4, wcfg.n_audio_frames, wcfg.d_model,
                                       generator=gen)} for i in range(3)]
    p_err, m_err, c, losses, calls = _steps_card_vs_cpu(
        torch, ops, wmodel, wbatches,
        steps.make_train_step(wmodel, opt, remat=True))
    want = layout_launches(wcfg, calls, remat=True)
    print(f"  whisper-medium SMOKE train steps card vs CPU: losses {losses}, "
          f"loss and grad_norm max rel |Δ| {m_err:.2e}, params max|Δ| "
          f"{p_err:.2e} (tol 1e-4); launches {c}, remat implies {want}")
    if m_err > 1e-4 or p_err > 1e-4 or c != want:
        raise AssertionError("the whisper-medium train step on the card "
                             "disagrees with the CPU")
    cfg = get_smoke_config("llama2-7b")
    model = registry.build(cfg)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    batches = [{k: torch.from_numpy(v)
                for k, v in corpus.batch(4, 64, index=i).items()}
               for i in range(3)]
    p_err, m_err, c, losses, _ = _steps_card_vs_cpu(
        torch, ops, model, batches,
        steps.make_train_step(model, opt, remat=True))
    want = 3 * 2 * cfg.n_layers          # 3 steps, forward + remat
    print(f"  train steps card vs CPU: losses {losses}, loss and "
          f"grad_norm max rel |Δ| {m_err:.2e}, params max|Δ| {p_err:.2e} "
          f"(tol 1e-4); launches {c}")
    if (m_err > 1e-4 or p_err > 1e-4 or c["flash_attention"] != want
            or c["fused_glu"] != want):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")
    calib = {k: torch.from_numpy(v)
             for k, v in corpus.batch(2, 64, split="calib").items()}
    cpu_p = model.init(0, "cpu")
    gpu_p = _tree_to(cpu_p, "cuda")
    sal = [baselines.taylor_saliency(model, p, _tree_to(calib, d))
           for p, d in ((gpu_p, "cuda"), (cpu_p, "cpu"))]
    cos = [np.r_[baselines.block_cosines(model, p, _tree_to(calib, d))]
           for p, d in ((gpu_p, "cuda"), (cpu_p, "cpu"))]
    s_err = float(np.max(np.abs(sal[0] - sal[1]) / np.abs(sal[1])))
    c_err = float(np.max(np.abs(cos[0] - cos[1])))
    print(f"  taylor_saliency card vs CPU max rel |Δ| {s_err:.2e} (tol "
          f"1e-4); block_cosines max|Δ| {c_err:.2e} (tol 1e-5)")
    if not (s_err <= 1e-4 and c_err <= 1e-5):
        raise AssertionError("the baselines' probes disagree card vs CPU")


def llmpruner_phase(torch, ops, card: str) -> dict:
    """Serve 10: serve 1 with ``--policy llmpruner``. Its order is one
    forward and backward of the whole model on the calibration batch
    (Taylor saliency): 32 flash and 32 GLU launches, the backward the
    plain derivative; the saliency finite for all 64 blocks."""
    from repro_torch.core import baselines
    torch.cuda.reset_peak_memory_stats()
    with Observed(ops, baselines, "taylor_saliency") as obs:
        s10 = serve_phase(torch, ops, card, SERVE10_ARGV)
    (call,) = obs.calls
    sal, c = call["result"], call["launches"]
    want = {k: 0 for k in c}
    want.update(flash_attention=32, fused_glu=32)
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  llmpruner order [{card}]: Taylor saliency in "
          f"{call['seconds']:.2f} s (one forward + backward at full width), "
          f"peak {peak:.1f} GB allocated in the serve; saliency of "
          f"{len(sal)} blocks, finite {int(np.isfinite(sal).sum())}, range "
          f"{np.min(sal):.4g}–{np.max(sal):.4g}; launches {c}")
    if len(sal) != 64 or not np.isfinite(sal).all() or c != want:
        raise AssertionError("serve 10's saliency failed its checks")
    s10.update(order_s=call["seconds"], order_launches=c,
               peak_gb=peak)
    return s10


def shortgpt_phase(torch, ops, card: str) -> dict:
    """Serve 11: serve 1 in structural mode with ``--policy shortgpt
    --bucket-quant layer``: ShortGPT drops whole layers, so buckets lose
    rows. Serve 8's checks (launches equal the layouts' sums, the cosine
    probe's own 32 flash and 32 GLU launches apart) and a bucket of fewer
    than 32 layers."""
    from repro_torch.core import baselines
    with Observed(ops, baselines, "block_cosines") as obs:
        s11 = structural_phase(torch, ops, card, SERVE11_ARGV, probe=obs)
    (call,) = obs.calls
    kept = sorted(set(s11["bucket_layers"]))
    dropped = sorted({tuple(d) for d in s11["dropped_layers"]})
    print(f"  shortgpt order [{card}]: block cosines in "
          f"{call['seconds']:.2f} s, launches {call['launches']}; buckets "
          f"of {kept} layers; whole layers dropped per request: {dropped} "
          f"(the rest kept)")
    if (call["launches"]["flash_attention"] != 32
            or call["launches"]["fused_glu"] != 32 or min(kept) >= 32):
        raise AssertionError("serve 11 failed its checks")
    s11.update(order_s=call["seconds"], order_launches=call["launches"])
    return s11


def train_launcher_phase(torch, ckpt: str) -> None:
    """(a) ``launch.train --smoke`` for 20 steps, then rerun to 40: the
    rerun resumes from the step-20 checkpoint."""
    import contextlib
    import io
    from repro_torch.launch import train
    outs = []
    for steps in (20, 40):
        buf = io.StringIO()
        argv = ["--arch", "llama2-7b", "--smoke", "--steps", str(steps),
                "--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            summary = train.main(argv)
        outs.append(buf.getvalue())
        lines = buf.getvalue().strip().splitlines()
        print(f"  launch.train {' '.join(argv[4:])}: {lines[0]} … "
              f"{lines[-1]} ({time.perf_counter() - t0:.1f} s)")
        if summary["final_step"] != steps:
            raise AssertionError(f"launch.train stopped at "
                                 f"{summary['final_step']}")
    if ("resumed from checkpoint at step 20" not in outs[1]
            or "resumed" in outs[0]):
        raise AssertionError("the rerun of launch.train did not resume")
    print("  the rerun printed: resumed from checkpoint at step 20")


# llama2-7b at full width and a depth of 2 layers: bf16 params, f32
# moments; B x S tokens a step, remat
FULL_TRAIN = {"layers": 2, "batch": 4, "seq": 256, "steps": 6, "ckpt": 3}


def _full_width_trainer(total: int, ckpt_dir: Optional[str] = None):
    """A ``Trainer`` of llama2-7b at full width and ``FULL_TRAIN``'s depth,
    with its corpus."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.runtime import Trainer, TrainerConfig
    f = FULL_TRAIN
    cfg = get_config("llama2-7b").replace(n_layers=f["layers"])
    return Trainer(registry.build(cfg),
                   adamw.AdamWConfig(lr=1e-4, warmup_steps=2,
                                     total_steps=f["steps"]),
                   TrainerConfig(total_steps=total, ckpt_dir=ckpt_dir,
                                 ckpt_every=f["ckpt"], log_every=1,
                                 remat=True, ckpt_async=True),
                   device="cuda"), SyntheticCorpus(cfg.vocab_size, seed=0)


def _losses(summary) -> dict:
    return {h["step"]: h["loss"] for h in summary["history"]}


def exact_resume(torch, ops, root: str) -> dict:
    """Under ``torch.use_deterministic_algorithms(True)``: an uninterrupted
    run of ``FULL_TRAIN``'s steps, then a run that stops at its async
    checkpoint and a fresh ``Trainer`` that restores it and runs on.
    Returns both runs' losses, the deterministic steps' times, and the
    checkpoint's bytes and background write times. (Its own process: the
    mode needs ``CUBLAS_WORKSPACE_CONFIG`` before the first product, which
    the rest of this script runs without.)"""
    import gc
    import os
    from repro_torch.checkpoint import manager
    from repro_torch.data import batch_iterator
    f = FULL_TRAIN
    ckpt = os.path.join(root, "full_width")
    torch.use_deterministic_algorithms(True)
    ref, corpus = _full_width_trainer(f["steps"])
    batches = lambda start=0: batch_iterator(corpus, f["batch"], f["seq"],
                                             start=start)
    out = ref.run(batches())
    want = _losses(out)
    det_times = [h["time_s"] for h in out["history"]][1:]
    del ref, out
    gc.collect()
    torch.cuda.empty_cache()
    with Observed(ops, manager, "_write") as writes:
        first, _ = _full_width_trainer(f["ckpt"], ckpt)
        got = _losses(first.run(batches()))
        del first
        gc.collect()
        torch.cuda.empty_cache()
        again, _ = _full_width_trainer(f["steps"], ckpt)
        if not again.maybe_restore() or again.step != f["ckpt"]:
            raise AssertionError(f"the fresh Trainer did not restore step "
                                 f"{f['ckpt']}")
        got.update(_losses(again.run(batches(again.step))))
    step_dir = os.path.join(ckpt, f"step_{f['ckpt']:010d}")
    return {"want": want, "got": got,
            "ms_per_step_deterministic": 1e3 * float(np.mean(det_times)),
            "ckpt_bytes": sum(os.path.getsize(os.path.join(step_dir, n))
                              for n in os.listdir(step_dir)),
            "ckpt_leaves": len(os.listdir(step_dir)) - 1,
            "ckpt_write_s": [c["seconds"] for c in writes.calls]}


def full_width_training(torch, ops, card: str, root: str) -> dict:
    """(b) ``Trainer`` on llama2-7b at full width, 2 layers: 6 timed steps
    (the Trainer's ms a step, one step on CUDA events, tokens/s, peak
    memory, launches, the plain backward's share of a step); then
    :func:`exact_resume` in a child process: the restored run's losses
    equal the uninterrupted run's bit for bit."""
    import gc
    import os
    from repro_torch.data import batch_iterator
    from repro_torch.runtime.trainer import to_device
    from repro_torch.tree import flatten
    f = FULL_TRAIN
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    timed, corpus = _full_width_trainer(f["steps"])
    cfg = timed.model.cfg
    out = timed.run(batch_iterator(corpus, f["batch"], f["seq"]))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    times = [h["time_s"] for h in out["history"]][1:]       # past the 1st
    n_params = sum(x.numel() for x in flatten(timed.params).values())
    share = plain_backward_share(torch, ops, timed, to_device(next(
        batch_iterator(corpus, f["batch"], f["seq"])), "cuda"))
    del timed, out
    gc.collect()
    torch.cuda.empty_cache()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--exact-resume",
         root], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    if child.returncode != 0:
        raise AssertionError(f"the exact-resume run failed:\n"
                             f"{child.stdout[-2000:]}{child.stderr[-4000:]}")
    ex = json.loads(child.stdout.strip().splitlines()[-1])
    want = {int(k): v for k, v in ex["want"].items()}
    got = {int(k): v for k, v in ex["got"].items()}
    ms = 1e3 * float(np.mean(times))
    tok_s = f["batch"] * f["seq"] / (ms / 1e3)
    per_step = {k: v / f["steps"] for k, v in counts.items() if v}
    print(f"  full width ({cfg.d_model} wide, {cfg.n_heads} heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {f['layers']} layers, "
          f"{n_params / 1e6:.1f} M params bf16, moments f32) [{card}]: "
          f"B={f['batch']} S={f['seq']} remat; Trainer {ms:.2f} ms/step "
          f"(steps 2-{f['steps']}, the host's batch sampling included), "
          f"{tok_s:.0f} tokens/s; one step on CUDA events "
          f"{share['step_ms']:.2f} ms, "
          f"{f['batch'] * f['seq'] / share['step_ms'] * 1e3:.0f} tokens/s; "
          f"max memory allocated {peak / 1e9:.2f} GB; launches per step "
          f"{per_step}; under deterministic algorithms "
          f"{ex['ms_per_step_deterministic']:.2f} ms/step")
    print(f"  checkpoint at step {f['ckpt']}: {ex['ckpt_bytes'] / 1e9:.3f} "
          f"GB in {ex['ckpt_leaves']} leaves, background writes "
          f"{[round(s, 2) for s in ex['ckpt_write_s']]} s")
    print(f"  losses uninterrupted {want}; checkpointed and restored "
          f"{got}")
    print(f"  plain backward of the kernels in one step [{card}]: "
          f"{share['backward_ms']} ms of {share['step_ms']:.2f} ms "
          f"({100 * share['share']:.1f}%)")
    if got != want or not np.isfinite(list(want.values())).all():
        raise AssertionError("the restored run's losses differ from the "
                             "uninterrupted run's")
    if per_step.get("flash_attention") != 2 * f["layers"] or \
            per_step.get("fused_glu") != 2 * f["layers"]:
        raise AssertionError(f"launches per step {per_step}: want "
                             f"{2 * f['layers']} flash and GLU (forward "
                             f"and remat)")
    return {"ms_per_step": ms, "tokens_per_s": tok_s, "peak_bytes": peak,
            "plain_backward": share, "launches": counts,
            "params": n_params, **{k: ex[k] for k in (
                "ms_per_step_deterministic", "ckpt_bytes", "ckpt_write_s")}}


def plain_backward_share(torch, ops, trainer, batch) -> dict:
    """One more train step of ``trainer`` with CUDA events around every
    ``KernelGrad.backward`` (the kernels' plain derivative), by kernel:
    its ms and its share of the step's ms (events around the step)."""
    orig = ops.KernelGrad.backward
    spans = []

    def timed(ctx, *grads):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = orig(ctx, *grads)
        b.record()
        spans.append((ctx.plain.__name__, a, b))
        return out

    ops.KernelGrad.backward = staticmethod(timed)
    try:
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        trainer._step_fn(trainer.params, trainer.opt_state, batch)
        b.record()
        torch.cuda.synchronize()
    finally:
        ops.KernelGrad.backward = orig
    by = {}
    for name, x, y in spans:
        by[name] = by.get(name, 0.0) + x.elapsed_time(y)
    step = a.elapsed_time(b)
    return {"backward_ms": by, "step_ms": step,
            "share": sum(by.values()) / step}


def subject_phase(torch, ops, root: str) -> dict:
    """(c) The port's ``benchmarks.common.subject()`` on the card:
    RAP_SUBJECT, 300 steps of B = 16, S = 128; its loss before training,
    at steps 100/200/300, and its held-out ppl and accuracy."""
    import os
    from repro_torch.benchmarks import common
    from repro_torch.runtime import Trainer, steps
    ops.reset_launches()
    t0 = time.perf_counter()
    with Observed(ops, Trainer, "run") as run:
        model, params, corpus = common.subject(
            device="cuda", bench_dir=os.path.join(root, "bench"))
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    hist = {h["step"]: round(h["loss"], 4)
            for h in run.calls[0]["result"]["history"]}
    first = {k: torch.from_numpy(v).to("cuda")
             for k, v in corpus.batch(16, 128, index=0).items()}
    loss0 = float(steps.make_eval_step(model)(model.init(0, "cuda"),
                                              first)["loss"])
    ev = common.evaluate(model, params, common.eval_batches(corpus))
    print(f"  subject ({model.cfg.name}: {model.cfg.n_layers} layers, "
          f"d_model {model.cfg.d_model}) trained 300 steps in {secs:.1f} s "
          f"on the card: loss {loss0:.4f} at step 0, {hist} after; "
          f"held-out ppl {ev['ppl']:.3f}, acc {ev['acc']:.4f}; launches "
          f"{counts}")
    if not (hist[300] < loss0 and np.isfinite(ev["ppl"])
            and ev["ppl"] < np.exp(loss0) and counts["flash_attention"]):
        raise AssertionError("the subject model did not train on the card")
    return {"seconds": secs, "loss0": loss0, "losses": hist, **ev,
            "launches": counts}


def train_phase_full(torch, ops, card: str) -> dict:
    """The train phase: the launcher's resume, full-width training with an
    exact resume, and the subject model; the checkpoint directories are
    removed at the end."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        train_launcher_phase(torch, f"{root}/launcher")
        print(f"  (a) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        full = full_width_training(torch, ops, card, root)
        print(f"  (b) {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        subj = subject_phase(torch, ops, root)
        print(f"  (c) {time.perf_counter() - t0:.1f} s")
        print("experiments:")
        t0 = time.perf_counter()
        exps = experiments_phase(torch, ops, card, f"{root}/bench", subj)
        print(f"  (d) experiments: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"full_width": full, "subject": subj, "experiments": exps}

# ------------------------------------------ the dense decoder's other archs
def _perturbed(torch, params, seed: int):
    """``params`` with random values in the leaves the initialiser zeroes
    (norm scales, q/k/v biases, q/k norms), so a misapplied one shows."""
    g = torch.Generator().manual_seed(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if name in ("scale", "bq", "bk", "bv", "q_norm", "k_norm"):
            return (0.2 * torch.randn(t.shape, generator=g)).to(t.dtype)
        return t
    return walk(params)


def arch_reference(torch) -> None:
    """Each new architecture's SMOKE model in f32 on the card (kernels)
    against the same weights on the CPU (plain versions): forward and
    prefill logits within 1e-3, then the greedy tokens of a paged decode
    horizon equal; internvl2 also with ``vision_embeds`` (forward, prefill
    over the prefix and the prompt, a slot decode horizon)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ref import put_pages
    from repro_torch.models import attention, decoder, registry
    pt, npg = 16, 4
    for i, arch in enumerate(NEW_ARCHS):
        cfg = get_smoke_config(arch)
        model = registry.build(cfg)
        cpu_params = _perturbed(torch, model.init(0, "cpu"), 40 + i)
        gpu_params = _tree_to(cpu_params, "cuda")
        gen = torch.Generator().manual_seed(50 + i)
        toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
        vis = (0.5 * torch.randn(2, cfg.n_vision_tokens, cfg.d_model,
                                 generator=gen)
               if cfg.family == "vlm" else None)
        outs = {}
        for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
            t = toks.to(dev)
            fwd = model.logits(p, {"tokens": t})
            logits, cache = decoder.prefill(p, cfg, t, npg * pt)
            table = torch.arange(2 * npg, dtype=torch.int32,
                                 device=dev).reshape(2, npg)
            pools = _paged_pools(torch, attention, put_pages, cfg, cache,
                                 table, 2 * npg + 1, None)
            pos = torch.full((2,), 40, dtype=torch.int32, device=dev)
            first = torch.argmax(logits, -1).to(torch.int32)[:, None]
            h, _, _ = decoder.paged_decode_horizon(p, cfg, pools, table, pos,
                                                   first, 8)
            out = {"forward": fwd, "prefill": logits, "tokens": h}
            if vis is not None:
                b = {"tokens": t, "vision_embeds": vis.to(dev)}
                vl, vc = model.prefill(p, b, 64)
                vfirst = torch.argmax(vl, -1).to(torch.int32)[:, None]
                vh, _ = decoder.decode_horizon(p, cfg, vc, vfirst, 8)
                out.update(vision_forward=model.logits(p, b),
                           vision_prefill=vl, vision_tokens=vh)
            outs[dev] = {k: v.cpu() for k, v in out.items()}
        errs = {k: max_err(v, outs["cpu"][k]) for k, v in outs["cuda"].items()
                if "tokens" not in k}
        same = {k: bool(torch.equal(v, outs["cpu"][k]))
                for k, v in outs["cuda"].items() if "tokens" in k}
        print(f"  reference ({arch} SMOKE, f32): logits max|Δ| card vs CPU "
              f"{ {k: f'{e:.2e}' for k, e in errs.items()} }; greedy tokens "
              f"equal: {same}")
        if max(errs.values()) > 1e-3 or not all(same.values()):
            raise AssertionError(f"{arch}: the card disagrees with the CPU")


def fp8_slot_reference(torch) -> None:
    """The slot path on an fp8 (float8_e4m3fn) slot cache, card against
    CPU: 3 rows prefilled, moved to ragged positions, 8 tokens decoded with
    ``[L, B]`` gates; the cache is a plain cast on store and load, and the
    card decodes through the dense decode kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decoder, registry
    cfg = get_smoke_config("llama2-7b").replace(n_layers=4)
    cpu_params = registry.build(cfg).init(0, "cpu")
    gpu_params = _tree_to(cpu_params, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(7))
    outs = {}
    for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
        logits, cache = decoder.prefill(p, cfg, toks.to(dev), 64,
                                        kv_dtype=torch.float8_e4m3fn)
        cache["pos"] = torch.tensor([40, 25, 60], dtype=torch.int32,
                                    device=dev)
        gates = torch.ones(2, cfg.n_layers, 3, device=dev)
        gates[0, 1, 0] = gates[1, 2, 1] = 0.0
        first = torch.argmax(logits, -1).to(torch.int32)[:, None]
        h, cache = decoder.decode_horizon(
            p, cfg, cache, first, 8,
            gates={"mixer": gates[0], "ffn": gates[1]})
        outs[dev] = (logits.cpu(), h.cpu(), cache["attn"]["k"].dtype)
    err = max_err(outs["cuda"][0], outs["cpu"][0])
    same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
    print(f"  reference (slot cache {outs['cuda'][2]}): prefill logits "
          f"max|Δ| card vs CPU {err:.2e}; horizon tokens equal: {same}")
    if (err > 1e-3 or not same
            or outs["cuda"][2] != torch.float8_e4m3fn):
        raise AssertionError("the fp8 slot cache on the card disagrees "
                             "with the CPU")


def arch_serves(torch, ops, card: str) -> dict:
    """Serves 12-16: serve 1 (masked, paged, grid 0.3) on each new
    architecture at full width with 3 requests (qwen1.5-32b at 48 of its
    64 layers): every request done and pruned, no overcommit, and flash,
    GLU and paged decode launched exactly as the layouts of the decoder's
    calls imply (no other kernel); then serve 3 on fp8 slot caches, which
    launches the dense decode kernel and no paged one. Returns each
    serve's summary."""
    from repro_torch.configs import get_config
    out = {}
    runs = [(str(n), arch, NEW_ARCH_ARGV[arch], NEW_ARCH_DEPTH.get(arch))
            for n, arch in enumerate(NEW_ARCHS, start=12)]
    runs.append(("_fp8_slot", "llama2-7b", SERVE_FP8_SLOT_ARGV, None))
    for n, arch, argv, depth in runs:
        print(f"serve {n.lstrip('_')} ({arch}):")
        t0 = time.perf_counter()
        with LayoutRecorder() as rec:
            s = serve_phase(torch, ops, card, argv, depth=depth)
        cfg = get_config(arch)
        cfg = cfg if depth is None else cfg.replace(n_layers=depth)
        want = layout_launches(cfg, rec.calls)
        got = s["launches"]
        steps = sum(name in ("decode_step", "paged_decode_step")
                    for name, _, _ in rec.calls)
        print(f"  {len(rec.calls)} decoder calls ({steps} decode steps); "
              f"launches {got}, the layouts imply {want}; peak "
              f"{s['peak_gb']:.2f} GB; {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        slot = n == "_fp8_slot"
        body = "decode_attention" if slot else "paged_decode_attention"
        other = "paged_decode_attention" if slot else "decode_attention"
        if (got != want or not s["all_pruned"]
                or min(got[body], got["flash_attention"],
                       got["fused_glu"]) < 1
                or got[other] or got["paged_decode_attention_quant"]
                or (slot and s["kv_dtype"] != "float8_e4m3fn")):
            raise AssertionError(f"serve {n.lstrip('_')} ({arch}) failed "
                                 f"its checks")
        out[f"c{n}"] = s
    return out


# ------------------------------ the MoE decoders and whisper-medium
def moe_reference(torch) -> None:
    """The MoE decoders' SMOKE models in f32 on the card (kernels) against
    the same weights on the CPU (plain versions): the experts layer 0
    routes a calibration-sized batch (16 x 64 tokens, half of them one
    repeated token, whose experts then take 512 assignments against a
    capacity of 320 or 640: drops are certain) to and the assignments its
    capacity drops, equal; forward and prefill logits within 1e-3; the
    greedy tokens of a paged decode horizon equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.ref import put_pages
    from repro_torch.models import attention, decoder, layers, moe, registry
    pt, npg = 16, 4
    for i, arch in enumerate(MOE_ARCHS):
        cfg = get_smoke_config(arch)
        model = registry.build(cfg)
        cpu_params = _perturbed(torch, model.init(0, "cpu"), 60 + i)
        gpu_params = _tree_to(cpu_params, "cuda")
        gen = torch.Generator().manual_seed(70 + i)
        calib = torch.randint(0, cfg.vocab_size, (16, 64), generator=gen)
        toks = calib[-2:, :40]
        calib[:8] = calib[0, 0]
        outs = {}
        for dev, p in (("cpu", cpu_params), ("cuda", gpu_params)):
            pm = decoder.tree_slice(p["stacks"]["moe"], 0)
            x = layers.apply_norm(cfg, pm["norm"],
                                  p["embed"][calib.to(dev)]).reshape(
                -1, cfg.d_model)
            _, idx = moe._route(pm, cfg, x)
            _, keep, _ = moe.dispatch(cfg, idx)
            t = toks.to(dev)
            logits, cache = decoder.prefill(p, cfg, t, npg * pt)
            table = torch.arange(2 * npg, dtype=torch.int32,
                                 device=dev).reshape(2, npg)
            pools = _paged_pools(torch, attention, put_pages, cfg, cache,
                                 table, 2 * npg + 1, None)
            pos = torch.full((2,), 40, dtype=torch.int32, device=dev)
            first = torch.argmax(logits, -1).to(torch.int32)[:, None]
            h, _, _ = decoder.paged_decode_horizon(p, cfg, pools, table, pos,
                                                   first, 8)
            outs[dev] = {"forward": model.logits(p, {"tokens": t}).cpu(),
                         "prefill": logits.cpu(), "experts": idx.cpu(),
                         "kept": keep.cpu(), "tokens": h.cpu()}
        c, g = outs["cpu"], outs["cuda"]
        errs = {k: max_err(g[k], c[k]) for k in ("forward", "prefill")}
        same = {k: bool(torch.equal(g[k], c[k]))
                for k in ("experts", "kept", "tokens")}
        drops = int((~c["kept"]).sum())
        print(f"  reference ({arch} SMOKE, f32): logits max|Δ| card vs CPU "
              f"{ {k: f'{e:.2e}' for k, e in errs.items()} }; equal: {same} "
              f"(layer 0 drops {drops} of {c['kept'].numel()} assignments)")
        if max(errs.values()) > 1e-3 or not all(same.values()) or not drops:
            raise AssertionError(f"{arch}: the card disagrees with the CPU")


def whisper_reference(torch) -> None:
    """whisper-medium's SMOKE model in f32, card against CPU: prefill on
    random frames and three greedy decode steps; logits within 1e-3,
    tokens equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry
    cfg = get_smoke_config("whisper-medium")
    model = registry.build(cfg)
    cpu_params = _perturbed(torch, model.init(0, "cpu"), 80)
    gen = torch.Generator().manual_seed(81)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=gen),
         "frames": torch.randn(2, cfg.n_audio_frames, cfg.d_model,
                               generator=gen)}
    outs = {}
    for dev, p in (("cpu", cpu_params),
                   ("cuda", _tree_to(cpu_params, "cuda"))):
        bd = {k: v.to(dev) for k, v in b.items()}
        last, cache = model.prefill(p, bd, 16)
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        steps, toks = [last], []
        for _ in range(3):
            lg, cache = model.decode(p, cache, tok)
            tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
            steps.append(lg[:, -1])
            toks.append(tok)
        outs[dev] = (torch.stack(steps).cpu(), torch.cat(toks, 1).cpu(),
                     model.logits(p, bd).cpu())
    err = max(max_err(outs["cuda"][0], outs["cpu"][0]),
              max_err(outs["cuda"][2], outs["cpu"][2]))
    same = bool(torch.equal(outs["cuda"][1], outs["cpu"][1]))
    print(f"  reference (whisper-medium SMOKE, f32): forward, prefill and "
          f"decode logits max|Δ| card vs CPU {err:.2e}; tokens equal: "
          f"{same}")
    if err > 1e-3 or not same:
        raise AssertionError("whisper-medium: the card disagrees with the "
                             "CPU")


def dbrx_depth(torch) -> int:
    """The most dbrx-132b layers whose bf16 weights fit on the card beside
    its embeddings and ``DBRX_HEADROOM_BYTES``."""
    from repro_torch.configs import get_config
    cfg = get_config("dbrx-132b")
    m, f = cfg.block_param_counts()
    total = torch.cuda.get_device_properties(0).total_memory
    return int((total - DBRX_HEADROOM_BYTES - 2 * cfg.embed_params())
               // (2 * (m[0] + f[0])))


def moe_serves(torch, ops, card: str) -> dict:
    """Serve 1 (masked, paged, grid 0.3, 3 requests) on olmoe-1b-7b at
    full width and depth, and on dbrx-132b at full width cut in depth
    (``dbrx_depth``): every request done and pruned, no overcommit, and
    flash, GLU (once per MoE layer: the expert buffer) and paged decode
    launched exactly as the layouts of the decoder's calls imply. Returns
    each serve's summary."""
    from repro_torch.configs import get_config
    out = {}
    for arch in MOE_ARCHS:
        depth = dbrx_depth(torch) if arch == "dbrx-132b" else None
        print(f"serve {arch}:")
        t0 = time.perf_counter()
        with LayoutRecorder() as rec:
            s = serve_phase(torch, ops, card, MOE_ARGV[arch], depth=depth)
        cfg = get_config(arch)
        cfg = cfg if depth is None else cfg.replace(n_layers=depth)
        want = layout_launches(cfg, rec.calls)
        got = s["launches"]
        s["seconds"] = time.perf_counter() - t0
        print(f"  {len(rec.calls)} decoder calls; launches {got}, the "
              f"layouts imply {want}; peak {s['peak_gb']:.2f} GB; decide "
              f"{s['decide_s_total']:.1f} s; {s['seconds']:.1f} s [{card}]")
        if (got != want or not s["all_pruned"]
                or min(got["paged_decode_attention"], got["flash_attention"],
                       got["fused_glu"]) < 1
                or got["decode_attention"]
                or got["paged_decode_attention_quant"]):
            raise AssertionError(f"the {arch} serve failed its checks")
        out[arch] = s
    return out


def watched_train(torch, argv, cfg=None) -> tuple:
    """``launch.train`` with ``argv`` (its log kept off stdout; ``cfg``: the
    config ``--arch`` builds, in place of the registered one), watching
    which elements of every leaf the steps moved. Returns (the run's
    summary, {leaf: (elements moved, elements)}, seconds)."""
    import contextlib
    import io
    import repro_torch.configs as configs
    import repro_torch.runtime as runtime
    from repro_torch.launch import train
    moved = {}

    class Watched(runtime.Trainer):
        def run(self, *a, **kw):
            from repro_torch import tree
            if self.params is None:
                self.init_state()
            before = {k: v.detach().clone()
                      for k, v in tree.flatten(self.params).items()}
            res = super().run(*a, **kw)
            for k, v in tree.flatten(self.params).items():
                moved[k] = (int((v != before[k]).sum()), v.numel())
            return res
    arch = argv[argv.index("--arch") + 1]
    real, get_config = runtime.Trainer, configs.get_config
    runtime.Trainer = Watched
    if cfg is not None:
        configs.get_config = lambda name: cfg if name == arch else get_config(
            name)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            summary = train.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        runtime.Trainer, configs.get_config = real, get_config
    return summary, moved, secs


def whisper_phase(torch, ops, card: str) -> dict:
    """whisper-medium at full width (random weights from seed 0, bf16):
    prefill of ``WHISPER["batch"]`` rows of random frames and a prompt,
    then ``WHISPER["new"]`` greedy decode steps, on a bf16 and an int8
    self cache — logits finite, tokens in range, the launches the calls
    imply (flash per encoder layer and twice per decoder layer at prefill,
    the dense decode kernel twice per decoder layer a step, no GLU); three
    training steps through ``launch.train --arch whisper-medium`` — losses
    finite, half of all elements and a tenth of every leaf moved, the
    launches of three remat steps; and the
    engine's refusal through ``launch.serve --arch whisper-medium``.
    Returns the numbers."""
    import contextlib
    import gc
    import io
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import registry
    cfg = get_config("whisper-medium")
    model = registry.build(cfg)
    t0 = time.perf_counter()
    params = model.init(0, "cuda")
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0}
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, new = WHISPER["batch"], WHISPER["prompt"], WHISPER["new"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device="cuda"),
             "frames": torch.randn(B, cfg.n_audio_frames, cfg.d_model,
                                   generator=g, device="cuda").to(
                 cfg.torch_dtype())}
    toks = {}
    for name, kv in (("bf16", None), ("int8", torch.int8)):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with LayoutRecorder() as rec, torch.no_grad():
            t0 = time.perf_counter()
            last, cache = model.prefill(params, batch, S + new, kv_dtype=kv)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tok = torch.argmax(last, -1).to(torch.int32)[:, None]
            gen, finite = [], bool(torch.isfinite(last).all())
            for _ in range(new):
                lg, cache = model.decode(params, cache, tok)
                finite &= bool(torch.isfinite(lg).all())
                tok = torch.argmax(lg[:, -1], -1).to(torch.int32)[:, None]
                gen.append(tok)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        counts = ops.launch_counts()
        want = layout_launches(cfg, rec.calls)
        toks[name] = torch.cat(gen, 1).cpu()
        run = {"prefill_ms": 1e3 * (t1 - t0),
               "decode_ms_per_step": 1e3 * (t2 - t1) / new,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "cache_dtype": str(cache["attn"]["k"].dtype),
               "launches": counts}
        print(f"  whisper-medium {name} self cache [{card}]: prefill of "
              f"{B} x {S} tokens on {cfg.n_audio_frames} frames "
              f"{run['prefill_ms']:.1f} ms, decode {run['decode_ms_per_step']:.2f}"
              f" ms a step, peak {run['peak_gb']:.2f} GB; launches {counts}, "
              f"the calls imply {want}")
        ok_toks = bool(((toks[name] >= 0)
                        & (toks[name] < cfg.vocab_padded)).all())
        if (counts != want or not finite or not ok_toks
                or counts["flash_attention"] < 1
                or counts["decode_attention"] < 1
                or cache["attn"]["k"].dtype != (kv or cfg.torch_dtype())):
            raise AssertionError(f"whisper-medium {name}: failed its checks")
        out[name] = run
        del cache
    agree = float((toks["bf16"] == toks["int8"]).float().mean())
    print(f"  bf16 vs int8 self cache: {agree:.3f} of the greedy tokens "
          f"agree (printed, not gated)")
    out["token_agreement"] = agree
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # three training steps through the launcher: most elements of every
    # leaf must move
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with LayoutRecorder() as rec:
        summary, moved, secs = watched_train(torch, WHISPER_TRAIN_ARGV)
    counts = ops.launch_counts()
    want = layout_launches(cfg, rec.calls, remat=True)
    losses = [h["loss"] for h in summary["history"]]
    frac = {k: n / size for k, (n, size) in moved.items()}
    least = min(frac, key=frac.get) if frac else None
    out["train"] = {"seconds": secs, "losses": losses,
                    "ms_per_step": [1e3 * h["time_s"]
                                    for h in summary["history"]],
                    "moved_fraction": (sum(n for n, _ in moved.values())
                                       / max(sum(z for _, z in
                                                 moved.values()), 1)),
                    "least_moved_leaf": [least, frac.get(least, 0.0)],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": counts}
    print(f"  launch.train {' '.join(WHISPER_TRAIN_ARGV)} [{card}]: losses "
          f"{[round(x, 4) for x in losses]}, "
          f"{out['train']['moved_fraction']:.4f} of all elements moved "
          f"(least: {least} {frac.get(least, 0.0):.4f}; gate: 0.5 of "
          f"all, 0.1 of every leaf), {secs:.1f} s, peak "
          f"{out['train']['peak_gb']:.2f} GB; launches {counts}, the remat "
          f"steps imply {want}")
    if (summary["final_step"] != 3 or not np.all(np.isfinite(losses))
            or len(moved) < 2 or out["train"]["moved_fraction"] < 0.5
            or frac[least] < 0.1 or counts != want):
        raise AssertionError("whisper-medium training failed its checks")
    gc.collect()
    torch.cuda.empty_cache()
    # the engine serves decoder-only models, as JAX's does
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--arch", "whisper-medium", "--smoke", "--requests",
                        "1", "--max-prompt", "16"])
    except NotImplementedError as e:
        if str(e) != "engine serves decoder-only models":
            raise
        print(f"  launch.serve --arch whisper-medium: NotImplementedError"
              f"({e})")
    else:
        raise AssertionError("the engine served an encoder-decoder model")
    return out


def experiments_phase(torch, ops, card: str, bench_dir: str,
                      subject: dict) -> dict:
    """The paper's experiments (``python -m repro_torch.benchmarks.run``:
    tables 1, 2 and 4, figures 3, 4, 6, 9, 10 and 11) over the subject the
    train phase trained, cached in ``bench_dir``; their DQN policies train
    here on the card. Checks: every number of every row finite; RAP's,
    LLMPruner's, ShortGPT's and MHA-Drop's masks fit their budgets
    (FFN-Skip's cannot shed KV, and is reported); the Dense row's ppl is
    the subject phase's held-out ppl; flash and GLU launched. Returns the
    rows, the launches and the seconds."""
    import os
    from repro_torch.benchmarks import common, run
    common.BENCH_DIR = bench_dir
    ops.reset_launches()
    t0 = time.perf_counter()
    print(f"  experiments on {card}")
    run.main([])
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    tables = {}
    for name, module, _ in run.BENCHES:
        out = module.rsplit(".", 1)[1]
        with open(os.path.join(bench_dir, out + ".json")) as f:
            tables[name] = json.load(f)
    bad = [(name, r) for name, rows in tables.items() for r in rows
           for v in r.values() if isinstance(v, (int, float))
           and not isinstance(v, bool) and not np.isfinite(v)]
    t1 = tables["table1"]
    unfit = [r for r in t1 + tables["table4"]
             if r["scheme"] in ("RAP", "LLMPruner", "ShortGPT", "MHA-Drop")
             and not r["fits"]]
    dense = [r for r in t1 if r["scheme"] == "Dense"][0]
    rel = abs(dense["ppl"] - subject["ppl"]) / subject["ppl"]
    print(f"  experiments [{card}]: {secs:.1f} s; Dense ppl "
          f"{dense['ppl']:.6f} against the subject phase's "
          f"{subject['ppl']:.6f} (relative {rel:.1e}); FFN-Skip fits "
          f"{[r['fits'] for r in t1 if r['scheme'] == 'FFN-Skip']}; "
          f"launches {counts}")
    print("experiments: " + json.dumps({"card": card, "seconds": secs,
                                        "tables": tables}))
    if (bad or unfit or rel > 1e-5 or counts["flash_attention"] < 1
            or counts["fused_glu"] < 1):
        raise AssertionError(f"the experiments failed their checks: "
                             f"non-finite {bad}, unfit {unfit}")
    return {"seconds": secs, "launches": counts, "tables": tables}



# --------- quantized rings on the recurrent layouts, the one-call decode
# surfaces, the kernel walkthrough, and the U1 probe
def ring_quant_cases(torch, ops, dec, attention) -> dict:
    """The dense decode kernel on recurrentgemma-9b's local-attention ring
    (G = 16 on one kv head of 256, serve 6's 264 slots, wrapped) stored as
    an int8 ring (``attention.store_kv``: codes and per-(token, head)
    scales) and as an fp8 ring (a plain cast), then dequantized to bf16 by
    ``attention.load_kv`` as the decode step does, against its plain
    version on the same inputs. Returns the max |Δ| by ring precision."""
    g = torch.Generator(device="cpu").manual_seed(26)
    b, h, k, d, s = 8, 16, 1, 256, 264
    kpos = torch.arange(s, device="cuda")
    valid = torch.remainder((s + 7 + 11 * torch.arange(b, device="cuda"))
                            [:, None] - kpos[None, :], s) < 200
    q = torch.randn(b, 1, h, d, generator=g).cuda().to(torch.bfloat16)
    kc = torch.randn(b, s, k, d, generator=g).cuda()
    vc = torch.randn(b, s, k, d, generator=g).cuda()
    out = {}
    for name, store in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        entry = {"k": torch.empty(b, s, k, d, dtype=store, device="cuda"),
                 "v": torch.empty(b, s, k, d, dtype=store, device="cuda")}
        if store == torch.int8:
            entry["ks"] = torch.empty(b, s, k, 1, device="cuda")
            entry["vs"] = torch.empty(b, s, k, 1, device="cuda")
        entry.update(attention.store_kv(entry, kc, vc))
        kd, vd = attention.load_kv(entry, torch.bfloat16)
        out[name] = check(
            f"decode on a dequantized {name} ring B={b} H={h} K={k} D={d} "
            f"S={s} (wrapped) bf16",
            ops.decode_attention(q, kd, vd, valid),
            dec.decode_attention_ref(q, kd, vd, valid), torch.bfloat16)
    return out


def recurrent_quant_reference(torch) -> None:
    """recurrentgemma and mamba2 SMOKE in f32 on an int8 slot cache (the
    ring quantized, the recurrent state f32), card against CPU: a 33-token
    prefill of 3 rows and 4 teacher-forced decode steps (logits within
    1e-3, max |Δ| printed); then 6 requests through ``LocalExecutor
    (kv_dtype="int8")`` (DensePolicy) under a tick staircase that cuts 60%
    of the KV headroom from tick 3 to 12: it preempts on both devices, and
    the card's shocked tokens equal the CPU's shocked tokens and the
    card's unshocked ones; on mamba2, which has no attention cache, they
    also equal the model-dtype serve's bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import masks, memory
    from repro_torch.core.policy import DensePolicy
    from repro_torch.models import decoder, registry
    from repro_torch.runtime import (EngineConfig, EngineRequest,
                                     LocalExecutor, RAPEngine, TickStaircase)
    for arch in ("recurrentgemma-9b", "mamba2-370m"):
        cfg = get_smoke_config(arch)
        model = registry.build(cfg)
        params = {"cpu": model.init(0, "cpu")}
        params["cuda"] = _tree_to(params["cpu"], "cuda")
        toks = torch.randint(0, cfg.vocab_size, (3, 37),
                             generator=torch.Generator().manual_seed(9))
        logits = {}
        for dev, p in params.items():
            lg, cache = decoder.prefill(p, cfg, toks[:, :33].to(dev), 64,
                                        kv_dtype=torch.int8)
            steps = [lg]
            for t in range(33, 37):
                st, cache = decoder.decode_step(p, cfg, cache,
                                                toks[:, t:t + 1].to(dev))
                steps.append(st[:, -1])
            logits[dev] = torch.stack([x.cpu() for x in steps])
        err = max_err(logits["cuda"], logits["cpu"])
        mm = memory.build_memory_model(cfg)
        full = masks.full_mask(cfg.n_layers)
        budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 32)
        prompt = torch.randint(0, cfg.vocab_size, (1, 24),
                               generator=torch.Generator().manual_seed(3))
        runs = {}
        cases = [("cuda", "int8", False), ("cuda", "int8", True),
                 ("cpu", "int8", True)]
        if arch == "mamba2-370m":
            cases.append(("cuda", None, True))
        for dev, kv, shock in cases:
            eng = RAPEngine(model, params[dev], DensePolicy(mm), EngineConfig(
                mode="masked", max_new_tokens=6, max_active=4, max_len=32,
                budget_bytes=budget, tokens_per_page=8, kv_dtype=kv,
                decode_horizon=2), executor=LocalExecutor(
                    model, params[dev], max_active=4, kv_dtype=kv))
            trace = None
            if shock:
                kvb = budget - eng.resident_param_bytes
                low = (eng.resident_param_bytes + 0.4 * kvb) / budget
                trace = TickStaircase(budget, [(3, 1.0), (9, low), (0, 1.0)])
            rep = eng.run([EngineRequest(
                rid=f"r{i}", prompt=prompt[:, : (18 if i % 2 else 24)].numpy())
                for i in range(6)], budget_trace=trace)
            if {r.status for r in rep.results} != {"done"}:
                raise AssertionError(f"{arch} ({dev}, {kv}): not every "
                                     f"request finished")
            runs[dev, kv, shock] = rep
        ref = {r.rid: r.tokens for r in runs["cuda", "int8", True].results}
        agree = {key: all(np.array_equal(r.tokens, ref[r.rid])
                          for r in rep.results)
                 for key, rep in runs.items()}
        preempted = {f"{d}{'' if s else ' unshocked'}": r.preempted_count
                     for (d, kv, s), r in runs.items() if kv == "int8"}
        print(f"  reference ({arch} SMOKE f32, int8 slot cache): prefill + "
              f"decode logits max|Δ| card vs CPU {err:.2e}; preempted "
              f"{preempted}; shocked card tokens equal to the CPU's "
              f"{agree['cpu', 'int8', True]} and to the unshocked card run "
              f"{agree['cuda', 'int8', False]}"
              + ("" if arch != "mamba2-370m" else
                 f"; int8 tokens equal to the model-dtype serve's "
                 f"{agree['cuda', None, True]}"))
        if (err > 1e-3 or not all(agree.values())
                or runs["cuda", "int8", True].preempted_count < 1
                or runs["cpu", "int8", True].preempted_count < 1):
            raise AssertionError(f"{arch} on an int8 slot cache: the card "
                                 f"disagrees with the CPU or with itself")


def decode_horizon_phase(torch) -> None:
    """The one-call decode surfaces on the card: ``decode_horizon`` and
    ``decode`` on both executors (the small f32 llama2, 4 layers) and
    ``SlotGroup.decode_horizon`` / ``decode_once`` (llama2, and
    recurrentgemma SMOKE on an int8 ring), each against a twin executor
    driven through ``decode_launch`` / ``decode_finish`` on the same two
    seated requests: tokens and host positions equal bitwise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import masks
    from repro_torch.models import registry
    from repro_torch.runtime import KVPool, LocalExecutor, PagedExecutor
    built = {}
    for arch, kind, kv in (("llama2-7b", "local", None),
                           ("llama2-7b", "paged", None),
                           ("recurrentgemma-9b", "local", "int8")):
        if arch not in built:
            cfg = get_smoke_config(arch)
            cfg = cfg.replace(n_layers=4) if arch == "llama2-7b" else cfg
            model = registry.build(cfg)
            built[arch] = (model, model.init(0, "cuda"))
        model, params = built[arch]
        full = masks.full_mask(model.cfg.n_layers)
        prompt = torch.randint(0, model.cfg.vocab_size, (2, 16),
                               generator=torch.Generator().manual_seed(4))
        twins = []
        for _ in range(2):
            make = PagedExecutor if kind == "paged" else LocalExecutor
            ex = make(model, params, max_active=4, kv_dtype=kv)
            if kind == "paged":
                page_bytes = ex.page_phys_bytes(8)
                pool = KVPool(16 * page_bytes, page_bytes=page_bytes,
                              tokens_per_page=8)
                ex.bind_pool(pool, max_len=64)
                for i in range(2):
                    pool.alloc_tokens(f"r{i}", 1, 16, max_tokens=64)
            g = ex.group_for(full, 48)
            for i in range(2):
                ex.prefill_into(g, [i], f"r{i}", prompt[i:i + 1].numpy(),
                                full)
            twins.append((ex, g))
        (a, ga), (b, gb) = twins
        got, want = [], []
        for h in (4, 2):
            toks, new = a.decode_horizon(ga, h)
            got.append(toks)
            want.append(b.decode_finish(b.decode_launch(gb, h)))
            if new is not False:
                raise AssertionError("decode_horizon reported a compile")
        got.append(a.decode(ga)[0][:, None])
        want.append(b.decode_finish(b.decode_launch(gb, 1)))
        if kind == "local":
            got.append(ga.decode_horizon(3, a.decode_buckets)[0])
            want.append(b.decode_finish(b.decode_launch(gb, 3)))
            got.append(ga.decode_once(a.decode_buckets)[0][:, None])
            want.append(b.decode_finish(b.decode_launch(gb, 1)))
        same = all(np.array_equal(x[:2], y[:2]) for x, y in zip(got, want))
        same_pos = np.array_equal(ga.pos[:2], gb.pos[:2])
        print(f"  decode_horizon ({arch}, {kind}, {kv or 'model-dtype'} "
              f"cache): {sum(x.shape[1] for x in got)} tokens a row through "
              f"the one-call surfaces, equal to decode_launch/decode_finish "
              f"bitwise: {same}; positions {[int(x) for x in ga.pos[:2]]} equal: "
              f"{same_pos}")
        if not (same and same_pos):
            raise AssertionError("decode_horizon disagrees with "
                                 "decode_launch/decode_finish")


def kernels_demo_phase(torch, ops) -> dict:
    """``examples/kernels_demo_torch.py``'s ``main`` in this process on the
    card: every kernel launched once on the demo's inputs, each within its
    tolerance of its plain version (f32: 1e-4; ssd and rglru their
    ``SCAN_TOL``). Returns the deviations."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kernels_demo_torch", ROOT / "examples" / "kernels_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    ops.reset_launches()
    errs = demo.main(["--device", "cuda"])
    counts = ops.launch_counts()
    tol = {name: SCAN_TOL.get(name, TOL["torch.float32"]) for name in counts}
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    if set(errs) != set(counts) or bad or set(counts.values()) != {1}:
        raise AssertionError(f"the kernel demo failed: over tolerance {bad}, "
                             f"launches {counts}")
    return errs


def u1_probe(torch, ops, card: str) -> dict:
    """ROADMAP queue 3, U1: whisper-medium's three full-width remat train
    steps (``WHISPER_TRAIN_ARGV``, ``--lr 3e-2``) with f32 params and
    activations in place of bf16. Prints the share of the elements of
    ``stacks/cross/wq`` and of all leaves that moved; the run must finish
    its three steps with finite losses, and the shares are not gated."""
    import gc
    from repro_torch.configs import get_config
    cfg = get_config("whisper-medium").replace(param_dtype="float32",
                                               dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    summary, moved, secs = watched_train(torch, WHISPER_TRAIN_ARGV, cfg)
    losses = [h["loss"] for h in summary["history"]]
    leaf = "stacks/cross/wq"
    share = {k: n / size for k, (n, size) in moved.items()}
    total = (sum(n for n, _ in moved.values())
             / max(sum(z for _, z in moved.values()), 1))
    least = min(share, key=share.get) if share else None
    out = {"seconds": secs, "losses": losses, "moved_fraction": total,
           "cross_wq_moved": share.get(leaf),
           "least_moved_leaf": [least, share.get(least)],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  U1 probe: launch.train {' '.join(WHISPER_TRAIN_ARGV)} in f32 "
          f"[{card}]: losses {[round(x, 4) for x in losses]}; {leaf} moved "
          f"{share.get(leaf)}; all elements {total:.4f}; least {least} "
          f"{share.get(least)}; {secs:.1f} s, peak {out['peak_gb']:.2f} GB")
    print("u1: " + json.dumps(out))
    if (summary["final_step"] != 3 or not np.all(np.isfinite(losses))
            or leaf not in share):
        raise AssertionError("the U1 probe's f32 training did not finish")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve6_quant_phase(torch, ops, card: str, s6: dict) -> dict:
    """Serve 6 (recurrentgemma-9b at full width, 38 layers, slot caches)
    with ``--kv-dtype int8`` and ``--kv-dtype fp8``: serve 1's checks, the
    ring in that precision, the launches the layout implies
    (``check_recurrent_launches``) and exactly those of the decoder's
    recorded calls (12 dense decode launches a decode step, as serve 6),
    none paged; wall, tok/s and peak beside serve 6's. Returns each
    serve's summary."""
    from repro_torch.configs import get_config
    from repro_torch.models import decoder
    cfg = get_config("recurrentgemma-9b")
    n_local = sum(s.mixer == "local_attn" for s in decoder.default_layout(cfg))
    out = {}
    for kv, argv in SERVE6_QUANT_ARGV.items():
        print(f"serve 6 {kv}:")
        with LayoutRecorder() as rec:
            s = serve_phase(torch, ops, card, argv)
        c = s["launches"]
        check_recurrent_launches(f"serve 6 {kv}", "recurrentgemma-9b", c)
        want = layout_launches(cfg, rec.calls)
        steps = sum(name == "decode_step" for name, _, _ in rec.calls)
        per_step = c["decode_attention"] / max(steps, 1)
        print(f"  serve 6 {kv} [{card}]: {s['wall_s']:.1f} s wall, "
              f"{s['tok_per_s']:.2f} tok/s, peak {s['peak_gb']:.2f} GB, KV "
              f"in {s['kv_dtype']}; serve 6 (model dtype): "
              f"{s6['wall_s']:.1f} s, {s6['tok_per_s']:.2f} tok/s, peak "
              f"{s6['peak_gb']:.2f} GB; {steps} decode steps, "
              f"{per_step:g} dense decode launches a step (the layout's "
              f"{n_local})")
        store = {"int8": "int8", "fp8": "float8_e4m3fn"}[kv]
        if (s["kv_dtype"] != store or c != want or per_step != n_local
                or steps < 1):
            raise AssertionError(f"serve 6 {kv} failed its checks: "
                                 f"{c} against {want}")
        out[kv] = s
    return out


class TickClock:
    """Within the block, a ``RAPEngine``'s clock advances 1 ms per reading
    (plus its own idle skips) instead of following the wall: a trace's
    arrivals and admissions then do not depend on how fast the card runs,
    so two serves of one argv take the same decisions. Its tok/s and
    latencies are on that clock; the phases print wall-clock rates."""

    def __enter__(self):
        from repro_torch.runtime import engine
        self._cls = engine.RAPEngine
        self._orig = self._cls._now

        def now(eng):
            eng._tick_s = getattr(eng, "_tick_s", 0.0) + 1e-3
            return eng._tick_s + eng._skew
        self._cls._now = now
        return self

    def __exit__(self, *exc):
        self._cls._now = self._orig
        return False


def sharded_serve_phase(torch, ops, card: str, s3: dict) -> dict:
    """Serve 3 and serve 3 on ``--executor sharded --mesh 1x1`` (an NCCL
    world of one), both on the ``TickClock``: the same masks and tokens,
    the same launches of every kernel, 0 overcommits, ``mesh_devices`` 1;
    their wall, tok/s and peak printed beside the real-clock serve 3's.
    Then ``--mesh auto`` (2 requests) must pick the same 1 x 1 mesh."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    t0 = time.perf_counter()
    with TickClock():
        print("serve 3 on the tick clock:")
        ref = serve_phase(torch, ops, card, SERVE3_ARGV)
        print("serve 3 sharded (1 x 1 mesh, NCCL world of one):")
        sh = serve_phase(torch, ops, card, SERVE3_SHARDED_ARGV)
    if dist.is_initialized():
        raise AssertionError("the sharded serve left its process group up")
    same = sh["streams"] == ref["streams"]
    launches = sh["launches"] == ref["launches"]
    stats = sh["bucket_stats"]
    rate = lambda r: r["generated_tokens"] / r["wall_s"]
    for name, r in (("serve 3 (real clock)", s3), ("serve 3 (tick clock)",
                                                   ref),
                    ("serve 3 sharded 1x1 (tick clock)", sh)):
        print(f"  {name} [{card}]: wall {r['wall_s']:.2f} s, "
              f"{rate(r):.2f} tok/s over the wall, peak {r['peak_gb']:.2f} "
              f"GB, launches {r['launches']}")
    print(f"  sharded vs tick-clock serve 3: tokens and masks equal {same}; "
          f"launches equal {launches}; executor {sh['executor']}, "
          f"mesh_devices {stats.get('mesh_devices')}")
    if (not same or not launches or stats.get("mesh_devices") != 1
            or sh["executor"] != "ShardedExecutor"):
        raise AssertionError("the sharded 1 x 1 serve is not serve 3")
    with TickClock():
        engine, rep = serve.main(SERVE3_AUTO_ARGV)
    shape = dict(engine.executor.mesh.shape)
    n = len(rep.results)
    done = sum(r.status == "done" for r in rep.results)
    print(f"  --mesh auto: {shape}, {done}/{n} done")
    del engine, rep
    if shape != {"data": 1, "model": 1} or done != n or n != 2:
        raise AssertionError("--mesh auto did not serve on the 1 x 1 mesh")
    print(f"  sharded serves: {time.perf_counter() - t0:.1f} s")
    return sh


def sharded_horizon_sync(torch) -> None:
    """A warmed sharded horizon (llama2-7b full width, 2 layers, 4 slots
    on the 1 x 1 mesh) launched under ``set_sync_debug_mode("error")``:
    no host-device synchronisation until its one read-back, the twin of
    JAX's zero-transfer test."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import masks
    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    from repro_torch.models import registry
    from repro_torch.runtime import ShardedExecutor
    t0 = time.perf_counter()
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        cfg = get_config("llama2-7b").replace(n_layers=2)
        model = registry.build(cfg)
        params = model.init(0, "cuda")
        ex = ShardedExecutor(model, mesh, params=params, max_active=4)
        full = masks.full_mask(cfg.n_layers)
        group = ex.group_for(full, 64)
        prompt = np.arange(16, dtype=np.int32)[None] % cfg.vocab_size
        ex.prefill_into(group, [0], "r0", prompt, full)
        ex.prefill_into(group, [2], "r1", prompt[:, :12], full)
        ex.decode_horizon(group, 4)                      # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks_dev, idx = group.launch_horizon(4, ex.decode_buckets)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        toks = toks_dev.cpu().numpy()                    # the one read-back
        print(f"  warmed sharded horizon under set_sync_debug_mode('error'): "
              f"no synchronisation before the read-back; tokens "
              f"{toks.shape}, full width {idx is None} "
              f"({time.perf_counter() - t0:.1f} s)")
        if idx is not None or toks.shape != (4, 4):
            raise AssertionError("the sharded horizon is not full width")
        del ex, params, group
    finally:
        destroy_distributed()
        gc.collect()
        torch.cuda.empty_cache()


def sharded_reference(torch, ops) -> None:
    """On an NCCL world of one, SMOKE f32: (a) a sharded 1 x 1 trace under
    a shock (80% of the KV headroom cut, ticks 3-13) gives the CPU's local
    unshocked tokens; (b) ``moe_ffn_ep`` on a model group of one is
    ``moe_ffn_scatter`` bit for bit and launches the GLU kernel on the
    expert buffer; (c) ``compress_allreduce`` gives the CPU quantizer's
    mean and residual bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import masks, memory
    from repro_torch.core.policy import DensePolicy
    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    from repro_torch.models import moe, registry
    from repro_torch.parallel import activation as act
    from repro_torch.parallel import compression
    from repro_torch.runtime import (EngineConfig, EngineRequest, RAPEngine,
                                     ShardedExecutor, TickStaircase)
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        cfg = get_smoke_config("llama2-7b").replace(
            n_layers=4, dtype="float32", param_dtype="float32")
        model = registry.build(cfg)
        cpu = model.init(0, "cpu")
        gpu = _tree_to(cpu, "cuda")
        mm = memory.build_memory_model(cfg)
        toks = torch.randint(0, cfg.vocab_size, (1, 24),
                             generator=torch.Generator().manual_seed(8)
                             ).numpy()
        full = masks.full_mask(cfg.n_layers)
        budget = mm.param_bytes(full) + 2.5 * mm.state_bytes(full, 1, 26)
        reqs = lambda: [EngineRequest(rid=f"r{i}",
                                      prompt=toks[:, : (16 if i % 2 else 24)])
                        for i in range(8)]
        want = shock_engine(model, cpu, mm, "local", None, budget, 32, 6, 2,
                            8).run(reqs())
        eng = RAPEngine(model, gpu, DensePolicy(mm), EngineConfig(
            mode="masked", max_new_tokens=6, max_active=4, max_len=32,
            budget_bytes=budget, tokens_per_page=8, decode_horizon=2),
            executor=ShardedExecutor(model, mesh, params=gpu, max_active=4))
        kvb = budget - eng.resident_param_bytes
        frac = (eng.resident_param_bytes + 0.2 * kvb) / budget
        got = eng.run(reqs(), budget_trace=TickStaircase(
            budget, [(3, 1.0), (10, frac), (0, 1.0)]))
        ref = {r.rid: r.tokens for r in want.results}
        same = all(np.array_equal(r.tokens, ref[r.rid])
                   for r in got.results if r.status == "done")
        done = sum(r.status == "done" for r in got.results)
        print(f"  sharded 1x1 shocked trace (f32, card) vs local (CPU): "
              f"{got.preempted_count} preempted, {done}/8 done, tokens "
              f"equal {same}")
        if not same or done != 8 or got.preempted_count < 1:
            raise AssertionError("the sharded shocked trace differs from "
                                 "the CPU's local tokens")
        mcfg = get_smoke_config("olmoe-1b-7b").replace(
            dtype="float32", param_dtype="float32")
        mp = _tree_to(registry.build(mcfg).init(0, "cpu"), "cuda")
        p = {k: mp["stacks"]["moe"][k][0] for k in ("wi", "wo", "router")}
        x = torch.randn(4, 16, mcfg.d_model,
                        generator=torch.Generator().manual_seed(3)).cuda()
        ops.reset_launches()
        with act.use(mesh):
            ep = moe.moe_ffn_ep(p, mcfg, x, act.policy())
        glu = ops.launch_counts()["fused_glu"]
        plain = moe.moe_ffn_scatter(p, mcfg, x)
        print(f"  moe_ffn_ep on a model group of one vs moe_ffn_scatter: "
              f"bitwise {torch.equal(ep, plain)}, GLU launches {glu}")
        if not torch.equal(ep, plain) or glu != 1:
            raise AssertionError("moe_ffn_ep on one rank is not the "
                                 "scatter dispatch")
        g = {"w": torch.randn(4096, generator=torch.Generator()
                              .manual_seed(5)),
             "b": torch.randn(3, 7, generator=torch.Generator()
                              .manual_seed(6)) * 1e-3}
        res = {k: torch.randn_like(v) * 1e-4 for k, v in g.items()}
        mean, new_r = compression.compress_allreduce(
            {k: v.cuda() for k, v in g.items()},
            {k: v.cuda() for k, v in res.items()})
        ok = True
        for k in g:
            v = g[k].float() + res[k]
            q, scale = compression._quantize(v)
            deq = q.float() * scale
            ok &= torch.equal(mean[k].cpu(), deq / 1)
            ok &= torch.equal(new_r[k].cpu(), v - deq)
        print(f"  compress_allreduce on a world of one vs the CPU's "
              f"quantizer: bitwise {bool(ok)}")
        if not ok:
            raise AssertionError("compress_allreduce differs from the CPU")
    finally:
        destroy_distributed()


MESH_TRAIN_ARGV = ["--arch", "llama2-7b", "--batch", "4", "--seq", "256",
                   "--steps", "3"]


def mesh_training(torch, ops) -> dict:
    """(Its own process, under deterministic algorithms: see
    ``exact_resume``.) ``launch.train`` on llama2-7b at full width and
    ``FULL_TRAIN``'s depth for 3 steps, without and with ``--mesh`` (an
    NCCL world of one); one ``make_compressed_train_step`` step; a
    ``Trainer(mesh=)`` re-meshed onto the same mesh. Returns the losses,
    the step's loss and movement, and whether the re-meshed state is
    bitwise the state before."""
    import contextlib
    import io
    import repro_torch.configs as configs
    from repro_torch.launch import train
    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.parallel import compression
    from repro_torch.runtime import Trainer, TrainerConfig, steps
    from repro_torch.runtime.trainer import to_device
    from repro_torch.data import SyntheticCorpus, batch_iterator
    from repro_torch.tree import flatten
    torch.use_deterministic_algorithms(True)
    cfg = configs.get_config("llama2-7b").replace(
        n_layers=FULL_TRAIN["layers"])
    get_config = configs.get_config
    configs.get_config = lambda name: cfg if name == "llama2-7b" else \
        get_config(name)
    out = {}
    try:
        for key, extra in (("meshless", []), ("mesh", ["--mesh"])):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = train.main(MESH_TRAIN_ARGV + extra)
            out[key] = _losses(summary)
            out[f"{key}_s"] = time.perf_counter() - t0
    finally:
        configs.get_config = get_config
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        model = registry.build(cfg)
        corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
        batch = to_device(next(batch_iterator(corpus, 4, 256)), "cuda")
        params = model.init(0, "cuda")
        before = {k: v.clone() for k, v in flatten(params).items()}
        step = steps.make_compressed_train_step(model, adamw.AdamWConfig(),
                                                mesh)
        new, _, res, metrics = step(params, adamw.init(params),
                                    compression.init_residuals(params),
                                    batch)
        out["compressed_loss"] = float(metrics["loss"])
        out["compressed_moved"] = max(
            float((v.float() - before[k].float()).abs().max())
            for k, v in flatten(new).items())
        del new, res, params, before
        tr = Trainer(model, adamw.AdamWConfig(lr=1e-4, total_steps=2),
                     TrainerConfig(total_steps=2, log_every=1, remat=True),
                     mesh=mesh, device="cuda")
        tr.run(batch_iterator(corpus, 4, 256), steps=1)
        was = {k: v.clone() for k, v in flatten(tr.gathered_state()).items()}
        tr.remesh(mesh)
        now = flatten(tr.gathered_state())
        out["remesh_bitwise"] = all(torch.equal(was[k], now[k])
                                    for k in was)
        more = tr.run(batch_iterator(corpus, 4, 256, start=tr.step), steps=1)
        out["after_remesh"] = _losses(more)
    finally:
        destroy_distributed()
    return out


def mesh_training_phase(torch, card: str) -> dict:
    """:func:`mesh_training` in a child process (``chip_smoke.py
    --mesh-train``, with ``CUBLAS_WORKSPACE_CONFIG`` set) and its checks."""
    import os
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-train"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    if child.returncode != 0:
        raise AssertionError(f"the mesh training run failed:\n"
                             f"{child.stdout[-2000:]}{child.stderr[-4000:]}")
    r = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"  launch.train [{card}] (llama2-7b full width, "
          f"{FULL_TRAIN['layers']} layers, B=4 S=256, 3 steps, deterministic "
          f"algorithms): meshless {r['meshless']} in {r['meshless_s']:.1f} s; "
          f"--mesh (1 x 1, NCCL) {r['mesh']} in {r['mesh_s']:.1f} s")
    print(f"  compressed step: loss {r['compressed_loss']:.4f}, largest "
          f"parameter move {r['compressed_moved']:.3e}; remesh onto the "
          f"same mesh bitwise {r['remesh_bitwise']}, then "
          f"{r['after_remesh']}; child {time.perf_counter() - t0:.1f} s")
    if (r["mesh"] != r["meshless"] or len(r["mesh"]) != 3
            or not np.isfinite(r["compressed_loss"])
            or not r["compressed_moved"] > 0 or not r["remesh_bitwise"]
            or not np.isfinite(list(r["after_remesh"].values())).all()):
        raise AssertionError("the mesh training phase failed its checks")
    return r


# the analysis phase: llama2-7b at full width on the 1 x 1 mesh at a decode
# shape one card holds (13.5 GB of bf16 weights, 17.2 GB of bf16 KV: 8 rows
# of a full 4096-token cache), and the sweep's keep fractions (32, 26, 19
# layers); the counted peak against the allocator's, within 2%; each
# variant's device-busy ms over the dense one's within 0.05 of its counted
# bound over the dense bound (the embedding and the head, which do not
# shrink, are under 1% of the bytes)
CARD_DECODE = ("card_decode", 4096, 8, "decode")
RAP_FRACS = (1.0, 0.8, 0.6)
ANALYSIS_STEPS = 20
PROFILED_STEPS = 5
PEAK_TOL = 0.02
SWEEP_TOL = 0.05
PRODUCTION_CELLS = (("qwen3-14b", "decode_32k"), ("gemma-2b", "train_4k"))


def production_cells(card: str) -> list:
    """The ``PRODUCTION_CELLS`` counted on a fake world of 256 ranks (no
    card), their records checked and their roofline rows printed."""
    import tempfile

    from repro_torch.launch import dryrun
    from repro_torch.roofline import analysis
    rows = []
    with tempfile.TemporaryDirectory() as d:
        for arch, shape in PRODUCTION_CELLS:
            t0 = time.perf_counter()
            r = dryrun.run_cell(arch, shape, False, d)
            if r.get("error") or not r["kernels"]:
                raise AssertionError(f"dry run {arch} x {shape}: "
                                     f"{r.get('error', 'no kernel calls')}")
            prev, analysis.DRYRUN_DIR = analysis.DRYRUN_DIR, d
            try:
                row = analysis.analyze_cell(arch, shape)
            finally:
                analysis.DRYRUN_DIR = prev
            rows.append(row)
            calls = {k: v["calls"] for k, v in r["kernels"].items()}
            print(f"  dry run {arch} x {shape} (fake world of 256, counted, "
                  f"not measured; counted on this host in "
                  f"{time.perf_counter() - t0:.1f} s): "
                  f"{r['cost']['flops'] / 1e12:.2f} TFLOP, "
                  f"{r['cost']['bytes_accessed'] / 1e9:.2f} GB, wire "
                  f"{r['collectives']['total_wire_bytes'] / 1e9:.3f} GB, peak "
                  f"{r['memory']['real_bytes'] / 1e9:.2f} GB a rank; kernels "
                  f"{calls}")
            print(f"    H100 terms: compute {row['compute_s']:.6f} s, memory "
                  f"{row['memory_s']:.6f} s, collective "
                  f"{row['collective_s']:.6f} s -> {row['dominant']}-bound, "
                  f"roofline_frac {row['roofline_frac']:.3f}, fits 80 GB "
                  f"{row['fits_hbm']} [data sheet, not {card}]")
    return rows


def device_busy_ms(torch, fn, steps: int) -> float:
    """Device-busy ms a call of ``fn``: the union of the device's activity
    intervals over ``steps`` calls under ``torch.profiler``, over
    ``steps``. The host's gaps between launches are left out, so on a
    host-bound step this is the time the card's work takes."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("torch.profiler recorded no device activity")
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3 / steps


def _plain_attention(q, k, v, valid, *, softcap=0.0, split_rows=0):
    from repro_torch.kernels import decode_attention as dec
    return dec.decode_attention_ref(q, k, v, valid, softcap=softcap)


def _library_attention(q, k, v, valid, *, softcap=0.0, split_rows=0):
    """The decode attention by ``scaled_dot_product_attention`` (boolean
    mask, no softcap: llama2-7b's)."""
    import torch
    H, K = q.shape[2], k.shape[2]
    kk, vv = (x.transpose(1, 2).repeat_interleave(H // K, 1) for x in (k, v))
    mask = valid if valid.ndim == 2 else valid[None].expand(q.shape[0], -1)
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kk, vv,
        attn_mask=mask[:, None, None, :]).transpose(1, 2)


def _library_glu(h, activation="swiglu"):
    """SwiGLU in PyTorch's own ops, in ``h``'s dtype."""
    import torch
    gate, up = h.chunk(2, dim=-1)
    return torch.nn.functional.silu(gate) * up


def decode_step_routes(torch, ops, step, params, cache, tokens) -> dict:
    """One decode step's logits three ways on the same inputs: through the
    kernels, through their plain versions and through PyTorch's own calls
    (the model code calls ``ops.decode_attention`` and ``ops.fused_glu``
    through ``ops``, so the two are swapped there for the call). The cache
    position is put back after each, so all three see the same cache."""
    from repro_torch.kernels import swiglu
    routes = {"kernels": (ops.decode_attention, ops.fused_glu),
              "plain": (_plain_attention, swiglu.glu_ref),
              "library": (_library_attention, _library_glu)}
    saved, pos, out = routes["kernels"], cache["pos"], {}
    try:
        for name, (attn, glu) in routes.items():
            ops.decode_attention, ops.fused_glu = attn, glu
            out[name], _ = step(params, cache, tokens)
            cache["pos"] = pos
    finally:
        ops.decode_attention, ops.fused_glu = saved
    return out


def rel_dist(a, b) -> float:
    """|a - b| / |b| (Frobenius)."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def random_cache(torch, cache, seed: int) -> None:
    """Fill a decode cache's K and V with normal values (seeded), so that
    the attention reads a cache worth comparing."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for v in cache["attn"].values():
        v.normal_(generator=g)


def analysis_step_f32(torch, ops) -> None:
    """llama2-7b at full width, 2 layers, f32, on ``CARD_DECODE``'s random
    cache: the decode step's logits through the kernels against its plain
    versions, elementwise at the f32 tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.runtime import steps
    _, S, B, _ = CARD_DECODE
    cfg = get_config("llama2-7b").replace(n_layers=2, param_dtype="float32",
                                          dtype="float32")
    model = registry.build(cfg)
    params = model.init(0, "cuda")
    cache = model.init_cache(B, S, device="cuda")
    random_cache(torch, cache, 5)
    cache["pos"] = S - 1
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), device="cuda",
                           dtype=torch.int32,
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    out = decode_step_routes(torch, ops, steps.make_decode_step(model),
                             params, cache, tokens)
    rel = rel_dist(out["kernels"], out["plain"])
    check(f"llama2-7b decode step logits B={B} S={S} f32, 2 layers, kernels "
          f"vs plain versions (|Δ|/|ref| {rel:.3e})", out["kernels"],
          out["plain"], torch.float32)


def analysis_phase(torch, ops, card: str) -> dict:
    """The production cells, then ``lower_decode``'s record of llama2-7b's
    decode step at ``CARD_DECODE`` beside the real step, and the RAP sweep
    measured (module docstring). Returns the timed steps' launches."""
    import gc
    import shutil
    import tempfile

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import rap_sweep
    from repro_torch.launch.mesh import destroy_distributed, make_host_mesh
    from repro_torch.models import registry
    from repro_torch.runtime import ShardedExecutor, steps
    from repro_torch.tree import flatten, unflatten
    t_phase = time.perf_counter()
    production_cells(card)
    analysis_step_f32(torch, ops)
    shape = ShapeConfig(*CARD_DECODE)
    _, S, B, _ = CARD_DECODE
    base = get_config("llama2-7b")
    mesh = make_host_mesh((1, 1), ("data", "model"), device="cuda")
    launches = dict.fromkeys(ops.launch_counts(), 0)
    rows = []
    out_dir = tempfile.mkdtemp(prefix="rap_sweep_")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        model = registry.build(base)
        params = model.init(0, "cuda")
        cache = model.init_cache(B, S, device="cuda")
        random_cache(torch, cache, 5)
        tokens = torch.randint(0, base.vocab_size, (B, 1), device="cuda",
                               dtype=torch.int32,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(3))
        for frac in RAP_FRACS:
            t0 = time.perf_counter()
            rec = rap_sweep.lower_pruned_decode("llama2-7b", shape, frac,
                                                out_dir, mesh=mesh)
            L = rec["n_layers"]
            count_s = time.perf_counter() - t0
            pm = registry.build(base.replace(n_layers=L))
            ex = ShardedExecutor(pm, mesh)
            p = unflatten(params, {k: v[:L] if k.startswith("stacks/") else v
                                   for k, v in flatten(params).items()})
            c = {"pos": S - 1, "attn": {n: v[:L]
                                         for n, v in cache["attn"].items()}}
            step = steps.make_decode_step(pm)

            def run():
                nonlocal c
                with ex.context():
                    _, c = step(p, c, tokens)
                c["pos"] = S - 1            # every step on the full cache
            for _ in range(3):
                run()
            if frac == 1.0:
                # the step the phase times, through the kernels, their plain
                # versions and PyTorch's own calls: 32 bf16 layers carry each
                # one's rounding on, so the kernels' step may lie no further
                # from the plain versions' than PyTorch's does (each kernel
                # alone is held elementwise at this shape in decode_cases,
                # the step in f32 by analysis_step_f32)
                with ex.context():
                    out = decode_step_routes(torch, ops, step, p, c, tokens)
                rk = rel_dist(out["kernels"], out["plain"])
                rl = rel_dist(out["library"], out["plain"])
                same = (out["kernels"].argmax(-1)
                        == out["plain"].argmax(-1)).float().mean()
                err = max_err(out["kernels"], out["plain"])
                print(f"  llama2-7b decode step logits B={B} S={S} bf16, {L} "
                      f"layers, against the plain versions: kernels "
                      f"|Δ|/|ref| {rk:.3e} (max|Δ| {err:.3e}), PyTorch's "
                      f"sdpa and GLU ops {rl:.3e}; greedy tokens equal "
                      f"{float(same):.3f}")
                if not (rk <= rl and torch.isfinite(out["kernels"]).all()):
                    raise AssertionError("the decode step through the "
                                         "kernels lies further from the plain "
                                         "versions than PyTorch's own calls")
                del out
            torch.cuda.synchronize()
            if frac == 1.0:
                torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(ANALYSIS_STEPS):
                run()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / ANALYSIS_STEPS
            busy = device_busy_ms(torch, run, PROFILED_STEPS)
            got = ops.launch_counts()
            for k, v in got.items():
                launches[k] += v
            n_steps = ANALYSIS_STEPS + PROFILED_STEPS
            per_step = {k: v["calls"] for k, v in rec["kernels"].items()}
            want = {k: v * n_steps for k, v in per_step.items()}
            if {k: v for k, v in got.items() if v} != want:
                raise AssertionError(f"keep {frac}: the record's kernel calls "
                                     f"{rec['kernels']} x {n_steps} are not "
                                     f"the real steps' launches {got}")
            terms = {"compute": rec["compute_s"], "memory": rec["memory_s"],
                     "collective": rec["collective_s"]}
            bound = max(terms.values())
            row = {"keep": frac, "layers": L, "ms": ms, "busy_ms": busy,
                   **terms, "dominant": max(terms, key=terms.get),
                   "share": bound * 1e3 / busy, "bound_s": bound}
            rows.append(row)
            print(f"  llama2-7b decode B={B} S={S} bf16, {L} layers (keep "
                  f"{frac}) [{card}]: device busy {busy:.4f} ms a step "
                  f"(torch.profiler, {PROFILED_STEPS} steps); wall {ms:.4f} "
                  f"ms a step (mean of {ANALYSIS_STEPS}, CUDA events, "
                  f"host-bound);"
                  f" counted (not measured, in {count_s:.1f} s): compute "
                  f"{rec['compute_s'] * 1e3:.4f} ms, memory "
                  f"{rec['memory_s'] * 1e3:.4f} ms, collective "
                  f"{rec['collective_s'] * 1e3:.4f} ms -> {row['dominant']}-"
                  f"bound; roofline share of the device time "
                  f"{row['share']:.3f} (of the wall {bound * 1e3 / ms:.3f}); "
                  f"kernel calls a step {per_step}, each launched so")
            if frac == 1.0:
                peak = torch.cuda.max_memory_allocated() - before
                counted = rec["real_gb"] * 1e9
                print(f"  peak over the steps [{card}]: "
                      f"{peak / 1e9:.3f} GB (max_memory_allocated) vs counted "
                      f"{counted / 1e9:.3f} GB ({peak / counted - 1:+.2%}, "
                      f"tolerance {PEAK_TOL:.0%})")
                if abs(peak / counted - 1) > PEAK_TOL:
                    raise AssertionError("the counted peak is not the card's")
            del ex, c, p
        dense = rows[0]
        for r in rows[1:]:
            want = r["bound_s"] / dense["bound_s"]
            got = r["busy_ms"] / dense["busy_ms"]
            print(f"  RAP sweep keep {r['keep']} ({r['layers']} layers) "
                  f"[{card}]: predicted bound {want:.3f}x of dense (counted), "
                  f"measured device busy {got:.3f}x (wall, host-bound "
                  f"{r['ms'] / dense['ms']:.3f}x; tolerance {SWEEP_TOL})")
            if abs(got - want) > SWEEP_TOL:
                raise AssertionError(f"keep {r['keep']}: the device time does "
                                     f"not follow the counted bound")
        del params, cache, tokens
    finally:
        destroy_distributed()
        shutil.rmtree(out_dir, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  analysis phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def serves(torch, ops, card: str) -> dict:
    """Serves 1-9 and serve 6 on int8 and fp8 slot caches, each with its
    checks; returns their launch counts (``c1``..``c9``, ``c6_int8``,
    ``c6_fp8``, serve 8's grid-0.6 run ``c8l``, serve 7's training
    ``c7_train``)."""
    print("serve:")
    s1 = serve_phase(torch, ops, card, SERVE_ARGV)
    c1 = s1["launches"]
    if (min(c1["paged_decode_attention"], c1["fused_glu"],
            c1["flash_attention"]) < 1 or c1["paged_decode_attention_quant"]
            or c1["decode_attention"]):
        raise AssertionError("serve 1 did not run the model-dtype kernels")
    print("serve 2:")
    s2 = serve_phase(torch, ops, card, SERVE2_ARGV)
    c2 = s2["launches"]
    print(f"  int8 pool {s2['n_pages']} pages vs serve 1's {s1['n_pages']} "
          f"({s2['n_pages'] / s1['n_pages']:.3f}x); in_use_scale "
          f"{s2['in_use_scale']:.4f}")
    if (s2["kv_dtype"] != "int8" or s2["in_use_scale"] >= 1.0
            or s2["n_pages"] < 1.8 * s1["n_pages"]
            or c2["paged_decode_attention_quant"] < 1
            or c2["paged_decode_attention"] != 0
            or min(c2["fused_glu"], c2["flash_attention"]) < 1):
        raise AssertionError("serve 2 failed its int8 checks")
    print("serve 3:")
    s3 = serve_phase(torch, ops, card, SERVE3_ARGV)
    c3 = s3["launches"]
    if (min(c3["decode_attention"], c3["fused_glu"],
            c3["flash_attention"]) < 1 or c3["paged_decode_attention"]
            or c3["paged_decode_attention_quant"]):
        raise AssertionError("serve 3 did not decode through the dense "
                             "decode kernel alone")
    c3s = sharded_serve_phase(torch, ops, card, s3)["launches"]
    print("serve 4:")
    t0 = time.perf_counter()
    c4 = serial_phase(torch, ops, card, SERVE4_ARGV)["launches"]
    print(f"  serve 4: {time.perf_counter() - t0:.1f} s")
    print("serve 5:")
    c5 = serve_phase(torch, ops, card, SERVE5_ARGV)["launches"]
    check_recurrent_launches("serve 5", "mamba2-370m", c5)
    print("serve 6:")
    s6 = serve_phase(torch, ops, card, SERVE6_ARGV)
    c6 = s6["launches"]
    check_recurrent_launches("serve 6", "recurrentgemma-9b", c6)
    s6q = serve6_quant_phase(torch, ops, card, s6)
    print("serve 7:")
    t0 = time.perf_counter()
    s7 = train_phase(torch, ops, card)
    print(f"  serve 7: {time.perf_counter() - t0:.1f} s")
    print("serve 8:")
    s8 = structural_phase(torch, ops, card, SERVE8_ARGV, s1)
    sig = s8["bucket_stats"]["bucket_signatures"]
    print(f"  serve 8: {sig} bucket signatures (pow2 bound 6), buckets of "
          f"{sorted(set(s8['bucket_layers']))} of 32 layers")
    if sig > 6:
        raise AssertionError("serve 8 minted more signatures than the pow2 "
                             "ladder holds")
    print("serve 8, layer buckets on a grid of 0.6:")
    s8l = structural_phase(torch, ops, card, SERVE8_LAYER_ARGV)
    small = min(s8l["bucket_layers"])
    print(f"  serve 8 (layer): smallest bucket {small} of 32 layers, "
          f"{s8l['launches']['flash_attention']} flash launches")
    if small >= 32:
        raise AssertionError("serve 8 (layer) ran no bucket below 32 layers")
    print("serve 9:")
    s9 = structural_phase(torch, ops, card, SERVE9_ARGV, s6)
    return {"c1": c1, "c2": c2, "c3": c3, "c4": c4, "c5": c5, "c6": c6,
            "c7": s7["launches"], "c7_train": s7["train_launches"],
            "c8": s8["launches"], "c8l": s8l["launches"],
            "c9": s9["launches"], "c6_int8": s6q["int8"]["launches"],
            "c6_fp8": s6q["fp8"]["launches"], "c3_sharded": c3s}


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--exact-resume", metavar="DIR",
                    help=argparse.SUPPRESS)    # the train phase's child
    ap.add_argument("--mesh-train", action="store_true",
                    help=argparse.SUPPRESS)    # the mesh phase's child
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(src/repro_torch not found beside this file)")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import rglru, ssd, swiglu
    from repro_torch.models import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.exact_resume:
        build.build()
        print(json.dumps(exact_resume(torch, ops, args.exact_resume)))
        return
    if args.mesh_train:
        build.build()
        print(json.dumps(mesh_training(torch, ops)))
        return
    card = card_line()
    print(f"card: {card}")
    t_start = t0 = time.perf_counter()
    lib = build.build()
    print(f"build: {len(build.SOURCES)} kernel sources with nvcc in "
          f"{time.perf_counter() - t0:.1f} s -> {lib}")

    print("kernels vs plain versions:")
    t0 = time.perf_counter()
    timed = {name: decode_timing(torch, dec, pdec, attention, *shape)
             for name, shape in DECODE_TIMED.items()}
    entries = [paged_cases(torch, ops, pdec, timed),
               paged_quant_cases(torch, ops, pdec, attention, timed),
               glu_cases(torch, ops, swiglu), flash_cases(torch, ops, fa),
               decode_cases(torch, ops, dec, pdec, attention, timed),
               ssd_cases(torch, ops, ssd), rglru_cases(torch, ops, rglru)]
    ring = ring_quant_cases(torch, ops, dec, attention)
    next(e for e in entries if e["name"] == "decode_attention").update(
        {f"max_abs_err_{k}_ring": v for k, v in ring.items()})
    for e in entries:
        for t in [e] + [x for x in e.values() if isinstance(x, dict)]:
            lib_ms = t["library_ms"]
            busy = (f" (device-only {t['busy_ms']:.4f})"
                    if "busy_ms" in t else "")
            print(f"  {e['name']} @ {t['shape']} [{card}]: kernel "
                  f"{t['ms']:.4f} ms{busy}, plain {t['plain_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), library "
                  f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms")
    print(f"kernels: {time.perf_counter() - t0:.1f} s")
    print("kernel gradients (KernelGrad) vs the plain versions' autograd:")
    t0 = time.perf_counter()
    grads = grad_cases(torch, ops, fa, swiglu, ssd, rglru)
    decode_refuses_grad(torch, ops)
    print(f"gradients: {time.perf_counter() - t0:.1f} s")
    print("reference:")
    t0 = time.perf_counter()
    reference_phase(torch)
    recurrent_reference(torch)
    reference_shock(torch)
    structural_reference(torch)
    training_reference(torch, ops)
    arch_reference(torch)
    fp8_slot_reference(torch)
    moe_reference(torch)
    whisper_reference(torch)
    recurrent_quant_reference(torch)
    decode_horizon_phase(torch)
    t1 = time.perf_counter()
    sharded_reference(torch, ops)
    print(f"  sharded reference: {time.perf_counter() - t1:.1f} s")
    print(f"reference: {time.perf_counter() - t0:.1f} s")
    print("kernel demo (examples/kernels_demo_torch.py):")
    t0 = time.perf_counter()
    demo = kernels_demo_phase(torch, ops)
    print(f"  kernel demo: {time.perf_counter() - t0:.1f} s")
    runs = serves(torch, ops, card)
    print("serve 10:")
    t0 = time.perf_counter()
    s10 = llmpruner_phase(torch, ops, card)
    print(f"  serve 10: {time.perf_counter() - t0:.1f} s")
    print("serve 11:")
    t0 = time.perf_counter()
    s11 = shortgpt_phase(torch, ops, card)
    print(f"  serve 11: {time.perf_counter() - t0:.1f} s")
    runs.update(c10=s10["launches"], c11=s11["launches"],
                c10_order=s10["order_launches"],
                c11_order=s11["order_launches"])
    t0 = time.perf_counter()
    runs.update({k: v["launches"] for k, v in
                 arch_serves(torch, ops, card).items()})
    print(f"  serves 12-16 and the fp8 slot serve: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe = moe_serves(torch, ops, card)
    runs.update({f"c_{arch}": s["launches"] for arch, s in moe.items()})
    print("whisper-medium:")
    whisper = whisper_phase(torch, ops, card)
    runs.update(c_whisper_bf16=whisper["bf16"]["launches"],
                c_whisper_int8=whisper["int8"]["launches"],
                c_whisper_train=whisper["train"]["launches"])
    print(f"  the MoE serves and whisper-medium: "
          f"{time.perf_counter() - t0:.1f} s")
    print("U1 probe (whisper-medium training in f32):")
    t0 = time.perf_counter()
    u1_probe(torch, ops, card)
    print(f"  U1 probe: {time.perf_counter() - t0:.1f} s")
    print("shock:")
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    shock = shock_phase(torch, ops, card, get_config("llama2-7b"))
    print(f"  shock and storm: {time.perf_counter() - t0:.1f} s")
    print("train:")
    t0 = time.perf_counter()
    tr = train_phase_full(torch, ops, card)
    runs.update(c_train_full=tr["full_width"]["launches"],
                c_train_subject=tr["subject"]["launches"],
                c_experiments=tr["experiments"]["launches"])
    print(f"  train: {time.perf_counter() - t0:.1f} s")
    print("multi-GPU on a 1 x 1 mesh (horizon syncs, launch.train --mesh):")
    t0 = time.perf_counter()
    sharded_horizon_sync(torch)
    mesh_training_phase(torch, card)
    print(f"  multi-GPU phases: {time.perf_counter() - t0:.1f} s")
    print("analysis (dry run on a fake world, lower_decode vs the card, "
          "the RAP sweep):")
    analysis_launches = analysis_phase(torch, ops, card)
    # each kernel's launches come from the serve whose path runs it
    c = runs
    home = {"paged_decode_attention_quant": c["c2"], "decode_attention":
            c["c3"], "ssd": c["c5"], "rglru": c["c6"]}
    for e in entries:
        e["launches"] = home.get(e["name"], c["c1"])[e["name"]]
        for i in range(1, 17):
            e[f"launches_serve{i}"] = c[f"c{i}"][e["name"]]
        e["launches_serve_fp8_slot"] = c["c_fp8_slot"][e["name"]]
        e["launches_serve3_sharded"] = c["c3_sharded"][e["name"]]
        for kv in ("int8", "fp8"):
            e[f"launches_serve6_{kv}"] = c[f"c6_{kv}"][e["name"]]
        e["demo_max_abs_err"] = demo[e["name"]]
        for key in ("olmoe-1b-7b", "dbrx-132b", "whisper_bf16",
                    "whisper_int8", "whisper_train"):
            e[f"launches_{key.replace('-', '_')}"] = c[f"c_{key}"][e["name"]]
        e["launches_experiments"] = c["c_experiments"][e["name"]]
        e["launches_serve8_layer_grid06"] = c["c8l"][e["name"]]
        e["launches_serve7_training"] = c["c7_train"][e["name"]]
        e["launches_serve10_llmpruner_order"] = c["c10_order"][e["name"]]
        e["launches_serve11_shortgpt_order"] = c["c11_order"][e["name"]]
        e["launches_train_full_width"] = c["c_train_full"][e["name"]]
        e["launches_train_subject"] = c["c_train_subject"][e["name"]]
        e["launches_analysis"] = analysis_launches[e["name"]]
        for name, run in shock.items():
            e[f"launches_{name.replace(' ', '_')}"] = run["launches"][
                e["name"]]
        e.update(grads.get(e["name"], {"grad_max_rel_err": None,
                                       "grad_cases": 0}))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s on {card}")
    print(f"device: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
