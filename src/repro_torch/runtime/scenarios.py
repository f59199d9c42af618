"""Fault-injection scenarios for the serving engine (DESIGN.md §11).

The engine's elastic-budget machinery (preemption, KV spill/resume,
cancellation) is only trustworthy if it survives adversarial traffic, so
this module packages three scenario families:

 * **budget-shock staircases** — the device budget is cut mid-serve (the
   paper's "runtime memory variation", `core/workload.py`'s OU walk in
   its most hostile form) and later restored; the engine must keep
   completing requests during the shock and recover its warmed
   throughput afterwards;
 * **cancellation storms** — a large fraction of in-flight requests is
   cancelled at random lifecycle stages (queued, prefilling,
   mid-horizon, preempted); the pool must end with zero live rids and
   zero leaked pages;
 * **heavy-tailed prompt mixes** — lognormal prompt lengths stress
   admission and preemption with co-resident requests of very different
   KV footprints.

Budget traces come in two forms, matching ``RAPEngine.run``:

 * :class:`TickStaircase` is **call-counting**: it steps on each engine
   tick, not at wall-clock breakpoints, so tests and benches get a
   deterministic number of pre-shock ticks regardless of how long a tick
   takes on the machine running them;
 * :func:`staircase_trace` / :func:`workload_budget_trace` build
   ``(t, bytes)`` breakpoint lists on the virtual clock — the form the
   serve CLI uses, where wall-time realism matters more than tick-exact
   determinism.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TickStaircase", "staircase_trace", "workload_budget_trace",
           "heavy_tailed_requests", "run_budget_shock",
           "run_cancellation_storm", "token_agreement"]


class TickStaircase:
    """Piecewise-constant budget over engine TICKS: ``phases`` is a list
    of ``(n_ticks, frac)`` — the budget is ``base_bytes * frac`` for the
    next ``n_ticks`` evaluations, holding the last phase's value once the
    phases are exhausted. The engine evaluates callable traces exactly
    once per tick, which makes this deterministic where wall-clock
    breakpoints are not (tick duration varies across machines)."""

    def __init__(self, base_bytes: float,
                 phases: Sequence[Tuple[int, float]]):
        if not phases:
            raise ValueError("TickStaircase needs at least one phase")
        self.base_bytes = float(base_bytes)
        self.phases = [(int(n), float(f)) for n, f in phases]
        if any(n < 0 for n, _ in self.phases):
            raise ValueError(f"phase tick counts must be >= 0, got "
                             f"{self.phases!r}")
        self.calls = 0

    def __call__(self, now: float) -> float:
        self.calls += 1
        left = self.calls
        for n, frac in self.phases:
            if left <= n:
                return self.base_bytes * frac
            left -= n
        return self.base_bytes * self.phases[-1][1]


def staircase_trace(base_bytes: float, t_down: float, t_up: float,
                    frac: float = 0.5) -> List[Tuple[float, float]]:
    """Breakpoint-list form of a single budget shock on the virtual
    clock: full budget until ``t_down``, ``frac`` of it until ``t_up``,
    full again after."""
    if not t_down < t_up:
        raise ValueError(f"shock window must satisfy t_down < t_up, got "
                         f"[{t_down}, {t_up})")
    return [(0.0, float(base_bytes)),
            (float(t_down), float(base_bytes) * float(frac)),
            (float(t_up), float(base_bytes))]


def workload_budget_trace(workload_requests,
                          base_bytes: float) -> List[Tuple[float, float]]:
    """Derive a budget trace from ``core/workload.py`` requests: each
    request's ``budget_frac`` (the OU memory-availability walk sampled at
    its arrival) becomes a breakpoint scaling the base budget — the
    serving loop finally consumes the trace the workload module has
    always synthesized."""
    return [(float(r.t), float(base_bytes) * float(r.budget_frac))
            for r in workload_requests]


def heavy_tailed_requests(tokens: np.ndarray, n: int, *, seed: int = 0,
                          rate: float = 200.0, min_len: int = 8,
                          max_len: int = 64, sigma: float = 0.8,
                          max_new: int = 4) -> List[Any]:
    """Poisson arrivals with LOGNORMAL prompt lengths clipped to
    ``[min_len, max_len]`` — a heavy-tailed mix where a few long prompts
    co-reside with many short ones, the regime where victim selection and
    page-granular admission actually differ from the uniform traces.
    Prompt token ids are sliced from ``tokens`` (any [1, >=max_len] int
    array). Deterministic in ``seed``."""
    from repro_torch.runtime.engine import EngineRequest
    rng = np.random.default_rng(seed)
    toks = np.asarray(tokens, np.int32)[:1]
    if toks.shape[1] < max_len:
        raise ValueError(f"token source holds {toks.shape[1]} tokens, "
                         f"need max_len={max_len}")
    med = math.sqrt(min_len * max_len)      # median in the middle (log scale)
    out = []
    t = 0.0
    for i in range(int(n)):
        t += float(rng.exponential(1.0 / rate))
        s = int(np.clip(rng.lognormal(math.log(med), sigma),
                        min_len, max_len))
        out.append(EngineRequest(rid=f"h{i}", prompt=toks[:, :s].copy(),
                                 arrival_t=t, max_new=max_new))
    return out


# ------------------------------------------------------------- scenarios
def _phase_stats(results, lo: float, hi: float) -> Dict[str, float]:
    """Completions whose finish lands in the virtual-clock window
    [lo, hi): count, generated tokens, tokens/s over the window, and
    ``slot_tok_per_s`` — tokens per second of request RESIDENCY
    (admission→finish, clipped to the window). The residency-normalized
    rate is what recovery gates compare: the raw window rate collapses
    at the drain tail when concurrency decays to one straggler, while
    per-residency throughput stays flat unless the engine actually got
    slower (leaked pages/slots stretch every residency)."""
    done = [r for r in results
            if r.status == "done" and lo <= r.finished_t < hi]
    toks = sum(r.tokens.size for r in done if r.tokens is not None)
    span = max(hi - lo, 1e-9)
    busy = sum(max(0.0, min(r.finished_t, hi) - max(r.admitted_t, lo))
               for r in done)
    return {"completed": float(len(done)), "tokens": float(toks),
            "tok_per_s": toks / span, "window_s": span,
            "slot_tok_per_s": toks / max(busy, 1e-9)}


def run_budget_shock(engine, requests, *, budget_bytes: float,
                     frac: float = 0.5, pre_ticks: Optional[int] = None,
                     shock_ticks: Optional[int] = None,
                     replays: int = 3) -> Dict[str, Any]:
    """Serve ``requests`` under a tick-staircase budget shock: full
    budget for ``pre_ticks`` ticks, then a cut taking ``frac`` of the
    **KV headroom** away for ``shock_ticks``, full again until drain.
    When the windows are not given they are auto-sized to ~30%/30% of
    the workload's estimated drain ticks, so the budget recovers while
    requests are still outstanding — a fixed window silently degenerates
    (no post-recovery completions to gate on) whenever the workload
    drains inside it.
    The cut is applied to the budget's KV share (budget − resident
    params), not the total: params stay resident through a shock, and at
    small model scale a 50% *total* cut would zero the pool outright
    instead of halving it — the interesting regime is the one where the
    engine must shed *some* victims and keep serving the rest. Phase
    windows are recovered from the report's ``budget_events`` (virtual
    clock), so the per-phase stats line up with what the engine actually
    applied.

    A caller gates on the returned dict: ``completed`` > 0 in both the
    shock and post phases (forward progress, no deadlock), and
    ``recovery_ratio`` — best-of-``replays`` full-budget replay tok/s
    AFTER the shocked run over the same measured BEFORE it. Recovery is
    steady state vs steady state on the same warmed engine: in-run
    phase-window rates (kept as diagnostics under ``pre``/``shock``/
    ``post``) are biased at small scale, where the drain tail runs below
    full concurrency. What the ratio owns is leakage: pages, slots or
    accounting corrupted by the shock show up as a permanently slower
    engine; on a shared host its clock spreads too widely to gate on
    alone. ``warm_report`` is the last unshocked run, the reference for
    the shocked run's tokens."""
    if pre_ticks is None or shock_ticks is None:
        cfg = engine.cfg
        h = max(int(getattr(cfg, "decode_horizon", 1) or 1), 1)
        slots = max(int(getattr(cfg, "max_active", 1) or 1), 1)
        longest = max((r.max_new if r.max_new is not None
                       else cfg.max_new_tokens) for r in requests)
        # one prefill tick + the decode horizons, in slot-width waves
        per_req = 1 + math.ceil(max(longest, 1) / h)
        est = math.ceil(len(requests) / slots) * per_req
        if pre_ticks is None:
            # a low floor drops the shock onto the FIRST resident wave
            # (mid-decode, reservations at their peak) — land it later
            # and the wave has drained, so nothing is left to preempt
            pre_ticks = max(3, round(0.3 * est))
        if shock_ticks is None:
            shock_ticks = max(6, round(0.3 * est))
    params = float(getattr(engine, "resident_param_bytes", 0.0))
    kv_share = max(budget_bytes - params, 0.0)
    shock_frac_total = (params + (1.0 - frac) * kv_share) / budget_bytes
    trace = TickStaircase(budget_bytes,
                          [(pre_ticks, 1.0), (shock_ticks, shock_frac_total),
                           (0, 1.0)])
    warm = [engine.run(requests) for _ in range(replays)]
    warmed_rate = max(r.tokens_per_s for r in warm)
    report = engine.run(requests, budget_bytes=budget_bytes,
                        budget_trace=trace)
    replay_rate = max(engine.run(requests).tokens_per_s
                      for _ in range(replays))
    # budget_events: (0, full) then one event per applied change; the
    # first drop below full opens the shock window, the return closes it
    t_down = t_up = None
    for t, b in report.budget_events[1:]:
        if t_down is None and b < budget_bytes:
            t_down = t
        elif t_down is not None and b >= budget_bytes:
            t_up = t
            break
    end = max(report.makespan_s, 1e-9)
    if t_down is None:                    # drained before the shock hit
        t_down = t_up = end
    elif t_up is None:                    # drained inside the shock
        t_up = end
    # the pre-shock window starts at the FIRST completion, not t=0:
    # cold-start compiles would otherwise depress the pre-shock rate and
    # flatter the recovery ratio (benches additionally warm up first)
    first_done = min((r.finished_t for r in report.results
                      if r.status == "done"), default=0.0)
    pre = _phase_stats(report.results, min(first_done, t_down), t_down)
    shock = _phase_stats(report.results, t_down, t_up)
    post = _phase_stats(report.results, t_up, end)
    return {
        "report": report,
        "warm_report": warm[-1],          # the same trace, unshocked
        "shock_frac": float(frac),
        "t_down": float(t_down), "t_up": float(t_up),
        "pre": pre, "shock": shock, "post": post,
        "preempted_count": report.preempted_count,
        "spilled_mb": report.spilled_mb,
        "resume_p50_s": report.resume_latency.get("p50", 0.0),
        "warmed_tok_per_s": float(warmed_rate),
        "replay_tok_per_s": float(replay_rate),
        "recovery_ratio": (replay_rate / warmed_rate
                           if warmed_rate > 0 else 0.0),
        "deadlock": False,                # engine.run returned ⇒ it drained
    }


def run_cancellation_storm(engine, requests, *, cancel_frac: float = 0.25,
                           seed: int = 0, start_tick: int = 2,
                           budget_trace: Optional[Any] = None,
                           budget_bytes: Optional[float] = None
                           ) -> Dict[str, Any]:
    """Serve ``requests`` while cancelling at least ``cancel_frac`` of
    them from the on_tick hook — each victim drawn at whatever lifecycle
    stage it happens to occupy (queued, prefilling, mid-horizon decode,
    or preempted when a ``budget_trace`` is also applied), which is the
    point: the cancel path must be safe at every stage, concurrently
    with in-flight scans. Victim draws are deterministic in ``seed``;
    the asserted invariants (zero live rids, zero leaked pages) are
    timing-independent.

    Returns the pool-ledger invariants a caller gates on."""
    rng = np.random.default_rng(seed)
    quota = int(math.ceil(cancel_frac * len(requests)))
    state = {"tick": 0, "cancelled": 0}

    def on_tick(eng):
        state["tick"] += 1
        if state["tick"] < start_tick or state["cancelled"] >= quota:
            return
        stages = ([r.rid for r in eng._pending]
                  + [rid for rid in eng._prefilling]
                  + [rid for rid in eng._running]
                  + [rid for rid in eng._preempted]
                  + [r.rid for r in
                     eng.scheduler.schedule(eng._now()).admit])
        if not stages:
            return
        # one victim per tick keeps every stage reachable across the
        # storm instead of emptying the engine in one burst
        rid = stages[int(rng.integers(0, len(stages)))]
        if eng.cancel(rid):
            state["cancelled"] += 1
        # double-cancel is part of the storm: must be a no-op
        assert eng.cancel(rid) is False

    report = engine.run(requests, budget_bytes=budget_bytes,
                        budget_trace=budget_trace, on_tick=on_tick)
    pool = engine.pool.stats()
    return {
        "report": report,
        "n_requests": len(requests),
        "cancelled": report.cancelled,
        "cancel_quota": quota,
        "done": sum(1 for r in report.results if r.status == "done"),
        "live_requests": pool["live_requests"],
        "spilled_requests": pool["spilled_requests"],
        "leaked_pages": pool["n_pages"] - pool["free_pages"],
        "preempted_count": report.preempted_count,
        "deadlock": False,
    }


def token_agreement(model, params, requests, ref_report,
                    report) -> Dict[str, Any]:
    """How far ``report``'s token streams agree with ``ref_report``'s (two
    runs of the same ``requests``, e.g. unshocked and shocked): requests
    with equal tokens, equal tokens counted over all, and, for the first
    request that differs, its first diverging (row, step) with the logit
    margin there — the reference run's token over the other run's, from a
    forward of the prompt and the reference tokens before the step, gated
    by the request's mask. A margin near 0 is a near tie: any change in
    the summation order can flip it."""
    import torch
    ref = {r.rid: r for r in ref_report.results if r.status == "done"}
    got = {r.rid: r for r in report.results if r.status == "done"}
    prompts = {r.rid: r.prompt for r in requests}
    out = {"requests": len(ref), "equal": 0, "tokens": 0,
           "equal_tokens": 0, "first": None}
    for rid, r in ref.items():
        g = got.get(rid)
        if g is None or g.tokens.shape != r.tokens.shape:
            continue
        same = g.tokens == r.tokens
        out["tokens"] += int(same.size)
        out["equal_tokens"] += int(same.sum())
        if same.all():
            out["equal"] += 1
            continue
        if out["first"] is not None:
            continue
        diff = np.argwhere(~same)
        row, step = (int(i) for i in diff[diff[:, 1].argmin()])
        dev = params["embed"].device
        ctx = np.concatenate([np.asarray(prompts[rid])[row],
                              r.tokens[row, :step]]).astype(np.int64)
        mask = torch.as_tensor(np.asarray(r.mask, np.float32), device=dev)
        L = mask.shape[0] // 2
        with torch.no_grad():
            logits = model.logits(
                params, {"tokens": torch.as_tensor(ctx, device=dev)[None]},
                gates={"mixer": mask[:L], "ffn": mask[L:]})[0, -1].float()
        a, b = int(r.tokens[row, step]), int(g.tokens[row, step])
        out["first"] = {"rid": rid, "row": row, "step": step,
                        "ref_token": a, "token": b,
                        "margin": float(logits[a] - logits[b])}
    return out
