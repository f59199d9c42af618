"""Continuous-batching RAP engine — shared-budget serving of concurrent
requests (the production form of paper Algorithm 3).

Many in-flight requests compete for one device budget, and the policy's
keep-mask decision is made against whatever the KV *pool* has left. The
engine is a thin loop over four seams:

  * :class:`~repro_torch.runtime.scheduler.Scheduler` — who is admitted
    next (FIFO / SJF / priority);
  * :class:`~repro_torch.core.policy.PruningPolicy` — what shape they run
    in: ``observe(PolicyState) → Decision`` against the remaining budget;
  * :class:`~repro_torch.runtime.executor.ModelExecutor` — how the mask
    executes (``PagedExecutor``: prefill into granted pages, horizon
    decode over the shared page pool);
  * :class:`~repro_torch.runtime.kv_pool.KVPool` — whether the bytes exist:
    page-granular admission against ``budget − resident params``.

One :meth:`RAPEngine._tick`:

  1. **launch** — every occupied group enqueues one decode horizon of up to
     ``EngineConfig.decode_horizon`` tokens on the current CUDA stream;
     the tokens stay on the device;
  2. **host phase** — arrivals (virtual clock; idle gaps are skipped,
     compute time is real), admission (policy decision, page grant,
     prefill) while the horizon runs;
  3. **finish** — the one device→host read of the horizon's tokens, folded
     into the requests resident at launch; completion is checked at the
     horizon boundary and over-generated tokens are truncated, so results
     are identical for any horizon.

Budget traces with preemption, ``cancel``, chunked prefill, structural
mode and ``force`` admission are later slices (ROADMAP queue 1, items 4
and 7–9) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import masks as masks_lib
from repro_torch.core.policy import Decision, PolicyState, PruningPolicy
from repro_torch.runtime.executor import ModelExecutor, PagedExecutor
from repro_torch.runtime.kv_pool import KVPool
from repro_torch.runtime.latency import summarize as _lat_summarize
from repro_torch.runtime.scheduler import Scheduler, make_scheduler

__all__ = ["EngineConfig", "EngineRequest", "RequestResult", "EngineReport",
           "RAPEngine"]


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ------------------------------------------------------------------- config
@dataclasses.dataclass
class EngineConfig:
    mode: str = "masked"              # masked (structural: ROADMAP item 8)
    max_new_tokens: int = 16
    max_active: int = 8               # decode slots (decode batch)
    max_len: int = 256                # prompt + generated tokens per row
    budget_bytes: float = 0.0         # TOTAL device budget (params + states)
    tokens_per_page: int = 16
    kv_dtype: Any = None
    admission: str = "strict"         # strict (force: ROADMAP item 9)
    # Admission quantizes the effective budget DOWN to this fraction of the
    # request's dense peak before calling the policy, so steady-state
    # admissions hit the policy's memo table. The page allocator, not the
    # decision, enforces the byte budget.
    budget_quantum_frac: float = 0.05
    # decode batch buckets: occupied slots step in the smallest bucket that
    # holds them; () = always full width
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # tokens per decode horizon (clamped per tick to the group's largest
    # remaining need and, while requests queue, its soonest completion)
    decode_horizon: int = 8
    max_prefill_tokens: int = 0       # >0 chunked prefill: ROADMAP item 4

    def __post_init__(self):
        if self.mode == "structural":
            raise NotImplementedError(
                "structural mode is ROADMAP queue 1, item 8")
        if self.mode != "masked":
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.admission == "force":
            raise NotImplementedError(
                "force admission (the one-shot slot path) is ROADMAP "
                "queue 1, item 9")
        if self.admission != "strict":
            raise ValueError(f"unknown admission {self.admission!r}")
        if self.max_prefill_tokens > 0:
            raise NotImplementedError(
                "chunked prefill is ROADMAP queue 1, item 4")
        if self.max_prefill_tokens < 0:
            raise ValueError(f"max_prefill_tokens must be >= 0, got "
                             f"{self.max_prefill_tokens!r}")
        if not (0.0 <= self.budget_quantum_frac <= 1.0):
            raise ValueError(
                f"budget_quantum_frac must be in [0, 1], got "
                f"{self.budget_quantum_frac!r}")
        if self.max_active < 1:
            raise ValueError(f"max_active must be >= 1, got "
                             f"{self.max_active!r}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len!r}")
        if self.max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got "
                             f"{self.max_new_tokens!r}")
        if self.tokens_per_page < 1:
            raise ValueError(f"tokens_per_page must be >= 1, got "
                             f"{self.tokens_per_page!r}")
        if self.budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got "
                             f"{self.budget_bytes!r}")
        if any(int(b) < 1 for b in self.decode_buckets):
            raise ValueError(f"decode_buckets must be positive slot counts, "
                             f"got {self.decode_buckets!r}")
        if self.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, got "
                             f"{self.decode_horizon!r}")


@dataclasses.dataclass
class EngineRequest:
    rid: str                          # unique among in-flight requests
    prompt: np.ndarray                # int32 [b, S]
    arrival_t: float = 0.0
    max_new: Optional[int] = None     # generated tokens (≥1); None → default
    priority: int = 0                 # PriorityScheduler rank (lower=sooner)


@dataclasses.dataclass
class RequestResult:
    rid: str
    status: str                       # done | rejected
    tokens: Optional[np.ndarray]      # [b, generated]
    mask: Optional[np.ndarray]
    arrival_t: float
    admitted_t: float
    finished_t: float
    queue_delay_s: float
    decide_s: float
    fits: bool
    cached_decision: bool
    peak_bytes: float
    kv_bytes: float
    reason: str = ""
    # time to first token, measured from ARRIVAL (-1.0 for rejected)
    ttft_s: float = -1.0


@dataclasses.dataclass
class EngineReport:
    results: List[RequestResult]
    wall_s: float                     # real compute wall time
    makespan_s: float                 # virtual: includes skipped arrival gaps
    generated_tokens: int
    tokens_per_s: float               # generated / makespan_s
    mean_queue_delay_s: float
    budget_fit_rate: float            # admitted requests whose peak fit
    rejected: int
    decode_iters: int                 # macro-ticks (horizons), not tokens
    pool: Dict[str, float]
    # wall time spent launching device work and reading it back
    launch_s: float = 0.0
    # mean over decode ticks of 1 − used / physical KV bytes
    measured_frag: float = 0.0
    # latency summaries (runtime.latency.summarize dicts, seconds)
    ttft: Dict[str, float] = dataclasses.field(default_factory=dict)
    itl: Dict[str, float] = dataclasses.field(default_factory=dict)

    def result(self, rid: str) -> RequestResult:
        for r in self.results:
            if r.rid == rid:
                return r
        raise KeyError(rid)


@dataclasses.dataclass
class _Running:
    req: EngineRequest
    decision: Decision
    group: Any
    slots: List[int]
    admitted_t: float
    kv_bytes: float
    max_new: int
    out: List[np.ndarray]            # per generated step: [b] tokens
    # token-emission events (virtual time, tokens appended): the first is
    # the prefill's token (TTFT anchor); each horizon appends one
    events: List[Tuple[float, int]] = dataclasses.field(default_factory=list)


# ------------------------------------------------------------------- engine
class RAPEngine:
    """Thin orchestration loop: Scheduler × PruningPolicy × ModelExecutor
    × KVPool."""

    def __init__(self, model, params, policy: PruningPolicy,
                 cfg: Optional[EngineConfig] = None, *,
                 scheduler: Optional[Scheduler] = None,
                 executor: Optional[ModelExecutor] = None):
        if not isinstance(policy, PruningPolicy):
            raise TypeError(f"RAPEngine requires a PruningPolicy, got "
                            f"{type(policy).__name__}")
        self.model = model
        self.mcfg = model.cfg
        self.params = params
        self.policy = policy
        self.cfg = dataclasses.replace(cfg if cfg is not None
                                       else EngineConfig())
        self.mm = policy.mm
        self.scheduler = make_scheduler(scheduler)
        self.executor = executor if executor is not None else PagedExecutor(
            model, params, max_active=self.cfg.max_active,
            kv_dtype=self.cfg.kv_dtype,
            decode_buckets=self.cfg.decode_buckets)
        if not getattr(self.executor, "paged", False):
            raise NotImplementedError(
                "the slot-cache executor is ROADMAP queue 1, item 9; the "
                "engine serves through PagedExecutor")
        self.resident_param_bytes = self.mm.param_bytes(
            masks_lib.full_mask(self.mcfg.n_layers))
        self.pool: Optional[KVPool] = None
        self._pending: List[EngineRequest] = []
        self._running: Dict[str, _Running] = {}
        self._results: List[RequestResult] = []
        self._ttft_samples: List[float] = []
        self._itl_samples: List[float] = []
        self._frag_samples: List[float] = []
        self._decode_iters = 0
        self._t0 = 0.0
        self._skew = 0.0
        self._budget = self.cfg.budget_bytes

    def _now(self) -> float:
        return (time.perf_counter() - self._t0) + self._skew

    def _make_pool(self, budget_bytes: float) -> KVPool:
        # the physical page size is dictated by the model's KV geometry
        page = self.executor.page_phys_bytes(self.cfg.tokens_per_page)
        cap = budget_bytes - self.resident_param_bytes
        if cap < page:
            raise ValueError(
                f"budget {budget_bytes:.0f}B leaves no KV pool after "
                f"resident params ({self.resident_param_bytes:.0f}B)")
        return KVPool(cap, page_bytes=page,
                      tokens_per_page=self.cfg.tokens_per_page)

    # ------------------------------------------------------------- serving
    def run(self, requests: List[EngineRequest], *,
            budget_bytes: Optional[float] = None,
            budget_trace: Any = None) -> EngineReport:
        """Serve a trace to completion and report aggregate stats."""
        if budget_trace is not None:
            raise NotImplementedError(
                "time-varying budgets with preemption are ROADMAP queue 1, "
                "item 7")
        budget = self.cfg.budget_bytes if budget_bytes is None else budget_bytes
        self.pool = self._make_pool(budget)
        self.executor.bind_pool(self.pool, self.cfg.max_len)
        self._budget = budget
        self._pending = sorted(requests, key=lambda r: r.arrival_t)
        self.scheduler.clear()
        self._running.clear()
        self._results = []
        self._ttft_samples, self._itl_samples = [], []
        self._frag_samples = []
        self._decode_iters = 0
        launch_s0 = self.executor.launch_s
        self._skew = 0.0
        self._t0 = time.perf_counter()
        while self._pending or len(self.scheduler) or self._running:
            self._tick()
        makespan = self._now()
        wall = time.perf_counter() - self._t0
        done = [r for r in self._results if r.status == "done"]
        gen = sum(r.tokens.size for r in done)
        delays = [r.queue_delay_s for r in done]
        return EngineReport(
            results=self._results,
            wall_s=wall,
            makespan_s=makespan,
            generated_tokens=gen,
            tokens_per_s=gen / max(makespan, 1e-9),
            mean_queue_delay_s=float(np.mean(delays)) if delays else 0.0,
            budget_fit_rate=(float(np.mean([r.fits for r in done]))
                             if done else 0.0),
            rejected=sum(1 for r in self._results if r.status == "rejected"),
            decode_iters=self._decode_iters,
            pool=self.pool.stats(),
            launch_s=self.executor.launch_s - launch_s0,
            measured_frag=(float(np.mean(self._frag_samples))
                           if self._frag_samples else 0.0),
            ttft=_lat_summarize(self._ttft_samples),
            itl=_lat_summarize(self._itl_samples))

    def cancel(self, rid: str) -> bool:
        raise NotImplementedError("cancel() is ROADMAP queue 1, item 7")

    def _tick(self) -> None:
        """launch → host phase (arrivals, admission) → finish. A request
        admitted during the host phase joins decode from the NEXT tick: its
        slots were free padding when this tick's horizon launched."""
        now = self._now()
        plan = self.scheduler.schedule(now, running=list(self._running))
        backlog = (len(self.scheduler) > 0
                   or bool(self._pending
                           and self._pending[0].arrival_t <= now))
        launches = self._launch_decode(plan.decode, backlog=backlog)
        # ---- host phase (device work in flight from here to finish) ----
        while self._pending and self._pending[0].arrival_t <= now:
            req = self._pending.pop(0)
            if req.rid in self.scheduler or req.rid in self._running:
                self._reject(req, f"duplicate request id {req.rid!r} "
                                  f"(already in flight)")
                continue
            max_new = (self.cfg.max_new_tokens if req.max_new is None
                       else req.max_new)
            cost = req.prompt.shape[0] * (req.prompt.shape[1]
                                          + max(max_new, 1))
            self.scheduler.add(req, cost=cost)
        deferred = None
        for req in self.scheduler.schedule(now).admit:
            verdict = self._try_admit(req)
            if verdict == "defer":
                deferred = req
                break
            self.scheduler.remove(req.rid)
        # a deferral with nothing launched or running can never be
        # satisfied: no completion will free what it waits on
        stuck = deferred is not None and not launches and not self._running
        # ---- finish: the tick's one read-back --------------------------
        if launches:
            self._finish_decode(launches)
        if not self._running:
            if stuck:
                self.scheduler.remove(deferred.rid)
                self._reject(deferred, "deferred with idle engine")
            elif deferred is None and self._pending:
                # fast-forward the virtual clock across the idle gap
                self._skew += max(self._pending[0].arrival_t - self._now(),
                                  0.0) + 1e-9

    # ----------------------------------------------------------- admission
    def _reject(self, req: EngineRequest, reason: str) -> None:
        now = self._now()
        self._results.append(RequestResult(
            rid=req.rid, status="rejected", tokens=None, mask=None,
            arrival_t=req.arrival_t, admitted_t=-1.0, finished_t=now,
            queue_delay_s=now - req.arrival_t, decide_s=0.0, fits=False,
            cached_decision=False, peak_bytes=0.0, kv_bytes=0.0,
            reason=reason))

    def _try_admit(self, req: EngineRequest) -> str:
        """→ 'admitted' | 'defer' | 'rejected' (rejection recorded here)."""
        b, S = req.prompt.shape
        max_new = (self.cfg.max_new_tokens if req.max_new is None
                   else req.max_new)
        # prefill always yields one token, so the floor is 1
        max_new = max(max_new, 1)
        total = S + max_new
        if req.rid in self._running:
            self._reject(req, f"duplicate request id {req.rid!r} "
                              f"(already in flight)")
            return "rejected"
        if total > self.cfg.max_len or b > self.cfg.max_active:
            self._reject(req, f"shape (b={b}, prompt+gen={total}) exceeds "
                              f"engine capacity ({self.cfg.max_active} "
                              f"slots × {self.cfg.max_len})")
            return "rejected"
        # keep-mask against the REMAINING shared budget, quantized down so
        # steady-state admissions hit the policy's memo table
        eff = self._budget - self.pool.bytes_reserved
        quantum = self.cfg.budget_quantum_frac * self.mm.dense_peak(b, total)
        if quantum > 0:
            eff = np.floor(eff / quantum + 1e-9) * quantum
        d = self.policy.observe(PolicyState(
            batch=b, total_len=total, budget_bytes=eff,
            reserved_bytes=self.pool.bytes_reserved,
            capacity_bytes=self.pool.acct.capacity_bytes,
            n_running=len(self._running), now=self._now()))
        kv_bytes = self.mm.state_bytes(d.mask, b, total)
        # page-granular admission: masked mode stores every layer's KV
        # whatever the mask says, so the charge is the worst-case PAGE
        # commitment, not the analytical byte count
        if not self.pool.fits_capacity_tokens(b, total):
            self._reject(req, f"{self.pool.pages_for_tokens(b, total)} pages "
                              f"({b}×{total} tokens) can never fit pool "
                              f"capacity of {self.pool.n_pages} pages")
            return "rejected"
        if not self.pool.can_alloc_tokens(b, total):
            return "defer"
        group = self.executor.group_for(d.mask)
        free = group.free_slots()
        if len(free) < b:
            return "defer"
        slots = free[:b]
        admitted_t = self._now()
        # grant pages backing the prompt now; commit the decode tail
        prompt_bytes = self.mm.state_bytes(d.mask, b, S)
        rate = max(kv_bytes - prompt_bytes, 0.0) / max(total - S, 1)
        self.pool.alloc_tokens(req.rid, b, S, max_tokens=total,
                               in_use_bytes=prompt_bytes,
                               in_use_per_token=rate, kv_dtype=d.kv_dtype)
        first = self.executor.prefill_into(
            group, slots, req.rid, np.asarray(req.prompt, np.int32), d.mask)
        run = _Running(req=req, decision=d, group=group, slots=slots,
                       admitted_t=admitted_t, kv_bytes=kv_bytes,
                       max_new=max_new, out=[first],
                       events=[(self._now(), 1)])
        self._running[req.rid] = run
        if run.max_new <= len(run.out):
            self._complete(run)
        return "admitted"

    # --------------------------------------------------------------- decode
    def _launch_decode(self, decode_plan: Optional[List[str]],
                       backlog: bool = False) -> List[Tuple[Any, set]]:
        """Launch one horizon per occupied group named in the decode plan,
        without reading it back. Returns the launches paired with the rids
        resident at launch (the only requests their tokens belong to)."""
        launches: List[Tuple[Any, set]] = []
        if not self._running:
            return launches
        allowed = None if decode_plan is None else set(decode_plan)
        for group in self.executor.groups():
            if not group.occupied():
                continue
            runs = [run for run in self._running.values()
                    if run.group is group]
            if not runs or (allowed is not None
                            and not any(r.req.rid in allowed for r in runs)):
                continue
            # clamp to the group's largest remaining need, pow2-quantized;
            # while requests wait, to its soonest completion so finished
            # requests hand their capacity to the queue early
            remaining = max((run.max_new - len(run.out) for run in runs),
                            default=1)
            horizon = min(self.cfg.decode_horizon,
                          _next_pow2(max(remaining, 1)))
            if backlog:
                soonest = min((run.max_new - len(run.out) for run in runs),
                              default=1)
                horizon = min(horizon, _next_pow2(max(soonest, 1)))
            launches.append((self.executor.decode_launch(group, horizon),
                             {run.req.rid for run in runs}))
        return launches

    def _finish_decode(self, launches: List[Tuple[Any, set]]) -> None:
        """Read back each launched horizon and fold its tokens into the
        requests resident at launch; truncate past ``max_new``."""
        for launch, rids in launches:
            toks = self.executor.decode_finish(launch)
            now = self._now()
            for rid in rids:
                run = self._running.get(rid)
                if run is None:
                    continue
                need = run.max_new - len(run.out)
                if need <= 0:
                    continue
                cols = toks[np.asarray(run.slots)]     # [b, horizon]
                n = min(need, launch.horizon)
                for h in range(n):
                    run.out.append(cols[:, h])
                run.events.append((now, n))
        self._decode_iters += 1
        used, phys = self.executor.kv_utilization()
        if phys > 0:
            self._frag_samples.append(1.0 - used / phys)
        done = [run for run in self._running.values()
                if len(run.out) >= run.max_new]
        by_group: Dict[int, Tuple[Any, List[int]]] = {}
        for run in done:
            by_group.setdefault(id(run.group), (run.group, []))[1].extend(
                run.slots)
        for group, slots in by_group.values():
            group.evict(slots)
        for run in done:
            self._complete(run, evict=False)

    def _complete(self, run: _Running, *, evict: bool = True) -> None:
        if evict:
            run.group.evict(run.slots)
        self.pool.free(run.req.rid)
        now = self._now()
        d = run.decision
        ttft = run.events[0][0] - run.req.arrival_t
        self._ttft_samples.append(ttft)
        prev = run.events[0][0]
        for t, n in run.events[1:]:
            self._itl_samples.extend([(t - prev) / max(n, 1)] * n)
            prev = t
        result = RequestResult(
            rid=run.req.rid, status="done",
            tokens=np.stack(run.out, axis=1),       # [b, generated]
            mask=d.mask, arrival_t=run.req.arrival_t,
            admitted_t=run.admitted_t, finished_t=now,
            queue_delay_s=run.admitted_t - run.req.arrival_t,
            decide_s=d.latency_s, fits=d.fits, cached_decision=d.cached,
            peak_bytes=d.peak_bytes, kv_bytes=run.kv_bytes, ttft_s=ttft)
        self._results.append(result)
        del self._running[run.req.rid]
        self.policy.feedback(result)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.executor.stats())
        out["requests"] = {
            r.rid: {"queue_delay_s": r.queue_delay_s, "ttft_s": r.ttft_s,
                    "prefill_s": max(r.ttft_s - r.queue_delay_s, 0.0)}
            for r in self._results if r.status == "done"}
        return out
