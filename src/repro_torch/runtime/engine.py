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
    executes (``LocalExecutor``, the default: dense slot caches per cache
    length; ``PagedExecutor``: prefill into granted pages, horizon decode
    over the shared page pool);
  * :class:`~repro_torch.runtime.kv_pool.KVPool` — whether the bytes exist:
    admission against ``budget − resident params``, byte-granular on the
    slot path (the request's analytical state bytes, quantized bytes for an
    int8 cache) and page-granular on the paged path (its worst-case page
    commitment).

One :meth:`RAPEngine._tick`:

  0. **budget** — under a budget trace, re-evaluate the device budget on
     the virtual clock and, if the bytes reserved now exceed it, preempt
     running victims (``Scheduler.select_victims`` order): their decode
     state and KV pages are copied to the host and their slots and pages
     freed. Nothing is in flight at this point of the tick, so the copies
     race no launch;
  1. **launch** — every occupied group enqueues one decode horizon of up to
     ``EngineConfig.decode_horizon`` tokens on the current CUDA stream;
     the tokens stay on the device;
  2. **host phase** — the ``on_tick`` hook, arrivals (virtual clock; idle
     gaps are skipped, compute time is real), resumes of preempted
     requests the budget has room for (before any new admission), then
     admission (policy decision, page grant, prefill) while the horizon
     runs;
  3. **finish** — the one device→host read of the horizon's tokens, folded
     into the requests resident at launch; completion is checked at the
     horizon boundary and over-generated tokens are truncated, so results
     are identical for any horizon.

A resumed request decodes on from its restored state, so its tokens are
those of a run that never preempted it (DESIGN.md §11). ``cancel(rid)``
removes a request at any stage (pending, queued, prefilling, decoding,
preempted) and frees what it holds; ``run`` releases pages, slots and
spill copies before re-raising an exception.

With ``EngineConfig.max_prefill_tokens > 0`` admission grants only the
first chunk's pages and every in-flight chunked prefill advances one
chunk per tick in the host phase, so a long prompt cannot stall running
decodes for more than one chunk.

``admission="force"`` (the one-shot ``RAPServer``, slot path only) runs
every request against the budget exactly as given, grows capacity for an
oversize request when nothing runs, and records an overcommit instead of
queueing.

``mode="structural"`` runs each request in its mask's bucket (the
executor's retained-layer group, ``bucket_quant`` snapping masks onto a
ladder). Under strict admission a request first tries *bucket affinity*
(:meth:`RAPEngine._sticky_decision`): an existing group whose minting mask
fits the remaining budget hosts it without a policy decision, so a
drifting pool level does not mint a bucket per admission. Results carry
the group's bucket signature (``()`` in masked mode).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import masks as masks_lib
from repro_torch.core.memory import dtype_bytes
from repro_torch.core.policy import Decision, PolicyState, PruningPolicy
from repro_torch.runtime.executor import (LocalExecutor, ModelExecutor,
                                          chunk_widths)
from repro_torch.runtime.kv_pool import (KVPool, default_page_bytes,
                                         resolve_kv_dtype)
from repro_torch.runtime.latency import summarize as _lat_summarize
from repro_torch.runtime.scheduler import (Scheduler, VictimCandidate,
                                           make_scheduler)

__all__ = ["EngineConfig", "EngineRequest", "RequestResult", "EngineReport",
           "RAPEngine"]


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _kv_byte_ratio(kv_dtype, mcfg) -> float:
    """Stored-vs-model KV bytes of a slot cache: an int8/fp8 cache holds
    1-byte elements plus one f32 scale per (token, kv head), while the
    analytical memory model charges at the model's KV width."""
    _, _, quantized, _ = resolve_kv_dtype(kv_dtype)
    if not quantized:
        return 1.0
    dh = max(int(mcfg.dh), 1)
    return (dh * 1.0 + 4.0) / (dh * dtype_bytes(mcfg.dtype))


# ------------------------------------------------------------------- config
@dataclasses.dataclass
class EngineConfig:
    mode: str = "masked"              # masked | structural
    max_new_tokens: int = 16
    max_active: int = 8               # decode slots (decode batch)
    max_len: int = 256                # prompt + generated tokens per row
    budget_bytes: float = 0.0         # TOTAL device budget (params + states)
    tokens_per_page: int = 16
    kv_dtype: Any = None
    admission: str = "strict"         # strict (queue) | force (overcommit)
    # Admission quantizes the effective budget DOWN to this fraction of the
    # request's dense peak before calling the policy, so steady-state
    # admissions hit the policy's memo table. The page allocator, not the
    # decision, enforces the byte budget.
    budget_quantum_frac: float = 0.05
    # slot path: "max" gives one max_len cache per group family (requests of
    # every length share one decode batch); "pow2" mints one group per
    # power-of-two cache length, so a long request does not invalidate the
    # short groups (RAPServer's setting)
    len_buckets: str = "max"
    # decode batch buckets: occupied slots step in the smallest bucket that
    # holds them; () = always full width
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # tokens per decode horizon (clamped per tick to the group's largest
    # remaining need and, while requests queue, its soonest completion)
    decode_horizon: int = 8
    # >0: prompts prefill in pow2 chunks of at most this many tokens, one
    # chunk per tick (0 = monolithic prefill)
    max_prefill_tokens: int = 0
    # Elastic budgets (DESIGN.md §11): under a run() budget_trace that
    # shrinks below the bytes reserved, preempt running victims (decode
    # state and KV pages spilled to the host, resumed when the budget
    # recovers). False still gates NEW admissions on the traced budget but
    # never preempts.
    preemption_enabled: bool = True
    # preemption frees this fraction of the shrunken KV budget beyond the
    # deficit, so the next admission or extension does not re-trigger a
    # shock at the boundary (0 frees exactly the deficit)
    spill_headroom_frac: float = 0.1
    # "scheduler": Scheduler.select_victims (SLO tiers + aging under
    # PriorityScheduler); "arrival": the newest running request first
    victim_policy: str = "scheduler"
    # structural mode (DESIGN.md §9): snap every decision mask onto a ladder
    # of whole-layer keep-sets before its bucket is minted (none | layer |
    # pow2, masks.quantize_mask); the exact mask runs as gates inside the
    # bucket, with the same tokens. Paged executors floor "none" at "layer"
    bucket_quant: str = "none"
    # cap on live structural groups of the default LocalExecutor (0 = no
    # cap): idle groups past it are dropped, least recently used first.
    # Groups share the full param stacks, so it bounds slot-cache bytes only
    max_structural_groups: int = 0

    def __post_init__(self):
        if self.mode not in ("masked", "structural"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.bucket_quant not in ("none", "layer", "pow2"):
            raise ValueError(f"unknown bucket_quant {self.bucket_quant!r}; "
                             f"expected none|layer|pow2")
        if self.max_structural_groups < 0:
            raise ValueError(f"max_structural_groups must be >= 0, got "
                             f"{self.max_structural_groups!r} (0 disables "
                             f"the cap)")
        if self.admission not in ("strict", "force"):
            raise ValueError(f"unknown admission {self.admission!r}")
        if self.len_buckets not in ("max", "pow2"):
            raise ValueError(f"unknown len_buckets {self.len_buckets!r}; "
                             f"expected max|pow2")
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
        if not isinstance(self.preemption_enabled, bool):
            raise ValueError(f"preemption_enabled must be a bool, got "
                             f"{self.preemption_enabled!r}")
        if not (0.0 <= self.spill_headroom_frac < 1.0):
            raise ValueError(f"spill_headroom_frac must be in [0, 1), got "
                             f"{self.spill_headroom_frac!r}")
        if self.victim_policy not in ("scheduler", "arrival"):
            raise ValueError(f"unknown victim_policy {self.victim_policy!r}; "
                             f"expected scheduler|arrival")


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
    status: str                       # done | rejected | cancelled
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
    # time to first token, measured from ARRIVAL (-1.0 when no token came)
    ttft_s: float = -1.0
    # the hosting group's bucket signature (structural mode), else ()
    bucket: Tuple = ()


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
    # elastic budgets: preemption events, requests cancelled, MB of KV
    # spilled to the host over the run
    preempted_count: int = 0
    cancelled: int = 0
    spilled_mb: float = 0.0
    # preempt → resume latency (one sample per resume, virtual clock)
    resume_latency: Dict[str, float] = dataclasses.field(default_factory=dict)
    # the ITL samples of requests preempted at least once, pooled apart:
    # a resume gap is one huge inter-token latency in the victim's stream
    itl_preempted: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (virtual t, budget bytes) breakpoints the run applied
    budget_events: List[Tuple[float, float]] = dataclasses.field(
        default_factory=list)

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
    # times preempted (routes its ITL samples to the itl_preempted pool)
    preempt_count: int = 0
    # set by the force-resume liveness backstop: exempt from preemption, so
    # a budget too small for even one request drains it instead of
    # re-spilling it at the next tick
    pinned: bool = False
    bucket: Tuple = ()


@dataclasses.dataclass
class _Prefilling:
    """A request admitted into a chunked prefill: its slots are reserved
    and it joins decode when the last chunk lands."""
    req: EngineRequest
    decision: Decision
    group: Any
    slots: List[int]
    admitted_t: float
    kv_bytes: float
    max_new: int
    task: Any
    bucket: Tuple = ()


@dataclasses.dataclass
class _Preempted:
    """A running request evicted under a budget shock: its KV pages in the
    pool's host-side spill store, the rest of its decode state in
    ``state`` (``executor.spill_state``)."""
    run: _Running
    state: Dict[str, Any]
    cache_len: Optional[int]         # group to restore into
    preempted_t: float               # virtual clock (resume-latency anchor)


# ------------------------------------------------------------------- engine
class RAPEngine:
    """Thin orchestration loop: Scheduler × PruningPolicy × ModelExecutor
    × KVPool."""

    @staticmethod
    def check_servable(mcfg) -> None:
        """Refuse a model the engine cannot serve: an encoder-decoder one
        (its requests carry audio frames and a cross K/V no executor
        holds), as JAX's engine does."""
        if getattr(mcfg, "is_encoder_decoder", False):
            raise NotImplementedError("engine serves decoder-only models")

    def __init__(self, model, params, policy: PruningPolicy,
                 cfg: Optional[EngineConfig] = None, *,
                 scheduler: Optional[Scheduler] = None,
                 executor: Optional[ModelExecutor] = None):
        if not isinstance(policy, PruningPolicy):
            raise TypeError(f"RAPEngine requires a PruningPolicy, got "
                            f"{type(policy).__name__}")
        self.check_servable(model.cfg)
        self.model = model
        self.mcfg = model.cfg
        self.params = params
        self.policy = policy
        self.cfg = dataclasses.replace(cfg if cfg is not None
                                       else EngineConfig())
        self.mm = policy.mm
        self.scheduler = make_scheduler(scheduler)
        self.executor = executor if executor is not None else LocalExecutor(
            model, params, mode=self.cfg.mode,
            max_active=self.cfg.max_active, kv_dtype=self.cfg.kv_dtype,
            decode_buckets=self.cfg.decode_buckets,
            bucket_quant=self.cfg.bucket_quant,
            max_groups=self.cfg.max_structural_groups)
        ex_mode = getattr(self.executor, "mode", self.cfg.mode)
        if ex_mode != self.cfg.mode:
            raise ValueError(
                f"the executor was built for mode={ex_mode!r} but "
                f"EngineConfig.mode={self.cfg.mode!r}")
        self._paged = bool(getattr(self.executor, "paged", False))
        if self._paged and self.cfg.admission != "strict":
            raise ValueError(
                "a paged executor requires strict admission: overflow pages "
                "have no physical backing to write KV into")
        # precision as a policy action: a stack built with a canonical KV
        # precision stamps it on the policy, so every Decision carries it
        # and the pool checks it against its pages at admission
        kv_name = getattr(self.executor, "kv_dtype_name", None)
        if kv_name is None:
            kv_name, _, _, _ = resolve_kv_dtype(self.cfg.kv_dtype)
        if kv_name is not None and getattr(policy, "kv_dtype", None) is None:
            policy.kv_dtype = kv_name
        self.resident_param_bytes = self.mm.param_bytes(
            masks_lib.full_mask(self.mcfg.n_layers))
        self.pool: Optional[KVPool] = None
        self._pending: List[EngineRequest] = []
        self._running: Dict[str, _Running] = {}
        self._prefilling: Dict[str, _Prefilling] = {}
        self._results: List[RequestResult] = []
        self._ttft_samples: List[float] = []
        self._itl_samples: List[float] = []
        self._frag_samples: List[float] = []
        self._decode_iters = 0
        self._t0 = 0.0
        self._skew = 0.0
        self._budget = self.cfg.budget_bytes
        # elastic-budget state
        self._preempted: Dict[str, _Preempted] = {}
        self._budget_trace: Any = None
        self._run_budget = self.cfg.budget_bytes
        self._budget_events: List[Tuple[float, float]] = []
        self._resume_samples: List[float] = []
        self._itl_preempted_samples: List[float] = []
        self._preempted_count = 0
        self._spilled_bytes = 0.0
        self._stall_ticks = 0

    def _now(self) -> float:
        """The run's virtual clock. An executor with ``agree_clock`` (the
        sharded one: every rank runs this engine) turns each rank's reading
        into one value every rank shares, so arrivals, budget breakpoints
        and idle skips decide alike everywhere."""
        t = (time.perf_counter() - self._t0) + self._skew
        agree = getattr(self.executor, "agree_clock", None)
        return agree(t) if agree is not None else t

    # ------------------------------------------------------------ capacity
    def ensure_capacity(self, batch: int, total_len: int) -> None:
        """Grow the slot count / cache-length cap (slot path). Slot growth
        drops every group (the slot axis changes); length growth is
        quantized to powers of two and drops the groups only under
        ``len_buckets="max"``, whose caches are ``max_len`` long."""
        if total_len > self.cfg.max_len:
            self.cfg.max_len = _next_pow2(total_len)
            if self.cfg.len_buckets == "max":
                self.executor.drop_groups()
        if batch > self.cfg.max_active:
            self.cfg.max_active = int(batch)
            self.executor.set_max_active(self.cfg.max_active)

    def _cache_len(self, total: int) -> int:
        """Cache length of the group hosting a (prompt + gen)-token request.
        pow2 buckets ignore ``max_len`` (admission already checked it), so a
        request shape keeps its bucket after capacity growth."""
        if self.cfg.len_buckets == "pow2":
            return max(_next_pow2(total), 16)
        return self.cfg.max_len

    def _make_pool(self, budget_bytes: float) -> KVPool:
        if self._paged:
            # the physical page size is dictated by the model's KV geometry
            page = self.executor.page_phys_bytes(self.cfg.tokens_per_page)
        else:
            page = default_page_bytes(self.mm, self.cfg.tokens_per_page)
        cap = budget_bytes - self.resident_param_bytes
        if cap < page and self.cfg.admission == "strict":
            raise ValueError(
                f"budget {budget_bytes:.0f}B leaves no KV pool after "
                f"resident params ({self.resident_param_bytes:.0f}B)")
        return KVPool(max(cap, 0.0), page_bytes=page,
                      tokens_per_page=(self.cfg.tokens_per_page
                                       if self._paged else None))

    # ------------------------------------------------------------- serving
    def run(self, requests: List[EngineRequest], *,
            budget_bytes: Optional[float] = None,
            budget_trace: Any = None, on_tick: Any = None) -> EngineReport:
        """Serve a trace to completion and report aggregate stats.

        ``budget_trace`` makes the device budget time-varying: a list of
        ``(t_seconds, budget_bytes)`` breakpoints, piecewise constant on the
        run's virtual clock and applied at the start of the first tick at or
        after each breakpoint, or a callable ``now → budget_bytes``
        evaluated once per tick at tick start (a tick-counting callable,
        ``scenarios.TickStaircase``, shocks at a fixed tick whatever a tick
        costs). The pool is sized once from the base budget: the trace
        gates admission and triggers preemption.

        ``on_tick(engine)`` runs once per tick in the host phase, after the
        launch and before arrivals: the seam fault-injection harnesses use
        to cancel requests mid-horizon."""
        budget = self.cfg.budget_bytes if budget_bytes is None else budget_bytes
        self.pool = self._make_pool(budget)
        if self._paged:
            self.executor.bind_pool(self.pool, self.cfg.max_len)
        self.executor.evict_all()             # a previous run's occupants
        self._budget = self._run_budget = budget
        if budget_trace is not None and not callable(budget_trace):
            budget_trace = sorted((float(t), float(v))
                                  for t, v in budget_trace)
        self._budget_trace = budget_trace
        self._budget_events = ([(0.0, float(budget))]
                               if budget_trace is not None else [])
        self._pending = sorted(requests, key=lambda r: r.arrival_t)
        self.scheduler.clear()
        self._running.clear()
        self._prefilling.clear()
        self._preempted.clear()
        self._results = []
        self._ttft_samples, self._itl_samples = [], []
        self._resume_samples, self._itl_preempted_samples = [], []
        self._frag_samples = []
        self._decode_iters = 0
        self._preempted_count = 0
        self._spilled_bytes = 0.0
        self._stall_ticks = 0
        launch_s0 = self.executor.launch_s
        self._skew = 0.0
        self._t0 = time.perf_counter()
        try:
            while (self._pending or len(self.scheduler) or self._running
                   or self._prefilling or self._preempted):
                self._tick(on_tick)
        except BaseException:
            # a run that raises must not leak pool entries, spill copies or
            # seated slots into the next run on this engine
            self._abort_cleanup()
            raise
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
            itl=_lat_summarize(self._itl_samples),
            preempted_count=self._preempted_count,
            cancelled=sum(1 for r in self._results
                          if r.status == "cancelled"),
            spilled_mb=self._spilled_bytes / 1e6,
            resume_latency=_lat_summarize(self._resume_samples),
            itl_preempted=_lat_summarize(self._itl_preempted_samples),
            budget_events=list(self._budget_events))

    def _tick(self, on_tick: Any = None) -> None:
        """budget → launch → host phase (hook, arrivals, resumes,
        admission) → finish. A request admitted or resumed during the host
        phase joins decode from the NEXT tick: its slots were free padding
        when this tick's horizon launched, and a cancelled request is
        skipped at fold-back."""
        now = self._now()
        self._eval_budget(now)
        self._maybe_preempt(now)
        plan = self.scheduler.schedule(now, running=list(self._running))
        backlog = (len(self.scheduler) > 0
                   or bool(self._pending
                           and self._pending[0].arrival_t <= now))
        launches = self._launch_decode(plan.decode, backlog=backlog)
        # ---- host phase (device work in flight from here to finish) ----
        if on_tick is not None:
            on_tick(self)
        while self._pending and self._pending[0].arrival_t <= now:
            req = self._pending.pop(0)
            if (req.rid in self.scheduler or req.rid in self._running
                    or req.rid in self._prefilling):
                self._reject(req, f"duplicate request id {req.rid!r} "
                                  f"(already in flight)")
                continue
            max_new = (self.cfg.max_new_tokens if req.max_new is None
                       else req.max_new)
            cost = req.prompt.shape[0] * (req.prompt.shape[1]
                                          + max(max_new, 1))
            self.scheduler.add(req, cost=cost)
        # a victim already holds its admission and its partial output:
        # letting the queue overtake it would turn a preemption into
        # starvation
        self._try_resume()
        deferred = None
        for req in self.scheduler.schedule(now).admit:
            verdict = self._try_admit(req)
            if verdict == "defer":
                deferred = req
                break
            self.scheduler.remove(req.rid)
        # a deferral with nothing launched, running, prefilling or preempted
        # can never be satisfied: no completion or resume frees what it
        # waits on
        stuck = (deferred is not None and not launches and not self._running
                 and not self._prefilling and not self._preempted)
        self._advance_prefills()
        # ---- finish: the tick's one read-back --------------------------
        if launches:
            self._finish_decode(launches)
        if self._running or self._prefilling:
            self._stall_ticks = 0
        else:
            self._idle_step(deferred, stuck)

    def _idle_step(self, deferred, stuck: bool) -> None:
        """Liveness with nothing running or prefilling: fast-forward the
        virtual clock to the next event that can change admissibility (an
        arrival or a budget breakpoint), and backstop the cases with no
        such event (a callable trace that never recovers must not spin
        forever)."""
        now = self._now()
        nxt = self._next_breakpoint(now)
        if stuck:
            if nxt is not None:
                # the budget may recover at the next breakpoint
                self._skew += max(nxt - now, 0.0) + 1e-9
            elif callable(self._budget_trace):
                # callables advance per evaluation: give the shock a bounded
                # number of idle ticks to recover
                self._stall_ticks += 1
                if self._stall_ticks > 256:
                    self.scheduler.remove(deferred.rid)
                    self._reject(deferred, "deferred with idle engine "
                                           "(budget trace never recovered)")
            else:
                self.scheduler.remove(deferred.rid)
                self._reject(deferred, "deferred with idle engine")
        elif deferred is None and self._pending and not self._preempted:
            # skip the idle gap, stopping at a breakpoint inside it
            tgt = self._pending[0].arrival_t
            if nxt is not None:
                tgt = min(tgt, nxt)
            self._skew += max(tgt - now, 0.0) + 1e-9
        elif self._preempted:
            if nxt is not None:
                tgt = nxt
                if self._pending:
                    tgt = min(tgt, self._pending[0].arrival_t)
                self._skew += max(tgt - now, 0.0) + 1e-9
            else:
                # no breakpoint will raise the budget again: after a
                # bounded spin, resume ignoring the budget (physical
                # capacity still checked), so the run drains
                self._stall_ticks += 1
                if self._stall_ticks > 8 and not self._force_resume():
                    raise RuntimeError(
                        "elastic-budget deadlock: preempted requests cannot "
                        "be restored even ignoring the budget")

    # ----------------------------------------- elastic budget / preemption
    def _kv_budget(self) -> float:
        """The KV share of the current budget: params stay resident through
        a shock, so shrinking below them leaves zero KV headroom."""
        return max(self._budget - self.resident_param_bytes, 0.0)

    def _eval_budget(self, now: float) -> None:
        """Apply the trace at tick start: every breakpoint ≤ now of a list,
        or one call of a callable. Changes are recorded as (t, bytes)."""
        tr = self._budget_trace
        if tr is None:
            return
        if callable(tr):
            b = float(tr(now))
        else:
            b = self._run_budget
            for t, v in tr:
                if t > now + 1e-12:
                    break
                b = v
        if b != self._budget:
            self._budget = b
            self._budget_events.append((now, b))

    def _next_breakpoint(self, now: float) -> Optional[float]:
        """The next breakpoint of a list trace (None for callables, which
        advance by being evaluated, and for an exhausted list)."""
        tr = self._budget_trace
        if tr is None or callable(tr):
            return None
        return next((t for t, _ in tr if t > now + 1e-12), None)

    def _maybe_preempt(self, now: float) -> None:
        """Shed reserved bytes when the budget shrank below them: preempt
        victims until the reservations fit the shrunken KV budget less
        ``spill_headroom_frac``. Only decoding requests are candidates: a
        chunked prefill finishes its prompt first."""
        if (not self.cfg.preemption_enabled or self._budget_trace is None
                or not self._running):
            return
        kv_budget = self._kv_budget()
        if self.pool.bytes_reserved <= kv_budget + 1e-6:
            return
        target = kv_budget * (1.0 - self.cfg.spill_headroom_frac)
        cands = [VictimCandidate(
                     rid=rid, priority=run.req.priority,
                     arrival_t=run.req.arrival_t,
                     remaining_tokens=max(run.max_new - len(run.out), 0),
                     reserved_bytes=self.pool.request_reserved_bytes(rid))
                 for rid, run in self._running.items() if not run.pinned]
        if self.cfg.victim_policy == "arrival":
            order = sorted(cands, key=lambda c: -c.arrival_t)
        else:
            order = self.scheduler.select_victims(cands, now)
        for cand in order:
            if self.pool.bytes_reserved <= target + 1e-6:
                break
            self._preempt(self._running[cand.rid], now)

    def _preempt(self, run: _Running, now: float) -> None:
        """Evict one running request with its state: decode state to the
        host (executor), slots freed, KV pages spilled (pool)."""
        rid = run.req.rid
        state = self.executor.spill_state(run.group, run.slots)
        run.group.evict(run.slots)
        self._spilled_bytes += self.pool.spill(rid)
        del self._running[rid]
        run.preempt_count += 1
        # paged groups have no cache length: pages make it per slot
        self._preempted[rid] = _Preempted(
            run=run, state=state,
            cache_len=getattr(run.group, "cache_len", None), preempted_t=now)
        self._preempted_count += 1

    def _try_resume(self) -> None:
        """Restore the preempted requests the budget has room for, the most
        important first (victims were shed least important first)."""
        kv_budget = self._kv_budget()
        for rid in reversed(list(self._preempted)):
            self._resume_one(rid, kv_budget)

    def _resume_one(self, rid: str, kv_budget: float, *,
                    force: bool = False) -> bool:
        p = self._preempted[rid]
        if not force:
            need = self.pool.restore_reserved_bytes(rid)
            if self.pool.bytes_reserved + need > kv_budget + 1e-6:
                return False
        if not self.pool.can_restore(rid):
            return False
        b = len(p.run.slots)
        group = self.executor.group_for(p.run.decision.mask, p.cache_len)
        free = group.free_slots()
        if len(free) < b:
            return False
        rows = self.pool.restore(rid)
        slots = free[:b]
        self.executor.restore_state(group, slots, rid, p.state,
                                    p.run.decision.mask, rows)
        run = p.run
        run.group, run.slots = group, slots
        if force:
            run.pinned = True        # liveness: drains, never re-spilled
        del self._preempted[rid]
        self._running[rid] = run
        self._resume_samples.append(self._now() - p.preempted_t)
        self._stall_ticks = 0
        return True

    def _force_resume(self) -> bool:
        """Deadlock backstop: restore the most important preempted request
        ignoring the budget (physical pages and slots still checked). The
        resumed run is pinned, so it decodes to completion instead of
        cycling through spill and resume when the shocked budget cannot
        host even one request."""
        return any(self._resume_one(rid, float("inf"), force=True)
                   for rid in reversed(list(self._preempted)))

    # --------------------------------------------------------- cancellation
    def cancel(self, rid: str) -> bool:
        """Cancel a request at any stage — pending, queued, prefilling,
        decoding mid-horizon, or preempted. True if it was found and
        cancelled; False for unknown, finished or already cancelled ids
        (so a double cancel, or a cancel racing a completion, is a no-op).
        The tokens a cancelled decode generated in its in-flight horizon
        are dropped: fold-back skips rids no longer running."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                self._pending.pop(i)
                self._record_cancelled(req)
                return True
        req = self.scheduler.peek(rid)
        if req is not None:
            self.scheduler.remove(rid)
            self._record_cancelled(req)
            return True
        pf = self._prefilling.pop(rid, None)
        if pf is not None:
            pf.group.evict(pf.slots)
            self.pool.free(rid, missing_ok=True)
            self._record_cancelled(pf.req, decision=pf.decision,
                                   admitted_t=pf.admitted_t,
                                   kv_bytes=pf.kv_bytes, bucket=pf.bucket)
            return True
        run = self._running.pop(rid, None)
        if run is None:
            p = self._preempted.pop(rid, None)
            if p is None:
                return False
            self.pool.drop_spilled(rid, missing_ok=True)
            run = p.run
        else:
            run.group.evict(run.slots)
            self.pool.free(rid, missing_ok=True)
        self._record_cancelled(run.req, decision=run.decision,
                               admitted_t=run.admitted_t,
                               kv_bytes=run.kv_bytes, out=run.out,
                               events=run.events, bucket=run.bucket)
        return True

    def _record_cancelled(self, req: EngineRequest, *, decision=None,
                          admitted_t: float = -1.0, kv_bytes: float = 0.0,
                          out=None, events=None, bucket: Tuple = ()) -> None:
        now = self._now()
        d = decision
        self._results.append(RequestResult(
            rid=req.rid, status="cancelled",
            tokens=np.stack(out, axis=1) if out else None,
            mask=d.mask if d is not None else None,
            arrival_t=req.arrival_t, admitted_t=admitted_t, finished_t=now,
            queue_delay_s=(admitted_t if admitted_t >= 0.0 else now)
            - req.arrival_t,
            decide_s=d.latency_s if d is not None else 0.0,
            fits=d.fits if d is not None else False,
            cached_decision=d.cached if d is not None else False,
            peak_bytes=d.peak_bytes if d is not None else 0.0,
            kv_bytes=kv_bytes, reason="cancelled",
            ttft_s=(events[0][0] - req.arrival_t) if events else -1.0,
            bucket=bucket))

    def _abort_cleanup(self) -> None:
        """Release what a raising run holds — live and spilled pool
        entries, seated slots, the queues — so the next run starts
        clean."""
        if self.pool is not None:
            for rid in self.pool.live_requests():
                self.pool.free(rid, missing_ok=True)
            for rid in self.pool.spilled_requests():
                self.pool.drop_spilled(rid, missing_ok=True)
        self.executor.evict_all()
        self._running.clear()
        self._prefilling.clear()
        self._preempted.clear()
        self.scheduler.clear()
        self._pending = []

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
        if req.rid in self._running or req.rid in self._prefilling:
            self._reject(req, f"duplicate request id {req.rid!r} "
                              f"(already in flight)")
            return "rejected"
        force = self.cfg.admission == "force"
        if total > self.cfg.max_len or b > self.cfg.max_active:
            if not force:
                self._reject(req, f"shape (b={b}, prompt+gen={total}) "
                                  f"exceeds engine capacity "
                                  f"({self.cfg.max_active} slots × "
                                  f"{self.cfg.max_len})")
                return "rejected"
            if self._running:
                return "defer"   # growth drops live caches; wait for drain
            self.ensure_capacity(b, total)
        # keep-mask against the REMAINING shared budget, quantized down so
        # steady-state admissions hit the policy's memo table (force mode
        # passes the budget through exactly: the one-shot contract)
        eff = self._budget - self.pool.bytes_reserved
        quantum = self.cfg.budget_quantum_frac * self.mm.dense_peak(b, total)
        if quantum > 0 and not force:
            eff = np.floor(eff / quantum + 1e-9) * quantum
        cache_len = self._cache_len(total)
        d = self._sticky_decision(b, total, eff, cache_len)
        if d is None:
            d = self.policy.observe(PolicyState(
                batch=b, total_len=total, budget_bytes=eff,
                reserved_bytes=self.pool.bytes_reserved,
                capacity_bytes=self.pool.acct.capacity_bytes,
                n_running=len(self._running), now=self._now()))
        kv_bytes = self.mm.state_bytes(d.mask, b, total)
        if not self._paged:
            # the slot path charges the bytes its cache stores: an int8
            # cache holds 1-byte elements plus a scale per (token, head)
            kv_bytes *= _kv_byte_ratio(d.kv_dtype, self.mcfg)
        if self._budget_trace is not None and not force:
            # the pool was sized from the BASE budget and cannot see a
            # shrink: check the request's worst-case reservation against
            # the CURRENT budget, or a shock would admit into bytes the
            # trace just took away and preempt at the next tick
            pages = (self.pool.pages_for_tokens(b, total) if self._paged
                     else self.pool.pages_needed(kv_bytes))
            if (self.pool.bytes_reserved + pages * self.pool.page_bytes
                    > self._kv_budget() + 1e-6):
                return "defer"
        if self._paged:
            # page-granular admission: masked mode stores every layer's KV
            # whatever the mask says, so the charge is the worst-case PAGE
            # commitment, not the analytical byte count
            if not self.pool.fits_capacity_tokens(b, total):
                self._reject(req, f"{self.pool.pages_for_tokens(b, total)} "
                                  f"pages ({b}×{total} tokens) can never fit "
                                  f"pool capacity of {self.pool.n_pages} "
                                  f"pages")
                return "rejected"
            if not self.pool.can_alloc_tokens(b, total):
                return "defer"
        elif not force:
            if not self.pool.fits_capacity(kv_bytes):
                self._reject(req, f"state {kv_bytes:.0f}B can never fit "
                                  f"pool capacity "
                                  f"{self.pool.acct.capacity_bytes:.0f}B")
                return "rejected"
            if not self.pool.can_alloc(kv_bytes):
                return "defer"
        group = self.executor.group_for(d.mask, cache_len)
        free = group.free_slots()
        if len(free) < b:
            return "defer"
        slots = free[:b]
        admitted_t = self._now()
        bucket = group.key if self.cfg.mode == "structural" else ()
        prompt = np.asarray(req.prompt, np.int32)
        chunked = (self.cfg.max_prefill_tokens > 0
                   and self.executor.supports_chunked_prefill(group))
        if not self._paged:
            self.pool.alloc(req.rid, kv_bytes, allow_overcommit=force)
        if chunked:
            if self._paged:
                # grant only the first chunk's pages; each later chunk
                # extends the allocation just before it runs (the
                # commitment covers it)
                c1 = chunk_widths(S, self.cfg.max_prefill_tokens)[0]
                rate = kv_bytes / max(total, 1)
                self.pool.alloc_tokens(req.rid, b, c1, max_tokens=total,
                                       in_use_bytes=rate * c1,
                                       in_use_per_token=rate,
                                       kv_dtype=d.kv_dtype)
            self._prefilling[req.rid] = _Prefilling(
                req=req, decision=d, group=group, slots=slots,
                admitted_t=admitted_t, kv_bytes=kv_bytes, max_new=max_new,
                bucket=bucket, task=self.executor.prefill_begin(
                    group, slots, req.rid, prompt, d.mask,
                    max_chunk=self.cfg.max_prefill_tokens))
            return "admitted"
        if self._paged:
            # grant pages backing the prompt now; commit the decode tail
            prompt_bytes = self.mm.state_bytes(d.mask, b, S)
            rate = max(kv_bytes - prompt_bytes, 0.0) / max(total - S, 1)
            self.pool.alloc_tokens(req.rid, b, S, max_tokens=total,
                                   in_use_bytes=prompt_bytes,
                                   in_use_per_token=rate, kv_dtype=d.kv_dtype)
        first = self.executor.prefill_into(group, slots, req.rid, prompt,
                                           d.mask)
        run = _Running(req=req, decision=d, group=group, slots=slots,
                       admitted_t=admitted_t, kv_bytes=kv_bytes,
                       max_new=max_new, out=[first],
                       events=[(self._now(), 1)], bucket=bucket)
        self._running[req.rid] = run
        if run.max_new <= len(run.out):
            self._complete(run)
        return "admitted"

    def _sticky_decision(self, b: int, total: int, eff: float,
                         cache_len: int) -> Optional[Decision]:
        """Bucket affinity (structural mode, strict admission): an existing
        group with ``b`` free slots whose minting mask's peak fits the
        remaining budget ``eff`` and whose state the pool can still grant
        hosts the request without a policy decision — the one keeping the
        most blocks wins. Without it a drifting pool level mints a new
        bucket per admission. Slot groups must also match ``cache_len``;
        paged groups host any length."""
        if self.cfg.mode != "structural" or self.cfg.admission != "strict":
            return None
        best = None
        for group in self.executor.groups():
            if group.mask is None or len(group.free_slots()) < b:
                continue
            if not self._paged and group.cache_len != cache_len:
                continue
            peak = self.mm.peak_bytes(group.mask, b, total)
            if peak > eff:
                continue
            if self._paged:
                if not self.pool.can_alloc_tokens(b, total):
                    continue
            elif not self.pool.can_alloc(
                    self.mm.state_bytes(group.mask, b, total)):
                continue
            kept = int(group.mask.sum())
            if best is None or kept > best[0]:
                best = (kept, group, peak)
        if best is None:
            return None
        _, group, peak = best
        return Decision(mask=group.mask.copy(), steps=0, peak_bytes=peak,
                        fits=True, latency_s=0.0, cached=True)

    def _advance_prefills(self) -> None:
        """Advance every in-flight chunked prefill by ONE chunk; a prefill
        that completes seats its request (it joins decode next tick) and
        stamps its first-token event."""
        for rid in list(self._prefilling):
            pf = self._prefilling[rid]
            first = self.executor.prefill_step(pf.task)
            if first is None:
                continue
            del self._prefilling[rid]
            run = _Running(req=pf.req, decision=pf.decision, group=pf.group,
                           slots=pf.slots, admitted_t=pf.admitted_t,
                           kv_bytes=pf.kv_bytes, max_new=pf.max_new,
                           out=[first], events=[(self._now(), 1)],
                           bucket=pf.bucket)
            self._running[rid] = run
            if run.max_new <= len(run.out):
                self._complete(run)

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
        # a resume gap would poison the ITL of requests never preempted
        sink = (self._itl_preempted_samples if run.preempt_count
                else self._itl_samples)
        prev = run.events[0][0]
        for t, n in run.events[1:]:
            sink.extend([(t - prev) / max(n, 1)] * n)
            prev = t
        result = RequestResult(
            rid=run.req.rid, status="done",
            tokens=np.stack(run.out, axis=1),       # [b, generated]
            mask=d.mask, arrival_t=run.req.arrival_t,
            admitted_t=run.admitted_t, finished_t=now,
            queue_delay_s=run.admitted_t - run.req.arrival_t,
            decide_s=d.latency_s, fits=d.fits, cached_decision=d.cached,
            peak_bytes=d.peak_bytes, kv_bytes=run.kv_bytes, ttft_s=ttft,
            bucket=run.bucket)
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
