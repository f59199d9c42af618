"""The measured window: ``RAPEngine.run`` on a ``PagedExecutor`` (masked
mode, pages at the model dtype, the ``rl`` policy over
``RAPController``, monolithic prefill through flash attention, decode
horizons through the paged-decode kernel), observed through the program's
seams.

* ``on_tick(engine)`` opens and closes the window and, at the close,
  ``engine.cancel`` s what is still in flight;
* the executor's ``prefill_into`` / ``decode_launch`` / ``decode_finish``
  are wrapped by a subclass, the policy's ``observe`` by a delegating
  policy, which stamp spans and count tokens as the caller receives them
  (one horizon at a time, the engine's own convention);
* the controller's importance passes (``RAPController._importance``, the
  one seam here that is not public) are recorded with the mask each was
  taken at, so the check can replay every decision's choices;
* the scheduler's ``schedule(now)`` hands over the engine's virtual clock
  once per tick.

Clock: every time here is on the engine's virtual clock, the one its
arrival schedule lives on. It is the wall clock plus the idle gaps the
engine skips (it fast-forwards when nothing runs and the next arrival is
in the future), so a skipped gap counts as time in which the device was
idle. A span stamped on the host's clock is moved onto the virtual clock
by the offset of the tick it falls in (the skew changes only between
ticks).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from benchlib import inputs, traffic


@dataclasses.dataclass
class Span:
    kind: str               # prefill | horizon | decide
    t0: float               # virtual clock
    t1: float
    rid: Optional[str] = None
    info: Any = None


@dataclasses.dataclass
class Served:
    """What a request received, as the caller received it."""
    rid: str
    index: int
    batch: int
    prompt: int
    max_new: int
    due: float                       # arrival time on the schedule
    mask: Optional[np.ndarray] = None
    first_t: Optional[float] = None  # first token (the prefill's)
    # (t, tokens) per read-back that delivered tokens to this request
    readbacks: List[tuple] = dataclasses.field(default_factory=list)
    delivered: int = 0
    cancelled_t: Optional[float] = None


class Clock:
    """The engine's virtual clock, read at each tick start through the
    scheduler, and the host clock's offset from it during that tick."""

    def __init__(self):
        self.offset = 0.0
        self.now = -1.0

    def tick(self, now: float) -> None:
        # the engine asks its scheduler twice a tick with the tick's start;
        # the offset is taken at the first ask
        if float(now) != self.now:
            self.now = float(now)
            self.offset = self.now - time.perf_counter()

    def __call__(self) -> float:
        return time.perf_counter() + self.offset


def _observed_classes():
    """Subclasses of the program's seams, defined on first use so that
    importing this module needs no ``repro_torch``."""
    from repro_torch.core.controller import RAPController
    from repro_torch.core.policy import PruningPolicy
    from repro_torch.runtime.executor import PagedExecutor
    from repro_torch.runtime.scheduler import FIFOScheduler

    class ClockedFIFO(FIFOScheduler):
        def __init__(self, clock: Clock):
            super().__init__()
            self.clock = clock

        def schedule(self, now, running=()):
            self.clock.tick(now)
            return super().schedule(now, running)

    class ObservedController(RAPController):
        """The controller, each importance pass recorded as (mask it was
        taken at, importance)."""

        def __init__(self, *a, window, **kw):
            super().__init__(*a, **kw)
            self.window = window

        def _importance(self, mask):
            imp = super()._importance(mask)
            self.window.passes.append((np.array(mask, bool),
                                       np.array(imp, np.float64)))
            return imp

    class ObservedPolicy(PruningPolicy):
        """The cell's policy, its ``observe`` stamped as a span that holds
        the state, the decision and the importance passes it ran."""

        def __init__(self, inner, window):
            self.inner, self.window = inner, window
            self.name, self.mm = inner.name, inner.mm

        def observe(self, state):
            w = self.window
            w.passes = []
            t0 = w.clock()
            d = self._stamp(self.inner.observe(state))
            w.spans.append(Span("decide", t0, w.clock(),
                                info=(state, d, w.passes)))
            return d

        def feedback(self, result):
            self.inner.feedback(result)

    class ObservedPaged(PagedExecutor):
        def __init__(self, *a, window, **kw):
            super().__init__(*a, **kw)
            self.window = window

        def prefill_into(self, group, slots, rid, prompt, mask):
            w = self.window
            t0 = w.clock()
            first = super().prefill_into(group, slots, rid, prompt, mask)
            w.on_prefill(rid, t0, w.clock(), np.asarray(mask, bool))
            return first

        def decode_launch(self, group, horizon):
            w = self.window
            t0 = w.clock()
            launch = super().decode_launch(group, horizon)
            rows = {}
            for s, rid in zip(launch.idx, launch.occupants):
                if rid is not None:
                    rows.setdefault(rid, int(group.pos[s]))
            w.on_launch(launch, t0, rows)
            return launch

        def decode_finish(self, launch):
            out = super().decode_finish(launch)
            self.window.on_finish(launch, self.window.clock())
            return out

    return ClockedFIFO, ObservedController, ObservedPolicy, ObservedPaged


# a traced run traces the last seconds of its window (at most this many):
# enough to read the kernels' shares, few enough events to reduce in time
TRACE_SECONDS = 10.0


class Window:
    """The run's observer: it opens the window, stamps what crosses the
    seams, and closes the run."""

    def __init__(self, mix: dict, seconds: float, *, trace: bool,
                 profiler_factory=None):
        self.mix = mix
        self.seconds = float(seconds)
        self.clock = Clock()
        self.spans: List[Span] = []
        self.passes: List[tuple] = []    # the current decision's passes
        self.served: Dict[str, Served] = {}
        self.trace = trace
        self.profiler_factory = profiler_factory
        self.profiler = None
        self.prof_span = None            # (t0, t1) virtual of the trace
        self.t_open: Optional[float] = None
        self.open_wall: Optional[float] = None
        self.t_close: Optional[float] = None
        self.closed = False
        self.admissions = 0
        self._open_launches: Dict[int, Span] = {}
        self.backlog = mix["loop"] == "backlog"
        self.drain_until: Optional[float] = None

    # ------------------------------------------------------------ seams
    def on_prefill(self, rid, t0, t1, mask):
        s = self.served[rid]
        s.mask, s.first_t, s.delivered = mask, t1, 1
        self.admissions += 1
        self.spans.append(Span("prefill", t0, t1, rid,
                               info=(s.batch, s.prompt)))

    def on_launch(self, launch, t0, rows):
        sp = Span("horizon", t0, t0, info={"horizon": int(launch.horizon),
                                           "rows": {}})
        for rid, pos in rows.items():
            s = self.served.get(rid)
            if s is None or s.cancelled_t is not None:
                continue
            n = min(int(launch.horizon), s.max_new - s.delivered)
            if n > 0:
                sp.info["rows"][rid] = (pos, n, s.batch)
        self._open_launches[id(launch)] = sp

    def on_finish(self, launch, t1):
        sp = self._open_launches.pop(id(launch))
        sp.t1 = t1
        self.spans.append(sp)
        for rid, (_, n, _) in sp.info["rows"].items():
            s = self.served[rid]
            if s.cancelled_t is not None:
                continue
            s.delivered += n
            s.readbacks.append((t1, n))

    # -------------------------------------------------------------- tick
    def on_tick(self, engine) -> None:
        now = self.clock.now
        if self.t_open is None:
            if self._ready(now):
                self.t_open = now if self.backlog else float(
                    self.mix["warmup_s"])
                self.open_wall = time.perf_counter()
            return
        if (self.profiler is None and self.trace and not self.closed
                and self.t_close is None
                and now >= self.t_open + self.seconds - TRACE_SECONDS):
            self._start_profile()
        if self.t_close is None and now >= self.t_open + self.seconds:
            self.t_close = self.t_open + self.seconds
            self._stop_profile()
            self.drain_until = (self.t_close if (self.backlog or self.trace)
                                else self.t_close + float(self.mix["drain_s"]))
        if self.t_close is not None and not self.closed:
            if now >= self.drain_until or self._all_due_started():
                self.closed = True
                for rid, s in self.served.items():
                    if engine.cancel(rid):
                        s.cancelled_t = now

    def _ready(self, now: float) -> bool:
        """The window opens on the schedule's clock in an open loop; in a
        backlog once the warm-up's admissions are in and every request
        admitted so far has had a read-back (so no gap of the ramp, when
        one tick admits a whole batch, falls in the window)."""
        if not self.backlog:
            return now >= float(self.mix["warmup_s"])
        if self.admissions < int(self.mix["warmup_admissions"]):
            return False
        return all(s.readbacks or s.delivered >= s.max_new
                   for s in self.served.values() if s.first_t is not None)

    def _all_due_started(self) -> bool:
        return all(s.first_t is not None for s in self.served.values()
                   if self.t_open <= s.due < self.t_close)

    def _start_profile(self):
        if not self.trace or self.profiler_factory is None:
            return
        torch.cuda.synchronize()
        self.profiler = self.profiler_factory()
        self.profiler.start()
        self.prof_epoch = time.time()
        self.prof_span = [self.clock(), None]

    def _stop_profile(self):
        if self.profiler is None:
            return
        torch.cuda.synchronize()
        self.prof_span[1] = self.clock()
        self.profiler.stop()


@dataclasses.dataclass
class Run:
    """A finished run: the window's records and the objects the check
    needs (the program's state is dropped before the reference runs)."""
    window: Window
    results: list
    pool: dict
    params: dict
    q_params: dict
    setup_s: float
    memory_peak_bytes: int
    profiler: Any
    seed: int


def build_program(cfg_file: dict, seed: int, device):
    """The port's model config, model, weights and memory model."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import memory
    from repro_torch.models import registry
    mcfg = ModelConfig(**cfg_file["model"])
    model = registry.build(mcfg)
    params = inputs.weights(cfg_file["model"], seed, device)
    return mcfg, model, params, memory.build_memory_model(mcfg)


def serve(cfg_file: dict, mix: dict, seed: int, seconds: float, *,
          trace: bool, device, t_start: float, profiler_factory=None,
          fault=None) -> Run:
    """Build everything from ``seed``, run the engine through the window,
    and return the records. ``fault`` (tests only) breaks the timed path
    underneath: it is handed the executor, the window and the controller
    before the run."""
    from repro_torch.core import masks
    from repro_torch.core.policy import RLPolicy
    from repro_torch.runtime import EngineConfig, EngineRequest, RAPEngine

    (ClockedFIFO, ObservedController, ObservedPolicy,
     ObservedPaged) = _observed_classes()
    sv = cfg_file["serving"]
    mcfg, model, params, mm = build_program(cfg_file, seed, device)
    calib = inputs.calib_batch(cfg_file["model"], *sv["calib"], seed, device)
    q_params = inputs.qnet(mcfg.n_layers, seed)
    pool_bytes = float(sv["pool_gib"]) * 2 ** 30
    full = masks.full_mask(mcfg.n_layers)
    budget = mm.param_bytes(full) + pool_bytes

    if mix["loop"] == "backlog":
        sched = traffic.schedule(mix, n=int(mix["backlog_requests"]))
    else:
        sched = traffic.schedule(mix, horizon_s=(
            float(mix["warmup_s"]) + seconds + float(mix["drain_s"])))
    window = Window(mix, seconds, trace=trace,
                    profiler_factory=profiler_factory)
    prompts = inputs.Prompts(mcfg.vocab_size, seed)
    requests = []
    for a in sched.arrivals:
        rid = f"r{a.index}"
        window.served[rid] = Served(rid, a.index, a.batch, a.prompt,
                                    a.output, a.t)
        requests.append(EngineRequest(rid=rid,
                                      prompt=prompts(a.index, a.batch,
                                                     a.prompt),
                                      arrival_t=a.t, max_new=a.output))
    budget_trace = traffic.budget_breakpoints(
        sched.kv_frac, mm.param_bytes(full), pool_bytes)
    max_len = max(a.prompt + a.output for a in sched.arrivals)
    max_len = max(max_len, int(sv.get("max_len", 0)))

    controller = ObservedController(model, params, calib, mm, q_params,
                                    window=window)
    inner = RLPolicy(controller)
    policy = ObservedPolicy(inner, window)
    executor = ObservedPaged(model, params, mode="masked",
                             max_active=int(sv["slots"]), window=window)
    engine = RAPEngine(model, params, policy, EngineConfig(
        mode="masked", max_active=int(sv["slots"]), max_len=max_len,
        budget_bytes=budget, decode_horizon=int(sv["decode_horizon"]),
        budget_quantum_frac=float(sv["budget_quantum"]),
        max_prefill_tokens=0,
        preemption_enabled=bool(mix.get("preemption", False))),
        scheduler=ClockedFIFO(window.clock), executor=executor)
    if fault is not None:
        fault(executor, window, controller)
    if device.type == "cuda":
        # the kernel library is built (first run in a checkout) and loaded
        # here, in set-up, not at the window's first prefill
        from repro_torch.kernels import build as kernel_build
        kernel_build.library()
    if trace and profiler_factory is not None:
        # the first profiler of a process initialises CUPTI for seconds:
        # pay that in set-up, not inside the window
        with profiler_factory():
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize()
    report = engine.run(requests, budget_trace=budget_trace,
                        on_tick=window.on_tick)
    if window.t_open is None:
        raise RuntimeError("the run ended before its window opened: the "
                           "traffic holds too few requests for its warm-up")
    if window.t_close is None:
        raise RuntimeError("the run drained before its window closed: the "
                           "traffic holds too few requests for the window")
    setup_s = window.open_wall - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    pool = dict(report.pool)
    results = list(report.results)
    del engine, executor, policy, inner, controller, report, calib
    return Run(window=window, results=results, pool=pool, params=params,
               q_params=q_params, setup_s=setup_s, memory_peak_bytes=int(peak),
               profiler=window.profiler, seed=int(seed))
