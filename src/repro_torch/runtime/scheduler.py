"""Pluggable request scheduling for the serving engine.

The queue and its ordering decision sit behind a small protocol, so
admission *policy* is swappable without touching the engine loop:

    Scheduler.add(request, cost=…)      requests enter the waiting set
    Scheduler.schedule(now, running=…) ──► SchedulerOutput(admit, decode)
    Scheduler.remove(rid)               admitted / rejected requests leave

A :class:`SchedulerOutput` carries two separate plans (the async-engine
split): ``admit`` is the **prefill plan** — waiting requests in admission
order — and ``decode`` the **decode plan** — which *running* requests
step this macro-tick (every scheduler here steps all of them; a
preemption/SLO-tier scheduler would return a subset).

The engine walks ``SchedulerOutput.admit`` in order, attempting admission
(policy decision → pool allocation → prefill) per candidate, and stops at
the first *deferral* (no pages / no free slots). Stopping preserves the
scheduler's ordering guarantee — a deferred candidate is never overtaken
within a tick — so FIFO keeps strict head-of-line semantics and SJF/
priority orders cannot starve the job they chose to run next.

Schedulers:
  * :class:`FIFOScheduler`     — arrival order;
  * :class:`SJFScheduler`      — shortest job first, by the request's
    total token cost (prompt + decode length), ties broken by arrival;
  * :class:`PriorityScheduler` — explicit ``EngineRequest.priority``
    (lower = sooner) with an **aging** term: priority improves linearly
    with waiting time (one level per ``aging_s`` seconds), so a
    low-priority request behind a steady high-priority stream is
    eventually ordered first instead of starving.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Scheduler", "SchedulerOutput", "VictimCandidate",
           "FIFOScheduler", "SJFScheduler", "PriorityScheduler",
           "SCHEDULERS", "make_scheduler"]


@dataclasses.dataclass(frozen=True)
class VictimCandidate:
    """One *running* request offered to :meth:`Scheduler.select_victims`
    when the engine must shed reserved bytes under a shrinking budget."""
    rid: str
    priority: int             # EngineRequest.priority (lower = sooner)
    arrival_t: float
    remaining_tokens: int     # decode tokens still owed
    reserved_bytes: float     # device bytes a preemption would free


@dataclasses.dataclass
class SchedulerOutput:
    """Explicit per-tick plans: who prefills, who decodes."""
    admit: List                     # prefill plan: EngineRequests, in order
    n_waiting: int = 0
    # decode plan: rids of running requests to step this macro-tick. Every
    # built-in scheduler steps all of them; None is treated as "all".
    decode: Optional[List[str]] = None


@dataclasses.dataclass
class _Entry:
    req: object                     # EngineRequest (duck-typed)
    cost: float                     # total tokens: prompt + decode budget
    seq: int                        # arrival tiebreak (insertion order)


class Scheduler:
    """Base: owns the waiting set; subclasses define the ordering key."""

    name = "base"

    def __init__(self):
        self._waiting: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._seq = 0

    # ------------------------------------------------------------ lifecycle
    def add(self, req, *, cost: float = 0.0) -> None:
        if req.rid in self._waiting:
            raise ValueError(f"request {req.rid!r} already waiting")
        self._waiting[req.rid] = _Entry(req=req, cost=float(cost),
                                        seq=self._seq)
        self._seq += 1

    def remove(self, rid: str) -> None:
        self._waiting.pop(rid, None)

    def peek(self, rid: str):
        """The waiting EngineRequest for ``rid``, or None — the engine's
        cancellation path needs the request object to record the result."""
        entry = self._waiting.get(rid)
        return entry.req if entry is not None else None

    def clear(self) -> None:
        self._waiting.clear()

    def __len__(self) -> int:
        return len(self._waiting)

    def __contains__(self, rid: str) -> bool:
        return rid in self._waiting

    # ------------------------------------------------------------- ordering
    def _key(self, entry: _Entry, now: float) -> Tuple:
        raise NotImplementedError

    # ------------------------------------------------------------ victims
    def _victim_priority(self, cand: VictimCandidate, now: float) -> float:
        """Effective priority of a running request for victim selection
        (lower = more important = preempted LAST). The base schedulers
        have no priority notion, so every candidate ties at 0.0 and the
        tiebreaks of :meth:`select_victims` decide."""
        return 0.0

    def select_victims(self, cands: Sequence[VictimCandidate],
                       now: float) -> List[VictimCandidate]:
        """Order running requests for preemption under a budget shock:
        lowest effective priority first, then most remaining work (the
        request furthest from done yields, so the least completed compute
        is set aside), then newest arrival. The engine preempts a prefix of
        this order until reserved bytes fit the shrunken budget."""
        return sorted(cands,
                      key=lambda c: (-self._victim_priority(c, now),
                                     -c.remaining_tokens, -c.arrival_t))

    def schedule(self, now: float,
                 running: Sequence[str] = ()) -> SchedulerOutput:
        """Order the waiting set into this tick's prefill plan; plan the
        decode step for every running request."""
        entries = sorted(self._waiting.values(),
                         key=lambda e: self._key(e, now))
        return SchedulerOutput(admit=[e.req for e in entries],
                               n_waiting=len(entries),
                               decode=list(running))


class FIFOScheduler(Scheduler):
    name = "fifo"

    def _key(self, entry: _Entry, now: float) -> Tuple:
        return (entry.seq,)

    def schedule(self, now: float,
                 running: Sequence[str] = ()) -> SchedulerOutput:
        # insertion order IS arrival order — skip the O(W log W) sort the
        # generic path pays per tick
        return SchedulerOutput(admit=[e.req for e in self._waiting.values()],
                               n_waiting=len(self._waiting),
                               decode=list(running))


class SJFScheduler(Scheduler):
    """Shortest job first — smallest total token cost (batch × (prompt +
    decode), the engine's `cost` at add()) next. Under memory pressure
    this admits the requests with the smallest KV demand first, trading
    FIFO fairness for queue-delay percentiles."""

    name = "sjf"

    def _key(self, entry: _Entry, now: float) -> Tuple:
        return (entry.cost, entry.seq)


class PriorityScheduler(Scheduler):
    """Explicit request priority (lower = sooner); FIFO within a level.

    The effective priority **ages**: it improves by one level per
    ``aging_s`` seconds of waiting (measured from the request's
    ``arrival_t`` on the engine's clock), so a steady stream of
    high-priority arrivals can delay a low-priority request only
    ``aging_s × Δpriority`` seconds before it sorts ahead of them —
    bounded starvation instead of indefinite deferral (pinned for the JAX
    package's copy of this class in ``tests/test_engine.py``).
    Ties (same arrival time) keep the pure priority order unchanged.
    ``aging_s=float('inf')`` restores the unaged behaviour.
    """

    name = "priority"

    def __init__(self, aging_s: float = 10.0):
        super().__init__()
        if not aging_s > 0:
            raise ValueError(
                f"aging_s must be > 0 seconds per priority level, got "
                f"{aging_s!r} (use float('inf') to disable aging)")
        self.aging_s = float(aging_s)

    def _aged(self, priority: float, arrival_t: float, now: float) -> float:
        waited = max(now - arrival_t, 0.0)
        return priority - (waited / self.aging_s
                           if self.aging_s != float("inf") else 0.0)

    def _key(self, entry: _Entry, now: float) -> Tuple:
        return (self._aged(getattr(entry.req, "priority", 0),
                           getattr(entry.req, "arrival_t", 0.0), now),
                entry.seq)

    def _victim_priority(self, cand: VictimCandidate, now: float) -> float:
        """Victim selection reuses the aging seam: a request's effective
        priority improves the longer it has been in the system, so an old
        low-tier request is not the automatic victim of every shock — the
        same bounded-starvation contract admission has."""
        return self._aged(cand.priority, cand.arrival_t, now)


SCHEDULERS: Dict[str, type] = {
    "fifo": FIFOScheduler,
    "sjf": SJFScheduler,
    "priority": PriorityScheduler,
}


def make_scheduler(spec) -> Scheduler:
    """Accepts a Scheduler instance (passed through), a registered name,
    or None (FIFO, the default)."""
    if spec is None:
        return FIFOScheduler()
    if isinstance(spec, Scheduler):
        return spec
    if isinstance(spec, str):
        if spec not in SCHEDULERS:
            raise KeyError(f"unknown scheduler {spec!r}; available: "
                           f"{', '.join(sorted(SCHEDULERS))}")
        return SCHEDULERS[spec]()
    raise TypeError(f"scheduler must be a name or Scheduler, got "
                    f"{type(spec).__name__}")
