"""The arithmetic of the end-to-end metrics, all over the window and on
the engine's virtual clock (``serve.py``), which their readers in
``bench/metrics/`` apply to a run; and the trace the per-layer readers
read.

* ``tokens_per_s``: generated tokens the caller received in the window
  (a read-back delivers a horizon's tokens of every row of a request; the
  prefill delivers the first), over the window's seconds;
* ``ttft_p90_ms``: over the requests due in the window, from when each
  was due on the schedule to its first token; a request refused, failed or
  still without a token when the run ends is ``inf``;
* ``itl_p99_ms``: over every token received in the window, the interval
  between its request's read-back and the one before, divided by the
  tokens the later one delivered (per step of the request, as the engine
  counts its ITL);
* ``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` over set-up and
  window;
* ``setup_s``: process start to the window's opening.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional


def deliveries(served) -> List[tuple]:
    """(t, tokens) of each delivery to one request, the first token's
    included."""
    if served.first_t is None:
        return []
    return [(served.first_t, 1)] + list(served.readbacks)


def in_window(w, t: float) -> bool:
    return w.t_open <= t < w.t_close


def tokens_per_s(w) -> float:
    n = sum(k * s.batch for s in w.served.values()
            for t, k in deliveries(s) if in_window(w, t))
    return n / w.seconds


def itl_samples(w) -> List[float]:
    out = []
    for s in w.served.values():
        ev = deliveries(s)
        for (t0, _), (t1, k) in zip(ev, ev[1:]):
            if in_window(w, t1):
                out.extend([(t1 - t0) / k] * k)
    return out


def due_in_window(w) -> List:
    return [s for s in w.served.values() if in_window(w, s.due)]


def ttft_samples(w, results) -> List[float]:
    refused = {r.rid for r in results if r.status == "rejected"}
    return [(s.first_t - s.due) if (s.first_t is not None
                                    and s.rid not in refused) else math.inf
            for s in due_in_window(w)]


def attempted_failed(run) -> tuple:
    """Requests the window served (open loop: those due in it; backlog:
    those that received a token in it) and how many of them failed."""
    w = run.window
    refused = {r.rid for r in run.results if r.status == "rejected"}
    if w.backlog:
        cells = [s for s in w.served.values()
                 if any(in_window(w, t) for t, _ in deliveries(s))]
    else:
        cells = due_in_window(w)
    failed = sum(1 for s in cells if s.rid in refused or s.first_t is None)
    return len(cells), failed


@dataclasses.dataclass
class Trace:
    """What a per-layer reader reads: the window, the benchmark's spans
    and token records, the program's request results and pool ledger,
    the configuration, and the device trace (None without one)."""
    t_open: float
    t_close: float
    seconds: float
    spans: List[Any]
    served: Dict[str, Any]
    results: List[Any]
    pool: Dict[str, float]
    cfg: Dict
    serving: Dict
    device: Optional[Dict]

    def within(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

    def traced(self, t: float) -> bool:
        """Whether ``t`` falls in the device trace (the window's end)."""
        return (self.device is not None
                and self.device["span"][0] <= t < self.device["span"][1])


def make_trace(run, cfg_file: Dict, device_summary: Optional[Dict]) -> Trace:
    w = run.window
    return Trace(t_open=w.t_open, t_close=w.t_close, seconds=w.seconds,
                 spans=w.spans, served=w.served, results=run.results,
                 pool=run.pool, cfg=cfg_file["model"],
                 serving=cfg_file["serving"], device=device_summary)
