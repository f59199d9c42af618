"""The one traffic generator: a mix file's parameters → a request schedule.

A frozen copy of the arithmetic of ``repro_torch/core/workload.py``:
``generate``'s arrivals (an exponential gap at the base rate, or at the
burst rate with ``burst_prob``), its bimodal prompt lengths (uniform in
each mode, floored to ``round_to``), its batch sizes (powers of two) and
its memory-availability walk (mean-reverting Gaussian steps plus spikes,
clipped to ``[floor, 1]``, stepped once per arrival). Two departures,
both for steadiness: the diurnal factor is left out (a window of a minute
would see a drift, not a day), and the schedule does not depend on the
run's seed.

Every seed gets the same work: a *population* of request templates (gap,
batch, prompt, output, walk step) is drawn once from the mix's
``population_seed``, and the schedule is a run of copies of it, each
shuffled by that seed too. The run's seed draws the weights, the prompts'
token ids and the controller's inputs (``inputs.py``); the sizes, the
arrivals and their order are the mix's. A different order would change
which admissions the controller's memo serves, and with it the work.

Mix keys: ``loop`` (``backlog``: every request queued at t = 0; ``open``:
an open loop on the arrival schedule), ``population``,
``population_seed``, ``batch_pow2_max``, ``prompt`` (a list of modes
``{"share", "lo", "hi"}``), ``round_to``, ``output`` (``{"lo", "hi"}``,
both inclusive), and per loop: ``backlog_requests`` and
``warmup_admissions``; or ``rate`` (``{"base", "burst_mult",
"burst_prob"}``, requests per second), ``warmup_s``, ``drain_s`` and
``walk`` (``null`` for a static budget). ``preemption`` says whether the
engine may preempt when the walk takes its memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Template:
    gap: float              # seconds after the previous arrival
    batch: int
    prompt: int
    output: int             # tokens to generate (≥ 1)
    walk_noise: float       # the walk's Gaussian step
    spike: float            # the walk's spike depth (0 = none)


@dataclasses.dataclass(frozen=True)
class Arrival:
    index: int
    t: float                # due time, seconds from the schedule's start
    batch: int
    prompt: int
    output: int


@dataclasses.dataclass
class Schedule:
    arrivals: List[Arrival]
    # (t, fraction of the KV headroom available) breakpoints; None = static
    kv_frac: Optional[List[Tuple[float, float]]]


def population(mix: dict) -> List[Template]:
    """The mix's request templates, from its ``population_seed`` alone."""
    rng = np.random.default_rng(int(mix["population_seed"]))
    rate = mix.get("rate") or {}
    walk = mix.get("walk") or {}
    modes = mix["prompt"]
    shares = np.asarray([m["share"] for m in modes], np.float64)
    shares = shares / shares.sum()
    rt = int(mix["round_to"])
    max_b = int(mix.get("batch_pow2_max", 1))
    out = []
    for _ in range(int(mix["population"])):
        gap = 0.0
        if rate:
            base = float(rate["base"])
            r = (base * float(rate["burst_mult"])
                 if rng.random() < float(rate["burst_prob"]) else base)
            gap = float(rng.exponential(1.0 / r))
        m = modes[int(rng.choice(len(modes), p=shares))]
        prompt = int(rng.integers(int(m["lo"]), int(m["hi"])))
        prompt = max(rt, (prompt // rt) * rt)
        batch = int(2 ** rng.integers(0, int(math.log2(max_b)) + 1))
        output = int(rng.integers(int(mix["output"]["lo"]),
                                  int(mix["output"]["hi"]) + 1))
        noise = float(rng.normal(0.0, float(walk.get("sigma", 0.0))))
        spike = 0.0
        if walk and rng.random() < float(walk["spike_prob"]):
            spike = float(rng.uniform(*walk["spike_depth"]))
        out.append(Template(gap, batch, prompt, max(output, 1), noise, spike))
    return out


def schedule(mix: dict, *, horizon_s: float = 0.0, n: int = 0) -> Schedule:
    """The mix's schedule: ``n`` requests (a backlog) or every arrival
    before ``horizon_s`` (an open loop; at most ``n`` where ``n`` > 0),
    the population's copies each shuffled."""
    pop = population(mix)
    rng = np.random.default_rng((int(mix["population_seed"]), 1))
    backlog = mix["loop"] == "backlog"
    walk = mix.get("walk")
    arrivals: List[Arrival] = []
    fracs: List[Tuple[float, float]] = []
    t, mem = 0.0, 1.0
    while True:
        for j in rng.permutation(len(pop)):
            tp = pop[int(j)]
            if (backlog or n > 0) and len(arrivals) >= n:
                return Schedule(arrivals, fracs if walk else None)
            if not backlog:
                t += tp.gap
                if t >= horizon_s:
                    return Schedule(arrivals, fracs if walk else None)
                if walk:
                    mem += tp.walk_noise + float(walk["revert"]) * (1.0 - mem)
                    mem -= tp.spike
                    mem = float(np.clip(mem, float(walk["floor"]), 1.0))
                    fracs.append((t, mem))
            arrivals.append(Arrival(len(arrivals), t, tp.batch, tp.prompt,
                                    tp.output))


def budget_breakpoints(kv_frac, param_bytes: float,
                       pool_bytes: float) -> Optional[List[Tuple[float, float]]]:
    """The engine's budget trace: the walk applies to the KV headroom (the
    budget less the resident weights), never to the weights themselves."""
    if kv_frac is None:
        return None
    return [(t, float(param_bytes) + f * float(pool_bytes))
            for t, f in kv_frac]
