"""Synthetic serving workload + memory-availability traces (paper Fig. 2/5).

Models the two runtime-variance sources the paper identifies:
 * input-driven — request mix: bursty arrivals, bimodal prompt lengths
   (short conversational turns + long-form documents), diurnal modulation,
   batch sizes from queue depth  (Azure LLM-trace-like, Stojkovic 2025);
 * system-level — available-memory trace: base capacity minus co-running
   application interference (OU random walk + occasional spikes).

Everything is deterministic in the seed so experiments replay exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    t: float                 # arrival time (s)
    batch: int
    seq_len: int
    budget_frac: float       # available memory / dense peak at this instant


@dataclasses.dataclass
class WorkloadConfig:
    seed: int = 0
    horizon_s: float = 600.0
    base_rate: float = 0.5           # requests/s baseline
    burst_rate: float = 4.0          # requests/s during bursts
    burst_prob: float = 0.08
    short_len: Tuple[int, int] = (64, 512)
    long_len: Tuple[int, int] = (1024, 4096)
    long_frac: float = 0.25
    max_batch: int = 32
    mem_base: float = 1.0            # fraction of dense peak available
    mem_walk_sigma: float = 0.04
    mem_spike_prob: float = 0.03
    mem_spike_depth: Tuple[float, float] = (0.2, 0.5)
    mem_floor: float = 0.45
    round_len_to: int = 64


def generate(cfg: WorkloadConfig) -> List[Request]:
    rng = np.random.default_rng(cfg.seed)
    out: List[Request] = []
    t = 0.0
    mem = cfg.mem_base
    while t < cfg.horizon_s:
        diurnal = 1.0 + 0.5 * np.sin(2 * np.pi * t / cfg.horizon_s)
        rate = (cfg.burst_rate if rng.random() < cfg.burst_prob
                else cfg.base_rate) * diurnal
        t += float(rng.exponential(1.0 / max(rate, 1e-6)))
        # memory availability: mean-reverting walk + interference spikes
        mem += (rng.normal(0.0, cfg.mem_walk_sigma)
                + 0.1 * (cfg.mem_base - mem))
        if rng.random() < cfg.mem_spike_prob:
            mem -= rng.uniform(*cfg.mem_spike_depth)
        mem = float(np.clip(mem, cfg.mem_floor, 1.0))
        if rng.random() < cfg.long_frac:
            sql = int(rng.integers(*cfg.long_len))
        else:
            sql = int(rng.integers(*cfg.short_len))
        sql = max(cfg.round_len_to,
                  (sql // cfg.round_len_to) * cfg.round_len_to)
        bs = int(2 ** rng.integers(0, int(np.log2(cfg.max_batch)) + 1))
        out.append(Request(t=t, batch=bs, seq_len=sql, budget_frac=mem))
    return out


# ------------------------------------------------- engine arrival processes
@dataclasses.dataclass
class PoissonConfig:
    """Homogeneous-Poisson request stream for the continuous-batching engine.

    Unlike :func:`generate` (which models the paper's diurnal/bursty traffic
    over a long horizon), this produces a fixed-count trace with exponential
    interarrivals — the standard benchmark arrival process for serving
    engines — plus the same bimodal prompt-length mix. Budget here is the
    *shared* pool fraction, not a per-request instantaneous budget.
    """
    seed: int = 0
    n_requests: int = 16
    rate: float = 4.0                    # mean arrivals per second
    short_len: Tuple[int, int] = (32, 128)
    long_len: Tuple[int, int] = (128, 512)
    long_frac: float = 0.25
    round_len_to: int = 16
    budget_frac: float = 0.8             # recorded per request for replay
    batch: int = 1                       # sequences per request


def poisson_requests(cfg: PoissonConfig) -> List[Request]:
    """Fixed-count Poisson trace with arrival timestamps (t strictly
    increasing). Deterministic in ``cfg.seed``."""
    rng = np.random.default_rng(cfg.seed)
    out: List[Request] = []
    t = 0.0
    for _ in range(cfg.n_requests):
        t += float(rng.exponential(1.0 / max(cfg.rate, 1e-9)))
        if rng.random() < cfg.long_frac:
            sql = int(rng.integers(*cfg.long_len))
        else:
            sql = int(rng.integers(*cfg.short_len))
        sql = max(cfg.round_len_to,
                  (sql // cfg.round_len_to) * cfg.round_len_to)
        out.append(Request(t=t, batch=cfg.batch, seq_len=sql,
                           budget_frac=cfg.budget_frac))
    return out


def trace_requests(arrivals, seq_lens, *, batch: int = 1,
                   budget_frac: float = 0.8) -> List[Request]:
    """Replay an externally supplied (arrival_time, prompt_len) trace —
    e.g. Azure LLM-trace timestamps — as engine requests."""
    if len(arrivals) != len(seq_lens):
        raise ValueError("arrivals and seq_lens must be the same length")
    return [Request(t=float(t), batch=batch, seq_len=int(s),
                    budget_frac=budget_frac)
            for t, s in zip(arrivals, seq_lens)]


def request_sampler(cfg: WorkloadConfig, mm, *,
                    budget_range: Tuple[float, float] = (0.55, 0.95)):
    """Adapter for the DQN trainer (``dqn.train``): samples (bs, sql, budget_bytes)
    per episode from the workload distributions."""
    wl_rng = np.random.default_rng(cfg.seed + 77)
    reqs = generate(cfg)

    def sample(rng: np.random.Generator):
        r = reqs[int(rng.integers(0, len(reqs)))]
        frac = float(np.clip(r.budget_frac, *budget_range))
        budget = frac * mm.dense_peak(r.batch, r.seq_len)
        return r.batch, r.seq_len, budget

    del wl_rng
    return sample
