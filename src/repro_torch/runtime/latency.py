"""Pure latency-percentile helpers for serving measurement.

The engine reports per-request TTFT (time to first token) and inter-token
latency as p50/p90/p99 summaries; this module is the arithmetic behind
them, a copy of the JAX package's (``tests/test_torch_core.py`` holds the
two equal).

Percentiles use the classic sorted-sample linear interpolation (numpy's
default "linear" method) and are total functions: an empty stream yields
zeros with ``count == 0`` rather than NaNs, so report plumbing never has
to special-case runs where nothing was measured (e.g. every request
rejected).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

__all__ = ["percentile", "summarize"]


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (``0 <= q <= 100``) of ``xs`` by linear
    interpolation between order statistics. Empty input yields 0.0."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    data = sorted(float(x) for x in xs)
    n = len(data)
    if n == 0:
        return 0.0
    if n == 1:
        return data[0]
    rank = (q / 100.0) * (n - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return data[lo] + (data[hi] - data[lo]) * frac


def summarize(xs: Iterable[float],
              qs: Tuple[float, ...] = (50.0, 90.0, 99.0)) -> Dict[str, float]:
    """{"p50", "p90", "p99", ..., "mean", "count"} summary of a latency
    stream. Percentile keys follow ``qs`` (integral q renders as ``pN``).
    Empty streams summarize to all-zeros with ``count == 0``."""
    data = [float(x) for x in xs]
    out: Dict[str, float] = {}
    for q in qs:
        key = f"p{int(q)}" if float(q).is_integer() else f"p{q}"
        out[key] = percentile(data, q)
    out["mean"] = sum(data) / len(data) if data else 0.0
    out["count"] = float(len(data))
    return out
