"""Percentiles by linear interpolation between order statistics (numpy's
default), a frozen copy of ``repro_torch/runtime/latency.py::percentile``.

A sample that is missing (a request refused, failed or without its first
token when the window closed) enters as ``inf``: it lies beyond every
measured one, so a tail that reaches it reads ``inf``.
"""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """q-th percentile (``0 <= q <= 100``) of ``xs``; ``nan`` when empty."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    data = sorted(float(x) for x in xs)
    n = len(data)
    if n == 0:
        return math.nan
    if n == 1:
        return data[0]
    rank = (q / 100.0) * (n - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    if frac == 0.0 or data[hi] == data[lo]:
        return data[lo]
    return data[lo] + (data[hi] - data[lo]) * frac
