"""End to end: the 99th percentile of the gap per token over every token
received in the window (``benchlib/result.py``)."""
from benchlib import result
from benchlib.latency import percentile


def read(run):
    return 1e3 * percentile(result.itl_samples(run.window), 99.0)
