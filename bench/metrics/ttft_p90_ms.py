"""End to end: the 90th percentile of the time to first token over the
requests due in the window, a request without one counted as ``inf``
(``benchlib/result.py``)."""
from benchlib import result
from benchlib.latency import percentile


def read(run):
    return 1e3 * percentile(result.ttft_samples(run.window, run.results),
                            90.0)
