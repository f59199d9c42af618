"""End to end: generated tokens the caller received in the window over
the window's seconds (``benchlib/result.py``)."""
from benchlib import result


def read(run):
    return result.tokens_per_s(run.window)
