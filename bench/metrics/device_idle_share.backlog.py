"""Device: the share (%) of the traced window in which no operation ran
on the card (``torch.profiler``; idle gaps the engine skipped count as
idle)."""


def read(trace):
    d = trace.device
    if d is None or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
