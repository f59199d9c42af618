"""The device's side of a traced run, from ``torch.profiler``.

Only CUDA activity is recorded (kernels, copies, fills), over the window
alone. From it: the busy time (the union of every device operation's
interval), the device time by kernel, and the idle gaps, each labelled by
what the host was doing then (the benchmark's own spans).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple


def profiler():
    """A CUDA-only profiler for the window, started and stopped by the
    window itself."""
    import torch
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def short_name(name: str) -> str:
    """A kernel's identifier without its return type, template arguments
    and parameters: ``void paged_tc_kernel<...>(...)`` → ``paged_tc_kernel``."""
    base = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return base.split()[-1] if base else name


def device_events(prof) -> List[Tuple[str, float, float]]:
    """(name, start s, end s) of each device operation, on the profiler's
    clock (nanoseconds since the epoch, as kineto stamps them)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            t0 = e.start_ns() * 1e-9
            out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
    out.sort(key=lambda x: x[1])
    return out


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the events' intervals, in time order."""
    merged: List[List[float]] = []
    for _, t0, t1 in events:
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return [(a, b) for a, b in merged]


def summarize(prof, span: Tuple[float, float], epoch_at_start: float,
              host_spans) -> Dict:
    """Busy and window seconds, device seconds by kernel, and idle seconds
    by the host's activity. ``span`` is the traced window on the virtual
    clock, ``epoch_at_start`` the epoch time at its start; ``host_spans``
    the benchmark's spans (``kind``, ``t0``, ``t1`` on the virtual
    clock)."""
    events = device_events(prof)
    window_s = span[1] - span[0]
    by_kernel: Dict[str, float] = {}
    for name, t0, t1 in events:
        k = short_name(name)
        by_kernel[k] = by_kernel.get(k, 0.0) + (t1 - t0)
    busy = busy_intervals(events)
    busy_s = sum(b - a for a, b in busy)
    # epoch → virtual clock; a profiler whose clock is not the epoch's is
    # aligned at its first operation instead
    shift = span[0] - epoch_at_start
    if events and not (span[0] - 1.0 <= events[0][1] + shift <= span[1]):
        shift = span[0] - events[0][1]
    gaps = []
    edges = [span[0]] + [x + shift for ab in busy for x in ab] + [span[1]]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    idle: Dict[str, float] = {}
    order = ("decide", "prefill", "horizon")
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = "engine tick, outside the spans"
        for kind in order:
            if any(s.kind == kind and s.t0 <= mid < s.t1 for s in host_spans):
                label = {"decide": "decide (controller, GSI scoring)",
                         "prefill": "prefill_into",
                         "horizon": "horizon in flight, host phase"}[kind]
                break
        idle[label] = idle.get(label, 0.0) + (b - a)
    # the idle gaps the engine's clock jumped over are not on the host's
    # clock that the gaps above were read on
    skipped = window_s - busy_s - sum(idle.values())
    if skipped > 1e-6:
        idle["skipped by the engine (nothing to run)"] = skipped
    return {"busy_s": busy_s, "window_s": window_s, "by_kernel": by_kernel,
            "idle": idle, "span": tuple(span)}
