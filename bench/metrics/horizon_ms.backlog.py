"""Executor: wall ms from ``decode_launch`` to its ``decode_finish``, per
token of the horizon, over the horizons launched in the window."""


def read(trace):
    hs = [sp for sp in trace.spans
          if sp.kind == "horizon" and trace.within(sp.t0)]
    steps = sum(sp.info["horizon"] for sp in hs)
    return 1e3 * sum(sp.t1 - sp.t0 for sp in hs) / steps if steps else None
