"""Controller: the share (%) of the window the policy's decisions took
(their spans, cut to the window)."""


def read(trace):
    busy = sum(max(0.0, min(sp.t1, trace.t_close) - max(sp.t0, trace.t_open))
               for sp in trace.spans if sp.kind == "decide")
    return 100.0 * busy / trace.seconds
