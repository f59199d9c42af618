"""Pool: the peak of the bytes the KV pool reserved, as a share (%) of its
capacity (``KVPool.stats()``)."""


def read(trace):
    cap = trace.pool["capacity_bytes"]
    return 100.0 * trace.pool["peak_reserved_bytes"] / cap if cap else None
