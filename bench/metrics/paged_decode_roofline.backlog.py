"""Kernels: the paged-decode kernels' least time (bytes or operations at
the H100's peaks, ``benchlib/workcount``) over their device time in the
window's trace, as a share (%)."""
from benchlib import workcount

KERNELS = ("paged_decode_kernel", "paged_tc_kernel", "combine_kernel")


def read(trace):
    if trace.device is None:
        return None
    t = workcount.kernel_seconds(trace, KERNELS)
    return 100.0 * workcount.paged_decode_least(trace) / t if t else None
