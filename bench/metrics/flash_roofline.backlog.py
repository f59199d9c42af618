"""Kernels: flash attention's least time (prefill and the controller's
scoring forwards; bytes or operations at the H100's peaks,
``benchlib/workcount``) over its device time in the window's trace, as a
share (%)."""
from benchlib import workcount

KERNELS = ("flash_kernel", "flash_wgmma_kernel")


def read(trace):
    if trace.device is None:
        return None
    t = workcount.kernel_seconds(trace, KERNELS)
    return 100.0 * workcount.flash_least(trace) / t if t else None
