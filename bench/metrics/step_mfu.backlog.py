"""Model step: the kept blocks' model operations of every forward in the
window (prefill, decode, the controller's scoring), over the window, as a
share (%) of one H100's bf16 peak. The count is ``benchlib/workcount``'s."""
from benchlib import workcount


def read(trace):
    return 100.0 * workcount.model_flops(trace) / trace.seconds \
        / workcount.PEAK_BF16_FLOPS
