"""End to end: ``torch.cuda.max_memory_allocated`` over set-up and
window, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
