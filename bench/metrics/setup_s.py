"""End to end: process start to the window's opening."""


def read(run):
    return run.setup_s
