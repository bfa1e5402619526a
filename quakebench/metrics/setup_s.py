"""setup_s: process start to the first timed frame (s)."""


def read(run):
    return run.setup_s
