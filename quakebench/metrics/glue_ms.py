"""glue_ms: device time a frame of every operation that is not the port's
own kernel (torch's kernels, copies, fills), from the profiler (ms).
Which kernels are the port's own: quakebench/devtrace.py ``is_own``."""


def read(run):
    p = run.profile
    return p["glue_s"] * 1e3 / len(run.frames) if p else None
