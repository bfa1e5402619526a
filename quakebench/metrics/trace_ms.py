"""trace_ms: device time a frame of the port's own kernels, those whose
names come from its csrc/ sources, from the profiler (ms)."""


def read(run):
    p = run.profile
    return p["own_s"] * 1e3 / len(run.frames) if p and p["own_s"] > 0 else None
