"""glue_launches: device operations a frame that are not the port's own
kernels (the profiler's count)."""


def read(run):
    p = run.profile
    return p["glue_launches"] / len(run.frames) if p else None
