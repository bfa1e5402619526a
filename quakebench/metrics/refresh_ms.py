"""refresh_ms: host clock around accel.build.refresh_dynamic, ended in a
synchronize, mean a frame of the traced window (ms); live mixes only."""


def read(run):
    t = run.spans.get("refresh_dynamic")
    return sum(t) / len(t) * 1e3 if t else None
