"""frame_ms: the whole timed window over the frames it completed (ms)."""


def read(run):
    return run.window_s * 1e3 / len(run.frames) if run.frames else None
