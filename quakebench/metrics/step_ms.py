"""step_ms: host clock around LiveGame.step_dynamic, mean a frame of the
traced window (ms); live mixes only."""


def read(run):
    t = run.spans.get("step_dynamic")
    return sum(t) / len(t) * 1e3 if t else None
