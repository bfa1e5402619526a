"""idle_pct: the share of the traced window with no operation on the
device, from the profiler (%)."""


def read(run):
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
