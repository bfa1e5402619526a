"""frame_ms_p90: the 90th percentile of every frame's time in the window
(ms; Python's inclusive quantiles over all frames)."""
import statistics


def read(run):
    if len(run.frames) < 2:
        return None
    return statistics.quantiles([f * 1e3 for f in run.frames], n=10, method="inclusive")[8]
