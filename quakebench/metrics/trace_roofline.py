"""trace_roofline: the least time of a frame's traces (quakebench/
roofline.py, counted from the configuration and the scene's sizes) over
their device time a frame (trace_ms), in percent."""
from quakebench import roofline


def read(run):
    p = run.profile
    if not p or p["own_s"] <= 0:
        return None
    floor = roofline.frame_floor_s(run.config, run.alpha, run.n_tris, run.n_clusters)
    return 100.0 * floor / (p["own_s"] / len(run.frames))
