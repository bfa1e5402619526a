"""The chip's peaks and the work of the trace kernels, counted from the
cell's configuration and scene sizes alone (never from a count that a
kernel reports), for ``trace_roofline_pct``.

The work is a floor. Each trace that the frame's algorithm makes counts
once, however many launches carry it: the primary trace, each bounce
segment of each sample, each volume scatter trace, each visibility trace
(and, where the scene has alpha-tested triangles, the alpha-tested
table's trace beside it). A trace reads each ray record once (origin,
direction, t_min, t_max: 32 bytes), writes each hit record once (t, tri,
u, v: 16 bytes; a visibility flag: 1 byte), reads the scene's Woop rows
(48 bytes a triangle) and walk boxes (24 bytes a cluster) once, and makes
one ray-triangle test a ray (42 operations, the count of the Woop test
that the repository's kernel bounds use). Which traces a frame makes is
the integrator's trace model (``quakebench/tracemodels/``).
"""
from __future__ import annotations

import importlib

from quakebench import spec

# NVIDIA H100 SXM (data sheet, full 700 W power limit): HBM3 bandwidth and
# FP32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_FP32 = 67e12

RAY_BYTES = 32
HIT_BYTES = 16
VIS_BYTES = 1
WOOP_BYTES_PER_TRI = 48
BOX_BYTES_PER_CLUSTER = 24
TEST_FLOPS = 42


def traces(cfg: dict, alpha: bool) -> list:
    """[(rays, nearest?)] of one frame's traces: the gbuffer's primary
    trace, then the integrator's, from its trace model
    (``quakebench/tracemodels/<integrator>.py``)."""
    r = cfg["render"]
    px = r["width"] * r["height"]
    integ = spec.valid_name("integrator", r["integrator"])
    try:
        model = importlib.import_module(f"quakebench.tracemodels.{integ}")
    except ModuleNotFoundError as e:
        raise ValueError(f"no trace model for integrator {integ!r}: "
                         f"quakebench/tracemodels/{integ}.py") from e
    return [(px, True)] + model.traces(cfg, px, alpha)


def trace_floor(rays: int, nearest: bool, n_tris: int, n_clusters: int) -> tuple:
    """(bytes, operations) of one trace."""
    out = HIT_BYTES if nearest else VIS_BYTES
    nbytes = rays * (RAY_BYTES + out) + n_tris * WOOP_BYTES_PER_TRI \
        + n_clusters * BOX_BYTES_PER_CLUSTER
    return nbytes, rays * TEST_FLOPS


def frame_floor_s(cfg: dict, alpha: bool, n_tris: int, n_clusters: int) -> float:
    """The least time one frame's traces could take: for each trace the
    larger of its bytes over the bandwidth and its operations over the
    FP32 rate, summed."""
    total = 0.0
    for rays, nearest in traces(cfg, alpha):
        nbytes, flops = trace_floor(rays, nearest, n_tris, n_clusters)
        total += max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_FP32)
    return total
