"""From a torch.profiler trace of the window to the device's numbers:
busy time, the port's own kernels against the rest, launches, the top
device operations and the longest idle gaps labelled by the host span
that was open.

One rule splits the device's work: a kernel is the port's own when its
name is one of the ``__global__`` functions of the port's ``csrc/``
sources; every other device operation (torch's kernels, copies, fills)
is glue. Busy time is the union of every device operation's interval in
the window, so the two parts add up to it where operations do not
overlap (a frame is one stream).
"""
from __future__ import annotations

import glob
import os
import re

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


def own_kernel_names(csrc_dir: str) -> frozenset:
    """The ``__global__`` function names of the sources under ``csrc_dir``."""
    names = set()
    for path in sorted(glob.glob(os.path.join(csrc_dir, "*.cu*"))):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return frozenset(names)


def is_own(name: str, own: frozenset) -> bool:
    """Is the device operation ``name`` (as the profiler spells it,
    demangled with its template and argument list) one of ``own``?"""
    name = name.replace("(anonymous namespace)::", "")
    words = name.split("(", 1)[0].split("<", 1)[0].split()
    return bool(words) and words[-1].rsplit("::", 1)[-1] in own


def union(intervals: list) -> float:
    """Total length covered by [(start, end)] intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, start: float, end: float) -> list:
    """[(start, end)] stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def label(gap: tuple, spans: list) -> str:
    """The host span ("step_dynamic", "replay", ...) that covers most of
    ``gap``; "host" where none does."""
    best, cover = "host", 0.0
    for name, s, e in spans:
        c = min(e, gap[1]) - max(s, gap[0])
        if c > cover:
            best, cover = name, c
    return best


def summarize(device_ops: list, host_spans: list, window: tuple, own: frozenset) -> dict:
    """``device_ops`` [(name, start_s, end_s)], ``host_spans`` [(name,
    start_s, end_s)] and ``window`` (start_s, end_s), all on the
    profiler's clock. Returns busy, own and glue seconds, launches,
    ``device_ops`` (the top 10 by time) and ``idle_gaps`` (the 10
    longest, labelled)."""
    w0, w1 = window
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device_ops if e > w0 and s < w1]
    mine = [(s, e) for n, s, e in ops if is_own(n, own)]
    glue = [(s, e) for n, s, e in ops if not is_own(n, own)]
    by_name: dict[str, float] = {}
    for n, s, e in ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    idle = gaps([(s, e) for _, s, e in ops], w0, w1)
    idle.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": union([(s, e) for _, s, e in ops]),
        "own_s": union(mine),
        "glue_s": union(glue),
        "own_launches": len(mine),
        "glue_launches": len(glue),
        "window_s": w1 - w0,
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(g, host_spans), g[1] - g[0]] for g in idle[:10]],
    }


def read_profiler(prof) -> tuple:
    """(device_ops, host_spans) of a finished ``torch.profiler.profile``:
    device operations (kernels, copies, fills) and the ``qb.*`` ranges
    the harness recorded, as (name, start_s, end_s). The profiler also
    puts each ``qb.*`` range on the device's timeline (an annotation, not
    an operation): those are not device operations."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.name().startswith("qb."):
            if e.device_type() != DeviceType.CUDA:
                spans.append((e.name()[3:], s, t))
        elif e.device_type() == DeviceType.CUDA:
            ops.append((e.name(), s, t))
    return ops, spans
