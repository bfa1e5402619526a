"""The phases in the order a whole run takes them, and the run.

``PHASES`` is the one table: a phase's number and its function. A phase
reads the fixtures its parameters name (``fixtures.py``); a new phase is a
function and a line here. :func:`run` takes phase 1 (the card and the
kernels' build) and then every phase, or the phases it is given, in this
order; a phase that another one's fixture needs runs first, once.
"""
from __future__ import annotations

import json
import re
import time

import torch

from . import capture, draw, fixtures, frames, live, native, presets, svgf, trace
from .common import card, log
from .summary import kernels_line


def phase1():
    """The card's name and power limit, every kernel source built with
    nvcc for sm_90a (all started together) with each one's ptxas lines,
    and the native accel builder built with g++; exits where there is no
    card."""
    from merian_quake_tpu_torch import kernels
    from merian_quake_tpu_torch.utils import native as native_builder

    dev, smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(smi)
    t0 = time.perf_counter()
    kernels.build_libraries(*kernels.KERNELS)
    build_s = time.perf_counter() - t0
    ptxas, spills = {}, {}
    for name in kernels.KERNELS:
        kernels.load_library(name)
        with open(kernels.library_path(name) + ".log") as f:
            lines = [line.strip() for line in f if "Used" in line or "spill" in line]
        ptxas[name] = " | ".join(lines)
        spills[name] = sum(int(x) for line in lines
                           for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", line))
    if spills["mt_dense"]:
        raise AssertionError(f"K8 spills registers: {ptxas['mt_dense']}")
    # the native accel builder (g++), which every build_accel uses
    t0 = time.perf_counter()
    native_builder.build_library()
    native_build_s = time.perf_counter() - t0
    log(f"phase 1 device: {kind} x{count} [{smi}] torch {torch.__version__} "
        f"cuda {torch.version.cuda}; the native accel builder (g++ "
        f"{' '.join(native_builder.CXXFLAGS)}) {native_build_s:.2f} s; K1, K2, K3, K4 + K5, "
        f"K6 + K7, K8, the alpha walk, the SVGF kernels and MCPG's draws build {build_s:.2f} s; "
        f"spill bytes {spills}; " + "; ".join(f"{k} ({ptxas[k]})" for k in kernels.KERNELS))
    fixtures.keep(dev=dev, smi=smi, native_build_s=native_build_s)
    return {"kind": kind, "count": count, "spills": spills}


PHASES = (
    (1, phase1),
    (2, trace.phase2),
    (3, frames.phase3),
    (4, frames.phase4),
    (5, trace.phase5),
    (6, frames.phase6),
    (7, frames.phase7),
    (8, trace.phase8),
    (9, trace.phase9),
    (10, trace.phase10),
    (11, trace.phase11),
    (12, trace.phase12),
    (13, trace.phase13),
    (14, trace.phase14),
    (15, trace.phase15),
    (16, frames.phase16),
    (17, frames.phase17),
    (18, frames.phase18),
    (19, frames.phase19),
    (20, frames.phase20),
    (21, frames.phase21),
    (22, frames.phase22),
    (23, frames.phase23),
    (24, frames.phase24),
    (25, frames.phase25),
    (26, presets.phase26),
    (27, presets.phase27),
    (28, presets.phase28),
    (29, live.phase29),
    (30, live.phase30),
    (31, live.phase31),
    (39, trace.phase39),  # on phase 31's live dungeon, before it is let go
    (32, live.phase32),
    (33, live.phase33),
    (34, live.phase34),
    (35, native.phase35),
    (36, native.phase36),
    (37, native.phase37),
    (38, capture.phase38),
    (40, svgf.phase40),
    (41, live.phase41),
    (42, draw.phase42),
)
_results: dict = {}
_marks: list = []  # (phase, when it ended), in the order the phases ran


def run_phase(n: int):
    """Phase ``n``'s result, running it (with the fixtures it reads) where
    it has not run."""
    if n not in _results:
        fn = dict(PHASES)[n]
        _results[n] = fn(*[fixtures.get(name) for name in fixtures.reads(fn)])
        _marks.append((n, time.perf_counter()))
    return _results[n]


def run(selection=None) -> int:
    """Phase 1, then every phase or those of ``selection``, in the table's
    order; each fixture is let go once no phase still to run reads it.
    After a whole run, the seconds each phase took and the kernels' JSON
    record; then ``{"ok": true, "device": ...}``."""
    t0 = time.perf_counter()
    order = [n for n, _ in PHASES if selection is None or n == 1 or n in selection]
    funcs = dict(PHASES)
    for i, n in enumerate(order):
        run_phase(n)
        fixtures.release(fixtures.needs(
            name for m in order[i + 1:] for name in fixtures.reads(funcs[m])))
    ran = ("every phase" if selection is None
           else "phases " + " ".join(str(n) for n, _ in _marks))
    log(f"chip_smoke: {ran} passed in {time.perf_counter() - t0:.1f} s (phase 1 "
        f"{_marks[0][1] - t0:.1f} s, " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.1f}" for a, b in zip(_marks, _marks[1:])) + ")")
    if selection is None:
        print(kernels_line(_results))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": _results[1]["kind"],
                                             "count": _results[1]["count"]}}))
    return 0
