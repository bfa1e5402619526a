"""The program's own spans and counters: what its tracer
(``utils/profiler.py`` of the package under test) recorded over a
``--trace 1`` window, read through its ``summary()``. The tracer records
while a ``torch.profiler`` session runs, which is the traced window. A
program without that tracer, or a run that recorded nothing, reads None
everywhere."""
from __future__ import annotations

import importlib

from quakebench import scenes


def summary() -> dict | None:
    """The program tracer's ``summary()``, or None where it has none or it
    recorded no frame."""
    try:
        mod = importlib.import_module(f"{scenes.PROGRAM}.utils.profiler")
    except ImportError:
        return None
    read = getattr(mod, "summary", None)
    s = read() if callable(read) else None
    return s if s and s.get("frames") else None


def span_ms(*names: str) -> float | None:
    """The spans ``names`` together, ms a recorded frame (device time where
    the span has device events); None where none of them was recorded."""
    s = summary()
    if s is None:
        return None
    found = [s["spans"][n]["ms"] for n in names if n in s["spans"]]
    return sum(found) / s["frames"] if found else None


def counter_pct(part: str, whole: str) -> float | None:
    """Counter ``part`` over counter ``whole`` over the recorded frames, in
    percent; None where ``whole`` was not counted or is 0."""
    s = summary()
    counters = s["counters"] if s else {}
    if not counters.get(whole):
        return None
    return 100.0 * counters.get(part, 0) / counters[whole]
