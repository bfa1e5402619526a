"""mcpg_surface_ms: device time a frame of the guided surface pass: the
program's spans ``mcpg.pack`` (the packed draw and light-cache tables) and
``mcpg.surface`` (its bounce segments, ``mcpg.surface.seg<k>``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("mcpg.pack", "mcpg.surface")
