"""mcpg_volume_ms: device time a frame of the guided volume pass (single
scattering), the program's span ``mcpg.volume``, ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("mcpg.volume")
