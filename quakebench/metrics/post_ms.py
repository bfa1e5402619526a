"""post_ms: device time a frame of everything after the integrator: the
accumulation, the SVGF / TAA / FXAA chain, the exposure and tonemap, the
program's span ``post`` and its children ``post.*``, ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("post")
