"""carry_ms: device time a frame of the copy of the new frame state into the
captured frame's static state at the graph's end, the program's span
``carry``, ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("carry")
