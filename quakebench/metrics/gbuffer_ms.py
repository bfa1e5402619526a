"""gbuffer_ms: device time a frame of the gbuffer stage (the primary trace and
its shading), the program's span ``gbuffer`` inside the captured frame, ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("gbuffer")
