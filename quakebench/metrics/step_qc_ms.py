"""step_qc_ms: host clock a frame of the QuakeC game tick (``host.frame``) in
the live game step, the program's span ``step.qc`` (its siblings
``step.entities``, ``step.extract``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("step.qc")
