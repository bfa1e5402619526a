"""refresh_rows_ms: host clock a frame of the refresh's numpy rows of the
dynamic suffix (``dynamic_rows``), the program's span ``refresh.rows`` (its
sibling ``refresh.write`` writes them), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("refresh.rows")
