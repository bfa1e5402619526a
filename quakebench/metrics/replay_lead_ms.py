"""replay_lead_ms: device time a frame from the replay call's start (before
its inputs are copied) to the captured graph's first event: the program's
span ``replay.lead`` (children ``replay.inputs``, ``replay.launch``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("replay.lead")
