"""mcpg_update_ms: device time a frame of the guiding update: the queues' row
ids and concatenation, their compactions and the replays into the chain
and distance states, the program's span ``mcpg.update``, ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("mcpg.update")
