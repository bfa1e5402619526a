"""mcpg_live_lanes_pct: the lanes alive on entering a bounce segment of the
guided surface pass over the lanes the segments ran, the program's device
counters ``mcpg.lanes_live`` and ``mcpg.lanes_run``, %."""
from quakebench import programtrace


def read(run):
    return programtrace.counter_pct("mcpg.lanes_live", "mcpg.lanes_run")
