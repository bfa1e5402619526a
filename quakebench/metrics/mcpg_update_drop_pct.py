"""mcpg_update_drop_pct: the live guiding-update rows past the update
queue's capacity, which the compaction drops, over the live rows, the
program's device counters ``mcpg.update_rows_dropped`` and
``mcpg.update_rows_live``, %."""
from quakebench import programtrace


def read(run):
    return programtrace.counter_pct("mcpg.update_rows_dropped", "mcpg.update_rows_live")
