"""mcpg_states_used_pct: the chain states that carry a weight (sum_w > 0)
after the frame's update over all chain states, the program's device
counter ``mcpg.states_weighted`` over ``mcpg.states``, %."""
from quakebench import programtrace


def read(run):
    return programtrace.counter_pct("mcpg.states_weighted", "mcpg.states")
