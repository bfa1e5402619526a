"""ssmm_chains_valid_pct: the live pixels whose tentative chain carries a
weight (sum_w > 0) after the exchange, over the live pixels, the
program's device counters ``ssmm.chains_valid`` and ``ssmm.pixels_live``,
%."""
from quakebench import programtrace


def read(run):
    return programtrace.counter_pct("ssmm.chains_valid", "ssmm.pixels_live")
