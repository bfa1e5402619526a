"""ssmm_guided_pct: the live lanes that sampled their chain's vMF lobe
rather than the BSDF, over the live pixels, the program's device counters
``ssmm.guided`` and ``ssmm.pixels_live``, %."""
from quakebench import programtrace


def read(run):
    return programtrace.counter_pct("ssmm.guided", "ssmm.pixels_live")
