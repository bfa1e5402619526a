"""ssmm_ms: device time a frame of the SSMM pass, the program's span
``ssmm`` (children ``ssmm.inputs``, ``ssmm.exchange``, ``ssmm.sample``,
``ssmm.trace``, ``ssmm.chain``, ``ssmm.smis``), ms."""
from quakebench import programtrace


def read(run):
    return programtrace.span_ms("ssmm")
